from nezha_tpu_torch.tensor.memory import (device_memory_stats,
                                           memory_metrics, to_device,
                                           to_host, tree_bytes)
from nezha_tpu_torch.tensor.policy import (DEFAULT_POLICY, Policy,
                                           bf16_policy, f32_policy)

__all__ = ["DEFAULT_POLICY", "Policy", "bf16_policy", "device_memory_stats",
           "f32_policy", "memory_metrics", "to_device", "to_host",
           "tree_bytes"]
