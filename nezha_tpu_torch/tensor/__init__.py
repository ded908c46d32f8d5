from nezha_tpu_torch.tensor.policy import (DEFAULT_POLICY, Policy,
                                           bf16_policy, f32_policy)

__all__ = ["DEFAULT_POLICY", "Policy", "bf16_policy", "f32_policy"]
