from nezha_tpu_torch.runtime.executor import CompileCache, Executor
from nezha_tpu_torch.runtime.prefetch import Prefetcher, prefetch_to_device

__all__ = ["CompileCache", "Executor", "Prefetcher", "prefetch_to_device"]
