from nezha_tpu_torch.runtime.prefetch import Prefetcher, prefetch_to_device

__all__ = ["Prefetcher", "prefetch_to_device"]
