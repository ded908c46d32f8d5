"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package builds nothing: a kernel compiles at its first
launch (see :mod:`nezha_tpu_torch.ops.cuda.build`).
"""

from nezha_tpu_torch.ops.cuda.decode_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from nezha_tpu_torch.ops.cuda.prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_plain)

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_prefill_attention", "paged_prefill_attention_plain"]
