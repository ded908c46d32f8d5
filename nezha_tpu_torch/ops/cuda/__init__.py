"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package builds nothing: a kernel compiles at its first
launch (see :mod:`nezha_tpu_torch.ops.cuda.build`).
"""

from nezha_tpu_torch.ops.cuda.decode_attention import (
    flash_decode_attention, flash_decode_attention_plain,
    paged_decode_attention, paged_decode_attention_plain,
    paged_quant_decode_attention, paged_quant_decode_attention_plain)
from nezha_tpu_torch.ops.cuda.flash_attention import (
    flash_attention, flash_block_bwd, flash_block_bwd_plain, flash_block_fwd,
    flash_block_fwd_plain)
from nezha_tpu_torch.ops.cuda.layer_norm import (
    fused_layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd,
    layer_norm_fwd_plain)
from nezha_tpu_torch.ops.cuda.prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_plain,
    paged_prefill_qoff_attention, paged_prefill_qoff_attention_plain,
    paged_quant_prefill_attention, paged_quant_prefill_attention_plain)

__all__ = ["flash_attention", "flash_block_bwd", "flash_block_bwd_plain",
           "flash_block_fwd", "flash_block_fwd_plain",
           "flash_decode_attention", "flash_decode_attention_plain",
           "fused_layer_norm", "layer_norm_bwd", "layer_norm_bwd_plain",
           "layer_norm_fwd", "layer_norm_fwd_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "paged_prefill_attention", "paged_prefill_attention_plain",
           "paged_prefill_qoff_attention",
           "paged_prefill_qoff_attention_plain",
           "paged_quant_decode_attention",
           "paged_quant_decode_attention_plain",
           "paged_quant_prefill_attention",
           "paged_quant_prefill_attention_plain"]
