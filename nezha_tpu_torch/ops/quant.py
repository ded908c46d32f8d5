"""Symmetric int8 quantization (counterpart of ``nezha_tpu/ops/quant.py``).

One policy, two layouts:

- :func:`quantize_blocks` / :func:`dequantize` — last-axis blocking
  (``[..., k*block] -> int8 [..., k, block] + fp32 scales [..., k, 1]``),
  the wire layout int8 block export/install and the quantized collectives
  carry;
- :func:`quantize_kv_block` / :func:`dequantize_kv_block` — trailing
  ``[..., bs, D]`` tiles with one scale per leading index: one scale per
  (block, head) of a ``[N, H, bs, D]`` KV pool (``ServeConfig.kv_dtype=
  "int8"``). This path sanitizes first, so a NaN/inf burst saturates
  deterministically instead of poisoning a block's scale.

Policy: ``q = clip(round(x / scale), -127, 127)`` with ``scale = amax /
127`` (1.0 for an all-zero block); round half to even and true fp32
division, never a multiply by a reciprocal, so every result is bitwise
equal to the JAX package's functions run eagerly. (Under ``jax.jit``,
XLA rewrites ``amax / 127`` into ``amax * (1/127)``, which moves the last
bit of about one scale in twenty; the port keeps the division the source
writes.) ``csrc/kv_quant.cuh`` applies the same policy on the card.
"""

from __future__ import annotations

import torch

QMAX = 127.0

# The ±inf saturation value, below the float32 maximum: the scale
# ``amax / 127`` may round up, and ``127 * scale`` of a block whose amax
# were the float32 maximum would overflow to inf.
SATURATE_MAX = 3.0e38


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """absmax -> fp32 scale, with the zero guard. The divisor is a tensor
    of amax's shape: PyTorch divides by a Python scalar (on the card; and
    on the CPU for bf16) as a multiply by its reciprocal, which can round
    the other way."""
    return torch.where(amax > 0, amax / torch.full_like(amax, QMAX),
                       1.0).float()


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)


# ------------------------------------------------------- wire layout
def quantize_blocks(x: torch.Tensor, block: int):
    """Per-block int8 quantization of ``x [..., k*block]`` -> ``(int8
    [..., k, block], fp32 scales [..., k, 1])``."""
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // block, block)
    scale = _scale_of(xb.abs().amax(dim=-1, keepdim=True))
    return _quantize(xb, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 + broadcastable fp32 scales -> fp32."""
    return q.float() * scale


# --------------------------------------------------------- KV layout
def sanitize(x: torch.Tensor) -> torch.Tensor:
    """Quantizer input in fp32 with ``NaN -> 0`` and ``±inf ->
    ±SATURATE_MAX``, so one non-finite element cannot make a block's
    scale NaN."""
    return torch.nan_to_num(x.float(), nan=0.0, posinf=SATURATE_MAX,
                            neginf=-SATURATE_MAX)


def quantize_kv_block(x: torch.Tensor):
    """Quantize trailing ``[..., bs, D]`` tiles with one absmax scale per
    leading index: ``x`` (any float dtype) -> ``(int8 [..., bs, D], fp32
    scales [...])``. Inputs are sanitized first."""
    xf = sanitize(x)
    scale = _scale_of(xf.abs().amax(dim=(-2, -1)))
    return _quantize(xf, scale[..., None, None]), scale


def dequantize_kv_block(q: torch.Tensor, scale: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``int8 [..., bs, D]`` + ``fp32 scales [...]`` -> ``dtype``: the
    dequant both int8 attention kernels apply to their tiles."""
    return (q.float() * scale[..., None, None]).to(dtype)


def kv_roundtrip_error(x: torch.Tensor) -> torch.Tensor:
    """Max-abs error of one KV-block quantization round trip of ``x
    [..., bs, D]`` -> fp32 scalar; at most ``amax / 254`` per block for
    finite inputs."""
    q, s = quantize_kv_block(x)
    return (sanitize(x) - dequantize_kv_block(q, s)).abs().max()
