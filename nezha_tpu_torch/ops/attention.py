"""Scaled dot-product attention composed of tensor ops (counterpart of
``nezha_tpu/ops/attention.py``).

This is the plain reference the model's no-cache causal forward runs,
and the scoring step the kernels' plain versions share
(:func:`masked_scores`). Softmax statistics are fp32 whatever the input
dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

# The finite "-inf" of the Pallas kernels (ops/pallas/common.py): a row
# whose every score is masked stays NaN-free.
NEG_BIG = -1e30


def causal_mask(q_len: int, kv_len: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive mask: 0 where attendable, -inf above the diagonal (q may
    be a suffix of kv)."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    offset = kv_len - q_len
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(j <= i + offset, zero,
                       torch.full((), float("-inf"), dtype=dtype,
                                  device=device))


def make_attention_mask(padding_mask: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` bool (True = a real token) -> ``[B, 1, 1, S]`` additive
    fp32 mask: 0 where attendable, -inf at padding."""
    m = torch.where(padding_mask.bool(), 0.0, float("-inf"))
    return m.float()[:, None, None, :]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v ``[B, H, S, D]``; ``mask`` additive, broadcastable to
    ``[B, H, Sq, Sk]``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if mask is not None:
        scores = scores + mask
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def masked_scores(q: torch.Tensor, k: torch.Tensor, valid: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """fp32 scores ``q . k^T * scale`` with invalid entries at ``NEG_BIG``
    — one Q·Kᵀ step of the kernels' online softmax. ``q [..., Sq, D]`` and
    ``k [..., Sk, D]`` arrive already in the dtype the dot runs in;
    ``valid`` broadcasts to ``[..., Sq, Sk]``."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    return torch.where(valid, s, torch.full((), NEG_BIG, device=s.device))
