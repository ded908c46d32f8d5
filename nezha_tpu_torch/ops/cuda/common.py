"""The online-softmax fold in plain PyTorch, shared by the attention
kernels' plain versions — the tensor-op twin of
``csrc/online_softmax.cuh`` and the counterpart of
``nezha_tpu/ops/pallas/common.py``.

A state is ``(m, l, acc)``: running row max and denominator ``[..., 1]``
and the fp32 accumulator ``[..., D]``. The plain versions fold block by
block in the order the TPU kernels do, so they round ``p`` against the
same running max and agree with the Pallas kernels to fp32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nezha_tpu_torch.ops.attention import NEG_BIG

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pick_block(size: int, target: int) -> int:
    """Largest divisor of ``size`` that is <= ``target``."""
    b = min(size, target)
    while size % b:
        b -= 1
    return b


def softmax_init(rows_shape, d: int, device) -> State:
    m = torch.full((*rows_shape, 1), NEG_BIG, dtype=torch.float32,
                   device=device)
    l = torch.zeros((*rows_shape, 1), dtype=torch.float32, device=device)
    acc = torch.zeros((*rows_shape, d), dtype=torch.float32, device=device)
    return m, l, acc


def softmax_block_update(state: State, s: torch.Tensor, v: torch.Tensor,
                         run: torch.Tensor = None) -> State:
    """Fold masked scores ``s [..., rows, keys]`` (fp32, masked entries at
    ``NEG_BIG``) and values ``v [..., keys, D]``; ``p`` is cast to ``v``'s
    dtype before P·V, as the TPU kernel does. ``run`` (broadcastable to
    ``[..., rows, 1]``) keeps the old state where False — the kernels'
    per-row block skip."""
    m, l, acc = state
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = corr * l + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.matmul(p.to(v.dtype).float(), v.float())
    if run is None:
        return m_new, l_new, acc_new
    return (torch.where(run, m_new, m), torch.where(run, l_new, l),
            torch.where(run, acc_new, acc))


def softmax_finalize(state: State, dtype: torch.dtype) -> torch.Tensor:
    """``acc / max(l, 1e-30)``: a row that folded nothing is exact zero."""
    _, l, acc = state
    return (acc / l.clamp_min(1e-30)).to(dtype)


def softmax_finalize_lse(state: State, dtype: torch.dtype
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`softmax_finalize` plus the per-row fp32 logsumexp
    ``m + log(max(l, 1e-30))`` ``[...]`` the training forward emits for
    the backward (``common.py:81-83``)."""
    m, l, acc = state
    denom = l.clamp_min(1e-30)
    return (acc / denom).to(dtype), (m + torch.log(denom))[..., 0]


BF16_UNIT_ROUNDOFF = 2.0 ** -8   # half a bf16 ulp, relative (8-bit significand)


def fold_error_bound(want: torch.Tensor, want_abs_v: torch.Tensor,
                     p_bf16: bool) -> torch.Tensor:
    """Elementwise bound on ``|kernel - plain|`` for one attention output.

    ``want`` is the plain version's output and ``want_abs_v`` the plain
    version run on ``|v|`` in place of ``v``: ``sum_j p_j |v_j| / l`` per
    element. The two fold in different orders (32-key tiles and warp
    splits against pool blocks), so:

    - when ``p`` is rounded to bf16 before P·V (``p_bf16``), each weight
      carries a relative error of at most the unit roundoff 2^-8, taken
      against different running maxima on each side: together at most
      ``2 * 2^-8 * sum_j p_j |v_j| / l``;
    - a bf16 output rounds once on each side: at most ``2 * 2^-8 * |out|``;
    - fp32 arithmetic in a different order: 1e-5.

    The bound follows each row's weighted ``|v|`` and ``|out|``, not
    ``max |v|``, so it stays tight on long rows whose outputs are small."""
    bound = torch.full(want.shape, 1e-5, dtype=torch.float32,
                       device=want.device)
    if p_bf16:
        bound += 2 * BF16_UNIT_ROUNDOFF * want_abs_v.float()
    if want.dtype == torch.bfloat16:
        bound += 2 * BF16_UNIT_ROUNDOFF * want.float().abs()
    return bound
