"""Ring attention over the one-process mesh (counterpart of
``nezha_tpu/parallel/ring.py`` ``ring_attention_lse`` with
``use_flash=False``, the composed hop fold).

The sequence is sharded: shard r holds the query, key and value rows
``[r * S_loc, (r + 1) * S_loc)``. For ``world`` hops each shard folds
the K/V block it holds into its queries' online-softmax state, then
passes the block to shard ``r + 1`` (:func:`~.mesh.ppermute`). After
``i`` hops shard r holds the block of shard ``(r - i) mod world``; under
``causal`` a block from a later shard is wholly masked and skipped.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from nezha_tpu_torch.parallel.mesh import ppermute, ring_perm

NEG_BIG = -1e30   # finite "-inf": fully masked rows stay NaN-free


def ring_attention_lse(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                       vs: Sequence[torch.Tensor], causal: bool = True,
                       scale: Optional[float] = None
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-shard local blocks ``[B, H, S_loc, D]`` -> per-shard
    ``(out [B, H, S_loc, D] in q's dtype, lse [B, H, S_loc] fp32)``, the
    log-sum-exp being the merge handle for attention computed elsewhere.
    The dots see the operands' own values with fp32 products and sums
    (``preferred_element_type=float32``); p is cast to V's dtype before
    P·V."""
    world = len(qs)
    b, h, s_loc, d = qs[0].shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    local = torch.arange(s_loc)
    perm = ring_perm(world)
    states = []
    for q in qs:
        dev = q.device
        states.append((torch.full((b, h, s_loc, 1), NEG_BIG,
                                  dtype=torch.float32, device=dev),
                       torch.zeros((b, h, s_loc, 1), dtype=torch.float32,
                                   device=dev),
                       torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                                   device=dev)))
    k_cur, v_cur = list(ks), list(vs)
    for i in range(world):
        for idx in range(world):
            src = (idx - i) % world
            if causal and src > idx:
                continue                 # a block wholly in the future
            q, k, v = qs[idx], k_cur[idx], v_cur[idx]
            m, l, acc = states[idx]
            scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                  k.float()) * scale
            if causal:
                q_pos = (idx * s_loc + local).to(q.device)
                k_pos = (src * s_loc + local).to(q.device)
                allowed = k_pos[None, :] <= q_pos[:, None]
                scores = torch.where(allowed, scores,
                                     torch.full((), NEG_BIG,
                                                device=q.device))
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
            p = torch.exp(scores - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
            states[idx] = (m_new, l, acc)
        k_cur, v_cur = ppermute(k_cur, perm), ppermute(v_cur, perm)
    outs, lses = [], []
    for q, (m, l, acc) in zip(qs, states):
        denom = l.clamp_min(1e-30)
        outs.append((acc / denom).to(q.dtype))
        lses.append((m + torch.log(denom))[..., 0])
    return outs, lses
