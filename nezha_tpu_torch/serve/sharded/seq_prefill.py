"""Sequence-sharded prefill: one chunk's attention spread over the mesh
(counterpart of ``nezha_tpu/serve/sharded/seq_prefill.py``).

``prefill_mode="sequence"`` splits each prefill chunk's query rows over
the serve mesh's M shards. Operands keep JAX's contract:

- q/k/v come in the **sequence domain**: shard r holds rows
  ``[r * S/M, (r + 1) * S/M)`` of every head (``[B, H, S/M, D]``);
- pools and scales are per shard in the **head domain** (shard r holds
  heads ``[r * H/M, (r + 1) * H/M)`` of every block);
- ``starts`` is a per-row broadcast of the chunk's scalar offset, one
  copy per shard, as is the block table.

:func:`seq_prefill_attention` writes the chunk into every shard's pools
in place (JAX returns new pools) and returns ``(outs, qerr)``: the
per-shard outputs in the sequence domain and, on int8 pools, the chunk's
largest dequant error per shard (``pmax``-ed; None on float pools). The
kernels run whatever the model's ``attn_impl``, as on the replicated
paged path. Variants:

- ``"ulysses"``: one all-to-all moves the chunk to the head domain, each
  shard runs the replicated computation on its own heads (B9 after the
  float write, B10 with its fused write on int8 pools), and a reverse
  all-to-all restores the sequence domain. Per-head math is untouched,
  so it gives the replicated path's bits;
- ``"ring"`` on float pools ("ring-q"): after the float write, the Q
  blocks circulate for M hops (:func:`~nezha_tpu_torch.parallel.mesh.
  ppermute`); at hop i shard ``idx`` holds the Q block of shard ``src =
  (idx - i) mod M`` and runs the q-offset kernel (B11) on that block's
  own head group with ``q_offsets = starts + src * S/M``, writing the
  result into the out buffer travelling with the block. Each (Q block,
  head group) pair is computed whole by one shard, so the result has the
  replicated kernel's bits per row;
- ``"ring"`` on int8 pools ("ring-KV"; B10 takes no query offsets): the
  composed per-shard write, the chunk's own causal attention by
  :func:`~nezha_tpu_torch.parallel.ring.ring_attention_lse`, then the
  gathered own-head prefix circulated and merged by log-sum-exp. Its
  reduction order differs from the replicated path's: greedy tokens
  agree, bits need not.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from nezha_tpu_torch.models.gpt2 import (_quant_prefill_write,
                                         float_prefill_write)
from nezha_tpu_torch.ops.cuda import paged_prefill_attention
from nezha_tpu_torch.ops.quant import dequantize_kv_block
from nezha_tpu_torch.parallel.mesh import (all_to_all, device_scope, pmax,
                                           ppermute, ring_perm)
from nezha_tpu_torch.parallel.ring import NEG_BIG, ring_attention_lse


def seq_to_heads(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``[B, H, S/M, D]`` per shard -> ``[B, H/M, S, D]``: the ulysses
    move."""
    return all_to_all(xs, split_axis=1, concat_axis=2)


def heads_to_seq(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``[B, H/M, S, D]`` per shard -> ``[B, H, S/M, D]``."""
    return all_to_all(xs, split_axis=2, concat_axis=1)


def check_divisible(s: int, h: int, world: int) -> None:
    if s % world:
        raise ValueError(
            f"sequence-sharded prefill needs the chunk width ({s}) "
            f"divisible by the mesh size ({world}): size prefill buckets "
            f"accordingly (ShardedEngine validates this)")
    if h % world:
        raise ValueError(f"sequence-sharded prefill needs num_heads ({h}) "
                         f"divisible by the mesh size ({world})")


def _dense(pool, tab, scales, dtype, hh: int, d: int) -> torch.Tensor:
    """A row's int8 pool blocks gathered through the table and
    dequantized, as a dense ``[b, hh, L, d]`` view in ``dtype``."""
    g = dequantize_kv_block(pool[tab.long()], scales[tab.long()], dtype)
    b = tab.shape[0]
    return g.permute(0, 2, 1, 3, 4).reshape(b, hh, -1, d)


def seq_prefill_attention(qs, ks, vs, k_pools, v_pools, tables, starts, *,
                          variant: str = "ulysses", block_scales=None,
                          scale: Optional[float] = None):
    """Sequence-sharded paged prefill-chunk attention plus the pool
    write; operands and result as the module docstring sets out."""
    world = len(qs)
    b, h, s_loc, d = qs[0].shape
    check_divisible(s_loc * world, h, world)
    if variant not in ("ulysses", "ring"):
        raise ValueError(f"unknown seq-prefill variant {variant!r}")
    if variant == "ulysses":
        return _ulysses(qs, ks, vs, k_pools, v_pools, tables, starts,
                        block_scales, scale)
    if block_scales is None:
        return _ring_q(qs, ks, vs, k_pools, v_pools, tables, starts, scale)
    return _ring_kv(qs, ks, vs, k_pools, v_pools, tables, starts,
                    block_scales, scale)


def _ulysses(qs, ks, vs, kps, vps, tabs, starts, block_scales, scale):
    """Per shard, the replicated computation on its own head group."""
    qh, kh, vh = seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs)
    outs, qerrs = [], []
    for r in range(len(qs)):
        kp, vp, tab, st = kps[r], vps[r], tabs[r], starts[r]
        with device_scope(kp.device):
            if block_scales is not None:
                out, qerr = paged_prefill_attention(
                    qh[r], kh[r], vh[r], kp, vp, tab, st, scale=scale,
                    block_scales=(block_scales[0][r], block_scales[1][r]))
                qerrs.append(qerr)
            else:
                float_prefill_write(kp, vp, tab, st[0].long(), kh[r], vh[r])
                out = paged_prefill_attention(qh[r], kh[r], vh[r], kp, vp,
                                              tab, st, scale=scale)
            outs.append(out)
    return heads_to_seq(outs), (pmax(qerrs) if qerrs else None)


def _ring_q(qs, ks, vs, kps, vps, tabs, starts, scale):
    """Float pools: Q blocks circulate, B11 per hop."""
    world = len(qs)
    b, h, s_loc, d = qs[0].shape
    hh = h // world
    kh, vh = seq_to_heads(ks), seq_to_heads(vs)
    for r in range(world):
        float_prefill_write(kps[r], vps[r], tabs[r], starts[r][0].long(),
                            kh[r], vh[r])
    perm = ring_perm(world)
    q_cur, o_cur = list(qs), [torch.zeros_like(q) for q in qs]
    for i in range(world):
        for idx in range(world):
            src = (idx - i) % world
            heads = slice(idx * hh, (idx + 1) * hh)
            st = starts[idx]
            with device_scope(q_cur[idx].device):
                o_cur[idx][:, heads] = paged_prefill_attention(
                    q_cur[idx][:, heads].contiguous(), kh[idx], vh[idx],
                    kps[idx], vps[idx], tabs[idx], st, scale=scale,
                    q_offsets=st + src * s_loc)
        # Every shard takes part in every hop, the last one included: the
        # blocks end back at their owners.
        q_cur, o_cur = ppermute(q_cur, perm), ppermute(o_cur, perm)
    return o_cur, None


def _ring_kv(qs, ks, vs, kps, vps, tabs, starts, block_scales, scale):
    """int8 pools: the write, the chunk's own ring attention over the
    fresh operands, the own-head prefix circulated, a log-sum-exp
    merge."""
    world = len(qs)
    b, h, s_loc, d = qs[0].shape
    hh = h // world
    s = s_loc * world
    kh, vh = seq_to_heads(ks), seq_to_heads(vs)
    kd, vd, qerrs = [], [], []
    for r in range(world):
        kp, vp, tab = kps[r], vps[r], tabs[r]
        pos = starts[r][0].long()
        sc = (block_scales[0][r], block_scales[1][r])
        qerrs.append(torch.maximum(
            _quant_prefill_write(kp, sc[0], tab, pos, kh[r], s),
            _quant_prefill_write(vp, sc[1], tab, pos, vh[r], s)))
        # The own-head dense prefix view: the block that circulates.
        kd.append(_dense(kp, tab, sc[0], qs[r].dtype, hh, d))
        vd.append(_dense(vp, tab, sc[1], qs[r].dtype, hh, d))
    out_c, lse_c = ring_attention_lse(qs, ks, vs, causal=True, scale=scale)
    sc_ = scale if scale is not None else 1.0 / (d ** 0.5)
    perm = ring_perm(world)
    state = []
    for q in qs:
        dev = q.device
        state.append([torch.full((b, h, s_loc, 1), NEG_BIG, device=dev),
                      torch.zeros((b, h, s_loc, 1), device=dev),
                      torch.zeros((b, h, s_loc, d), device=dev)])
    for i in range(world):
        for idx in range(world):
            # After i hops the resident block covers head group src.
            src = (idx - i) % world
            grp = slice(src * hh, (src + 1) * hh)
            q_h = qs[idx][:, grp]
            dev = q_h.device
            scores = torch.einsum("bhqd,bhkd->bhqk", q_h.float(),
                                  kd[idx].float()) * sc_
            kpos = torch.arange(kd[idx].shape[2], device=dev)
            attendable = (kpos[None, :] < starts[idx].long()[:, None]
                          )[:, None, None, :]
            scores = torch.where(attendable, scores,
                                 torch.full((), NEG_BIG, device=dev))
            m_src = scores.amax(dim=-1, keepdim=True)
            # Masked lanes zero explicitly: an empty prefix would see
            # exp(NEG_BIG - NEG_BIG) = 1 per lane otherwise.
            p = torch.where(attendable, torch.exp(scores - m_src), 0.0)
            st = state[idx]
            st[0][:, grp] = m_src
            st[1][:, grp] = p.sum(dim=-1, keepdim=True)
            st[2][:, grp] = torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vd[idx].dtype).float(),
                vd[idx].float())
        kd, vd = ppermute(kd, perm), ppermute(vd, perm)
    outs = []
    for (mx, l, acc), oc, lc, q in zip(state, out_c, lse_c, qs):
        denom = l.clamp_min(1e-30)
        out_p = acc / denom
        lse_p = (mx + torch.log(denom))[..., 0]
        # An empty prefix carries lse_p ~ -1e30: its weight is exactly 0.
        lse_t = torch.logaddexp(lse_p, lc)
        w_p = torch.exp(lse_p - lse_t)[..., None]
        w_c = torch.exp(lc - lse_t)[..., None]
        outs.append((out_p * w_p + oc.float() * w_c).to(q.dtype))
    return outs, pmax(qerrs)
