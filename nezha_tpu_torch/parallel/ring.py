"""Ring attention over the one-process mesh (counterpart of
``nezha_tpu/parallel/ring.py``).

The sequence is sharded: shard r holds the query, key and value rows
``[r * S_loc, (r + 1) * S_loc)``. For ``world`` hops each shard folds
the K/V block it holds into its queries' online-softmax state, then
passes the block to shard ``r + 1`` (:func:`~.mesh.ppermute`). After
``i`` hops shard r holds the block of shard ``(r - i) mod world``; under
``causal`` a block from a later shard is wholly masked and skipped
(:func:`_hop_case`).

Two folds, each over per-shard lists (``qs[r]`` on shard r's device):

- composed (:func:`ring_attention_lse` with ``use_flash=False``, the
  serve prefill's, and :func:`ring_attention`'s ``use_flash=False``):
  scores of each hop in tensor ops, differentiable by autograd;
- flash (``use_flash`` None or True): each hop one call of the flash
  forward kernel B1 (:func:`~nezha_tpu_torch.ops.cuda.flash_attention.
  flash_block_fwd`), causal on the diagonal hop and full on past hops,
  none on future hops; the hops' ``(out, lse)`` merge by ``logaddexp`` in
  fp32 from ``lse = -1e30``. Its backward (:class:`_RingFlash`, JAX's
  ring-level custom VJP) runs the ring again: each hop one
  :func:`~nezha_tpu_torch.ops.cuda.flash_attention.flash_block_bwd` (the
  delta pre-pass, B2 and B3) against the GLOBAL row lse and output, dQ
  summed in fp32 on its shard, dK and dV summed in fp32 and travelling
  with their K/V block, so after ``world`` hops each is home. CUDA
  tensors launch the kernels (or raise); CPU tensors run their plain
  versions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from nezha_tpu_torch.ops.cuda.flash_attention import (flash_block_bwd,
                                                      flash_block_fwd)
from nezha_tpu_torch.parallel.mesh import (Mesh, device_scope, ppermute,
                                           ring_perm)

NEG_BIG = -1e30   # finite "-inf": fully masked rows stay NaN-free


# _hop_case's answers: a future block (skipped), the diagonal block
# (causal within it), a past block or any block of a non-causal ring.
SKIP, DIAGONAL, FULL = 0, 1, 2


def _hop_case(idx: int, src: int, causal: bool) -> int:
    """What shard ``idx`` does with the block of shard ``src``."""
    if not causal:
        return FULL
    return SKIP if src > idx else DIAGONAL if src == idx else FULL


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], causal: bool = True,
                   scale: Optional[float] = None,
                   use_flash: Optional[bool] = None) -> List[torch.Tensor]:
    """Per-shard local blocks ``[B, H, S_loc, D]`` -> per-shard outputs
    ``[B, H, S_loc, D]`` in q's dtype, differentiable: the flash ring
    (:class:`_RingFlash`) unless ``use_flash`` is False, then the
    composed fold under autograd."""
    if use_flash is False:
        return ring_attention_lse(qs, ks, vs, causal, scale)[0]
    return list(_RingFlash.apply(causal, scale, len(qs), *qs, *ks, *vs))


def ring_attention_lse(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                       vs: Sequence[torch.Tensor], causal: bool = True,
                       scale: Optional[float] = None,
                       use_flash: Optional[bool] = False
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-shard local blocks ``[B, H, S_loc, D]`` -> per-shard
    ``(out [B, H, S_loc, D] in q's dtype, lse [B, H, S_loc] fp32)``, the
    log-sum-exp being the merge handle for attention computed elsewhere.
    ``use_flash`` False (the default, the serve prefill's): the composed
    fold, whose dots see the operands' own values with fp32 products and
    sums (``preferred_element_type=float32``), p cast to V's dtype before
    P·V. True or None: the flash hops' forward (no autograd)."""
    if use_flash is not False:
        return _ring_flash_fwd(qs, ks, vs, causal, scale)
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


def _ring_flash_fwd(qs, ks, vs, causal: bool, scale: Optional[float]):
    """The flash ring's forward: -> (outs in q's dtype, fp32 lses)."""
    world = len(qs)
    perm = ring_perm(world)
    os_ = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    lses = [torch.full(q.shape[:3], NEG_BIG, dtype=torch.float32,
                       device=q.device) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for i in range(world):
        for idx in range(world):
            case = _hop_case(idx, (idx - i) % world, causal)
            if case == SKIP:
                continue
            with device_scope(qs[idx].device):
                o_i, lse_i = flash_block_fwd(qs[idx], k_cur[idx], v_cur[idx],
                                             causal=case == DIAGONAL,
                                             scale=scale)
                lse = lses[idx]
                new = torch.logaddexp(lse, lse_i)
                os_[idx] = (os_[idx] * torch.exp(lse - new)[..., None]
                            + o_i.float() * torch.exp(lse_i - new)[..., None])
                lses[idx] = new
        if i < world - 1:   # the last hop's blocks would only go home
            k_cur = ppermute(k_cur, perm, copy=False)
            v_cur = ppermute(v_cur, perm, copy=False)
    return [o.to(q.dtype) for o, q in zip(os_, qs)], lses


class _RingFlash(torch.autograd.Function):
    """``apply(causal, scale, world, *qs, *ks, *vs)`` -> the shards'
    outputs; the residuals are q, k, v (contiguous), the outputs and the
    global lse of every shard."""

    @staticmethod
    def forward(ctx, causal, scale, world, *qkv):
        qkv = [t.contiguous() for t in qkv]
        qs, ks, vs = (qkv[j * world:(j + 1) * world] for j in range(3))
        outs, lses = _ring_flash_fwd(qs, ks, vs, causal, scale)
        ctx.save_for_backward(*qkv, *outs, *lses)
        ctx.causal, ctx.scale, ctx.world = causal, scale, world
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        world, causal, scale = ctx.world, ctx.causal, ctx.scale
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[j * world:(j + 1) * world]
                                  for j in range(5))
        gs = [g.to(o.dtype).contiguous() for g, o in zip(gs, outs)]
        perm = ring_perm(world)
        dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
               for q in qs]
        dk_cur = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
                  for k in ks]
        dv_cur = [torch.zeros_like(d) for d in dk_cur]
        k_cur, v_cur = list(ks), list(vs)
        for i in range(world):
            for idx in range(world):
                case = _hop_case(idx, (idx - i) % world, causal)
                if case == SKIP:
                    continue
                with device_scope(qs[idx].device):
                    dqi, dki, dvi = flash_block_bwd(
                        qs[idx], k_cur[idx], v_cur[idx], outs[idx],
                        lses[idx], gs[idx], causal=case == DIAGONAL,
                        scale=scale)
                    dqs[idx] = dqs[idx] + dqi.float()
                    dk_cur[idx] = dk_cur[idx] + dki.float()
                    dv_cur[idx] = dv_cur[idx] + dvi.float()
            # dK/dV travel with their K/V block: after `world` hops each
            # is back on its own shard.
            dk_cur = ppermute(dk_cur, perm, copy=False)
            dv_cur = ppermute(dv_cur, perm, copy=False)
            if i < world - 1:
                k_cur = ppermute(k_cur, perm, copy=False)
                v_cur = ppermute(v_cur, perm, copy=False)
        return (None, None, None,
                *(d.to(q.dtype) for d, q in zip(dqs, qs)),
                *(d.to(k.dtype) for d, k in zip(dk_cur, ks)),
                *(d.to(v.dtype) for d, v in zip(dv_cur, vs)))


def ring_self_attention(mesh: Mesh, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool = True,
                        use_flash: Optional[bool] = None) -> torch.Tensor:
    """Whole ``[B, H, S, D]`` q, k, v -> the whole output: the sequence
    split over ``mesh``'s shards (each on its device), ring attention,
    the shards' outputs concatenated on q's device."""
    m = mesh.size
    if q.shape[2] % m:
        raise ValueError(f"sequence length {q.shape[2]} not divisible by "
                         f"{mesh.axis_name}={m}")
    split = [[part.to(dev) for part, dev in zip(x.chunk(m, dim=2),
                                                mesh.devices)]
             for x in (q, k, v)]
    outs = ring_attention(*split, causal=causal, use_flash=use_flash)
    return torch.cat([o.to(q.device) for o in outs], dim=2)
