"""Paged flash-prefill: a prompt chunk attends its cached prefix through
the block table plus itself causally (counterpart of the float-pool path
of ``nezha_tpu/ops/pallas/prefill_attention.py``).

:func:`paged_prefill_attention` launches the CUDA kernel
``csrc/paged_prefill.cu`` on CUDA tensors and runs
:func:`paged_prefill_attention_plain` on CPU tensors; any other device
raises. ``paged_prefill_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nezha_tpu_torch.ops.attention import masked_scores
from nezha_tpu_torch.ops.cuda import build
from nezha_tpu_torch.ops.cuda.common import (pick_block,
                                             softmax_block_update,
                                             softmax_finalize, softmax_init)

_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_KC_TILE_TARGET = 256   # the TPU kernel's chunk-KV tile


def _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables,
                  starts) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got {tuple(q.shape)}")
    b, h, _, d = q.shape
    if k_chunk.shape != q.shape or v_chunk.shape != q.shape:
        raise ValueError(
            f"chunk k/v {tuple(k_chunk.shape)}/{tuple(v_chunk.shape)} do "
            f"not match q {tuple(q.shape)}")
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 4
            or k_pool.shape[1] != h or k_pool.shape[3] != d):
        raise ValueError(
            f"paged k/v pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
            f"do not match q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} does "
                         f"not match batch {b}")
    if tuple(starts.shape) != (b,):
        raise ValueError(f"starts {tuple(starts.shape)} must be [{b}]")


def paged_prefill_attention_plain(q, k_chunk, v_chunk, k_pool, v_pool,
                                  block_tables, starts,
                                  scale: Optional[float] = None):
    """The kernel's function in tensor ops, folded in the TPU kernel's
    order: the prefix pool blocks (masked to ``[0, start)``, skipped past
    it; q and p cast to the pool dtype), then the chunk's own K/V in
    256-wide tiles, causally (routed through the pool dtype, then to q's
    dtype; p cast to q's dtype)."""
    _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts)
    b, h, s, d = q.shape
    bs = k_pool.shape[2]
    m = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    starts = starts.long().clamp(0, m * bs)
    tab = block_tables.long()
    dev = q.device
    state = softmax_init((b, h, s), d, dev)
    qk = q.to(k_pool.dtype)
    offs = torch.arange(bs, device=dev)
    for t in range(m):
        run = t * bs < starts                                  # [B]
        if not bool(run.any()):
            break
        k = k_pool[tab[:, t]]                                  # [B,H,bs,D]
        v = v_pool[tab[:, t]]
        valid = (t * bs + offs)[None, :] < starts[:, None]     # [B, bs]
        sc = masked_scores(qk, k, valid[:, None, None, :], scale)
        state = softmax_block_update(state, sc, v,
                                     run=run[:, None, None, None])
    kc = k_chunk.to(k_pool.dtype).to(q.dtype)
    vc = v_chunk.to(k_pool.dtype).to(q.dtype)
    qpos = torch.arange(s, device=dev)
    tile = pick_block(s, _KC_TILE_TARGET)
    for j0 in range(0, s, tile):
        kpos = j0 + torch.arange(tile, device=dev)
        causal = kpos[None, :] <= qpos[:, None]                # [S, tile]
        sc = masked_scores(q, kc[:, :, j0:j0 + tile], causal, scale)
        state = softmax_block_update(state, sc, vc[:, :, j0:j0 + tile])
    return softmax_finalize(state, q.dtype)


def _launch(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts,
            scale):
    dev = q.device
    for name, t in (("k_chunk", k_chunk), ("v_chunk", v_chunk),
                    ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("starts", starts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in build.DTYPE_CODES or k_chunk.dtype != q.dtype \
            or v_chunk.dtype != q.dtype:
        raise ValueError(f"q/chunk dtypes {q.dtype}/{k_chunk.dtype}/"
                         f"{v_chunk.dtype} not supported (one of f32, bf16)")
    if k_pool.dtype not in build.DTYPE_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                         f"supported (one of f32, bf16)")
    if starts.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise ValueError("starts and block_tables must be int32")
    for name, t in (("q", q), ("k_chunk", k_chunk), ("v_chunk", v_chunk),
                    ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("starts", starts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, s, d = q.shape
    build.check_head_dim(d)
    build.check_aligned(q=q, k_chunk=k_chunk, v_chunk=v_chunk,
                        k_pool=k_pool, v_pool=v_pool)
    out = torch.empty_like(q)
    fn = build.bind("paged_prefill", "nezha_paged_prefill", _ARGTYPES)
    rc = fn(q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
            starts.data_ptr(), out.data_ptr(), b, h, s, d, k_pool.shape[2],
            block_tables.shape[1], float(scale),
            build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pool.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(rc, "nezha_paged_prefill")
    paged_prefill_attention.launches += 1
    return out


def paged_prefill_attention(q, k_chunk, v_chunk, k_pool, v_pool,
                            block_tables, starts,
                            scale: Optional[float] = None):
    """q/k_chunk/v_chunk ``[B, H, S, D]`` (the chunk's fresh projections),
    pools ``[N, H, bs, D]``, ``block_tables [B, M]`` int32, ``starts [B]``
    int32 -> ``[B, H, S, D]`` in q's dtype.

    Query i of row b sits at position ``starts[b] + i`` and attends the
    cached prefix ``[0, starts[b])`` plus the chunk causally. The pool is
    read only below ``starts[b]``, so the caller's chunk write into the
    pool commutes with this call. CUDA tensors launch
    ``csrc/paged_prefill.cu`` (f32 or bf16, D a multiple of 8 up to
    128); CPU tensors run
    the plain version."""
    _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cuda":
        return _launch(q, k_chunk, v_chunk, k_pool, v_pool, block_tables,
                       starts, scale)
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_chunk, v_chunk, k_pool,
                                             v_pool, block_tables, starts,
                                             scale)
    raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not "
                     f"{q.device}")


paged_prefill_attention.launches = 0
