"""Paged flash-prefill: a prompt chunk attends its cached prefix through
the block table plus itself causally (counterpart of
``nezha_tpu/ops/pallas/prefill_attention.py``), over a float pool or,
with the chunk's block write fused in, an int8 one.

:func:`paged_prefill_attention` launches the CUDA kernel
``csrc/paged_prefill.cu`` on CUDA tensors and runs
:func:`paged_prefill_attention_plain` on CPU tensors; any other device
raises. Given ``block_scales`` it is :func:`paged_quant_prefill_attention`
(``csrc/quant_prefill.cu``, plain version
:func:`paged_quant_prefill_attention_plain`); given ``q_offsets`` it is
:func:`paged_prefill_qoff_attention` (the q-offset form of
``csrc/paged_prefill.cu``, plain version
:func:`paged_prefill_qoff_attention_plain`). Each wrapper counts its
kernel launches in ``<wrapper>.launches``.
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
from nezha_tpu_torch.ops.cuda.decode_attention import check_block_scales
from nezha_tpu_torch.ops.quant import dequantize_kv_block

_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_QUANT_ARGTYPES = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_QOFF_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_KC_TILE_TARGET = 256   # the TPU kernel's chunk-KV tile


def _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables,
                  starts, q_offsets=None) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got {tuple(q.shape)}")
    b, h, _, d = q.shape
    if q_offsets is not None:
        # The chunk may hold more rows than q (S_kc != S_q).
        if (k_chunk.dim() != 4 or k_chunk.shape[:2] != q.shape[:2]
                or k_chunk.shape[3] != d or v_chunk.shape != k_chunk.shape):
            raise ValueError(
                f"chunk k/v {tuple(k_chunk.shape)}/{tuple(v_chunk.shape)} "
                f"do not match q {tuple(q.shape)} on (B, H, D)")
        if tuple(q_offsets.shape) != (b,):
            raise ValueError(
                f"q_offsets {tuple(q_offsets.shape)} must be [{b}]")
    elif k_chunk.shape != q.shape or v_chunk.shape != q.shape:
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


def _prefill_fold(q, qk, kc, vc, block_tables, starts, bs: int, tile,
                  scale: float, q_offsets=None):
    """Fold in the TPU kernel's order: the prefix pool blocks (masked to
    ``[0, start)``, skipped past it; ``tile(blocks [B])`` -> their K and V
    as the dots see them, ``qk`` is q as it enters the prefix Q·Kᵀ), then
    the chunk's own ``kc``/``vc`` in 256-wide tiles, causally: query i of
    row b at chunk-local position ``i + q_offsets[b] - starts[b]`` (``i``
    without ``q_offsets``). A tile wholly past a row's diagonal leaves
    its state as it was. p is cast to V's dtype before each P·V."""
    b, h, s, d = q.shape
    m = block_tables.shape[1]
    raw_starts = starts
    starts = starts.long().clamp(0, m * bs)
    tab = block_tables.long()
    dev = q.device
    state = softmax_init((b, h, s), d, dev)
    offs = torch.arange(bs, device=dev)
    for t in range(m):
        run = t * bs < starts                                  # [B]
        if not bool(run.any()):
            break
        k, v = tile(tab[:, t])                                 # [B,H,bs,D]
        valid = (t * bs + offs)[None, :] < starts[:, None]     # [B, bs]
        sc = masked_scores(qk, k, valid[:, None, None, :], scale)
        state = softmax_block_update(state, sc, v,
                                     run=run[:, None, None, None])
    qpos = torch.arange(s, device=dev)
    if q_offsets is not None:
        qoff = q_offsets.long() - raw_starts.long()             # [B]
        qpos = (qoff[:, None] + qpos[None, :])[:, None, :, None]
    else:
        qpos = qpos[:, None]                                   # [S, 1]
    s_kc = kc.shape[2]
    width = pick_block(s_kc, _KC_TILE_TARGET)
    for j0 in range(0, s_kc, width):
        kpos = j0 + torch.arange(width, device=dev)
        causal = kpos <= qpos                          # [S, w] / [B,1,S,w]
        sc = masked_scores(q, kc[:, :, j0:j0 + width], causal, scale)
        state = softmax_block_update(state, sc, vc[:, :, j0:j0 + width])
    return softmax_finalize(state, q.dtype)


def paged_prefill_attention_plain(q, k_chunk, v_chunk, k_pool, v_pool,
                                  block_tables, starts,
                                  scale: Optional[float] = None):
    """The float kernel's function in tensor ops (``_prefill_kernel``):
    in the prefix q and p are cast to the pool dtype; the chunk's K/V are
    routed through the pool dtype, then to q's dtype, and p is cast to
    q's dtype."""
    _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    return _float_fold(q, k_chunk, v_chunk, k_pool, v_pool, block_tables,
                       starts, scale)


def _float_fold(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts,
                scale, q_offsets=None):
    kc = k_chunk.to(k_pool.dtype).to(q.dtype)
    vc = v_chunk.to(k_pool.dtype).to(q.dtype)
    return _prefill_fold(q, q.to(k_pool.dtype), kc, vc, block_tables,
                         starts, k_pool.shape[2],
                         lambda i: (k_pool[i], v_pool[i]), scale, q_offsets)


def paged_prefill_qoff_attention_plain(q, k_chunk, v_chunk, k_pool, v_pool,
                                       block_tables, starts, q_offsets,
                                       scale: Optional[float] = None):
    """The q-offset kernel's function in tensor ops
    (``_prefill_qoff_kernel``): :func:`paged_prefill_attention_plain`
    with query i of row b at absolute position ``q_offsets[b] + i``."""
    _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts,
                  q_offsets)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    return _float_fold(q, k_chunk, v_chunk, k_pool, v_pool, block_tables,
                       starts, scale, q_offsets)


def paged_quant_prefill_attention_plain(q, k_chunk, v_chunk, k_pool, v_pool,
                                        k_scales, v_scales, block_tables,
                                        starts,
                                        scale: Optional[float] = None):
    """The int8 kernel's function in tensor ops (``_quant_prefill_kernel``)
    -> ``(out, qerr)``, the pools and scales updated in place. First the
    attention: prefix blocks dequantized as ``(int8 * scale).to(q.dtype)``
    and the chunk's K/V as they are, every dot in q's dtype. Then, per
    row, the block write of ``models/gpt2._quant_prefill_write`` for K and
    V; ``qerr`` is the largest of their errors."""
    from nezha_tpu_torch.models.gpt2 import _quant_prefill_write

    _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts)
    check_block_scales(k_pool, k_scales, v_scales)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)

    def tile(i):
        return (dequantize_kv_block(k_pool[i], k_scales[i], q.dtype),
                dequantize_kv_block(v_pool[i], v_scales[i], q.dtype))

    out = _prefill_fold(q, q, k_chunk.to(q.dtype), v_chunk.to(q.dtype),
                        block_tables, starts, k_pool.shape[2], tile, scale)
    s = q.shape[2]
    errs = []
    for r in range(q.shape[0]):     # rows never share a touched block
        tab, pos = block_tables[r:r + 1].long(), int(starts[r])
        errs += [_quant_prefill_write(k_pool, k_scales, tab, pos,
                                      k_chunk[r:r + 1], s),
                 _quant_prefill_write(v_pool, v_scales, tab, pos,
                                      v_chunk[r:r + 1], s)]
    return out, torch.stack(errs).max()


def _launch(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts,
            scale, q_offsets=None):
    """B9, or B11 given ``q_offsets``: the two instantiations of
    ``csrc/paged_prefill.cu``."""
    dev = q.device
    ints = (("block_tables", block_tables), ("starts", starts))
    if q_offsets is not None:
        ints += (("q_offsets", q_offsets),)
    for name, t in (("k_chunk", k_chunk), ("v_chunk", v_chunk),
                    ("k_pool", k_pool), ("v_pool", v_pool)) + ints:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in build.DTYPE_CODES or k_chunk.dtype != q.dtype \
            or v_chunk.dtype != q.dtype:
        raise ValueError(f"q/chunk dtypes {q.dtype}/{k_chunk.dtype}/"
                         f"{v_chunk.dtype} not supported (one of f32, bf16)")
    if k_pool.dtype not in build.DTYPE_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                         f"supported (one of f32, bf16)")
    if any(t.dtype != torch.int32 for _, t in ints):
        raise ValueError(f"{', '.join(n for n, _ in ints)} must be int32")
    for name, t in (("q", q), ("k_chunk", k_chunk), ("v_chunk", v_chunk),
                    ("k_pool", k_pool), ("v_pool", v_pool)) + ints:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, s, d = q.shape
    build.check_head_dim(d)
    build.check_aligned(q=q, k_chunk=k_chunk, v_chunk=v_chunk,
                        k_pool=k_pool, v_pool=v_pool)
    out = torch.empty_like(q)
    tail = (block_tables.shape[1], float(scale), build.DTYPE_CODES[q.dtype],
            build.DTYPE_CODES[k_pool.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    ptrs = (q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
            starts.data_ptr())
    if q_offsets is None:
        symbol = "nezha_paged_prefill"
        fn = build.bind("paged_prefill", symbol, _ARGTYPES)
        rc = fn(*ptrs, out.data_ptr(), b, h, s, d, k_pool.shape[2], *tail)
    else:
        symbol = "nezha_paged_prefill_qoff"
        fn = build.bind("paged_prefill", symbol, _QOFF_ARGTYPES)
        rc = fn(*ptrs, q_offsets.data_ptr(), out.data_ptr(), b, h, s,
                k_chunk.shape[2], d, k_pool.shape[2], *tail)
    build.check_launch(rc, symbol)
    if q_offsets is None:
        paged_prefill_attention.launches += 1
    else:
        paged_prefill_qoff_attention.launches += 1
    return out


def paged_prefill_attention(q, k_chunk, v_chunk, k_pool, v_pool,
                            block_tables, starts,
                            scale: Optional[float] = None,
                            block_scales=None, q_offsets=None):
    """q/k_chunk/v_chunk ``[B, H, S, D]`` (the chunk's fresh projections),
    pools ``[N, H, bs, D]``, ``block_tables [B, M]`` int32, ``starts [B]``
    int32 -> ``[B, H, S, D]`` in q's dtype.

    Query i of row b sits at position ``starts[b] + i`` and attends the
    cached prefix ``[0, starts[b])`` plus the chunk causally. The pool is
    read only below ``starts[b]``, so the caller's chunk write into the
    pool commutes with this call. CUDA tensors launch
    ``csrc/paged_prefill.cu`` (f32 or bf16, D a multiple of 8 up to
    128); CPU tensors run
    the plain version.

    With ``block_scales=(k_scales, v_scales)`` (``[N, H]`` fp32) the pools
    are int8 and the call is :func:`paged_quant_prefill_attention`, which
    also writes the chunk and returns ``(out, qerr)``.

    With ``q_offsets [B]`` int32 (float pools only) the call is
    :func:`paged_prefill_qoff_attention`: query i of row b sits at
    ``q_offsets[b] + i`` and q may hold fewer rows than the chunk."""
    if q_offsets is not None:
        if block_scales is not None:
            raise ValueError(
                "q_offsets is a read-layout feature of the float path; "
                "int8 pools fuse the block write and need the full "
                "chunk's queries resident (use the per-shard fused write "
                "on head-resharded operands instead)")
        return paged_prefill_qoff_attention(q, k_chunk, v_chunk, k_pool,
                                            v_pool, block_tables, starts,
                                            q_offsets, scale)
    if block_scales is not None:
        return paged_quant_prefill_attention(q, k_chunk, v_chunk, k_pool,
                                             v_pool, *block_scales,
                                             block_tables, starts, scale)
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


def paged_prefill_qoff_attention(q, k_chunk, v_chunk, k_pool, v_pool,
                                 block_tables, starts, q_offsets,
                                 scale: Optional[float] = None):
    """:func:`paged_prefill_attention` with per-row query offsets: q
    ``[B, H, S_q, D]``, the chunk's fresh ``k_chunk``/``v_chunk``
    ``[B, H, S_kc, D]`` at ``[starts[b], starts[b] + S_kc)``, and query i
    of row b at absolute position ``q_offsets[b] + i``; it attends the
    prefix ``[0, starts[b])`` and the chunk keys at or before it. Needs
    ``starts[b] <= q_offsets[b]`` (no query precedes the prefix
    boundary). A sequence shard's slice of a chunk's queries against the
    full chunk: each row gets the bits the full chunk's call gives the
    same query. CUDA tensors launch the q-offset form of
    ``csrc/paged_prefill.cu``; CPU tensors run the plain version."""
    _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts,
                  q_offsets)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cuda":
        return _launch(q, k_chunk, v_chunk, k_pool, v_pool, block_tables,
                       starts, scale, q_offsets)
    if q.device.type == "cpu":
        return paged_prefill_qoff_attention_plain(
            q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts,
            q_offsets, scale)
    raise ValueError(f"paged_prefill_qoff_attention runs on cuda or cpu, "
                     f"not {q.device}")


paged_prefill_qoff_attention.launches = 0


def _quant_launch(q, k_chunk, v_chunk, k_pool, v_pool, k_scales, v_scales,
                  block_tables, starts, scale):
    i8, f32, i32 = torch.int8, torch.float32, torch.int32
    build.check_operands(q, k_chunk=(k_chunk, q.dtype),
                         v_chunk=(v_chunk, q.dtype), k_pool=(k_pool, i8),
                         v_pool=(v_pool, i8), k_scales=(k_scales, f32),
                         v_scales=(v_scales, f32),
                         block_tables=(block_tables, i32),
                         starts=(starts, i32))
    b, h, s, d = q.shape
    dev = q.device
    build.check_head_dim(d, multiple=16)
    build.check_aligned(q=q, k_chunk=k_chunk, v_chunk=v_chunk,
                        k_pool=k_pool, v_pool=v_pool)
    out = torch.empty_like(q)
    qerr = torch.empty((), dtype=torch.float32, device=dev)
    fn = build.bind("quant_prefill", "nezha_quant_prefill", _QUANT_ARGTYPES)
    rc = fn(q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), starts.data_ptr(),
            out.data_ptr(), qerr.data_ptr(), b, h, s, d, k_pool.shape[2],
            block_tables.shape[1], float(scale), build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(rc, "nezha_quant_prefill")
    paged_quant_prefill_attention.launches += 1
    return out, qerr


def paged_quant_prefill_attention(q, k_chunk, v_chunk, k_pool, v_pool,
                                  k_scales, v_scales, block_tables, starts,
                                  scale: Optional[float] = None):
    """:func:`paged_prefill_attention` over int8 pools ``[N, H, bs, D]``
    with fp32 scales ``[N, H]``, with the chunk's block write fused in ->
    ``(out, qerr)``.

    The prefix is dequantized as ``(int8 * scale).to(q.dtype)`` and the
    chunk's K/V attended as they are, every dot in q's dtype. Then every
    block the chunk touches (``[start // bs, (start + S - 1) // bs]``)
    is rewritten with a fresh per-(block, head) scale: its old content
    below ``start``, the chunk's values (pads of a bucketed chunk
    included), zeros after them, quantized by ``ops.quant``'s policy. The
    pools and scales are updated IN PLACE (JAX returns them as aliased
    outputs); ``qerr`` is a device scalar: the largest ``|merged -
    dequantized|`` over the written positions, the old ones included.
    Rows of one call must not share touched blocks (the serve engine
    prefills one row per call); prefix blocks are only read and may be
    shared. Scratch block 0 is not written. CUDA tensors launch
    ``csrc/quant_prefill.cu`` (f32 or bf16 q, D a multiple of 16 up to
    128); CPU tensors run the plain version."""
    _check_shapes(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts)
    check_block_scales(k_pool, k_scales, v_scales)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cuda":
        return _quant_launch(q, k_chunk, v_chunk, k_pool, v_pool, k_scales,
                             v_scales, block_tables, starts, scale)
    if q.device.type == "cpu":
        return paged_quant_prefill_attention_plain(
            q, k_chunk, v_chunk, k_pool, v_pool, k_scales, v_scales,
            block_tables, starts, scale)
    raise ValueError(f"paged_quant_prefill_attention runs on cuda or cpu, "
                     f"not {q.device}")


paged_quant_prefill_attention.launches = 0
