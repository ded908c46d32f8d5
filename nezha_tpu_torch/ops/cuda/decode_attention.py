"""Flash-decode: one query token per row against a KV cache (counterpart
of ``nezha_tpu/ops/pallas/decode_attention.py``), in its two layouts:

- paged: :func:`paged_decode_attention` reads a block-paged pool through
  block tables (the serve engine's cache) with ``csrc/paged_decode.cu``,
  or, given ``block_scales``, an int8 pool with
  ``csrc/paged_quant_decode.cu`` (:func:`paged_quant_decode_attention`);
- dense: :func:`flash_decode_attention` reads ``[B, H, L, D]`` caches
  (``models/generate.py``'s) with ``csrc/flash_decode.cu``.

The kernels share one body (``csrc/decode_fold.cuh``). Each wrapper
launches its kernel on CUDA tensors and runs its plain version
(``*_plain``) on CPU tensors; any other device raises. Each counts its
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
from nezha_tpu_torch.ops.quant import dequantize_kv_block

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_DENSE_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_QUANT_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
# The TPU kernel's key block (``_pick_block(L, 256)``): the dense plain
# version folds in the same blocks, so on the CPU it agrees with the
# Pallas kernel to fp32 rounding. The CUDA kernel folds 32-key tiles.
_PLAIN_BLOCK_K = 256
# Largest dynamic shared memory one thread block may opt into on sm_90.
_SMEM_LIMIT = 227 * 1024


def smem_bytes(d: int) -> int:
    """Shared memory of one decode thread block (``decode_smem_bytes`` in
    ``csrc/decode_fold.cuh``): q, each of the 8 warps' fp32 K tile
    ``[32, D+1]`` and V tile ``[32, D]``, and the 8 warps' merge rows."""
    return 4 * (d + 8 * (32 * (d + 1) + 32 * d) + 8 * (d + 2))


def check_head_dim(d: int) -> None:
    """The decode kernel's head dims: those of ``build.check_head_dim``
    whose shared memory fits one block (D <= 104)."""
    build.check_head_dim(d)
    if smem_bytes(d) > _SMEM_LIMIT:
        raise ValueError(f"head dim {d} not supported by the decode kernel "
                         f"({smem_bytes(d)} bytes of shared memory per "
                         f"block, at most {_SMEM_LIMIT})")


def _check_shapes(q, k_pool, v_pool, lengths, block_tables) -> None:
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, H, 1, D], got {tuple(q.shape)}")
    b, h, _, d = q.shape
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 4
            or k_pool.shape[1] != h or k_pool.shape[3] != d):
        raise ValueError(
            f"paged k/v pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
            f"do not match q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} does "
                         f"not match batch {b}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be [{b}]")


def _paged_fold(q, qk, lengths, block_tables, bs: int, tile, scale: float):
    """Fold the row's pool blocks in table order, each masked to ``[0,
    length)`` and skipped once it starts at or past the row's length (the
    TPU kernels' per-row block skip); ``tile(blocks [B])`` -> the blocks'
    K and V ``[B, H, bs, D]`` as the dots see them, ``qk`` is q as it
    enters Q·Kᵀ, and p is cast to V's dtype before P·V."""
    b, h, _, d = q.shape
    m = block_tables.shape[1]
    lengths = lengths.long().clamp(0, m * bs)
    tab = block_tables.long()
    state = softmax_init((b, h, 1), d, q.device)
    offs = torch.arange(bs, device=q.device)
    for t in range(m):
        run = t * bs < lengths                                # [B]
        if not bool(run.any()):
            break      # lengths only shrink the span: no later block runs
        k, v = tile(tab[:, t])                                # [B,H,bs,D]
        valid = (t * bs + offs)[None, :] < lengths[:, None]   # [B, bs]
        s = masked_scores(qk, k, valid[:, None, None, :], scale)
        state = softmax_block_update(state, s, v,
                                     run=run[:, None, None, None])
    return softmax_finalize(state, q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, lengths, block_tables,
                                 scale: Optional[float] = None):
    """The float kernel's function in tensor ops (``_paged_decode_kernel``):
    q is cast to the pool dtype before Q·Kᵀ, p to the pool dtype before
    P·V."""
    _check_shapes(q, k_pool, v_pool, lengths, block_tables)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    return _paged_fold(q, q.to(k_pool.dtype), lengths, block_tables,
                       k_pool.shape[2], lambda i: (k_pool[i], v_pool[i]),
                       scale)


def check_block_scales(k_pool, k_scales, v_scales) -> None:
    """An int8 pool's scales: one per (block, head), ``[N, H]``."""
    want = (k_pool.shape[0], k_pool.shape[1])
    if tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
        raise ValueError(f"block_scales {tuple(k_scales.shape)}/"
                         f"{tuple(v_scales.shape)} must be [num_blocks, H] "
                         f"= {want}")


def paged_quant_decode_attention_plain(q, k_pool, v_pool, k_scales,
                                       v_scales, lengths, block_tables,
                                       scale: Optional[float] = None):
    """The int8 kernel's function in tensor ops
    (``_paged_quant_decode_kernel``): each block dequantized as
    ``(int8 * scale).to(q.dtype)`` (``ops.quant.dequantize_kv_block``),
    the dots in q's dtype, p cast to q's dtype before P·V."""
    _check_shapes(q, k_pool, v_pool, lengths, block_tables)
    check_block_scales(k_pool, k_scales, v_scales)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)

    def tile(i):
        return (dequantize_kv_block(k_pool[i], k_scales[i], q.dtype),
                dequantize_kv_block(v_pool[i], v_scales[i], q.dtype))

    return _paged_fold(q, q, lengths, block_tables, k_pool.shape[2], tile,
                       scale)


def _check_cuda(q, lengths, **kv) -> None:
    """What both kernels take: f32 or bf16 q, K and V of one f32 or bf16
    dtype, int32 lengths, all contiguous and 16-byte aligned on q's
    device, a head dim the decode kernel fits."""
    for name, t in (("lengths", lengths),) + tuple(kv.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    kv_dtypes = {t.dtype for t in kv.values() if t.is_floating_point()}
    if len(kv_dtypes) != 1 or not kv_dtypes <= set(build.DTYPE_CODES):
        raise ValueError(f"k/v dtypes {sorted(map(str, kv_dtypes))} not "
                         f"supported (one of f32, bf16)")
    for name, t in (("q", q), ("lengths", lengths)) + tuple(kv.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not t.is_floating_point() and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    check_head_dim(q.shape[3])
    build.check_aligned(q=q, **{n: t for n, t in kv.items()
                                if t.is_floating_point()})


def _launch(q, k_pool, v_pool, lengths, block_tables, scale):
    _check_cuda(q, lengths, k_pool=k_pool, v_pool=v_pool,
                block_tables=block_tables)
    b, h, _, d = q.shape
    out = torch.empty_like(q)
    fn = build.bind("paged_decode", "nezha_paged_decode", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            b, h, d, k_pool.shape[2], block_tables.shape[1], float(scale),
            build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pool.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(rc, "nezha_paged_decode")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, lengths, block_tables,
                           scale: Optional[float] = None,
                           block_scales=None):
    """q ``[B, H, 1, D]``, pools ``[N, H, bs, D]``, ``lengths [B]`` int32,
    ``block_tables [B, M]`` int32 -> ``[B, H, 1, D]`` in q's dtype.

    Row b's positions ``[ki*bs, (ki+1)*bs)`` live in pool block
    ``block_tables[b, ki]``; ``lengths[b]`` (clamped to ``[0, M*bs]``)
    is how many positions it attends, and 0 marks an inactive row whose
    output is exactly zero. CUDA tensors launch ``csrc/paged_decode.cu``
    (f32 or bf16 q and pools, D a multiple of 8 up to 104); CPU tensors
    run the plain version.

    With ``block_scales=(k_scales, v_scales)`` (``[N, H]`` fp32) the
    pools are int8 and the call is :func:`paged_quant_decode_attention`."""
    if block_scales is not None:
        return paged_quant_decode_attention(q, k_pool, v_pool,
                                            *block_scales, lengths,
                                            block_tables, scale)
    _check_shapes(q, k_pool, v_pool, lengths, block_tables)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cuda":
        return _launch(q, k_pool, v_pool, lengths, block_tables, scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, lengths,
                                            block_tables, scale)
    raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                     f"{q.device}")


paged_decode_attention.launches = 0


def _quant_launch(q, k_pool, v_pool, k_scales, v_scales, lengths,
                  block_tables, scale):
    i8, f32, i32 = torch.int8, torch.float32, torch.int32
    build.check_operands(q, k_pool=(k_pool, i8), v_pool=(v_pool, i8),
                         k_scales=(k_scales, f32), v_scales=(v_scales, f32),
                         lengths=(lengths, i32),
                         block_tables=(block_tables, i32))
    b, h, _, d = q.shape
    check_head_dim(d)
    build.check_head_dim(d, multiple=16)
    build.check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)
    out = torch.empty_like(q)
    fn = build.bind("paged_quant_decode", "nezha_paged_quant_decode",
                    _QUANT_ARGTYPES)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), lengths.data_ptr(),
            block_tables.data_ptr(), out.data_ptr(), b, h, d,
            k_pool.shape[2], block_tables.shape[1], float(scale),
            build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(rc, "nezha_paged_quant_decode")
    paged_quant_decode_attention.launches += 1
    return out


def paged_quant_decode_attention(q, k_pool, v_pool, k_scales, v_scales,
                                 lengths, block_tables,
                                 scale: Optional[float] = None):
    """:func:`paged_decode_attention` over int8 pools ``[N, H, bs, D]``
    with fp32 scales ``[N, H]``, one per (block, head): each position is
    dequantized as ``(int8 * scale).to(q.dtype)`` and the dots run in q's
    dtype. Blocks at or past a row's length load neither data nor scale.
    CUDA tensors launch ``csrc/paged_quant_decode.cu`` (f32 or bf16 q, D a
    multiple of 16 up to 96); CPU tensors run the plain version."""
    _check_shapes(q, k_pool, v_pool, lengths, block_tables)
    check_block_scales(k_pool, k_scales, v_scales)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cuda":
        return _quant_launch(q, k_pool, v_pool, k_scales, v_scales, lengths,
                             block_tables, scale)
    if q.device.type == "cpu":
        return paged_quant_decode_attention_plain(
            q, k_pool, v_pool, k_scales, v_scales, lengths, block_tables,
            scale)
    raise ValueError(f"paged_quant_decode_attention runs on cuda or cpu, "
                     f"not {q.device}")


paged_quant_decode_attention.launches = 0


# ------------------------------------------------------------ dense caches
def _check_dense(q, k, v, lengths) -> None:
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, H, 1, D], got {tuple(q.shape)}")
    b, h, _, d = q.shape
    if (k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (b, h)
            or k.shape[3] != d or k.shape[2] < 1):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be [{b}]")


def flash_decode_attention_plain(q, k, v, lengths,
                                 scale: Optional[float] = None):
    """The dense kernel's function in tensor ops: fold the cache in the
    TPU kernel's blocks (the largest divisor of L up to 256) in order,
    each masked to ``[0, length)`` and skipped once it starts at or past
    the row's length (``_decode_kernel``). q is cast to the cache dtype
    before Q·Kᵀ, p to v's dtype before P·V."""
    _check_dense(q, k, v, lengths)
    b, h, _, d = q.shape
    cap = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    lengths = lengths.long().clamp(0, cap)
    qk = q.to(k.dtype)
    state = softmax_init((b, h, 1), d, q.device)
    bk = pick_block(cap, _PLAIN_BLOCK_K)
    offs = torch.arange(bk, device=q.device)
    for k0 in range(0, cap, bk):
        run = k0 < lengths                                    # [B]
        if not bool(run.any()):
            break      # lengths only shrink the span: no later block runs
        valid = (k0 + offs)[None, :] < lengths[:, None]      # [B, bk]
        s = masked_scores(qk, k[:, :, k0:k0 + bk], valid[:, None, None, :],
                          scale)
        state = softmax_block_update(state, s, v[:, :, k0:k0 + bk],
                                     run=run[:, None, None, None])
    return softmax_finalize(state, q.dtype)


def _dense_launch(q, k, v, lengths, scale):
    _check_cuda(q, lengths, k=k, v=v)
    b, h, _, d = q.shape
    out = torch.empty_like(q)
    fn = build.bind("flash_decode", "nezha_flash_decode", _DENSE_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, k.shape[2], d, float(scale),
            build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(rc, "nezha_flash_decode")
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention(q, k, v, lengths, scale: Optional[float] = None):
    """q ``[B, H, 1, D]``, dense caches k/v ``[B, H, L, D]``, ``lengths
    [B]`` int32 -> ``[B, H, 1, D]`` in q's dtype.

    ``lengths[b]`` (clamped to ``[0, L]``) is how many cache positions
    row b attends — the decode convention ``pos + 1`` — and 0 marks an
    inactive row whose output is exactly zero. CUDA tensors launch
    ``csrc/flash_decode.cu`` (f32 or bf16 q over an f32 or bf16 cache,
    D a multiple of 8 up to 104); CPU tensors run the plain version."""
    _check_dense(q, k, v, lengths)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cuda":
        return _dense_launch(q, k, v, lengths, scale)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, lengths, scale)
    raise ValueError(f"flash_decode_attention runs on cuda or cpu, not "
                     f"{q.device}")


flash_decode_attention.launches = 0
