"""Paged flash-decode: one query token per row against a block-paged KV
pool (counterpart of the paged path of
``nezha_tpu/ops/pallas/decode_attention.py``).

:func:`paged_decode_attention` launches the CUDA kernel
``csrc/paged_decode.cu`` on CUDA tensors and runs
:func:`paged_decode_attention_plain` on CPU tensors; any other device
raises. ``paged_decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nezha_tpu_torch.ops.attention import masked_scores
from nezha_tpu_torch.ops.cuda import build
from nezha_tpu_torch.ops.cuda.common import (softmax_block_update,
                                             softmax_finalize, softmax_init)

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# Largest dynamic shared memory one thread block may opt into on sm_90.
_SMEM_LIMIT = 227 * 1024


def smem_bytes(d: int) -> int:
    """Shared memory of one decode thread block (``launch`` in
    ``csrc/paged_decode.cu``): q, each of the 8 warps' fp32 K tile
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


def paged_decode_attention_plain(q, k_pool, v_pool, lengths, block_tables,
                                 scale: Optional[float] = None):
    """The kernel's function in tensor ops: fold the row's pool blocks in
    table order, each masked to ``[0, length)`` and skipped once it starts
    at or past the row's length (``_paged_decode_kernel``). q is cast to the
    pool dtype before Q·Kᵀ, p to the pool dtype before P·V."""
    _check_shapes(q, k_pool, v_pool, lengths, block_tables)
    b, h, _, d = q.shape
    bs = k_pool.shape[2]
    m = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    lengths = lengths.long().clamp(0, m * bs)
    tab = block_tables.long()
    qk = q.to(k_pool.dtype)                                  # [B,H,1,D]
    state = softmax_init((b, h, 1), d, q.device)
    offs = torch.arange(bs, device=q.device)
    for t in range(m):
        run = t * bs < lengths                                # [B]
        if not bool(run.any()):
            break      # lengths only shrink the span: no later block runs
        k = k_pool[tab[:, t]]                                 # [B,H,bs,D]
        v = v_pool[tab[:, t]]
        valid = (t * bs + offs)[None, :] < lengths[:, None]   # [B, bs]
        s = masked_scores(qk, k, valid[:, None, None, :], scale)
        state = softmax_block_update(state, s, v,
                                     run=run[:, None, None, None])
    return softmax_finalize(state, q.dtype)


def _launch(q, k_pool, v_pool, lengths, block_tables, scale):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("lengths", lengths), ("block_tables", block_tables)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k_pool.dtype not in build.DTYPE_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                         f"supported (one of f32, bf16)")
    if lengths.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise ValueError("lengths and block_tables must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("lengths", lengths), ("block_tables", block_tables)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, _, d = q.shape
    check_head_dim(d)
    build.check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)
    out = torch.empty_like(q)
    fn = build.bind("paged_decode", "nezha_paged_decode", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            b, h, d, k_pool.shape[2], block_tables.shape[1], float(scale),
            build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pool.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(rc, "nezha_paged_decode")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, lengths, block_tables,
                           scale: Optional[float] = None):
    """q ``[B, H, 1, D]``, pools ``[N, H, bs, D]``, ``lengths [B]`` int32,
    ``block_tables [B, M]`` int32 -> ``[B, H, 1, D]`` in q's dtype.

    Row b's positions ``[ki*bs, (ki+1)*bs)`` live in pool block
    ``block_tables[b, ki]``; ``lengths[b]`` (clamped to ``[0, M*bs]``)
    is how many positions it attends, and 0 marks an inactive row whose
    output is exactly zero. CUDA tensors launch ``csrc/paged_decode.cu``
    (f32 or bf16 q and pools, D a multiple of 8 up to 104); CPU tensors
    run the plain version."""
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
