"""Flash attention for training: the forward and the two backward kernels
(counterpart of ``nezha_tpu/ops/pallas/flash_attention.py``).

- :func:`flash_block_fwd` -> ``(out, lse)`` and :func:`flash_block_bwd`
  -> ``(dq, dk, dv)`` are the raw entry points (no autograd). On CUDA
  tensors they launch ``csrc/flash_fwd.cu`` and the dq and dk/dv kernels
  of ``csrc/flash_bwd.cu``; on CPU tensors they run
  :func:`flash_block_fwd_plain` and :func:`flash_block_bwd_plain`; any
  other device raises.
- :func:`flash_attention` is the differentiable call the model makes: a
  ``torch.autograd.Function`` (the counterpart of the TPU custom VJPs)
  that saves ``q, k, v, out`` and the ``[B, H, S]`` fp32 lse, and runs
  :func:`flash_block_bwd` in its backward.

The launch geometry of the forward and dK/dV kernels is decided here
(:class:`FlashPlan`, :func:`fwd_plan`, :func:`dkv_plan`) and passed to
their C entry points, which launch only a body built for it: bf16 runs
the Hopper bodies (wgmma fed by TMA), fp32 the first bodies. The dK/dV
kernel reads delta = rowsum(dO*O) from a pre-pass kernel
(:func:`flash_bwd_delta_plain` is its plain version). The functions
:func:`launch_order`, :func:`fwd_visits`, :func:`dkv_visits` and
:func:`attended_pairs` restate the kernels' walk over the tiles, so the
CPU tests can hold it against :func:`_valid`.

``LAUNCHES`` counts kernel launches by kernel name. Shapes: q ``[B, H,
Sq, D]``, k and v ``[B, H, Sk, D]`` of q's dtype (f32 or bf16), D a
multiple of 8 up to 128; causal needs ``Sq == Sk``; ``kv_lengths`` ([B]
int) masks keys at or past each row's length, clamped to ``[1, Sk]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch

from nezha_tpu_torch.ops.attention import masked_scores
from nezha_tpu_torch.ops.cuda import build
from nezha_tpu_torch.ops.cuda.common import (BF16_UNIT_ROUNDOFF, pick_block,
                                             softmax_block_update,
                                             softmax_finalize_lse,
                                             softmax_init)

_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = (_I,) * 5 + (ctypes.c_float, _I, _I, _P)
_FWD_ARGTYPES = (_P,) * 6 + _TAIL + (_P,)         # ..., plan
_DQ_ARGTYPES = (_P,) * 8 + _TAIL
_DKV_ARGTYPES = (_P,) * 9 + _TAIL + (_P, _P)      # ..., delta, plan
_DELTA_ARGTYPES = (_P,) * 3 + (_I,) * 5 + (_P,)
# The TPU kernel's key block at training lengths (_auto_blocks: 512): the
# plain forward folds in the same order.
_PLAIN_BLOCK_K = 512

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkv": 0}

# ------------------------------------------------------------ launch plans
# The largest dynamic shared memory a block may ask for on Hopper.
MAX_SMEM_BYTES = 232448
_GROUP = 64            # rows one consumer warpgroup owns (wgmma's M)
_SUB_COLS = 64         # bf16 columns of one 128-byte swizzled line
_ALIGN = 1024          # the kernels round their shared base up to this
_BARRIER = 8           # bytes of an mbarrier
_FIRST_TILE = 64       # the first bodies' rows a block owns and streams
_FIRST_PAD = 8         # and their shared row padding, in elements


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """The launch geometry of one flash kernel, decided here and passed to
    its C entry point (``csrc/flash_common.cuh`` ``Plan``), which launches
    only a body built for it and fails otherwise.

    - ``kernel``: ``"fwd"`` or ``"dkv"``;
    - ``wgmma``: the Hopper body (bf16: a producer warpgroup feeds TMA
      tiles to consumer warpgroups of 64 rows, which mask only the tiles
      that cross the diagonal, the sequence's end or ``kv_len``) or the
      first body (fp32: 4 warps on 64 rows, every tile masked);
    - ``d_pad``: the head dim its tiles hold (zeros past D);
    - ``rows``: rows a block owns (queries in the forward, keys in dK/dV);
    - ``tile``: rows of a streamed tile (keys in the forward, queries in
      dK/dV);
    - ``stages``: streamed tiles in flight;
    - ``smem_bytes``: the dynamic shared memory the launch asks for;
    - ``heavy_first``: under causal, the grid launches the tiles with the
      most work first (:func:`launch_order`)."""

    kernel: str
    wgmma: bool
    d_pad: int
    rows: int
    tile: int
    stages: int
    smem_bytes: int
    heavy_first: bool

    def as_c(self):
        """The six ints of the C ``Plan``, in its order."""
        return (ctypes.c_int * 6)(self.d_pad, self.rows, self.tile,
                                  self.stages, self.smem_bytes,
                                  int(self.heavy_first))


def _padded(d: int) -> int:
    """D rounded up to whole 64-column swizzled sub-tiles."""
    return -(-d // _SUB_COLS) * _SUB_COLS


# The Hopper bodies' builds, by padded D: (consumer warpgroups, rows of a
# streamed tile, stages) — csrc/flash_fwd.cu FwdBuilds and csrc/flash_bwd.cu
# DkvBuilds. Each is the fastest of those tools/tune_flash_plans.py timed
# at the training shape on the H100 (PERF.md).
FWD_BUILDS = {64: (1, 128, 3), 128: (2, 128, 3)}
DKV_BUILDS = {64: (1, 64, 2), 128: (1, 64, 2)}


def hopper_plan(kernel: str, d_pad: int, consumers: int, tile: int,
                stages: int) -> FlashPlan:
    """One geometry of a Hopper body: a block owns ``consumers`` x 64 rows
    and streams ``tile``-row tiles through ``stages`` ring slots. Shared
    memory holds, from a 1024-aligned base (1024 bytes more asked for),
    the forward's Q and ring of K/V tiles, or dK/dV's K, V and ring of
    Q/dO tiles with their lse and delta slices, then 1 + 2 * stages
    barriers."""
    rows = _GROUP * consumers
    held = rows if kernel == "fwd" else 2 * rows
    smem = (_ALIGN + 2 * d_pad * (held + 2 * stages * tile)
            + (4 * 2 * stages * tile if kernel == "dkv" else 0)
            + _BARRIER * (1 + 2 * stages))
    return FlashPlan(kernel, True, d_pad, rows, tile, stages, smem, True)


def fwd_plan(d: int, dtype) -> FlashPlan:
    """The forward's geometry. bf16: the build FWD_BUILDS names for D
    padded to 64 or 128 columns. fp32: the first body, 64 queries a block,
    Q/K/V tiles of D + 8 columns."""
    build.check_head_dim(d)
    if dtype == torch.bfloat16:
        return hopper_plan("fwd", _padded(d), *FWD_BUILDS[_padded(d)])
    if dtype == torch.float32:
        return FlashPlan("fwd", False, d, _FIRST_TILE, _FIRST_TILE, 1,
                         4 * 3 * _FIRST_TILE * (d + _FIRST_PAD), False)
    raise ValueError(f"dtype {dtype} not supported (f32 or bf16)")


def dkv_plan(d: int, dtype) -> FlashPlan:
    """The dK/dV kernel's geometry. bf16: the build DKV_BUILDS names for D
    padded to 64 or 128 columns; its query tiles stay 64 wide, since at
    D = 128 the two fp32 accumulators and S^T, dP^T take ~192 of a
    consumer's 232 registers. fp32: the first body, 64 keys a block."""
    build.check_head_dim(d)
    if dtype == torch.bfloat16:
        return hopper_plan("dkv", _padded(d), *DKV_BUILDS[_padded(d)])
    if dtype == torch.float32:
        return FlashPlan("dkv", False, d, _FIRST_TILE, _FIRST_TILE, 1,
                         4 * 4 * _FIRST_TILE * (d + _FIRST_PAD), False)
    raise ValueError(f"dtype {dtype} not supported (f32 or bf16)")


def launch_order(plan: FlashPlan, s_rows: int, causal: bool) -> List[int]:
    """The row tiles of one (b, h) in the order the grid launches them
    (rank ``blockIdx.y`` of the Hopper grids, which put every (b, h) of a
    rank before the next rank). Under causal the forward's last query tile
    meets the most key tiles and dK/dV's first key tile the most query
    tiles, so heaviest first is descending for one, ascending for the
    other."""
    n = -(-s_rows // plan.rows)
    if plan.kernel == "fwd" and plan.wgmma and causal and plan.heavy_first:
        return [n - 1 - r for r in range(n)]
    return list(range(n))


def fwd_visits(plan: FlashPlan, s_q: int, s_k: int, causal: bool,
               kv_len: int) -> List[List[Tuple[int, bool]]]:
    """For each query tile, the key tiles the forward folds, in order,
    each with whether it runs the mask: tiles wholly above the diagonal
    or past ``kv_len`` are skipped; the Hopper body masks only a tile
    that crosses ``kv_len`` or the diagonal of the block's first query."""
    kv_len = max(1, min(kv_len, s_k))
    out = []
    for qt in range(-(-s_q // plan.rows)):
        q0 = qt * plan.rows
        k_end = min(kv_len, q0 + plan.rows) if causal else kv_len
        tiles = []
        for kt in range(-(-k_end // plan.tile)):
            k0 = kt * plan.tile
            edge = (k0 + plan.tile > kv_len
                    or (causal and k0 + plan.tile - 1 > q0))
            tiles.append((kt, edge or not plan.wgmma))
        out.append(tiles)
    return out


def dkv_visits(plan: FlashPlan, s_q: int, s_k: int, causal: bool,
               kv_len: int) -> List[List[Tuple[int, bool]]]:
    """For each group of 64 keys (a consumer warpgroup, or a first-body
    block), the query tiles dK/dV folds, in order, each with whether it
    runs the mask.
    A block starts at the diagonal query tile under causal and does
    nothing past ``kv_len``; a Hopper consumer skips the tiles none of its
    keys sees and masks only those that cross the diagonal, the end of the
    queries or ``kv_len``."""
    kv_len = max(1, min(kv_len, s_k))
    out = []
    for kt in range(-(-s_k // plan.rows)):
        k0 = kt * plan.rows
        q_begin = k0 if causal else 0
        n_q = -(-(s_q - q_begin) // plan.tile) if k0 < kv_len else 0
        for kw in range(k0, k0 + plan.rows, _GROUP):
            tiles = []
            for i in range(n_q):
                q0 = q_begin + i * plan.tile
                if plan.wgmma and not (kw < kv_len and (
                        not causal or q0 + plan.tile - 1 >= kw)):
                    continue
                edge = (not plan.wgmma
                        or (causal and q0 < kw + _GROUP - 1)
                        or q0 + plan.tile > s_q
                        or kw + _GROUP > kv_len)
                tiles.append((q0 // plan.tile, edge))
            out.append(tiles)
    return out


def attended_pairs(plan: FlashPlan, s_q: int, s_k: int, causal: bool,
                   kv_len: int) -> torch.Tensor:
    """``[s_q, s_k]`` bool: the (query, key) pairs the kernel's walk lets
    through — every pair of a tile it folds unmasked, and the pairs the
    mask keeps (key < kv_len, and key <= query under causal) of a tile it
    masks."""
    kv_len = max(1, min(kv_len, s_k))
    qpos = torch.arange(s_q)[:, None]
    kpos = torch.arange(s_k)[None, :]
    keep = ((kpos < kv_len) & ((kpos <= qpos) | (not causal))).expand(
        s_q, s_k)
    out = torch.zeros(s_q, s_k, dtype=torch.bool)

    def let_through(qs: slice, ks: slice, masked: bool) -> None:
        out[qs, ks] |= keep[qs, ks] if masked else True

    if plan.kernel == "fwd":
        for qt, tiles in enumerate(fwd_visits(plan, s_q, s_k, causal,
                                              kv_len)):
            for kt, masked in tiles:
                let_through(slice(qt * plan.rows, (qt + 1) * plan.rows),
                            slice(kt * plan.tile, (kt + 1) * plan.tile),
                            masked)
    else:
        for g, tiles in enumerate(dkv_visits(plan, s_q, s_k, causal,
                                             kv_len)):
            for qt, masked in tiles:
                let_through(slice(qt * plan.tile, (qt + 1) * plan.tile),
                            slice(g * _GROUP, (g + 1) * _GROUP),
                            masked)
    return out


def _check(q, k, v, causal: bool, *more) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s_q, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if causal and s_q != k.shape[2]:
        # As on the TPU: the causal mask has no (Sk - Sq) diagonal offset.
        raise ValueError(f"causal flash_attention requires s_q == s_k, "
                         f"got {s_q} != {k.shape[2]}")
    build.check_head_dim(d)
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"o/do {tuple(t.shape)} do not match q "
                             f"{tuple(q.shape)}")
    for t in (k, v) + more:
        if t.dtype != q.dtype:
            raise ValueError(f"dtypes {q.dtype} and {t.dtype} differ")
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (f32 or bf16)")


def _scale(q, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / (q.shape[3] ** 0.5)


def _lengths(kv_lengths, q, s_k: int) -> Optional[torch.Tensor]:
    """``kv_lengths`` as int32 on q's device, clamped to ``[1, Sk]``."""
    if kv_lengths is None:
        return None
    lens = torch.as_tensor(kv_lengths, device=q.device)
    if tuple(lens.shape) != (q.shape[0],):
        raise ValueError(f"kv_lengths {tuple(lens.shape)} must be "
                         f"[{q.shape[0]}]")
    return lens.to(torch.int32).clamp(1, s_k).contiguous()


def _valid(s_q: int, s_k: int, causal: bool, lens, device):
    """Attendable ``[B or 1, 1, Sq, Sk]`` bool mask."""
    qpos = torch.arange(s_q, device=device)[:, None]
    kpos = torch.arange(s_k, device=device)[None, :]
    valid = (kpos <= qpos) if causal else torch.ones(
        s_q, s_k, dtype=torch.bool, device=device)
    valid = valid[None, None]
    if lens is not None:
        valid = valid & (kpos[None, None] < lens[:, None, None, None])
    return valid


# ------------------------------------------------------------ plain versions
def flash_block_fwd_plain(q, k, v, causal: bool,
                          scale: Optional[float] = None, kv_lengths=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in tensor ops, folded over 512-key
    blocks in order as the TPU kernel does at training lengths: scores of
    the operands in fp32 (exact products of bf16 inputs, fp32 sums),
    masked to ``NEG_BIG``; ``p`` cast to v's dtype before P·V. -> (out in
    q's dtype, lse ``[B, H, Sq]`` fp32)."""
    _check(q, k, v, causal)
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    scale = _scale(q, scale)
    valid = _valid(s_q, s_k, causal, _lengths(kv_lengths, q, s_k), q.device)
    state = softmax_init((b, h, s_q), d, q.device)
    bk = pick_block(s_k, _PLAIN_BLOCK_K)
    for k0 in range(0, s_k, bk):
        s = masked_scores(q, k[:, :, k0:k0 + bk], valid[..., k0:k0 + bk],
                          scale)
        state = softmax_block_update(state, s, v[:, :, k0:k0 + bk])
    return softmax_finalize_lse(state, q.dtype)


def _bwd_terms(q, k, v, o, lse, do, causal, scale, kv_lengths):
    """Dense fp32 ``p`` and ``dp - delta`` ``[B, H, Sq, Sk]`` of the
    backward."""
    s_k = k.shape[2]
    valid = _valid(q.shape[2], s_k, causal, _lengths(kv_lengths, q, s_k),
                   q.device)
    s = masked_scores(q, k, valid, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, dp - flash_bwd_delta_plain(o, do)[..., None]


def flash_bwd_delta_plain(o, do) -> torch.Tensor:
    """The delta pre-pass's function: ``rowsum(dO * O)`` in fp32, ``[B, H,
    Sq]``."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_block_bwd_plain(q, k, v, o, lse, do, causal: bool,
                          scale: Optional[float] = None, kv_lengths=None
                          ) -> Tuple[torch.Tensor, ...]:
    """The two backward kernels' function in dense tensor ops (the FA2
    formulas, not autograd through composed attention): ``p = exp(s -
    lse)``, ``ds = p * (dO·Vᵀ - rowsum(dO*O)) * scale`` in fp32, then
    ``dq = ds.to(k) · K``, ``dk = ds.to(q)ᵀ · Q``, ``dv = p.to(dO)ᵀ · dO``
    with the TPU kernels' casts, fp32 sums, and outputs in the inputs'
    dtype. -> (dq, dk, dv)."""
    _check(q, k, v, causal, o, do)
    scale = _scale(q, scale)
    p, dpd = _bwd_terms(q, k, v, o, lse.float(), do, causal, scale,
                        kv_lengths)
    ds = p * dpd * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


FP32_UNIT_ROUNDOFF = 2.0 ** -24


def flash_bwd_error_bound(q, k, v, o, lse, do, causal: bool,
                          scale: Optional[float] = None, kv_lengths=None
                          ) -> Tuple[torch.Tensor, ...]:
    """Elementwise bounds on ``|kernel - plain|`` for (dq, dk, dv), to
    first order in the roundings of both sides.

    - fp32 arithmetic in another order: a D-term dot is off by at most
      ``D * 2^-24 * sum |x||y|``. So the scores by ``e_s = D 2^-24 scale
      |Q|·|K|ᵀ`` (plus ``2^-24 |lse|``), which moves ``p`` by ``p * e_s``,
      and ``dp - delta`` by ``e_d = D 2^-24 (|dO|·|V|ᵀ + rowsum|dO*O|)``:
      ``ds`` moves by ``dds = scale (dp_err |dp - delta| + p e_d)``, with
      ``dp_err = p e_s``. These flow into the outputs as ``dds·|K|``,
      ``ddsᵀ·|Q|`` and ``dp_errᵀ·|dO|``.
    - Where the inputs are bf16, both sides cast ``ds`` (dq, dk) or ``p``
      (dv) to bf16 before the dot: two roundings of nearly equal values
      differ by at most 2 x 2^-8 of the value, ``2^-7 sum |x||y|`` over
      the dot (``|ds|·|K|``, ``|ds|ᵀ·|Q|``, ``|p|ᵀ·|dO|``), plus the
      rounding of the bf16 output on each side, ``2^-7 |out|``. In fp32
      the outputs' own sums add ``Sk 2^-24`` (or ``Sq 2^-24``) of the
      same dots.
    - 1e-5 absolute on everything."""
    _check(q, k, v, causal, o, do)
    scale = _scale(q, scale)
    lse = lse.float()
    p, dpd = _bwd_terms(q, k, v, o, lse, do, causal, scale, kv_lengths)
    d, s_q, s_k = q.shape[3], q.shape[2], k.shape[2]
    aq, ak, av, ao, ado = (t.float().abs() for t in (q, k, v, o, do))
    e_s = d * FP32_UNIT_ROUNDOFF * scale * torch.einsum(
        "bhqd,bhkd->bhqk", aq, ak) + FP32_UNIT_ROUNDOFF * lse.abs()[..., None]
    e_d = d * FP32_UNIT_ROUNDOFF * (
        torch.einsum("bhqd,bhkd->bhqk", ado, av)
        + (ado * ao).sum(dim=-1, keepdim=True))
    dp_err = p * e_s
    dds = scale * (dp_err * dpd.abs() + p * e_d)
    ads = p * dpd.abs() * scale
    bf16 = q.dtype == torch.bfloat16
    rel = (2 * BF16_UNIT_ROUNDOFF if bf16
           else max(s_q, s_k) * FP32_UNIT_ROUNDOFF)
    terms = (torch.einsum("bhqk,bhkd->bhqd", dds + rel * ads, ak),
             torch.einsum("bhqk,bhqd->bhkd", dds + rel * ads, aq),
             torch.einsum("bhqk,bhqd->bhkd", dp_err + rel * p, ado))
    want = flash_block_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                 kv_lengths)
    out = []
    for term, w in zip(terms, want):
        bound = 1e-5 + term
        if bf16:
            bound = bound + 2 * BF16_UNIT_ROUNDOFF * w.float().abs()
        out.append(bound)
    return tuple(out)


# ----------------------------------------------------------------- kernels
def _check_cuda(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    build.check_aligned(**tensors)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd_launch(q, k, v, lens, causal, scale, plan=None):
    """The forward kernel at ``plan`` (fwd_plan's by default)."""
    _check_cuda(q=q, k=k, v=v)
    b, h, s_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fn = build.bind("flash_fwd", "nezha_flash_fwd", _FWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens),
            out.data_ptr(), lse.data_ptr(), b, h, s_q, k.shape[2], d, scale,
            int(causal), build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
            (plan or fwd_plan(d, q.dtype)).as_c())
    build.check_launch(rc, "nezha_flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _bwd_args(q, k, v, o, lse, do, lens, causal, scale):
    """The pointer head and the shape tail both backward entry points
    take."""
    if lse.dtype != torch.float32 or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse must be fp32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    _check_cuda(q=q, k=k, v=v, o=o, lse=lse, do=do)
    b, h, s_q, d = q.shape
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), _ptr(lens))
    tail = (b, h, s_q, k.shape[2], d, scale, int(causal),
            build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail


def _dq_launch(q, k, v, o, lse, do, lens, causal, scale):
    head, tail = _bwd_args(q, k, v, o, lse, do, lens, causal, scale)
    dq = torch.empty_like(q)
    fn = build.bind("flash_bwd", "nezha_flash_bwd_dq", _DQ_ARGTYPES)
    build.check_launch(fn(*head, dq.data_ptr(), *tail), "nezha_flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _delta_launch(o, do):
    """The delta pre-pass: -> ``rowsum(dO * O)`` fp32 ``[B, H, Sq]``."""
    b, h, s_q, d = o.shape
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=o.device)
    fn = build.bind("flash_bwd", "nezha_flash_bwd_delta", _DELTA_ARGTYPES)
    build.check_launch(
        fn(o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, h, s_q, d,
           build.DTYPE_CODES[o.dtype],
           torch.cuda.current_stream(o.device).cuda_stream),
        "nezha_flash_bwd_delta")
    LAUNCHES["flash_bwd_delta"] += 1
    return delta


def _dkv_launch(q, k, v, o, lse, do, lens, causal, scale, plan=None):
    """dK and dV: the delta pre-pass, then the dK/dV kernel at ``plan``
    (dkv_plan's by default)."""
    head, tail = _bwd_args(q, k, v, o, lse, do, lens, causal, scale)
    delta = _delta_launch(o, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = build.bind("flash_bwd", "nezha_flash_bwd_dkv", _DKV_ARGTYPES)
    build.check_launch(fn(*head, dk.data_ptr(), dv.data_ptr(), *tail,
                          delta.data_ptr(),
                          (plan or dkv_plan(q.shape[3], q.dtype)).as_c()),
                       "nezha_flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _route(q) -> str:
    if q.device.type in ("cuda", "cpu"):
        return q.device.type
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_block_fwd(q, k, v, causal: bool, scale: Optional[float] = None,
                    kv_lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block pair, no autograd: -> (out ``[B, H, Sq, D]``, lse
    ``[B, H, Sq]`` fp32). CUDA tensors launch the forward kernel; CPU
    tensors run the plain version."""
    _check(q, k, v, causal)
    if _route(q) == "cpu":
        return flash_block_fwd_plain(q, k, v, causal, scale, kv_lengths)
    return _fwd_launch(q, k, v, _lengths(kv_lengths, q, k.shape[2]), causal,
                       _scale(q, scale))


def flash_block_bwd(q, k, v, o, lse, do, causal: bool,
                    scale: Optional[float] = None, kv_lengths=None
                    ) -> Tuple[torch.Tensor, ...]:
    """Gradients for one block pair given the row lse ``[B, H, Sq]`` and
    the output o (delta = rowsum(dO*O)): -> (dq, dk, dv). CUDA tensors
    launch the dq kernel, the delta pre-pass and the dk/dv kernel; CPU
    tensors run the plain version."""
    _check(q, k, v, causal, o, do)
    if _route(q) == "cpu":
        return flash_block_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                     kv_lengths)
    args = (q, k, v, o, lse, do, _lengths(kv_lengths, q, k.shape[2]),
            causal, _scale(q, scale))
    return (_dq_launch(*args),) + _dkv_launch(*args)


class _FlashAttention(torch.autograd.Function):
    """q, k, v made contiguous once; the residuals are them, the output
    and the compact ``[B, H, S]`` lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_lengths):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        lens = _lengths(kv_lengths, q, k.shape[2])
        out, lse = flash_block_fwd(q, k, v, causal, scale, lens)
        ctx.save_for_backward(q, k, v, out, lse, lens)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lens = ctx.saved_tensors
        dq, dk, dv = flash_block_bwd(q, k, v, out, lse, dout.contiguous(),
                                     ctx.causal, ctx.scale, lens)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, kv_lengths=None):
    """q, k, v ``[B, H, S, D]`` -> ``[B, H, S, D]``, differentiable.

    ``kv_lengths`` ([B]) masks key positions at or beyond each row's
    length, clamped to >= 1 as on the TPU: a zero-length row attends
    position 0 only. Query rows past the length give finite values the
    caller must mask; padded keys get exactly zero gradient, except
    position 0 of a zero-length row."""
    return _FlashAttention.apply(q, k, v, causal, scale, kv_lengths)
