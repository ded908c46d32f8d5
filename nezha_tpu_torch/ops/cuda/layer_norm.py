"""Fused LayerNorm, forward and backward kernels (counterpart of
``nezha_tpu/ops/pallas/layer_norm.py``).

- :func:`layer_norm_fwd` -> y and :func:`layer_norm_bwd` -> ``(dx,
  dscale, dbias)`` (dscale and dbias fp32 ``[D]``) are the raw entry
  points over ``x [rows, D]`` (no autograd). On CUDA tensors they launch
  the kernels of ``csrc/layer_norm.cu``: the forward's, and the
  backward's rows then its column sums; on CPU tensors they run
  :func:`layer_norm_fwd_plain` and :func:`layer_norm_bwd_plain`; any other
  device raises.
- :func:`fused_layer_norm` is the differentiable call the model makes: a
  ``torch.autograd.Function`` (the counterpart of the TPU custom VJP)
  that saves x and scale; its backward is :func:`layer_norm_bwd`, its
  gradients cast to scale's and bias's dtypes.

Statistics are fp32 and two-pass: ``mean = sum(x)/D``, ``var =
sum((x - mean)^2)/D``, ``rsqrt(var + eps)``; the affine step is fp32 and
y is stored in x's dtype. x is f32 or bf16, scale and bias fp32 ``[D]``.
Both kernels' launch geometry is planned here (:func:`fwd_plan`, few rows
and many rows; :func:`bwd_plan`, a persistent grid) and
checked by their C entry points, which refuse any other; the forward's
is read back from its library (:func:`launched_fwd_plan`). ``LAUNCHES``
counts kernel launches by kernel name, ``FWD_LAUNCHES_BY_ROWS`` the
forward's by row count.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from nezha_tpu_torch.ops.cuda import build
from nezha_tpu_torch.ops.cuda.common import BF16_UNIT_ROUNDOFF

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = (_P,) * 4 + (_I, _I, ctypes.c_float, _I, _P, _I, _I, _I)
_BWD_ARGTYPES = (_P,) * 6 + (_I, _I, ctypes.c_float, _I, _P, _I, _I, _I,
                              _P)
# Rows of a partial of the plain backward: it sums dscale and dbias over
# blocks of BWD_ROWS rows, then the blocks in order.
BWD_ROWS = 32
# The kernels hold a row in registers, at most 32 values a lane.
MAX_D = 1024
FP32_UNIT_ROUNDOFF = 2.0 ** -24

LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0,
            "layer_norm_bwd_sums": 0}
# The forward's launches by row count (their sum is LAUNCHES'), for a
# caller that reports which shapes a path gave it.
FWD_LAUNCHES_BY_ROWS: Dict[int, int] = {}

# ------------------------------------------------------- the forward's plan
# SMs of an H100 SXM: the plan's default where no card is asked.
H100_SMS = 132
# The forward's many-rows geometry: FWD_MANY_WARPS-warp blocks,
# FWD_BLOCKS_PER_SM of them an SM (timed against other geometries with
# tools/tune_layer_norm.py --sweep on the H100: PERF.md). The C entry
# point restates both (LN_FWD_WARPS, LN_FWD_BLOCKS_PER_SM).
FWD_MANY_WARPS = 8
FWD_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The forward kernel's launch geometry, decided by :func:`fwd_plan`
    and checked by its C entry point (``fwd_plan_ok`` in
    ``csrc/layer_norm.cu``), which refuses any other:

    - ``cpl``: the 16-byte chunks of a row each lane holds (one warp a
      row; 1-4 for bf16, 1-8 for f32), the build the launch takes;
    - ``warps``: warps of a block (1, or FWD_MANY_WARPS);
    - ``blocks``: the grid; its warps stride over the rows, so a warp
      takes rows w, w + blocks * warps, ..."""

    cpl: int
    warps: int
    blocks: int


def _chunks(d: int, dtype) -> int:
    """16-byte chunks of a row of ``d`` values of ``dtype``."""
    return d * dtype.itemsize // 16


def fwd_plan(rows: int, d: int, dtype, sms: int = H100_SMS) -> FwdPlan:
    """The forward's geometry for ``rows`` rows of ``d`` values:

    - a lane holds ``ceil(chunks / 32)`` 16-byte chunks of the row;
    - few rows (at most one per SM): a block of one warp per row, so each
      row has an SM to itself and its loads go out at once;
    - more: a persistent grid of FWD_MANY_WARPS-warp blocks,
      FWD_BLOCKS_PER_SM an SM at most, sized so every warp takes the same
      number of rows (up to one), each warp keeping scale and bias in
      registers across its rows."""
    cpl = -(-_chunks(d, dtype) // 32)
    if rows <= sms:
        return FwdPlan(cpl, 1, rows)
    per_warp = -(-rows // (sms * FWD_BLOCKS_PER_SM * FWD_MANY_WARPS))
    warps = -(-rows // per_warp)
    return FwdPlan(cpl, FWD_MANY_WARPS, -(-warps // FWD_MANY_WARPS))


def check_fwd_plan(plan: FwdPlan, rows: int, d: int, dtype,
                   sms: int = H100_SMS) -> None:
    """What the C entry point takes (``bad_shape``, ``fwd_plan_ok``): a
    width the kernel holds and :func:`fwd_plan`'s geometry for the card's
    ``sms``, nothing else. Raises ValueError on any other plan."""
    _check_plan("forward", plan, fwd_plan(rows, d, dtype, sms), rows, d,
                dtype)


def _check_plan(what: str, plan, want, rows: int, d: int, dtype) -> None:
    if not 0 < d <= MAX_D or d % 8 or plan != want:
        raise ValueError(f"layer norm {what} plan {plan} does not fit "
                         f"rows={rows} D={d} {dtype} (takes {want}, D a "
                         f"multiple of 8 up to {MAX_D})")


# ------------------------------------------------------ the backward's plan
# The backward's geometry: BWD_WARPS-warp blocks, at most
# BWD_BLOCKS_PER_SM of them an SM, every block resident at once (timed
# against one block an SM with tools/tune_layer_norm.py --bwd-variants on
# the H100: PERF.md). The C entry point restates both (LN_BWD_WARPS,
# LN_BWD_BLOCKS_PER_SM).
BWD_WARPS = 8
BWD_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward kernel's launch geometry, decided by :func:`bwd_plan`
    and checked by its C entry point (``bwd_plan_ok`` in
    ``csrc/layer_norm.cu``), which refuses any other:

    - ``cpl``: the 16-byte chunks of a row each lane holds (one warp a
      row), the build the launch takes;
    - ``warps``: warps of a block (BWD_WARPS);
    - ``blocks``: the grid; its warps stride over the rows, and each
      block writes one partial of dscale and dbias, which the sums
      kernel adds over the blocks."""

    cpl: int
    warps: int
    blocks: int


def bwd_plan(rows: int, d: int, dtype, sms: int = H100_SMS) -> BwdPlan:
    """The backward's geometry for ``rows`` rows of ``d`` values: a lane
    holds ``ceil(chunks / 32)`` 16-byte chunks of the row; BWD_WARPS-warp
    blocks, as many as the rows fill (a warp a row), at most
    BWD_BLOCKS_PER_SM an SM, so the grid is resident at once and every
    warp takes the same number of rows up to one."""
    cpl = -(-_chunks(d, dtype) // 32)
    blocks = min(-(-rows // BWD_WARPS), sms * BWD_BLOCKS_PER_SM)
    return BwdPlan(cpl, BWD_WARPS, blocks)


def check_bwd_plan(plan: BwdPlan, rows: int, d: int, dtype,
                   sms: int = H100_SMS) -> None:
    """What the backward's C entry point takes (``bad_shape``,
    ``bwd_plan_ok``): :func:`bwd_plan`'s geometry for the card's ``sms``,
    nothing else. Raises ValueError on any other plan."""
    _check_plan("backward", plan, bwd_plan(rows, d, dtype, sms), rows, d,
                dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, scale, bias=None, dy=None) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, D], got {tuple(x.shape)}")
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not supported (f32 or bf16)")
    d = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if tuple(t.shape) != (d,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 [{d}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype
                           or dy.device != x.device):
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match "
                         f"x {x.dtype} {tuple(x.shape)}")


def _route(x) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"layer norm runs on cuda or cpu, not {x.device}")


# ------------------------------------------------------------ plain versions
def _stats(xf: torch.Tensor, eps: float):
    """Two-pass fp32 row statistics -> (x - mean, rsqrt(var + eps))."""
    xc = xf - xf.mean(dim=-1, keepdim=True)
    return xc, torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)


def layer_norm_fwd_plain(x, scale, bias, eps: float) -> torch.Tensor:
    """The forward kernel's function in tensor ops (``_ln_kernel``)."""
    _check(x, scale, bias)
    xc, r = _stats(x.float(), eps)
    return (xc * r * scale + bias).to(x.dtype)


def _column_sums(t: torch.Tensor) -> torch.Tensor:
    """Column sums of ``t [rows, D]``: over blocks of BWD_ROWS rows (the
    TPU kernel's per-block partials), then over the blocks -> ``[D]``."""
    rows, d = t.shape
    n = -(-rows // BWD_ROWS)
    return F.pad(t, (0, 0, 0, n * BWD_ROWS - rows)).reshape(
        n, BWD_ROWS, d).sum(dim=1).sum(dim=0)


def layer_norm_bwd_plain(x, scale, dy, eps: float
                         ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's function in tensor ops (``_ln_bwd_kernel``
    and the custom VJP's sums of its partials): statistics recomputed
    from x, ``dx = r (g - mean(g) - xhat mean(g xhat))`` with ``g = dy
    scale`` in x's dtype, and ``dscale = sum dy xhat`` and ``dbias = sum
    dy`` in fp32 ``[D]``."""
    _check(x, scale, dy=dy)
    xc, r = _stats(x.float(), eps)
    xhat = xc * r
    dyf = dy.float()
    g = dyf * scale
    d = x.shape[1]
    m1 = g.sum(dim=-1, keepdim=True) / d
    m2 = (g * xhat).sum(dim=-1, keepdim=True) / d
    dx = r * (g - m1 - xhat * m2)
    return dx.to(x.dtype), _column_sums(dyf * xhat), _column_sums(dyf)


def layer_norm_error_bound(x, scale, bias, eps: float, dy=None):
    """Elementwise bounds on ``|kernel - plain|``: for y, or, given dy,
    for (dx, dscale, dbias). To first order in
    the roundings of both sides, with ``E = (2 D + 16) 2^-24``:

    - fp32 sums of D terms in another order move the mean by ``2 D 2^-24
      mean|x|`` and the variance by ``2 (D + 3) 2^-24`` of itself, so r by
      ``(D + 9) 2^-24`` of itself (rsqrt's own error included), and xhat
      by ``ex = E (r mean|x| + |xhat|)``: y moves by ``E (|scale| (r
      mean|x| + |xhat|) + |bias|)``;
    - dx moves by ``E |dx|`` through r and by ``r`` times the moves of
      ``g - m1 - xhat m2``: ``E (mean|g| + |g| + |m1|)``, ``ex |m2|`` and
      ``|xhat| E (mean|g xhat| + mean(|g| ex / E))``;
    - dscale moves by ``sum_rows |dy| ex`` plus the row sums' order,
      ``2 rows 2^-24 sum_rows |dy xhat|``; dbias by ``2 rows 2^-24
      sum_rows |dy|``;
    - a bf16 output rounds once on each side. Two fp32 values a and b
      that differ by at most the fp32 bound above round to bf16 values
      A and B with ``|A - B| <= 2^-8 (|a| + |b|) + |a - b|``, which is
      at most ``2^-7 (1 + 2^-7) |B| + (1 + 2^-8) |a - b|``: the fp32
      bound grows by 2^-8 and ``2^-7 (1 + 2^-7) |out|`` is added. A pair
      that rounds apart next to a power of two comes within 1% of it;
    - 1e-6 absolute on everything."""
    _check(x, scale, bias, dy)
    u = FP32_UNIT_ROUNDOFF
    rows, d = x.shape
    e = (2 * d + 16) * u
    xf = x.float()
    xc, r = _stats(xf, eps)
    xhat = xc * r
    amean = xf.abs().mean(dim=-1, keepdim=True)
    ex = e * (r * amean + xhat.abs())
    bf16 = x.dtype == torch.bfloat16

    def rounded(bound, plain):
        """The fp32 bound widened for one bf16 rounding of each side."""
        if not bf16:
            return bound
        return ((1 + BF16_UNIT_ROUNDOFF) * bound + 2 * BF16_UNIT_ROUNDOFF
                * (1 + 2 * BF16_UNIT_ROUNDOFF) * plain.float().abs())

    if dy is None:
        bound = 1e-6 + e * (scale.abs() * (r * amean + xhat.abs())
                            + bias.abs())
        return rounded(bound, layer_norm_fwd_plain(x, scale, bias, eps))
    dyf = dy.float()
    g = dyf * scale
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = r * (g - m1 - xhat * m2)
    terms = (e * (g.abs().mean(dim=-1, keepdim=True) + g.abs() + m1.abs())
             + ex * m2.abs()
             + xhat.abs() * (e * (g * xhat).abs().mean(dim=-1, keepdim=True)
                             + (g.abs() * ex).mean(dim=-1, keepdim=True)))
    bound_dx = rounded(1e-6 + e * dx.abs() + r * terms,
                       layer_norm_bwd_plain(x, scale, dy, eps)[0])
    bound_ds = 1e-6 + (dyf.abs() * ex).sum(dim=0) + 2 * rows * u * (
        dyf * xhat).abs().sum(dim=0)
    bound_db = 1e-6 + 2 * rows * u * dyf.abs().sum(dim=0)
    return bound_dx, bound_ds, bound_db


# ----------------------------------------------------------------- kernels
def _check_cuda(x, **tensors) -> None:
    d = x.shape[1]
    if d % 8 or d > MAX_D:
        raise ValueError(f"layer norm width {d} not supported by the kernel "
                         f"(a multiple of 8, at most {MAX_D})")
    for name, t in (("x", x),) + tuple(tensors.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    build.check_aligned(x=x, **tensors)


def _fwd_launch(x, scale, bias, eps):
    """The forward kernel on :func:`fwd_plan`'s geometry."""
    _check_cuda(x, scale=scale, bias=bias)
    rows, d = x.shape
    y = torch.empty_like(x)
    if rows == 0:
        return y
    plan = fwd_plan(rows, d, x.dtype, _sm_count(x.device.index))
    fn = build.bind("layer_norm", "nezha_layer_norm_fwd", _FWD_ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, d, float(eps), build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream, plan.cpl,
            plan.warps, plan.blocks)
    build.check_launch(rc, "nezha_layer_norm_fwd")
    LAUNCHES["layer_norm_fwd"] += 1
    FWD_LAUNCHES_BY_ROWS[rows] = FWD_LAUNCHES_BY_ROWS.get(rows, 0) + 1
    return y


def launched_fwd_plan() -> FwdPlan:
    """The plan of the forward's last launch, as its C entry point
    recorded it at the launch (``nezha_layer_norm_fwd_last_plan``)."""
    out = (_I * 3)()
    build.bind("layer_norm", "nezha_layer_norm_fwd_last_plan", (_P,))(out)
    return FwdPlan(*out)


# Per (device, stream): the backward's fp32 partials, grown to the
# largest call.
_BWD_WORKSPACE = {}


def _bwd_workspace(device, stream: int, part_floats: int) -> torch.Tensor:
    key = (device, stream)
    parts = _BWD_WORKSPACE.get(key)
    if parts is None or parts.numel() < part_floats:
        parts = torch.empty(part_floats, dtype=torch.float32, device=device)
        _BWD_WORKSPACE[key] = parts
    return parts


def _bwd_launch(x, scale, dy, eps):
    """The backward kernel on :func:`bwd_plan`'s geometry (dx, and one
    partial of dscale and dbias a block), then the sums kernel (dscale
    and dbias over the blocks' partials)."""
    _check_cuda(x, scale=scale, dy=dy)
    rows, d = x.shape
    dx = torch.empty_like(x)
    if rows == 0:
        zeros = torch.zeros(d, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    dbias = torch.empty(d, dtype=torch.float32, device=x.device)
    plan = bwd_plan(rows, d, x.dtype, _sm_count(x.device.index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    parts = _bwd_workspace(x.device, stream, 2 * plan.blocks * d)
    fn = build.bind("layer_norm", "nezha_layer_norm_bwd", _BWD_ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), rows, d, float(eps),
            build.DTYPE_CODES[x.dtype], stream, plan.cpl, plan.warps,
            plan.blocks, parts.data_ptr())
    build.check_launch(rc, "nezha_layer_norm_bwd")
    LAUNCHES["layer_norm_bwd"] += 1
    LAUNCHES["layer_norm_bwd_sums"] += 1
    return dx, dscale, dbias


def layer_norm_fwd(x, scale, bias, eps: float) -> torch.Tensor:
    """x ``[rows, D]`` -> LayerNorm(x) in x's dtype. CUDA tensors launch
    the forward kernel (D a multiple of 8, at most 1024); CPU tensors run
    the plain version."""
    _check(x, scale, bias)
    if _route(x) == "cpu":
        return layer_norm_fwd_plain(x, scale, bias, eps)
    return _fwd_launch(x, scale, bias, eps)


def layer_norm_bwd(x, scale, dy, eps: float) -> Tuple[torch.Tensor, ...]:
    """-> (dx in x's dtype, dscale and dbias fp32 ``[D]``). CUDA tensors
    launch the backward kernel and its sums kernel, once each a call (D a
    multiple of 8, at most 1024); CPU tensors run the plain version."""
    _check(x, scale, dy=dy)
    if _route(x) == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, eps)
    return _bwd_launch(x, scale, dy, eps)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        x2 = x2.contiguous()
        ctx.save_for_backward(x2, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return layer_norm_fwd(x2, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x2, scale, dy.contiguous(),
                                           ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


def fused_layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """x ``[..., D]``, fp32 scale and bias ``[D]`` -> LayerNorm(x) in x's
    dtype, differentiable (the backward kernel, see the module
    docstring)."""
    d = x.shape[-1]
    y = _FusedLayerNorm.apply(x.reshape(-1, d), scale, bias, eps)
    return y.reshape(x.shape)
