"""Fused LayerNorm, forward and backward kernels (counterpart of
``nezha_tpu/ops/pallas/layer_norm.py``).

- :func:`layer_norm_fwd` -> y and :func:`layer_norm_bwd` -> ``(dx,
  dscale_part, dbias_part)`` are the raw entry points over ``x [rows,
  D]`` (no autograd). On CUDA tensors they launch the two kernels of
  ``csrc/layer_norm.cu``; on CPU tensors they run
  :func:`layer_norm_fwd_plain` and :func:`layer_norm_bwd_plain`; any other
  device raises.
- :func:`fused_layer_norm` is the differentiable call the model makes: a
  ``torch.autograd.Function`` (the counterpart of the TPU custom VJP)
  that saves x and scale, recomputes the row statistics in its backward,
  and sums the per-block partials of dscale and dbias outside the
  kernel.

Statistics are fp32 and two-pass: ``mean = sum(x)/D``, ``var =
sum((x - mean)^2)/D``, ``rsqrt(var + eps)``; the affine step is fp32 and
y is stored in x's dtype. x is f32 or bf16, scale and bias fp32 ``[D]``.
``LAUNCHES`` counts kernel launches by kernel name.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from nezha_tpu_torch.ops.cuda import build
from nezha_tpu_torch.ops.cuda.common import BF16_UNIT_ROUNDOFF

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = (_P,) * 4 + (_I, _I, ctypes.c_float, _I, _P)
_BWD_ARGTYPES = (_P,) * 6 + (_I, _I, ctypes.c_float, _I, _P)
# Rows per backward thread block: one [D] row of each partial per block
# (csrc/layer_norm.cu LN_BWD_ROWS). The plain backward blocks rows alike.
BWD_ROWS = 32
# The kernels hold a row in registers, 32 values per lane.
MAX_D = 1024
FP32_UNIT_ROUNDOFF = 2.0 ** -24

LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}


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


def _partials(t: torch.Tensor) -> torch.Tensor:
    """Column sums of ``t [rows, D]`` over blocks of BWD_ROWS rows ->
    ``[ceil(rows / BWD_ROWS), D]``, the kernel's partial layout."""
    rows, d = t.shape
    n = -(-rows // BWD_ROWS)
    return F.pad(t, (0, 0, 0, n * BWD_ROWS - rows)).reshape(
        n, BWD_ROWS, d).sum(dim=1)


def layer_norm_bwd_plain(x, scale, dy, eps: float
                         ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's function in tensor ops (``_ln_bwd_kernel``):
    statistics recomputed from x, ``dx = r (g - mean(g) - xhat
    mean(g xhat))`` with ``g = dy scale`` in x's dtype, and the fp32
    partials of ``dscale = sum dy xhat`` and ``dbias = sum dy`` per block
    of BWD_ROWS rows."""
    _check(x, scale, dy=dy)
    xc, r = _stats(x.float(), eps)
    xhat = xc * r
    dyf = dy.float()
    g = dyf * scale
    d = x.shape[1]
    m1 = g.sum(dim=-1, keepdim=True) / d
    m2 = (g * xhat).sum(dim=-1, keepdim=True) / d
    dx = r * (g - m1 - xhat * m2)
    return dx.to(x.dtype), _partials(dyf * xhat), _partials(dyf)


def layer_norm_error_bound(x, scale, bias, eps: float, dy=None):
    """Elementwise bounds on ``|kernel - plain|``: for y, or, given dy,
    for (dx, dscale, dbias) with the partials summed. To first order in
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
    _check_cuda(x, scale=scale, bias=bias)
    rows, d = x.shape
    y = torch.empty_like(x)
    if rows == 0:
        return y
    fn = build.bind("layer_norm", "nezha_layer_norm_fwd", _FWD_ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, d, float(eps), build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(rc, "nezha_layer_norm_fwd")
    LAUNCHES["layer_norm_fwd"] += 1
    return y


def _bwd_launch(x, scale, dy, eps):
    _check_cuda(x, scale=scale, dy=dy)
    rows, d = x.shape
    dx = torch.empty_like(x)
    n = -(-rows // BWD_ROWS)
    dsp = torch.empty((n, d), dtype=torch.float32, device=x.device)
    dbp = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dsp, dbp
    fn = build.bind("layer_norm", "nezha_layer_norm_bwd", _BWD_ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dsp.data_ptr(), dbp.data_ptr(), rows, d, float(eps),
            build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(rc, "nezha_layer_norm_bwd")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, dsp, dbp


def layer_norm_fwd(x, scale, bias, eps: float) -> torch.Tensor:
    """x ``[rows, D]`` -> LayerNorm(x) in x's dtype. CUDA tensors launch
    the forward kernel (D a multiple of 8, at most 1024); CPU tensors run
    the plain version."""
    _check(x, scale, bias)
    if _route(x) == "cpu":
        return layer_norm_fwd_plain(x, scale, bias, eps)
    return _fwd_launch(x, scale, bias, eps)


def layer_norm_bwd(x, scale, dy, eps: float) -> Tuple[torch.Tensor, ...]:
    """-> (dx in x's dtype, dscale and dbias partials ``[ceil(rows / 32),
    D]`` fp32; their column sums are the gradients). CUDA tensors launch
    the backward kernel; CPU tensors run the plain version."""
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
        dx, dsp, dbp = layer_norm_bwd(x2, scale, dy.contiguous(), ctx.eps)
        return (dx, dsp.sum(dim=0).to(scale.dtype),
                dbp.sum(dim=0).to(ctx.bias_dtype), None)


def fused_layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """x ``[..., D]``, fp32 scale and bias ``[D]`` -> LayerNorm(x) in x's
    dtype, differentiable (the backward kernel, see the module
    docstring)."""
    d = x.shape[-1]
    y = _FusedLayerNorm.apply(x.reshape(-1, d), scale, bias, eps)
    return y.reshape(x.shape)
