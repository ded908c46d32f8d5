"""Core layers of GPT-2, the MLP and the ResNets (counterpart of
``nezha_tpu/nn/layers.py``).

Parameter names follow the JAX package so weights carry across by name:
``Linear`` stores ``w`` as ``[in, out]`` plus ``b``, ``LayerNorm`` stores
``scale`` and ``bias``, ``Embedding`` stores ``embedding``, ``BatchNorm``
stores ``scale`` and ``bias`` plus the fp32 buffers ``mean`` and ``var``.
Images run NCHW in ``torch.channels_last`` memory (the JAX package's NHWC
bytes, cuDNN's fast layout): ``Conv2d`` stores ``weight`` as PyTorch's
``[O, I/groups, kh, kw]`` (``models.convert`` transposes JAX's HWIO) and
the pools take NCHW. Every layer takes a dtype :class:`Policy`:
parameters are kept in the param dtype and cast to the compute dtype at
use, and normalization statistics stay fp32 whatever the policy. Layers
build on the card unless the caller passes ``device="cpu"`` or a CPU
generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.nn.remat import recomputing
from nezha_tpu_torch.ops.cuda.layer_norm import fused_layer_norm
from nezha_tpu_torch.tensor.policy import DEFAULT_POLICY, Policy


def resolve_device(device=None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.device:
    """Where a layer or model builds: the generator's device, else
    ``device``, else ``cuda`` — the port's entry points run on the card
    unless asked for the CPU."""
    if generator is not None:
        return generator.device
    return torch.device(device if device is not None else "cuda")


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           policy: Policy) -> torch.Tensor:
    """``x @ w + b`` in the policy's compute dtype (:class:`Linear`)."""
    y = policy.cast_to_compute(x) @ policy.cast_to_compute(w)
    if b is not None:
        y = y + policy.cast_to_compute(b)
    return policy.cast_output(y)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, policy: Policy, impl: str = "xla") -> torch.Tensor:
    """The row LayerNorm of :class:`LayerNorm` (fp32 statistics)."""
    if impl == "pallas":
        y = fused_layer_norm(policy.cast_to_compute(x), scale.float(),
                             bias.float(), eps)
        return policy.cast_output(y)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return policy.cast_output(y)


def _generator(generator: Optional[torch.Generator],
               device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=resolve_device(device))


class Linear(nn.Module):
    """y = x @ w + b, weights stored ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, kernel_init=None,
                 bias_init=init_lib.zeros, policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = _generator(generator, device)
        self.policy = policy
        kernel_init = kernel_init or init_lib.normal(0.02)
        self.w = nn.Parameter(kernel_init(g, (in_features, out_features),
                                          policy.param_dtype))
        self.b = (nn.Parameter(bias_init(g, (out_features,),
                                         policy.param_dtype))
                  if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w, self.b, self.policy)


class LayerNorm(nn.Module):
    """Layer norm over the last axis with fp32 statistics (mean, biased
    variance, ``rsqrt(var + eps)``), output cast to the policy's output
    dtype. Two paths, named as in the JAX layer:

    - ``impl="xla"``: tensor ops on x upcast to fp32;
    - ``impl="pallas"``: the fused kernels (``ops/cuda/layer_norm.py``,
      forward and backward) on x cast to the compute dtype, as the JAX
      layer feeds its Pallas kernel; CPU tensors run their plain
      versions."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 policy: Policy = DEFAULT_POLICY, device=None,
                 impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "pallas"):
            raise ValueError(f"unknown LayerNorm impl {impl!r}")
        self.eps = eps
        self.policy = policy
        self.impl = impl
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(dim, dtype=policy.param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=policy.param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps, self.policy,
                          self.impl)


class Embedding(nn.Module):
    """Lookup table; ``attend`` is the tied-softmax head ``x @ E^T``."""

    def __init__(self, num_embeddings: int, features: int,
                 embedding_init=None, policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = _generator(generator, device)
        self.policy = policy
        embedding_init = embedding_init or init_lib.normal(0.02)
        self.embedding = nn.Parameter(embedding_init(
            g, (num_embeddings, features), policy.param_dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # Gather, then cast: the same values as casting the whole table
        # first, without converting every row per call.
        return self.policy.cast_to_compute(self.embedding[ids])

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        table = self.policy.cast_to_compute(self.embedding)
        return self.policy.cast_to_compute(x) @ table.t()


class Dropout(nn.Module):
    """Inverted dropout (``nezha_tpu/nn/layers.py`` ``Dropout``): in
    training each element is kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, else zeroed; the identity at rate 0 or
    in eval mode. The masks come from ``generator`` (a ``torch.Generator``
    on the input's device; the default generator when None), so a seed
    fixes them. They cannot match JAX's threefry bits for the same
    seed."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the output has
    ``ceil(size / stride)`` positions, the padding they need is split low
    ``total // 2``, high the rest. The two sides differ when the total is
    odd (a 3x3 stride-2 conv on 56 px pads (0, 1), the 7x7 stem on 32 px
    (2, 3)), which ``F.conv2d``'s symmetric ``padding`` cannot express."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def resolve_pads(padding, hw: Sequence[int], kernel: Sequence[int],
                 stride: Sequence[int]) -> Pads:
    """``"SAME"``, ``"VALID"``, an int or per-dim ints or (low, high)
    pairs -> ((low_h, high_h), (low_w, high_w))."""
    if padding == "SAME":
        return tuple(same_pads(n, k, s)
                     for n, k, s in zip(hw, kernel, stride))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple((p, p) if isinstance(p, int) else tuple(p)
                 for p in padding)


def _pad_for(x: torch.Tensor, pads: Pads, value: float = 0.0):
    """-> (input, symmetric padding for the op): equal sides go to the
    op's own ``padding``, unequal ones through an explicit ``F.pad``."""
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        return x, (lh, lw)
    return F.pad(x, (lw, hw, lh, hh), value=value), (0, 0)


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2d(nn.Module):
    """2-D convolution over NCHW input, ``weight [O, I/groups, kh, kw]``,
    optional ``bias``, JAX's padding semantics (:func:`resolve_pads`).
    Input and weight are cast to the compute dtype; the product runs in
    cuDNN on the card."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[str, int, tuple] = "SAME", groups: int = 1,
                 use_bias: bool = True, kernel_init=None,
                 policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = _generator(generator, device)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        self.groups = groups
        self.policy = policy
        kernel_init = kernel_init or init_lib.he_normal()
        self.weight = nn.Parameter(kernel_init(
            g, (out_channels, in_channels // groups, *self.kernel_size),
            policy.param_dtype))
        self.bias = (nn.Parameter(init_lib.zeros(g, (out_channels,),
                                                 policy.param_dtype))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = resolve_pads(self.padding, x.shape[2:], self.kernel_size,
                            self.stride)
        x, sym = _pad_for(self.policy.cast_to_compute(x), pads)
        y = F.conv2d(x, self.policy.cast_to_compute(self.weight),
                     stride=self.stride, padding=sym, groups=self.groups)
        if self.bias is not None:
            y = y + self.policy.cast_to_compute(self.bias)[:, None, None]
        return self.policy.cast_output(y)


class BatchNorm(nn.Module):
    """Batch norm over every axis but the channels (axis 1), JAX's
    semantics rather than ``nn.BatchNorm2d``'s:

    - batch statistics in fp32 whatever the input's dtype, the variance
      biased (divided by the count);
    - in training the fp32 buffers ``mean`` and ``var`` become
      ``momentum * old + (1 - momentum) * batch`` (JAX's momentum keeps
      the old value; PyTorch's weighs the new), under ``no_grad`` in the
      forward, where JAX's train step threads the new state; not again
      when a rematerialized block recomputes its forward
      (``nn.remat.recomputing``);
    - in eval mode the buffers stand in for the batch statistics;
    - the output is ``x * scale + shift`` in ``x``'s dtype, ``scale`` and
      ``shift`` formed per channel in fp32 and then cast."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.policy = policy
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(
            num_features, dtype=policy.param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(
            num_features, dtype=policy.param_dtype, device=device))
        self.register_buffer("mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            reduce = (0,) + tuple(range(2, x.dim()))
            var, mean = torch.var_mean(x.float(), dim=reduce, correction=0)
            m = self.momentum
            if not recomputing():   # the forward took this batch in
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        scale = self.scale.float() * torch.rsqrt(var + self.eps)
        shift = self.bias.float() - mean * scale
        per_channel = (-1,) + (1,) * (x.dim() - 2)
        y = torch.addcmul(shift.to(x.dtype).view(per_channel), x,
                          scale.to(x.dtype).view(per_channel))
        return self.policy.cast_output(y)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "SAME") -> torch.Tensor:
    """NCHW max pool; "SAME" pads with -inf, unequal sides included."""
    pads = resolve_pads(padding, x.shape[2:], (window, window),
                        (stride, stride))
    x, sym = _pad_for(x, pads, value=-math.inf)
    return F.max_pool2d(x, window, stride, padding=sym)  # pads with -inf


def avg_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """NCHW average pool; under "SAME" each window divides by the count
    of its elements that lie inside the input."""
    pads = resolve_pads(padding, x.shape[2:], (window, window),
                        (stride, stride))
    if pads == ((0, 0), (0, 0)):
        return F.avg_pool2d(x, window, stride)
    (lh, hh), (lw, hw) = pads

    def window_sums(t):
        return F.avg_pool2d(F.pad(t, (lw, hw, lh, hh)), window, stride,
                            divisor_override=1)

    return window_sums(x) / window_sums(torch.ones_like(x[:1, :1]))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC."""
    return x.mean(dim=(2, 3))
