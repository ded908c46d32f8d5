"""Core layers GPT-2 needs (counterpart of ``nezha_tpu/nn/layers.py``).

Parameter names and layouts follow the JAX package so weights carry
across by name: ``Linear`` stores ``w`` as ``[in, out]`` plus ``b``,
``LayerNorm`` stores ``scale`` and ``bias``, ``Embedding`` stores
``embedding``. Every layer takes a dtype :class:`Policy`: parameters are
kept in the param dtype and cast to the compute dtype at use, and layer
norm statistics stay fp32 whatever the policy. Layers build on the card
unless the caller passes ``device="cpu"`` or a CPU generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nezha_tpu_torch.nn import initializers as init_lib
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
        pol = self.policy
        y = pol.cast_to_compute(x) @ pol.cast_to_compute(self.w)
        if self.b is not None:
            y = y + pol.cast_to_compute(self.b)
        return pol.cast_output(y)


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
        if self.impl == "pallas":
            y = fused_layer_norm(self.policy.cast_to_compute(x),
                                 self.scale.float(), self.bias.float(),
                                 self.eps)
            return self.policy.cast_output(y)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return self.policy.cast_output(y)


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
