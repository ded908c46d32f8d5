"""Core layers GPT-2 needs (counterpart of ``nezha_tpu/nn/layers.py``).

Parameter names and layouts follow the JAX package so weights carry
across by name: ``Linear`` stores ``w`` as ``[in, out]`` plus ``b``,
``LayerNorm`` stores ``scale`` and ``bias``, ``Embedding`` stores
``embedding``. Every layer takes a dtype :class:`Policy`: parameters are
kept in the param dtype and cast to the compute dtype at use, and layer
norm statistics stay fp32 whatever the policy.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.tensor.policy import DEFAULT_POLICY, Policy


def _generator(generator: Optional[torch.Generator],
               device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device or "cpu")


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
    """Layer norm over the last axis with fp32 statistics (the ``xla``
    path of the JAX layer: mean, biased variance, ``rsqrt(var + eps)``),
    output cast to the policy's output dtype."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.eps = eps
        self.policy = policy
        self.scale = nn.Parameter(torch.ones(dim, dtype=policy.param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=policy.param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
