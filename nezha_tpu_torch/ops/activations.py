"""Elementwise activations (counterpart of ``nezha_tpu/ops/activations.py``)."""

from __future__ import annotations

import math

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` as JAX's ``jnp.maximum(x, 0)``: where ``x`` is
    exactly 0 the gradient is split, half to ``x`` (``torch.maximum``'s
    rule; ``torch.relu`` passes none). That happens at every zero a
    residual adds to a zero-initialized branch."""
    return torch.maximum(x, x.new_zeros(()))


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GPT-2 uses the tanh approximation; computed in ``x``'s dtype, as
    the JAX version is."""
    if approximate:
        c = math.sqrt(2.0 / math.pi)
        return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
