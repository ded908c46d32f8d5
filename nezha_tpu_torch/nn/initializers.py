"""Parameter initializers GPT-2, the MLP and the ResNets use (counterpart
of ``nezha_tpu/nn/initializers.py``), driven by an explicit
``torch.Generator`` so a seed fixes every weight.

An initializer is ``init(generator, shape, dtype) -> Tensor``; the tensor
lands on the generator's device. The numbers differ from JAX's for the
same seed (threefry and Philox/mt19937 are different generators): tests
that compare the two packages carry JAX's weights across with
``models.convert.params_from_jax``. The fan-aware initializers read the
port's layouts: ``[in, out]`` for a ``Linear`` kernel, ``[O, I/groups,
kh, kw]`` for a ``Conv2d`` weight (JAX's HWIO fans, transposed).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Initializer = Callable[[torch.Generator, Sequence[int], torch.dtype],
                       torch.Tensor]


def zeros(generator: torch.Generator, shape: Sequence[int],
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=generator.device)


def normal(stddev: float = 0.02) -> Initializer:
    def init(generator: torch.Generator, shape: Sequence[int],
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = torch.randn(tuple(shape), generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (x * stddev).to(dtype)
    return init


def _fan_in(shape: Sequence[int]) -> int:
    if len(shape) == 4:  # conv OIHW: input channels x receptive field
        return math.prod(shape[1:])
    return shape[0]      # linear [in, out]; a vector's own length


def _scaled_normal(gain: float) -> Initializer:
    def init(generator: torch.Generator, shape: Sequence[int],
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        std = math.sqrt(gain / _fan_in(shape))
        return normal(std)(generator, shape, dtype)
    return init


def he_normal() -> Initializer:
    """Kaiming/He normal, std sqrt(2 / fan_in): the ResNets' convs."""
    return _scaled_normal(2.0)


def lecun_normal() -> Initializer:
    """std sqrt(1 / fan_in): the JAX ``Linear``'s default, the MLP's."""
    return _scaled_normal(1.0)
