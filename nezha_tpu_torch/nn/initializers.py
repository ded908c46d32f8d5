"""Parameter initializers GPT-2 uses (counterpart of
``nezha_tpu/nn/initializers.py``), driven by an explicit
``torch.Generator`` so a seed fixes every weight.

An initializer is ``init(generator, shape, dtype) -> Tensor``; the tensor
lands on the generator's device. The numbers differ from JAX's for the
same seed (threefry and Philox/mt19937 are different generators): tests
that compare the two packages carry JAX's weights across with
``models.convert.params_from_jax``.
"""

from __future__ import annotations

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
