"""Mixed-precision dtype policies (counterpart of ``nezha_tpu/tensor/policy.py``).

Parameters live in fp32 (the master copy), compute runs in the policy's
compute dtype (bf16 for the full-size models, so products run on the
tensor cores), and normalization statistics stay fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """What dtype each class of value uses.

    - ``param_dtype``: storage dtype of parameters (master copy).
    - ``compute_dtype``: dtype activations and weights are cast to for
      the math.
    - ``output_dtype``: dtype of layer outputs (None: the compute dtype).
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: Optional[torch.dtype] = None

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype or self.compute_dtype)


def f32_policy() -> Policy:
    return Policy(torch.float32, torch.float32)


def bf16_policy() -> Policy:
    """fp32 master params, bf16 compute."""
    return Policy(torch.float32, torch.bfloat16)


DEFAULT_POLICY = f32_policy()
