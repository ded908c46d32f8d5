"""The 3-layer MLP of the ``mlp_mnist`` config (counterpart of
``nezha_tpu/models/mlp.py``): ``fc{i}`` Linears with a ReLU after each,
then ``head``; kernels LeCun-normal, biases zero, as in JAX."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.nn.layers import Linear, _generator
from nezha_tpu_torch.ops.activations import relu
from nezha_tpu_torch.tensor.policy import DEFAULT_POLICY, Policy


class MLP(nn.Module):
    def __init__(self, in_features: int = 784,
                 hidden: Sequence[int] = (256, 256), num_classes: int = 10,
                 policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = _generator(generator, device)
        dims = [in_features, *hidden]
        self.n_hidden = len(hidden)
        for i in range(self.n_hidden):
            setattr(self, f"fc{i}", Linear(
                dims[i], dims[i + 1], kernel_init=init_lib.lecun_normal(),
                policy=policy, generator=g))
        self.head = Linear(dims[-1], num_classes,
                           kernel_init=init_lib.lecun_normal(),
                           policy=policy, generator=g)

    def forward(self, batch) -> torch.Tensor:
        x = batch["image"] if isinstance(batch, dict) else batch
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_hidden):
            x = relu(getattr(self, f"fc{i}")(x))
        return self.head(x)
