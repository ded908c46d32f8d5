"""Optimizers over dicts of tensors (counterpart of
``nezha_tpu/optim/optimizers.py``), written out in the JAX formulas.

An optimizer is ``init(params) -> state`` plus ``update(grads, state,
params) -> (updates, new_state)``; ``params`` and ``grads`` are
``{name: tensor}`` dicts (``dict(model.named_parameters())``) and
``updates`` are deltas. :func:`apply_updates_` adds them into the
parameters in place (JAX returns new parameters), which saves the train
step a copy of the weights. Optimizer math
runs in fp32 on the master parameters whatever the forward's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def _as_schedule(lr) -> Callable[[int], float]:
    if callable(lr):
        return lr
    value = float(torch.tensor(lr, dtype=torch.float32))
    return lambda step: value


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]


@torch.no_grad()
def apply_updates_(params: Tree, updates: Tree) -> None:
    """``p += u`` for every parameter, in its own dtype."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


def global_norm(tree: Tree, group=None) -> torch.Tensor:
    """Global L2 norm: the square root of the per-tensor fp32 sums of
    squares, added in the tree's order. ``group`` (JAX's ``axis_name``):
    a ``torch.distributed`` group whose ranks each hold a shard of every
    tensor (ZeRO-1's chunks); the squared sums are all-reduced over it
    first. None: the tree is whole."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


def clip_by_global_norm(tree: Tree, max_norm: float, group=None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale ``tree`` so its global L2 norm is at most ``max_norm``;
    -> (clipped tree, norm before clipping). ``group``: see
    :func:`global_norm`; without it a sharded tree would be clipped
    against its shard's norm, about sqrt(world) times too small."""
    norm = global_norm(tree, group)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {k: x * scale for k, x in tree.items()}, norm


def sgd(lr) -> Optimizer:
    """Plain SGD: the update is ``-lr_t * g`` in fp32."""
    sched = _as_schedule(lr)

    def init(params: Tree) -> dict:
        return {"step": 0}

    def update(grads: Tree, state: dict, params: Tree = None):
        lr_t = sched(state["step"])
        return ({k: -lr_t * g.float() for k, g in grads.items()},
                {"step": state["step"] + 1})

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False,
             weight_decay: float = 0.0) -> Optimizer:
    """SGD with momentum, the ResNet-50/ImageNet optimizer. Weight decay
    is coupled: ``g + weight_decay * p`` on every tensor, norm scales and
    biases included, as in JAX. The fp32 velocity is ``v = beta * v +
    g``; the update ``-lr_t * v`` (Nesterov: ``-lr_t * (g + beta * v)``)
    with ``lr_t`` read from the schedule at the step count before this
    update."""
    sched = _as_schedule(lr)

    def init(params: Tree) -> dict:
        return {"step": 0,
                "velocity": {k: torch.zeros_like(p, dtype=torch.float32)
                             for k, p in params.items()}}

    def update(grads: Tree, state: dict, params: Tree):
        lr_t = sched(state["step"])
        updates, velocity = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            if weight_decay:
                g = g + weight_decay * p.detach().float()
            v = beta * state["velocity"][k] + g
            d = g + beta * v if nesterov else v
            updates[k], velocity[k] = -lr_t * d, v
        return updates, {"step": state["step"] + 1, "velocity": velocity}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01,
          mask: Optional[Callable[[Tree], Dict[str, bool]]] = None
          ) -> Optimizer:
    """AdamW with decoupled weight decay. The learning rate is read from
    the schedule at the step count before this update; the bias
    corrections ``1 - b ** t`` use the count after it. ``mask(params)``
    may return ``{name: bool}`` selecting the tensors that decay."""
    sched = _as_schedule(lr)

    def init(params: Tree) -> dict:
        return {"step": 0,
                "mu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()}}

    def update(grads: Tree, state: dict, params: Tree):
        step = state["step"] + 1
        lr_t = sched(state["step"])
        c1 = float(1.0 - _f32(b1) ** _f32(step))
        c2 = float(1.0 - _f32(b2) ** _f32(step))
        use_wd = mask(params) if mask is not None else None
        updates, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state["mu"][k] + (1 - b1) * g
            v = b2 * state["nu"][k] + (1 - b2) * torch.square(g)
            d = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and (use_wd is None or use_wd[k]):
                d = d + weight_decay * p.detach().float()
            updates[k], mu[k], nu[k] = -lr_t * d, m, v
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def with_grad_clipping(opt: Optimizer, max_norm: float,
                       group=None) -> Optimizer:
    """Clip the gradients to global norm ``max_norm`` before ``opt``.
    Pass ``group`` when ``opt`` runs on per-rank gradient shards
    (ZeRO-1), so the norm is the whole gradient's."""

    def update(grads: Tree, state, params: Tree):
        grads, _ = clip_by_global_norm(grads, max_norm, group)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


def matrix_decay_mask(params: Tree) -> Dict[str, bool]:
    """The GPT-2/BERT weight-decay exclusion: decay only tensors with
    ndim >= 2 (kernels, embeddings), not norm scales and biases."""
    return {k: p.dim() >= 2 for k, p in params.items()}
