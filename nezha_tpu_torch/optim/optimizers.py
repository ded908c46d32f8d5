"""Optimizers over dicts of tensors (counterpart of
``nezha_tpu/optim/optimizers.py``), written out in the JAX formulas.

An optimizer is ``init(params) -> state`` plus ``update(grads, state,
params) -> (updates, new_state)``; ``params`` and ``grads`` are
``{name: tensor}`` dicts (``dict(model.named_parameters())``) and
``updates`` are deltas. :func:`apply_updates_` adds them into the
parameters in place (JAX returns new parameters), which saves the train
step a copy of the weights. Optimizer math
runs in fp32 on the master parameters whatever the forward's dtype.

A state is a dict whose leaves are tensors and Python int counters
(``step``, ``count``), nested where JAX's is (``accumulate_gradients``'s
``inner``, Adafactor's ``slots``); a per-parameter dict is keyed by the
parameter's name. :func:`state_leaves` walks it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

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
    """``elementwise``: each tensor's update depends on that tensor's
    elements one by one (and on global scalars), so a tensor cut into
    pieces updates piece by piece with the same result; False where
    statistics span a whole tensor (LARS's and LAMB's trust ratios,
    Adafactor's factored moments)."""
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]
    elementwise: bool = True


def state_leaves(state: dict, path: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """Every leaf of an optimizer state with its path of keys, in the
    state's order: tensors, and Python ints for the counters."""
    for key, val in state.items():
        if isinstance(val, dict):
            yield from state_leaves(val, path + (key,))
        else:
            yield path + (key,), val


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
    first. None: the tree is whole. Tensors on several devices (a
    tensor-parallel step's shards) are summed on the first one's."""
    dev = next(iter(tree.values())).device
    sq = sum(torch.sum(torch.square(x.float())).to(dev)
             for x in tree.values())
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


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of all of ``x``'s elements (JAX's
    ``jnp.linalg.norm(x.reshape(-1))``)."""
    return torch.sqrt(torch.sum(torch.square(x)))


def _trust(num: torch.Tensor, den: torch.Tensor,
           ratio: torch.Tensor) -> torch.Tensor:
    """``ratio`` where both norms are positive, else 1."""
    return torch.where((num > 0) & (den > 0), ratio, torch.ones_like(ratio))


def lars(lr, beta: float = 0.9, weight_decay: float = 0.0,
         trust_coefficient: float = 0.001, eps: float = 1e-9,
         skip_fn: Optional[Callable[[Tree], Dict[str, bool]]] = None
         ) -> Optimizer:
    """LARS: layerwise-adaptive SGD with momentum for large-batch CNN
    training. Each tensor's step is scaled by ``trust_coefficient *
    |p| / (|g| + eps)``, with the coupled weight decay inside ``g``;
    ``skip_fn(params)`` may return ``{name: True}`` for the tensors
    (biases, norm scales) that take plain momentum without decay."""
    sched = _as_schedule(lr)

    def init(params: Tree) -> dict:
        return {"step": 0,
                "velocity": {k: torch.zeros_like(p, dtype=torch.float32)
                             for k, p in params.items()}}

    def update(grads: Tree, state: dict, params: Tree):
        lr_t = sched(state["step"])
        skip = skip_fn(params) if skip_fn is not None else {}
        updates, velocity = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            plain = skip.get(k, False)
            if weight_decay and not plain:
                g = g + weight_decay * p.detach().float()
            if plain:
                v = beta * state["velocity"][k] + g
            else:
                p_norm, g_norm = _norm(p.detach().float()), _norm(g)
                trust = _trust(p_norm, g_norm, trust_coefficient * p_norm
                               / (g_norm + eps))
                v = beta * state["velocity"][k] + trust * g
            updates[k], velocity[k] = -lr_t * v, v
        return updates, {"step": state["step"] + 1, "velocity": velocity}

    return Optimizer(init, update, elementwise=False)


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01,
         mask: Optional[Callable[[Tree], Dict[str, bool]]] = None
         ) -> Optimizer:
    """LAMB: layerwise-adaptive AdamW for large-batch transformer
    pretraining. The AdamW direction (decoupled decay, on the tensors
    ``mask`` selects) is scaled by ``|p| / |d|`` per tensor."""
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
            p32 = p.detach().float()
            m = b1 * state["mu"][k] + (1 - b1) * g
            v = b2 * state["nu"][k] + (1 - b2) * torch.square(g)
            d = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and (use_wd is None or use_wd[k]):
                d = d + weight_decay * p32
            p_norm, d_norm = _norm(p32), _norm(d)
            trust = _trust(p_norm, d_norm, p_norm / d_norm)
            updates[k], mu[k], nu[k] = -lr_t * trust * d, m, v
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update, elementwise=False)


def _jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A 4-D tensor, a conv kernel in the port's OIHW, as JAX's HWIO;
    any other tensor as it is."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def _port_layout(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_jax_layout`."""
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Adafactor: a factored second moment and no first moment, so the
    state of an ``[m, n]`` matrix is ``m + n`` floats. Every tensor of two
    or more dimensions is factored over its last two axes in JAX's layout:
    a conv kernel (OIHW here) as HWIO, its ``vr`` over H, W and I and its
    ``vc`` over H, W and O, so the state is JAX's leaf for leaf. The
    decay follows ``1 - step ** -decay``; each update's RMS is clipped to
    ``clip_threshold``."""
    sched = _as_schedule(lr)

    def init(params: Tree) -> dict:
        slots = {}
        for k, p in params.items():
            shape = _jax_layout(p).shape
            if len(shape) >= 2:
                slots[k] = {"vr": p.new_zeros(shape[:-1],
                                              dtype=torch.float32),
                            "vc": p.new_zeros(shape[:-2] + shape[-1:],
                                              dtype=torch.float32)}
            else:
                slots[k] = {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"step": 0, "slots": slots}

    def update(grads: Tree, state: dict, params: Tree):
        step = state["step"] + 1
        lr_t = sched(state["step"])
        beta = 1.0 - _f32(step) ** -decay
        rest = 1.0 - beta
        updates, slots = {}, {}
        for k, p in params.items():
            g = _jax_layout(grads[k].float())
            slot = state["slots"][k]
            g2 = torch.square(g) + eps
            if g.dim() >= 2:
                vr = beta * slot["vr"] + rest * g2.mean(dim=-1)
                vc = beta * slot["vc"] + rest * g2.mean(dim=-2)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                d = g / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc)[..., None, :])
                slots[k] = {"vr": vr, "vc": vc}
            else:
                v = beta * slot["v"] + rest * g2
                d = g / torch.sqrt(v)
                slots[k] = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(d)))
            d = d / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                d = d + weight_decay * _jax_layout(p.detach().float())
            updates[k] = _port_layout(-lr_t * d)
        return updates, {"step": step, "slots": slots}

    return Optimizer(init, update, elementwise=False)


def accumulate_gradients(opt: Optimizer, every: int) -> Optimizer:
    """Gradient accumulation: the mean of ``every`` micro-steps' fp32
    gradients goes to ``opt`` once; the updates in between are zeros. The
    effective batch is the micro-batch times ``every``, at a constant
    memory. The state is JAX's ``{"inner", "acc", "count"}``."""
    if every < 1:
        raise ValueError("every must be >= 1")
    if every == 1:
        return opt

    def init(params: Tree) -> dict:
        return {"inner": opt.init(params),
                "acc": {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()},
                "count": 0}

    def update(grads: Tree, state: dict, params: Tree):
        acc = {k: a + grads[k].float() for k, a in state["acc"].items()}
        count = state["count"] + 1
        if count >= every:
            updates, inner = opt.update({k: a / every for k, a in
                                         acc.items()}, state["inner"],
                                        params)
            return updates, {"inner": inner,
                             "acc": {k: torch.zeros_like(a)
                                     for k, a in acc.items()},
                             "count": 0}
        return ({k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()},
                {"inner": state["inner"], "acc": acc, "count": count})

    return Optimizer(init, update, opt.elementwise)


def with_grad_clipping(opt: Optimizer, max_norm: float,
                       group=None) -> Optimizer:
    """Clip the gradients to global norm ``max_norm`` before ``opt``.
    Pass ``group`` when ``opt`` runs on per-rank gradient shards
    (ZeRO-1), so the norm is the whole gradient's."""

    def update(grads: Tree, state, params: Tree):
        grads, _ = clip_by_global_norm(grads, max_norm, group)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update, opt.elementwise)


def matrix_decay_mask(params: Tree) -> Dict[str, bool]:
    """The GPT-2/BERT weight-decay exclusion: decay only tensors with
    ndim >= 2 (kernels, embeddings), not norm scales and biases."""
    return {k: p.dim() >= 2 for k, p in params.items()}
