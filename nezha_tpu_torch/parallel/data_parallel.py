"""Data parallelism over a ``torch.distributed`` group (counterpart of
``nezha_tpu/parallel/data_parallel.py``).

One process per device, each holding a whole copy of the weights and the
optimizer state, and its own rows of the global batch. A step is the
single-device step with one reduction between the backward and the
update: the gradients' mean over the group (fp32, or the int8 wire of
:mod:`.quantized` for leaves of at least ``min_numel`` elements), the
loss's mean, and the mean of the BatchNorm buffers as the forward left
them (JAX pmeans ``new_state``). The exact leaves travel in one bucket.
On one rank the mean is a copy, so the weights are bitwise those of the
single-device step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from nezha_tpu_torch import obs
from nezha_tpu_torch.optim.optimizers import Optimizer
from nezha_tpu_torch.parallel.collectives import _all_reduce_mean, tree_bytes
from nezha_tpu_torch.parallel.quantized import (DEFAULT_MIN_NUMEL,
                                                all_reduce_mean_many,
                                                should_quantize,
                                                wire_payload_bytes)
from nezha_tpu_torch.train.loop import TrainStep

GRAD_REDUCE = ("fp32", "int8")


def check_grad_reduce(grad_reduce: str) -> None:
    if grad_reduce not in GRAD_REDUCE:
        raise ValueError(f"grad_reduce must be fp32|int8, got "
                         f"{grad_reduce!r}")


def state_buffers(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The buffers of JAX's state tree (BatchNorm's ``mean`` and
    ``var``), by ``state_dict`` name."""
    from nezha_tpu_torch.models.convert import jax_leaf_names
    sd = model.state_dict(keep_vars=True)
    return {n: sd[n] for n, (key, _) in jax_leaf_names(model).items()
            if key.startswith("state/")}


def local_rows(batch: dict, rank: int, world: int) -> dict:
    """Rows ``[rank * B / world, (rank + 1) * B / world)`` of a global
    batch: this rank's share (JAX's ``shard_batch``). A loader that
    reads a disjoint shard yields local rows already (JAX's
    ``shard_batch_process_local``), which the step takes as they are."""
    local = len(next(iter(batch.values()))) // world
    return {k: v[rank * local:(rank + 1) * local] for k, v in batch.items()}


@torch.no_grad()
def replicate(model: torch.nn.Module, group=None, src: int = 0) -> None:
    """Make every rank's weights and buffers rank ``src``'s: one
    broadcast for each dtype."""
    tensors = [t for t in model.state_dict(keep_vars=True).values()]
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src, group=group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def mean_over_group(grads: Dict[str, torch.Tensor], extras: Dict[str, Any],
                    group, grad_reduce: str, min_numel: int):
    """-> (mean gradients, mean extras). Gradients of at least
    ``min_numel`` float elements take the int8 wire under ``int8``;
    the rest, and ``extras`` (the loss, BatchNorm buffers), travel exact
    in one bucket. Counts the gradients' payload as JAX's dp step does:
    one ``all_reduce`` of the exact gradients, one ``all_reduce_int8``
    of the others at the wire's width; the extras are not counted."""
    quant = {k: g for k, g in grads.items()
             if grad_reduce == "int8" and should_quantize(g, min_numel)}
    exact = {("g", k): g for k, g in grads.items() if k not in quant}
    if obs.enabled():
        if quant:
            obs.record_collective("all_reduce_int8", sum(
                wire_payload_bytes(g.numel()) for g in quant.values()))
        if exact:
            obs.record_collective("all_reduce", tree_bytes(exact))
    exact.update({("x", k): v for k, v in extras.items()})
    out = _all_reduce_mean(exact, group) if exact else {}
    if quant:
        quant = dict(zip(quant, all_reduce_mean_many(list(quant.values()),
                                                     group)))
    mean = {k: quant[k] if k in quant else out[("g", k)] for k in grads}
    return mean, {k: out[("x", k)] for k in extras}


class DPTrainStep(TrainStep):
    """``step(batch) -> {"loss"}`` on this rank's rows: the forward and
    backward, the group's mean of the gradients, the loss and the
    BatchNorm buffers, then the optimizer update, identical on every
    rank. ``grad_reduce="int8"`` puts the gradients of at least
    ``min_numel`` elements on the int8 wire; the loss and buffers stay
    exact."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, group=None, grad_reduce: str = "fp32",
                 min_numel: int = DEFAULT_MIN_NUMEL):
        check_grad_reduce(grad_reduce)
        super().__init__(model, optimizer, loss_fn)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.grad_reduce = grad_reduce
        self.min_numel = min_numel
        self.buffers = state_buffers(model)

    def __call__(self, batch: dict) -> Dict[str, torch.Tensor]:
        loss, grads = self.loss_and_grads(batch)
        grads, extras = mean_over_group(
            grads, {"loss": loss, **{("b", k): b for k, b in
                                     self.buffers.items()}},
            self.group, self.grad_reduce, self.min_numel)
        with torch.no_grad():
            for k, b in self.buffers.items():
                b.copy_(extras[("b", k)])
        self.apply_gradients(grads)
        return {"loss": extras["loss"]}


def sync_batch_stats(stacked_state: Optional[dict]) -> dict:
    """Mean over the leading (replica) axis of per-replica BatchNorm
    statistics stacked ``[replicas, ...]``, for custom steps that keep
    them apart; the dp and ZeRO-1 steps average them every step."""
    return {k: s.float().mean(dim=0) for k, s in (stacked_state or {}).items()}
