"""ZeRO-1: the optimizer state sharded over the data-parallel group
(counterpart of ``nezha_tpu/parallel/zero1.py``; BASELINE.json's "BERT-
base with grad reduce-scatter + weight all-gather").

Each rank holds the whole weights and 1/world of the optimizer state. A
step:

1. the local forward and backward give whole gradients;
2. each gradient, flattened and zero-padded to a multiple of the world
   size, is reduce-scattered: rank r keeps the mean of chunk r (one
   ``reduce_scatter`` for all exact leaves, or the int8 wire for leaves
   of at least ``quant_min_numel`` elements);
3. the optimizer updates this rank's chunk of every weight, against its
   chunk of the state;
4. the update chunks are all-gathered, cut to each weight's size and
   added in place.

Weights are flattened in the JAX package's layout (a conv kernel in HWIO,
not the port's OIHW), so a rank's chunk covers the elements it covers in
JAX and the per-shard checkpoints of either package restore in the
other. Each element's update is the single-device formula on the mean
gradient; only a global-norm clip's sum (over the chunks, then the
ranks) is added in another order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from nezha_tpu_torch import obs
from nezha_tpu_torch.optim.optimizers import (Optimizer, apply_updates_,
                                              state_leaves)
from nezha_tpu_torch.parallel.collectives import (_all_gather,
                                                  _all_reduce_mean, _divide,
                                                  _reduce_scatter)
from nezha_tpu_torch.parallel.data_parallel import (check_grad_reduce,
                                                    state_buffers)
from nezha_tpu_torch.parallel.quantized import (DEFAULT_MIN_NUMEL,
                                                all_gather_many,
                                                reduce_scatter_mean_many,
                                                should_quantize,
                                                wire_payload_bytes)
from nezha_tpu_torch.train.loop import TrainStep

Tree = Dict[str, torch.Tensor]


def _padded_size(n: int, world: int) -> int:
    return math.ceil(n / world) * world


def _flat_pad(x: torch.Tensor, world: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, _padded_size(flat.numel(), world) - flat.numel()))


def to_jax_layout(t: torch.Tensor, conv: bool) -> torch.Tensor:
    """A port tensor in the JAX package's layout (OIHW -> HWIO)."""
    return t.permute(2, 3, 1, 0) if conv else t


def from_jax_layout(flat: torch.Tensor, like: torch.Tensor,
                    conv: bool) -> torch.Tensor:
    """The inverse of :func:`to_jax_layout` on a flat tensor."""
    if conv:
        o, i, h, w = like.shape
        return flat.reshape(h, w, i, o).permute(3, 2, 0, 1)
    return flat.reshape(like.shape)


def zero1_init_opt_state(optimizer: Optimizer, params: Tree, world: int,
                         rank: int, conv: Dict[str, bool] = None):
    """The optimizer's state over this rank's chunk of every parameter:
    fp32, flattened in JAX's layout, padded to a multiple of ``world``;
    each slot tensor holds ``padded / world`` elements."""
    conv = conv or {}
    return optimizer.init(param_chunks(params, world, rank, conv))


@torch.no_grad()
def param_chunks(params: Tree, world: int, rank: int,
                 conv: Dict[str, bool]) -> Tree:
    out = {}
    for k, p in params.items():
        flat = _flat_pad(to_jax_layout(p.float(), conv.get(k, False)), world)
        c = flat.numel() // world
        out[k] = flat[rank * c:(rank + 1) * c]
    return out


class Zero1TrainStep(TrainStep):
    """``step(batch) -> {"loss"}`` with the optimizer state sharded over
    the group; see the module. The loss and BatchNorm buffers are the
    group's exact mean, as in :class:`~.data_parallel.DPTrainStep`.
    ``grad_reduce="int8"`` puts both collectives of the leaves of at
    least ``quant_min_numel`` elements on the int8 wire."""

    sharded = True

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, group=None, grad_reduce: str = "fp32",
                 quant_min_numel: int = DEFAULT_MIN_NUMEL):
        check_grad_reduce(grad_reduce)
        from nezha_tpu_torch.models.convert import jax_leaf_names
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.params = dict(model.named_parameters())
        self.device = next(model.parameters()).device
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.grad_reduce = grad_reduce
        self.quant_min_numel = quant_min_numel
        names = jax_leaf_names(model)
        self.jax_keys = {k: names[k][0] for k in self.params}
        self.conv = {k: names[k][1] for k in self.params}
        self.buffers = state_buffers(model)
        self.opt_state = zero1_init_opt_state(optimizer, self.params,
                                              self.world, self.rank,
                                              self.conv)

    def _quantized(self, k: str) -> bool:
        return (self.grad_reduce == "int8"
                and should_quantize(self.params[k], self.quant_min_numel))

    def _record_payloads(self, quant) -> None:
        """Count the step's collectives as JAX's ZeRO-1 step does: one
        record an op, each leaf's chunk ``ceil(numel / world)`` (the
        world-padded flat), fp32 on the exact path and the wire's width
        on the int8 one; the loss and buffers' mean is not counted."""
        w = self.world
        chunks_q = [-(-self.params[k].numel() // w) for k in quant]
        chunks_e = [-(-p.numel() // w) for k, p in self.params.items()
                    if k not in quant]
        for op, payload in (
                ("reduce_scatter", sum(c * w * 4 for c in chunks_e)),
                ("reduce_scatter_int8",
                 sum(w * wire_payload_bytes(c) for c in chunks_q)),
                ("all_gather", sum(c * 4 for c in chunks_e)),
                ("all_gather_int8",
                 sum(wire_payload_bytes(c) for c in chunks_q))):
            if payload:
                obs.record_collective(op, payload)

    def __call__(self, batch: dict) -> Dict[str, torch.Tensor]:
        loss, grads = self.loss_and_grads(batch)
        extras = _all_reduce_mean({"loss": loss, **{
            ("b", k): b for k, b in self.buffers.items()}}, self.group)
        with torch.no_grad():
            for k, b in self.buffers.items():
                b.copy_(extras[("b", k)])
        flats = {k: _flat_pad(to_jax_layout(g.float(), self.conv[k]),
                              self.world) for k, g in grads.items()}
        quant = [k for k in flats if self._quantized(k)]
        if obs.enabled():
            self._record_payloads(quant)
        exact = {k: f for k, f in flats.items() if k not in quant}
        chunks = {k: _divide(c, self.world) for k, c in
                  (_reduce_scatter(exact, self.group) if exact else
                   {}).items()}
        if quant:
            chunks.update(zip(quant, reduce_scatter_mean_many(
                [flats[k] for k in quant], self.group)))
        grad_chunks = {k: chunks[k] for k in grads}
        update_chunks, self.opt_state = self.optimizer.update(
            grad_chunks, self.opt_state,
            param_chunks(self.params, self.world, self.rank, self.conv))
        full = {}
        ex = {k: u for k, u in update_chunks.items() if k not in quant}
        if ex:
            full.update(_all_gather(ex, self.group))
        if quant:
            full.update(zip(quant, all_gather_many(
                [update_chunks[k] for k in quant], self.group)))
        updates = {k: from_jax_layout(full[k][:p.numel()], p, self.conv[k])
                   for k, p in self.params.items()}
        apply_updates_(self.params, updates)
        return {"loss": extras["loss"]}

    # ------------------------------------------------ per-shard state
    def _state_keys(self):
        """Each optimizer-state leaf: (path, its JAX checkpoint key, the
        parameter whose chunk it holds, or None for a replicated
        counter)."""
        from nezha_tpu_torch.models.convert import jax_leaf_names, \
            opt_state_key
        names = jax_leaf_names(self.model)
        for path, leaf in state_leaves(self.opt_state):
            param = next((p for p in reversed(path) if p in self.params),
                         None) if torch.is_tensor(leaf) else None
            yield path, opt_state_key(path, names), param

    def state_chunks(self) -> Dict[str, torch.Tensor]:
        """This rank's chunk of every tensor of the optimizer state (the
        moments, a velocity, an accumulator), by JAX checkpoint key."""
        out = {}
        for path, key, param in self._state_keys():
            if param is not None:
                node = self.opt_state
                for k in path:
                    node = node[k]
                out[key] = node
        return out

    def _bounds(self, k: str) -> Tuple[int, int, int]:
        """(padded size, start, stop) of this rank's chunk of ``k``."""
        padded = _padded_size(self.params[k].numel(), self.world)
        c = padded // self.world
        return padded, self.rank * c, (self.rank + 1) * c

    def shard_leaves(self, rng) -> Dict[str, "ShardedLeaf"]:
        """This rank's leaves of the JAX ZeRO-1 train state, as host
        copies: the replicated ones (variables, the optimizer's counters,
        ``rng``) whole on rank 0 and listed without shards elsewhere, and
        this rank's chunk of every optimizer-state tensor."""
        from nezha_tpu_torch.models.convert import (jax_variable_shapes,
                                                    train_state_to_jax)
        from nezha_tpu_torch.train.sharded_checkpoint import (ShardedLeaf,
                                                              host_array,
                                                              whole)
        if self.rank == 0:
            out = {k: whole(a) for k, a in
                   train_state_to_jax(self.model, rng=rng).items()}
        else:
            out = {k: ShardedLeaf(shape, "float32")
                   for k, shape in jax_variable_shapes(self.model).items()}
            out["rng"] = ShardedLeaf((2,), "uint32")
        chunks = self.state_chunks()
        for path, key, param in self._state_keys():
            if param is None:
                node = self.opt_state
                for k in path:
                    node = node[k]
                out[key] = (whole(np.asarray(int(node), np.int32))
                            if self.rank == 0 else ShardedLeaf((), "int32"))
                continue
            padded, a, b = self._bounds(param)
            arr, dt = host_array(chunks[key])
            out[key] = ShardedLeaf((padded,), dt, [(((a, b),), arr)])
        return out

    def restore_request(self):
        """What this rank reads back: every variable whole, the key, the
        optimizer's counters, and its chunk of every optimizer-state
        tensor (``restore_sharded``'s template)."""
        from nezha_tpu_torch.models.convert import jax_variable_shapes
        req = {k: (shape, None)
               for k, shape in jax_variable_shapes(self.model).items()}
        req["rng"] = ((2,), None)
        for _, key, param in self._state_keys():
            if param is None:
                req[key] = ((), None)
            else:
                padded, a, b = self._bounds(param)
                req[key] = ((padded,), ((a, b),))
        return req

    def load_restored(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install a restore of :meth:`restore_request`: the variables
        whole into the model, the optimizer state's chunks."""
        from nezha_tpu_torch.models.convert import load_train_state
        load_train_state({k: a for k, a in arrays.items()
                          if k.startswith("variables/")}, self.model)
        self.load_chunks({k: a for k, a in arrays.items()
                          if k.startswith("opt_state/")})

    @torch.no_grad()
    def load_chunks(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install restored optimizer state: ``arrays`` maps each key of
        :meth:`restore_request` under ``opt_state/`` to this rank's chunk
        of a tensor, or to a counter."""
        keys = {path: (key, param) for path, key, param in
                self._state_keys()}

        def fill(node: dict, path: Tuple[str, ...]) -> dict:
            out = {}
            for k, like in node.items():
                at = path + (k,)
                if isinstance(like, dict):
                    out[k] = fill(like, at)
                    continue
                key, param = keys[at]
                out[k] = (int(np.asarray(arrays[key])) if param is None
                          else torch.from_numpy(np.ascontiguousarray(
                              arrays[key], np.float32)).to(like.device))
            return out

        self.opt_state = fill(self.opt_state, ())
