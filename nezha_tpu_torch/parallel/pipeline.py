"""Pipeline parallelism: the GPipe microbatch schedule over a ``pp`` axis
(counterpart of ``nezha_tpu/parallel/pipeline.py``).

JAX's schedule is one SPMD program: a scan over ``M + P - 1`` ticks inside
``shard_map``, where every stage applies its slab of layers each tick
(the bubble ticks compute values that are masked away), ``ppermute``
hands the activations on, and a masked ``psum`` gives every rank the last
stage's outputs; ``jax.grad`` runs the reverse schedule. One process
drives the port's schedule from the host, tick by tick: at tick t stage s
runs microbatch ``t - s`` when there is one (the bubble applications,
which change nothing, are skipped), a microbatch moves to the next
stage's device with ``.to(...)``, and the last stage's outputs are
concatenated. Autograd runs the reverse schedule.

- The block parameters are stacked along a leading layer axis and cut
  into P contiguous slabs, one a stage, on the stage's device; the
  optimizer's leaves are the slabs (``blocks.<name>@<s>``, as
  :func:`~nezha_tpu_torch.parallel.gspmd.shard_key`), its slots
  following them. The outer parameters (the embeddings, ``ln_f``, the
  tied head) are the model's own, on stage 0's device, which must be the
  model's.
- An elementwise optimizer (SGD, momentum, AdamW, accumulation, the
  global-norm clip) updates each slab with its own state, which equals
  JAX's update of the stacked leaf. LARS's and LAMB's trust ratios and
  Adafactor's statistics span the whole stacked leaf, across stages: for
  those (``Optimizer.elementwise`` False) the step gathers the slabs to
  stage 0's device and updates the stacked leaves, as JAX does, with the
  state kept stacked there.
- A ``dp`` axis is D groups sharing the leaves, as in the port's gspmd:
  each group's rows run the schedule, the gradients add up in the shared
  leaves, the loss is the whole batch's. A group's devices repeat group
  0's; dp groups on other cards need a process each (ROADMAP A7).
- Dropout: the masks follow the port's own stream (ROADMAP C6), not
  JAX's folded keys. Each block application reseeds its stage's
  generator from (the step's dropout seed, the layer's global index, the
  microbatch, the dp group), so the masks are independent across them
  and the recompute of ``remat`` replays them.
- ``remat`` checkpoints each stage application of a microbatch (JAX's
  per-tick ``jax.checkpoint`` of the stage): its activations are
  recomputed in the backward.

A save (:meth:`PipelineTrainStep.shard_leaves`) writes JAX's pipeline
state keys, ``pparams/{outer,blocks}/...``, ``opt_state/...`` and
``rng``, the stacked layer axis split pp ways, so JAX's
``restore_sharded`` reads a port save and the port resumes from JAX's.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from nezha_tpu_torch.nn.layers import Dropout
from nezha_tpu_torch.nn.remat import checkpoint
from nezha_tpu_torch.optim.optimizers import (Optimizer, apply_updates_,
                                              state_leaves)
from nezha_tpu_torch.parallel.mesh import (_indexed, check_groups_repeat,
                                           device_scope, group_mesh)
from nezha_tpu_torch.train.loop import TrainStep, batch_to_device, grads_of

Params = Dict[str, torch.Tensor]


class PipelineSpec(NamedTuple):
    """How to pipeline a model of shape embed -> N identical blocks ->
    head, over ``{name: tensor}`` parameter dicts:

    - ``embed_fn(outer, batch, rng=None) -> x``: before the pipeline
      (``rng``, an int seed or None, draws the embedding dropout);
    - ``block_fn(block_params, x, rng=None) -> x``: ONE block, on the
      device of ``x``; ``rng`` is unique per (layer, microbatch, dp
      group);
    - ``head_fn(outer, x) -> out``: after the pipeline;
    - ``split(params) -> (outer, [block_params, ...])`` and
      ``merge(outer, blocks) -> params``: the model's names <-> the
      pipelined layout (block names relative to their block).
    """

    embed_fn: Callable
    block_fn: Callable
    head_fn: Callable
    split: Callable[[Params], Tuple[Params, List[Params]]]
    merge: Callable[[Params, List[Params]], Params]
    dropout: float = 0.0
    remat: bool = False


def stack_block_params(blocks: List[Params]) -> Params:
    """Per-layer dicts -> leading-axis stacks ``[L, ...]``."""
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def unstack_block_params(stacked: Params) -> List[Params]:
    n = next(iter(stacked.values())).shape[0]
    return [{k: t[i] for k, t in stacked.items()} for i in range(n)]


def merge_pipeline_params(spec: PipelineSpec, pparams: Dict[str, Params]
                          ) -> Params:
    """``{"outer", "blocks"}`` (stacked) -> the model's parameter dict."""
    return spec.merge(pparams["outer"],
                      unstack_block_params(pparams["blocks"]))


def mask_seed(seed: int, *ids: int) -> int:
    """A dropout seed for ``ids`` (layer, microbatch, dp group, ...)
    under a step's ``seed``."""
    h = hashlib.sha256(b"".join(int(v).to_bytes(8, "little", signed=True)
                                for v in (seed,) + ids))
    return int.from_bytes(h.digest()[:8], "little") & (2 ** 63 - 1)


# ------------------------------------------------------------- the mesh
@dataclasses.dataclass(frozen=True)
class PipelineMesh:
    """``dp`` groups of ``pp`` stages: group g's stage s is
    ``devices[g * pp + s]``."""

    devices: Tuple[torch.device, ...]
    dp: int
    pp: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "pp": self.pp}

    def stages(self, g: int = 0) -> Tuple[torch.device, ...]:
        return self.devices[g * self.pp:(g + 1) * self.pp]


def make_pipeline_mesh(axes: Dict[str, int], devices=None,
                       device_type: str = "cuda") -> PipelineMesh:
    """The ``{"dp": D, "pp": P}`` mesh on ``devices`` (None: the visible
    cards on ``cuda``, the CPU repeated on ``cpu``); ``pp=-1`` takes the
    visible cards left to each dp group. A dp group on other devices than
    group 0's raises :class:`NotPortedError` (ROADMAP A7)."""
    sizes, devs = group_mesh(axes, ("pp",), "pipeline", devices,
                             device_type)
    mesh = PipelineMesh(tuple(devs), sizes["dp"], sizes["pp"])
    check_groups_repeat([mesh.stages(g) for g in range(mesh.dp)],
                        "pipeline")
    return mesh


# ---------------------------------------------------------- GPT-2 spec
def gpt2_pipeline_spec(model) -> PipelineSpec:
    """The :class:`PipelineSpec` of ``nezha_tpu_torch.models.gpt2.GPT2``
    (the JAX adapter's). A dropout > 0 model needs a step built with
    ``dropout_rng=True``."""
    cfg = model.cfg
    if cfg.moe_experts:
        raise ValueError("gpt2_pipeline_spec cannot pipeline MoE blocks "
                         "(heterogeneous stage slabs)")
    pat = re.compile(r"^h\.(\d+)\.(.+)$")
    templates: Dict[torch.device, Tuple[torch.nn.Module, Any]] = {}

    def template(dev: torch.device):
        """Block 0's modules with a dropout generator on ``dev`` (their
        parameters are replaced at every call)."""
        if dev not in templates:
            gen = torch.Generator(device=dev)

            def clone(mod):
                new = copy.copy(mod)
                new._modules = {k: clone(c) for k, c in mod._modules.items()}
                if isinstance(new, Dropout):
                    new.generator = gen
                return new
            templates[dev] = (clone(model.h[0]), gen)
        return templates[dev]

    def sub(params: Params, prefix: str) -> Params:
        return {k[len(prefix):]: v for k, v in params.items()
                if k.startswith(prefix)}

    def embed_fn(outer, batch, rng=None):
        tokens = batch["tokens"][:, :-1] if isinstance(batch, dict) \
            else batch
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = (functional_call(model.wte, sub(outer, "wte."), (tokens,))
             + functional_call(model.wpe, sub(outer, "wpe."), (pos,)))
        if rng is not None and cfg.dropout:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(rng)
            drop = Dropout(cfg.dropout, gen)
            x = drop(x)
        return x

    def block_fn(block_params, x, rng=None):
        block, gen = template(x.device)
        block.train(rng is not None)
        if rng is not None:
            gen.manual_seed(rng)
        return functional_call(block, block_params, (x,))

    def head_fn(outer, x):
        x = functional_call(model.ln_f, sub(outer, "ln_f."), (x,))
        wte = outer["wte.embedding"]
        if cfg.fused_loss_chunk:
            return {"hidden": x, "wte": wte, "chunk": cfg.fused_loss_chunk}
        pol = model.policy
        return (pol.cast_to_compute(x)
                @ pol.cast_to_compute(wte).t()).float()

    def split(params):
        blocks: List[Params] = [{} for _ in range(cfg.num_layers)]
        outer = {}
        for k, v in params.items():
            m = pat.match(k)
            if m:
                blocks[int(m.group(1))][m.group(2)] = v
            else:
                outer[k] = v
        return outer, blocks

    def merge(outer, blocks):
        p = dict(outer)
        for i, b in enumerate(blocks):
            p.update({f"h.{i}.{k}": v for k, v in b.items()})
        return p

    return PipelineSpec(embed_fn, block_fn, head_fn, split, merge,
                        dropout=cfg.dropout, remat=cfg.remat)


# ------------------------------------------------------- the train step
def _blocks_key(name: str) -> str:
    return f"blocks.{name}"


def _slab_key(name: str, s: int) -> str:
    return f"blocks.{name}@{s}"


def _cat_outputs(outs: List[Any]) -> Any:
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], dict):
        return {**outs[0], "hidden": torch.cat([o["hidden"] for o in outs])}
    return torch.cat(outs)


class PipelineTrainStep(TrainStep):
    """``step(batch) -> {"loss"}`` over a :class:`PipelineMesh`; see the
    module. ``params`` maps flat keys to the leaves the optimizer updates:
    the model's outer parameters by name and each stage's slab
    (``blocks.<name>@<s>``, ``[L/P, ...]`` on the stage's device); the
    model's own block tensors are released (:meth:`sync_model` writes the
    merged weights back). Saves are per-shard in JAX's pipeline layout
    (``sharded``)."""

    sharded = True
    rank, world = 0, 1

    def __init__(self, model: torch.nn.Module, spec: PipelineSpec,
                 optimizer: Optimizer, loss_fn: Callable,
                 mesh: PipelineMesh, num_microbatches: int,
                 dropout_rng: bool = False, remat: Optional[bool] = None):
        if spec.dropout and not dropout_rng:
            # Without seeds the blocks would run without dropout.
            raise ValueError(
                f"spec carries dropout={spec.dropout} but dropout_rng=False; "
                f"pass make_pipeline_train_step(..., dropout_rng=True)")
        if num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got "
                             f"{num_microbatches}")
        self.model, self.spec, self.optimizer = model, spec, optimizer
        self.loss_fn, self.mesh = loss_fn, mesh
        self.num_microbatches = num_microbatches
        self.dropout_rng = dropout_rng
        self.remat = spec.remat if remat is None else remat
        self.device = next(model.parameters()).device
        self.stage_devices = mesh.stages(0)
        if self.stage_devices[0] != _indexed(self.device):
            raise ValueError(f"stage 0 runs on {self.stage_devices[0]} but "
                             f"the model (its outer parameters) lives on "
                             f"{self.device}")
        names = dict(model.named_parameters())
        outer, blocks = spec.split(names)
        n_layers, pp = len(blocks), mesh.pp
        if n_layers % pp:
            raise ValueError(f"{n_layers} layers not divisible by pp={pp}")
        self.n_layers, self.per_stage = n_layers, n_layers // pp
        self.outer_names = list(outer)
        self.block_names = list(blocks[0])
        self.params: Params = dict(outer)
        with torch.no_grad():
            for name in self.block_names:
                for s, dev in enumerate(self.stage_devices):
                    layers = blocks[s * self.per_stage:
                                    (s + 1) * self.per_stage]
                    self.params[_slab_key(name, s)] = torch.stack(
                        [b[name].detach() for b in layers]).to(dev) \
                        .requires_grad_(True)
        # The slabs hold the blocks now: the model's copies are released.
        self._block_params = {k: v for k, v in names.items()
                              if k not in outer}
        for t in self._block_params.values():
            t.data = torch.empty(0, dtype=t.dtype, device=t.device)
        self.opt_state = optimizer.init(
            self.params if optimizer.elementwise else self._stacked(
                self.params))
        self._drop_gen = next((m.generator for m in model.modules()
                               if isinstance(m, Dropout) and m.rate
                               and m.generator is not None), None)

    # ------------------------------------------------------------- views
    def _stacked(self, flat: Params) -> Params:
        """Flat leaves (slabs) -> outer tensors plus whole stacked
        ``blocks.<name>`` leaves (detached copies) on stage 0's device."""
        out = {k: flat[k] for k in self.outer_names if k in flat}
        dev = self.stage_devices[0]
        for name in self.block_names:
            if _slab_key(name, 0) in flat:
                out[_blocks_key(name)] = torch.cat(
                    [flat[_slab_key(name, s)].detach().to(dev)
                     for s in range(self.mesh.pp)])
        return out

    def _split(self, stacked: Params) -> Params:
        """The inverse of :meth:`_stacked`: each ``blocks.<name>`` cut into
        its stages' slabs on their devices."""
        out = {}
        for k, t in stacked.items():
            if k.startswith("blocks."):
                name = k[len("blocks."):]
                for s, dev in enumerate(self.stage_devices):
                    out[_slab_key(name, s)] = t[s * self.per_stage:(s + 1)
                                                * self.per_stage].to(dev)
            else:
                out[k] = t
        return out

    def pipeline_params(self, flat: Optional[Params] = None
                        ) -> Dict[str, Params]:
        """``{"outer", "blocks"}`` of ``flat`` (the leaves, or gradients
        keyed like them): the outer tensors by name and the whole stacked
        block leaves by block-relative name (detached)."""
        st = self._stacked(self.params if flat is None else flat)
        return {"outer": {k: st[k].detach() for k in self.outer_names},
                "blocks": {n: st[_blocks_key(n)] for n in self.block_names}}

    @torch.no_grad()
    def merged_variables(self, flat: Optional[Params] = None) -> Params:
        """Every parameter (or, given ``flat`` gradients, every gradient)
        whole, by the model's names (a gather)."""
        return {k: v.clone() for k, v in merge_pipeline_params(
            self.spec, self.pipeline_params(flat)).items()}

    @torch.no_grad()
    def sync_model(self) -> torch.nn.Module:
        """Write the merged weights into the model's released block
        tensors (for the eval, which runs the plain model); -> the
        model."""
        merged = self.merged_variables()
        for name, t in self._block_params.items():
            t.data = merged[name].to(device=self.device, dtype=t.dtype)
        return self.model

    # ---------------------------------------------------------- forward
    def _step_seed(self) -> Optional[int]:
        if not self.dropout_rng:
            return None
        return (self._drop_gen.initial_seed() if self._drop_gen is not None
                else 0)

    def _stage(self, s: int, h: torch.Tensor, mb: int, g: int,
               seed: Optional[int]) -> torch.Tensor:
        slab = {n: self.params[_slab_key(n, s)] for n in self.block_names}

        def run(h):
            for li in range(self.per_stage):
                layer = s * self.per_stage + li
                rng = None if seed is None else mask_seed(seed, layer, mb, g)
                h = self.spec.block_fn({n: t[li] for n, t in slab.items()},
                                       h, rng)
            return h

        with device_scope(self.stage_devices[s]):
            return checkpoint(run, h) if self.remat else run(h)

    def _pipeline(self, x: torch.Tensor, g: int,
                  seed: Optional[int]) -> torch.Tensor:
        """The GPipe ticks over the local batch ``x``: at tick t stage s
        runs microbatch t - s."""
        m, pp = self.num_microbatches, self.mesh.pp
        b_local = x.shape[0]
        if b_local % m:
            raise ValueError(f"local batch {b_local} not divisible by "
                             f"num_microbatches {m}")
        held = list(x.reshape(m, b_local // m, *x.shape[1:]).unbind(0))
        outs: List[Optional[torch.Tensor]] = [None] * m
        for t in range(m + pp - 1):
            for s in range(pp):
                mb = t - s
                if not 0 <= mb < m:
                    continue                 # a bubble: nothing to do
                h = self._stage(s, held[mb].to(self.stage_devices[s]), mb,
                                g, seed)
                if s == pp - 1:
                    outs[mb] = h.to(x.device)
                else:
                    held[mb] = h
        return torch.cat(outs)

    def forward(self, batch: dict, seed: Optional[int] = None):
        """JAX's ``pipelined_forward``: embed -> the pipelined blocks ->
        head of ``batch`` (every dp group's rows) over the current leaves
        -> the head's output for the whole batch. ``seed``: the step's
        dropout seed, None for a deterministic forward."""
        groups = self._groups(batch)
        outer = {k: self.params[k] for k in self.outer_names}
        outs = []
        for g, rows in enumerate(groups):
            x = self.spec.embed_fn(outer, rows, None if seed is None
                                   else mask_seed(seed, -1, 0, g))
            outs.append(self.spec.head_fn(outer, self._pipeline(x, g, seed)))
        return _cat_outputs(outs)

    def _groups(self, batch: dict) -> List[dict]:
        batch = batch_to_device(batch, self.device)
        n = len(next(iter(batch.values())))
        if n % self.mesh.dp:
            raise ValueError(f"batch of {n} rows does not split over dp="
                             f"{self.mesh.dp} groups")
        rows = n // self.mesh.dp
        return [{k: v[g * rows:(g + 1) * rows] for k, v in batch.items()}
                for g in range(self.mesh.dp)]

    def loss_and_grads(self, batch):
        batch = batch_to_device(batch, self.device)
        self.model.train()
        out = self.forward(batch, self._step_seed())
        loss = self.loss_fn(out, batch).float()
        return loss.detach(), grads_of(loss, self.params)

    def apply_gradients(self, grads: Params) -> None:
        if self.optimizer.elementwise:
            return super().apply_gradients(grads)
        # Statistics over whole stacked leaves: update them as JAX does.
        updates, self.opt_state = self.optimizer.update(
            self._stacked(grads), self.opt_state, self._stacked(self.params))
        apply_updates_(self.params, self._split(updates))

    # ------------------------------------------------ JAX's state keys
    def _jax_param_key(self, logical: str) -> str:
        from nezha_tpu_torch.models.convert import pipeline_key
        return pipeline_key(logical)

    def _opt_key(self, path: Tuple[str, ...]) -> str:
        logical = set(self.outer_names) | {_blocks_key(n)
                                           for n in self.block_names}
        return "opt_state/" + "/".join(
            self._jax_param_key(p) if p in logical else p for p in path)

    def _state_groups(self):
        """The optimizer state by whole leaf: ``(logical path, flat paths
        of its parts or None for a counter)``."""
        seen: Dict[Tuple[str, ...], Optional[List[Tuple[str, ...]]]] = {}
        for path, leaf in state_leaves(self.opt_state):
            name, _, s = path[-1].rpartition("@")
            if torch.is_tensor(leaf) and s.isdigit() and name.startswith(
                    "blocks."):
                logical = path[:-1] + (name,)
                seen.setdefault(logical, [path[:-1] + (_slab_key(
                    name[len("blocks."):], i),) for i in range(self.mesh.pp)])
            else:
                seen[path] = [path] if torch.is_tensor(leaf) else None
        return seen

    def _node(self, path):
        node = self.opt_state
        for k in path:
            node = node[k]
        return node

    def _shards(self, t: torch.Tensor):
        """A whole leaf as JAX's pieces: split pp ways along its layer
        axis when it has one (``[L, ...]``), else whole."""
        from nezha_tpu_torch.train.sharded_checkpoint import (ShardedLeaf,
                                                              host_array)
        arr, dtype = host_array(t)
        full = [(0, n) for n in arr.shape]
        if arr.ndim == 0 or arr.shape[0] != self.n_layers:
            return ShardedLeaf(arr.shape, dtype, [(tuple(full), arr)])
        pieces = []
        for s in range(self.mesh.pp):
            lo, hi = s * self.per_stage, (s + 1) * self.per_stage
            pieces.append((tuple([(lo, hi)] + full[1:]),
                           np.ascontiguousarray(arr[lo:hi])))
        return ShardedLeaf(arr.shape, dtype, pieces)

    def _logical_state(self, logical, parts) -> torch.Tensor:
        leaves = [self._node(p) for p in parts]
        if len(leaves) == 1:
            return leaves[0]
        dev = self.stage_devices[0]
        return torch.cat([t.to(dev) for t in leaves])

    def shard_leaves(self, rng) -> Dict[str, Any]:
        """The JAX pipeline state as per-shard host leaves."""
        from nezha_tpu_torch.train.sharded_checkpoint import whole
        out = {}
        for k, t in self._stacked(self.params).items():
            out["pparams/" + self._jax_param_key(k)] = self._shards(t)
        for logical, parts in self._state_groups().items():
            key = self._opt_key(logical)
            if parts is None:
                out[key] = whole(np.asarray(int(self._node(logical)),
                                            np.int32))
            else:
                out[key] = self._shards(
                    self._logical_state(logical, parts).detach())
        out["rng"] = whole(np.asarray(rng, np.uint32))
        return out

    def restore_request(self):
        """Every leaf whole (``restore_sharded``'s template)."""
        req = {"pparams/" + self._jax_param_key(k): (tuple(t.shape), None)
               for k, t in self._stacked(self.params).items()}
        for logical, parts in self._state_groups().items():
            shape = (() if parts is None else tuple(
                self._logical_state(logical, parts).shape))
            req[self._opt_key(logical)] = (shape, None)
        req["rng"] = ((2,), None)
        return req

    @torch.no_grad()
    def load_restored(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install a restored state (whole leaves by JAX key), each
        stacked leaf cut into this mesh's slabs."""
        def put(leaves, arr):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if len(leaves) > 1:
                parts = t.split(self.per_stage)
            else:
                parts = [t]
            for leaf, part in zip(leaves, parts):
                leaf.copy_(part.to(device=leaf.device, dtype=leaf.dtype))

        for k in self.outer_names:
            put([self.params[k]], arrays["pparams/" + self._jax_param_key(k)])
        for n in self.block_names:
            put([self.params[_slab_key(n, s)] for s in range(self.mesh.pp)],
                arrays["pparams/" + self._jax_param_key(_blocks_key(n))])
        for logical, parts in self._state_groups().items():
            arr = arrays[self._opt_key(logical)]
            if parts is None:
                self._node(logical[:-1])[logical[-1]] = int(np.asarray(arr))
            else:
                put([self._node(p) for p in parts], arr)


def make_pipeline_train_step(model: torch.nn.Module, spec: PipelineSpec,
                             optimizer: Optimizer, loss_fn: Callable,
                             mesh: PipelineMesh, num_microbatches: int,
                             dropout_rng: bool = False,
                             remat: Optional[bool] = None
                             ) -> PipelineTrainStep:
    """The pipelined train step (:class:`PipelineTrainStep`), which holds
    the state it updates (JAX's ``init_pipeline_state`` and its step in
    one object, as every port step is). ``remat`` defaults to the spec's
    (the model config's ``remat``)."""
    return PipelineTrainStep(model, spec, optimizer, loss_fn, mesh,
                             num_microbatches, dropout_rng=dropout_rng,
                             remat=remat)


__all__ = ["PipelineMesh", "PipelineSpec", "PipelineTrainStep",
           "gpt2_pipeline_spec", "make_pipeline_mesh",
           "make_pipeline_train_step", "mask_seed", "merge_pipeline_params",
           "stack_block_params", "unstack_block_params"]
