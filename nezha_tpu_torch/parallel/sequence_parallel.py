"""Sequence parallelism: Ulysses attention and the dp x sp training step
(counterpart of ``nezha_tpu/parallel/sequence_parallel.py``).

:func:`ulysses_attention` re-shards the shards' blocks from the sequence
to the heads with one all-to-all, runs whole-sequence attention on each
shard's ``H / sp`` heads (the flash kernels B1-B3, or composed), and
turns back with a second all-to-all. Ring attention is
:func:`~nezha_tpu_torch.parallel.ring.ring_attention`.

:class:`SPTrainStep` is the training path. JAX runs the whole model per
shard inside ``shard_map``; one process drives the port's mesh, so the
step advances every shard one layer at a time through the model's own
modules (``GPT2.embed``, ``Attention.heads``, ``Attention.attend_shards``
across the shards, ``Attention.project``, ``Block.mlp_residual``,
``GPT2.head``):

- shard (g, s) of an :class:`~.mesh.SpMesh` (id ``g * sp + s``) runs
  rows ``[g B/dp, (g + 1) B/dp)`` and positions ``[s S_loc, (s + 1)
  S_loc)`` of the batch (:func:`shard_lm_batch`, the shift done first on
  the whole rows) with position offset ``s * S_loc``, so the position
  embeddings and the ring's causal mask see global positions; its
  residual stream stays on its device;
- the loss is the mean of the shards' mean losses, and the gradients
  are that mean's, as JAX's ``pmean`` over ``(dp, sp)`` gives (every
  shard holds as many tokens). A MoE layer routes each shard's own
  tokens with its own capacity, as under ``shard_map``;
- the parameters and the optimizer state are the model's, replicated,
  held once: a shard on another device than the model's runs a copy of
  its modules whose parameters are differentiable copies (``.to``) of
  the model's, so the gradients add up in the model's leaves and the
  optimizer updates once; on the model's device (one card repeated, the
  CPU) the copies are the parameters themselves;
- ``remat`` checkpoints each whole cross-shard layer: the recompute
  replays its hops and its dropout masks;
- dropout: the masks follow the port's own stream (ROADMAP C6), not
  JAX's folded keys. Before a shard's embedding and before its half of
  each layer the step reseeds the dropout generator of the shard's
  device from (the step's dropout seed, the layer, the dp group, the sp
  shard), ``parallel.pipeline.mask_seed``, so no two shards share a mask.

A save is the single-device one (the step holds the model's leaves), and
an eval runs the plain model on them (``models.gpt2.with_overrides`` with
``attn_impl="auto"``).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from nezha_tpu_torch.nn.layers import Dropout
from nezha_tpu_torch.nn.remat import checkpoint
from nezha_tpu_torch.ops import causal_mask, dot_product_attention
from nezha_tpu_torch.ops.cuda import flash_attention
from nezha_tpu_torch.ops.losses import lm_objective
from nezha_tpu_torch.optim.optimizers import Optimizer
from nezha_tpu_torch.parallel.mesh import SpMesh, all_to_all, device_scope
from nezha_tpu_torch.parallel.pipeline import mask_seed
from nezha_tpu_torch.train.loop import TrainStep, grads_of


def ulysses_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                      vs: Sequence[torch.Tensor], causal: bool = True,
                      use_flash: Optional[bool] = None) -> List[torch.Tensor]:
    """Per-shard blocks ``[B, H, S_loc, D]`` (shard r's positions ``[r
    S_loc, (r + 1) S_loc)`` on its device) -> per-shard outputs of the
    same shape, differentiable. Each shard attends the whole sequence on
    its ``H / world`` heads: the flash kernels unless ``use_flash`` is
    False (composed attention). ``H % world`` raises ``ValueError``."""
    world = len(qs)
    h = qs[0].shape[1]
    if h % world:
        raise ValueError(f"heads {h} not divisible by sequence world "
                         f"{world}")
    # [B, H, S_loc, D] -> heads split over the shards, the sequence whole.
    qh, kh, vh = (all_to_all(x, split_axis=1, concat_axis=2)
                  for x in (qs, ks, vs))
    outs = []
    for q, k, v in zip(qh, kh, vh):
        with device_scope(q.device):
            if use_flash is False:
                s = q.shape[2]
                mask = causal_mask(s, s, device=q.device) if causal else None
                outs.append(dot_product_attention(q, k, v, mask=mask))
            else:
                outs.append(flash_attention(q, k, v, causal=causal))
    return all_to_all(outs, split_axis=2, concat_axis=1)


def shard_lm_batch(mesh: SpMesh, batch: Dict) -> List[Dict[str, torch.Tensor]]:
    """``{"tokens": [B, S + 1]}`` -> one ``{"inputs", "targets"}`` dict
    per shard, in shard-id order (``g * sp + s``), each ``[B / dp, S /
    sp]`` int64 on the shard's device. The shift happens first, on the
    whole rows: ``[B, S + 1]`` cannot split evenly over the sequence, the
    ``[B, S]`` inputs and targets can."""
    tokens = batch["tokens"]
    tokens = (tokens if torch.is_tensor(tokens)
              else torch.from_numpy(np.asarray(tokens))).long()
    n, s = tokens.shape[0], tokens.shape[1] - 1
    if s % mesh.sp:
        raise ValueError(f"sequence length {s} not divisible by "
                         f"sp={mesh.sp}")
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not split over "
                         f"dp={mesh.dp} groups")
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    rows, cols = n // mesh.dp, s // mesh.sp
    shards = []
    for g in range(mesh.dp):
        for r, dev in enumerate(mesh.group(g).devices):
            cut = (slice(g * rows, (g + 1) * rows),
                   slice(r * cols, (r + 1) * cols))
            shards.append({"inputs": inputs[cut].contiguous().to(dev),
                           "targets": targets[cut].contiguous().to(dev)})
    return shards


class _Replica:
    """The model's modules for one shard device: shallow copies with a
    dropout generator on that device, and, off the model's device,
    parameter slots that :meth:`bind` fills with differentiable copies."""

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 copies: bool):
        self.generator = torch.Generator(device=device)
        self.device = device
        self.slots = []   # (module copy, leaf name, the model's parameter)

        def clone(mod: torch.nn.Module) -> torch.nn.Module:
            new = copy.copy(mod)
            new._modules = {k: clone(c) for k, c in mod._modules.items()}
            if isinstance(new, Dropout):
                new.generator = self.generator
            if copies:
                new._parameters = dict(mod._parameters)
                self.slots += [(new, k, p) for k, p in
                               mod._parameters.items() if p is not None]
            return new

        self.model = clone(model)

    def bind(self, training: bool) -> torch.nn.Module:
        """This step's parameters in place (copies off the model's
        device; a module's ``_parameters`` slot takes the plain tensor),
        and the model's mode."""
        for mod, name, p in self.slots:
            mod._parameters[name] = p.to(self.device)
        return self.model.train(training)

    def reseed(self, seed: Optional[int]) -> None:
        if seed is not None:
            self.generator.manual_seed(seed)


class SPTrainStep(TrainStep):
    """``step(batch) -> {"loss"}`` over an :class:`~.mesh.SpMesh` for a
    GPT-2 built with ``attn_impl`` "ring" or "ulysses"; see the module.
    ``loss_fn(out, targets)`` (default ``lm_objective``) scores a shard's
    forward output against its ``[B / dp, S / sp]`` targets."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 mesh: SpMesh, loss_fn: Optional[Callable] = None):
        from nezha_tpu_torch.models.gpt2 import SP_ATTN_IMPLS
        impl = model.cfg.attn_impl
        if impl not in SP_ATTN_IMPLS:
            raise ValueError(f"the sequence-parallel step needs a model "
                             f"built with attn_impl 'ring' or 'ulysses', "
                             f"got {impl!r}")
        super().__init__(model, optimizer, loss_fn or lm_objective)
        self.mesh = mesh
        self._replicas: Dict[torch.device, _Replica] = {}
        self._drop_gen = next((m.generator for m in model.modules()
                               if isinstance(m, Dropout) and m.rate
                               and m.generator is not None), None)

    def _replica(self, device: torch.device) -> _Replica:
        if device not in self._replicas:
            self._replicas[device] = _Replica(self.model, device,
                                              copies=device != self.device)
        return self._replicas[device]

    def _step_seed(self) -> Optional[int]:
        """The step's dropout seed (the model generator's, as the trainer
        set it for the step), None without dropout."""
        return (self._drop_gen.initial_seed() if self._drop_gen is not None
                else None)

    def _layer(self, i: int, reps: List[_Replica], seeds, xs):
        """Layer ``i`` on every shard of a group: -> (outputs, the MoE
        layer's aux losses or Nones)."""
        qkv = []
        for rep, x in zip(reps, xs):
            block = rep.model.h[i]
            with device_scope(rep.device):
                qkv.append(block.attn.heads(block.ln_1(x)))
        qs, ks, vs = (list(t) for t in zip(*qkv))
        atts = reps[0].model.h[i].attn.attend_shards(qs, ks, vs)
        outs, auxes = [], []
        for s, (rep, x, att) in enumerate(zip(reps, xs, atts)):
            block = rep.model.h[i]
            with device_scope(rep.device):
                # A shard's masks of the layer are drawn in one run.
                rep.reseed(None if seeds is None else seeds[s])
                x, aux = block.mlp_residual(x + block.attn.project(att))
            outs.append(x)
            auxes.append(aux)
        return outs, auxes

    def _group(self, g: int, shards: List[dict], seed: Optional[int],
               training: bool) -> List:
        """Dp group g's forward over its shards -> their outputs."""
        devices = self.mesh.group(g).devices
        reps = [self._replica(d) for d in devices]
        for rep in {id(r): r for r in reps}.values():
            rep.bind(training)
        s_loc = shards[0]["inputs"].shape[1]
        xs = []
        for s, (rep, shard) in enumerate(zip(reps, shards)):
            with device_scope(rep.device):
                rep.reseed(None if seed is None
                           else mask_seed(seed, -1, g, s))
                xs.append(rep.model.embed(shard["inputs"], pos=s * s_loc))
        remat = self.model.cfg.remat and training
        terms: List[List[torch.Tensor]] = [[] for _ in reps]
        gens = [r.generator for r in reps]
        for i in range(self.model.cfg.num_layers):
            seeds = (None if seed is None else
                     [mask_seed(seed, i, g, s) for s in range(len(reps))])
            if remat:
                xs, auxes = checkpoint(
                    lambda *x, i=i, seeds=seeds: self._layer(i, reps, seeds,
                                                             list(x)),
                    *xs, generators=gens)
            else:
                xs, auxes = self._layer(i, reps, seeds, xs)
            for t, aux in zip(terms, auxes):
                if aux is not None:
                    t.append(aux)
        outs = []
        for rep, x, t in zip(reps, xs, terms):
            with device_scope(rep.device):
                outs.append(rep.model.head(x, t))
        return outs

    def _forward(self, shards: List[dict], seed: Optional[int],
                 training: bool) -> List:
        sp = self.mesh.sp
        outs = []
        for g in range(self.mesh.dp):
            outs += self._group(g, shards[g * sp:(g + 1) * sp], seed,
                                training)
        return outs

    def _shards(self, batch: dict) -> List[dict]:
        s = batch["tokens"].shape[1] - 1
        if s > self.model.cfg.max_positions:
            raise ValueError(f"sequence length {s} exceeds max_positions "
                             f"{self.model.cfg.max_positions}")
        return shard_lm_batch(self.mesh, batch)

    def forward(self, batch: dict, seed: Optional[int] = None,
                training: bool = True) -> List:
        """The model's forward on every shard of ``batch`` (``{"tokens":
        [B, S + 1]}``) -> the shards' outputs, in shard-id order.
        ``seed``: the step's dropout seed (None: no reseeding)."""
        return self._forward(self._shards(batch), seed, training)

    def loss_and_grads(self, batch: dict):
        self.model.train()
        shards = self._shards(batch)
        outs = self._forward(shards, self._step_seed(), True)
        losses = []
        for out, shard in zip(outs, shards):
            with device_scope(shard["targets"].device):
                losses.append(self.loss_fn(out, shard["targets"]).float()
                              .to(self.device))
        loss = torch.stack(losses).mean()
        return loss.detach(), grads_of(loss, self.params)


def make_sp_train_step(model: torch.nn.Module, optimizer: Optimizer,
                       mesh: SpMesh, loss_fn: Optional[Callable] = None
                       ) -> SPTrainStep:
    """The sequence-parallel train step (:class:`SPTrainStep`), which
    holds the state it updates (JAX's replicated state and its step in
    one object, as every port step is). Batches are ``{"tokens": [B, S +
    1]}``; the step shards them itself (:func:`shard_lm_batch`)."""
    return SPTrainStep(model, optimizer, mesh, loss_fn)


__all__ = ["SPTrainStep", "make_sp_train_step", "shard_lm_batch",
           "ulysses_attention"]
