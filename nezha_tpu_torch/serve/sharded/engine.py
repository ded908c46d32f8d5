"""The tensor-sharded serve engine: one replica, M shards, one mesh
(counterpart of ``nezha_tpu/serve/sharded/engine.py``).

:class:`ShardedEngine` is the continuous-batching :class:`Engine` with
its model and pool split over a one-axis mesh (``tp``):

- parameters are placed Megatron-style (:func:`~.reshard.serve_tp_rules`:
  column-parallel qkv/fc by whole heads, row-parallel projections);
- the paged K/V pools and int8 scales are split by heads
  (:class:`~.pool.ShardedPagedSlotPool`), while block tables, the free
  list, ref counts and the prefix trie stay one host-side set;
- prefill, decode and speculative verify run the engine's own host
  logic unchanged through the sharded forward (:class:`~.model.
  ShardedGPT2`), which runs the port's paged branches per shard on its
  heads: the kernels, or the composed paths that ``decode_impl="xla"``,
  ``prefill_impl="xla"`` and the switches select.

Like the JAX engine it is one controller: one process drives every
shard, so one scheduler and one set of host books serve them all. With
``prefill_mode="sequence"`` each prefill chunk's attention is sharded
over the sequence as well (:mod:`.seq_prefill`, ulysses or ring).

``devices`` names the mesh's devices and may repeat one (``[cuda:0] *
4`` runs four shards on one card, one after another); None takes the
visible cards on ``cuda`` and the CPU repeated on ``cpu`` — never one
card repeated on its own. ``shards`` takes parameters already placed on
that mesh (:func:`~.reshard.reshard_checkpoint`), so a checkpoint's
weights are never gathered whole on one device: ``model`` then gives
the structure, and its replicated parameters are set from shard 0.

Speculative decoding runs as on one device, its draft on the mesh too:
a self-draft (``SpeculativeConfig.draft_layers``) shares the target's
placed shards, an explicit ``draft_model`` (a draft checkpoint) is
placed with :func:`~.reshard.serve_tp_rules` of its own config, and the
draft pool is built through :meth:`_make_paged_pool`, head-sharded and
mirrored. The host KV tier and the block wire compose through the
sharded pool's gather-on-export and scatter-on-install
(:mod:`.pool`): the same full-head wire and host entries as one device.

It sets JAX's gauges ``serve.mesh.devices`` and ``serve.prefill.seq_shards``,
counts ``serve.prefill.ring_hops_total`` and the estimate
``serve.mesh.collective_bytes``, and arms ``serve.prefill.seq`` at the
head of a sequence-mode prefill (inside the ``serve.prefill.seq_s``
span's caller). ``NEZHA_NO_NESTED_KERNELS`` sends the per-shard decode
and prefill to the composed paths and pins
``serve.prefill.kernel_active`` at 0, as in JAX.

``NEZHA_NO_SEQ_PREFILL`` turns ``prefill_mode="sequence"`` back into
the replicated prefill, as in JAX (a warning names it).

Refused, as in JAX: the dense layout (no head-sharded pool), and a mesh
that does not divide the heads (the target's or the draft's) or the
sequence-mode buckets.
"""


from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.models.gpt2 import NO_NESTED_KERNELS
from nezha_tpu_torch.parallel.mesh import make_mesh
from nezha_tpu_torch.serve.engine import Engine, ServeConfig
from nezha_tpu_torch.serve.sharded.model import ShardedGPT2
from nezha_tpu_torch.serve.sharded.pool import ShardedPagedSlotPool
from nezha_tpu_torch.serve.sharded.reshard import rule_for, serve_tp_rules
from nezha_tpu_torch.utils.logging import get_logger

NO_SEQ_PREFILL = "NEZHA_NO_SEQ_PREFILL"


class ShardedEngine(Engine):
    """The M-shard tensor-parallel serve engine; a drop-in for
    :class:`Engine` wherever the scheduler is concerned.
    ``mesh_devices=1`` is a valid degenerate mesh."""

    _seq_prefill_capable = True

    def __init__(self, model, cfg: ServeConfig = ServeConfig(), *,
                 mesh_devices: int, devices: Optional[Sequence] = None,
                 shards: Optional[Sequence[dict]] = None, draft_model=None):
        m = int(mesh_devices)
        if m < 1:
            raise ValueError(f"mesh_devices must be >= 1, got {m}")
        if cfg.kv_layout != "paged":
            raise ValueError("the sharded engine requires kv_layout='paged': "
                             "the dense layout has no head-sharded pool")
        if cfg.prefill_mode == "sequence" and os.environ.get(NO_SEQ_PREFILL):
            get_logger("nezha_tpu_torch.serve").warning(
                "%s is set: prefill_mode='sequence' falls back to the "
                "replicated prefill", NO_SEQ_PREFILL)
            cfg = dataclasses.replace(cfg, prefill_mode="replicated")
        self._seq_active = cfg.prefill_mode == "sequence"
        self._seq_variant = None
        if self._seq_active:
            if m < 2:
                raise ValueError(
                    "prefill_mode='sequence' requires mesh_devices > 1: "
                    "there is no sequence axis to shard over on a "
                    "degenerate 1-device mesh")
            bad = [w for w in cfg.all_prefill_buckets if w % m]
            if bad:
                raise ValueError(
                    f"prefill_mode='sequence' needs every prefill bucket "
                    f"width divisible by mesh_devices={m}; offending "
                    f"buckets: {bad} (size prefill_buckets/"
                    f"long_prefill_buckets accordingly)")
            # "auto" is ulysses: heads divide by M (checked below), and
            # ulysses gives the replicated path's bits.
            self._seq_variant = ("ulysses"
                                 if cfg.seq_prefill_variant == "auto"
                                 else cfg.seq_prefill_variant)
        self.mesh = make_mesh({"tp": m}, devices,
                              next(model.parameters()).device.type)
        for what, mod in (("", model), ("draft ", draft_model)):
            if mod is not None and mod.cfg.num_heads % m:
                raise ValueError(
                    f"{what}num_heads={mod.cfg.num_heads} not divisible by "
                    f"mesh_devices={m}: K/V pools shard on the head axis")
        self.mesh_devices = m
        self._rules = serve_tp_rules(model.cfg, m)
        if shards is not None and len(shards) != m:
            raise ValueError(f"{len(shards)} placed shards for a mesh of "
                             f"{m}")
        # The serving overrides go onto the model before it is split (the
        # base engine's are then a no-op on the sharded forward).
        self.cfg = cfg
        target = ShardedGPT2(self._impl_overrides(model), self.mesh,
                             self._rules, seq_variant=self._seq_variant,
                             shards=shards)
        if draft_model is not None:
            draft_model = ShardedGPT2(self._impl_overrides(draft_model),
                                      self.mesh,
                                      serve_tp_rules(draft_model.cfg, m))
        super().__init__(target, cfg, draft_model=draft_model)
        if self.prefill_kernel_active and os.environ.get(NO_NESTED_KERNELS):
            # The per-shard prefill kernels are JAX's nested kernels: the
            # switch turns them off here too.
            self.prefill_kernel_active = False
            obs.gauge("serve.prefill.kernel_active").set(0.0)
        obs.gauge("serve.mesh.devices").set(m)
        obs.gauge("serve.prefill.seq_shards").set(
            float(m) if self._seq_active else 0.0)
        # Cross-shard payload per token a forward moves (JAX's estimate:
        # two reductions a layer of hidden_size fp32 values); 0 on a
        # one-shard mesh.
        c = model.cfg
        self._coll_bytes_per_token = (
            0 if m == 1 else 2 * c.num_layers * c.hidden_size * 4)

    # ---------------------------------------------------------- dispatch
    def prefill(self, slot: int, tokens, **kwargs) -> None:
        if self._seq_active:
            # A fault here must retire only the victim request, with no
            # slot, block or scale leaked on any shard.
            faults.point("serve.prefill.seq")
            obs.gauge("serve.prefill.seq_shards").set(
                float(self.mesh_devices))
            with obs.span("serve.prefill.seq_s"):
                super().prefill(slot, tokens, **kwargs)
            if self._seq_variant == "ring":
                # Every shard's block travels the whole ring each chunk.
                obs.counter("serve.prefill.ring_hops_total").inc(
                    self.mesh_devices * self.last_prefill_chunks)
        else:
            super().prefill(slot, tokens, **kwargs)
        if self._coll_bytes_per_token:
            obs.counter("serve.mesh.collective_bytes").inc(
                self.last_prefill_tokens * self._coll_bytes_per_token)

    def step(self, active: np.ndarray):
        out = super().step(active)
        if self._coll_bytes_per_token:
            obs.counter("serve.mesh.collective_bytes").inc(
                self.cfg.max_batch_size * self.tokens_per_dispatch
                * self._coll_bytes_per_token)
        return out

    # ------------------------------------------------------------- hooks
    def _make_paged_pool(self, model_cfg, *, num_blocks, prefix_cache,
                         eviction, host_blocks=0) -> ShardedPagedSlotPool:
        cfg = self.cfg
        return ShardedPagedSlotPool(
            model_cfg, cfg.max_batch_size, cfg.max_len, cfg.cache_dtype,
            mesh=self.mesh, block_size=cfg.kv_block_size,
            num_blocks=num_blocks, prefix_cache=prefix_cache,
            eviction=eviction, quantized=cfg.kv_dtype == "int8",
            host_blocks=host_blocks)

    def _rows(self, pool, tables):
        """Per layer ``{"shards": [...]}``: each shard's cache dict of
        ``pool`` with the block table on its device (uploaded once per
        device)."""
        tabs = {}
        for dev in self.mesh.devices:
            if dev not in tabs:
                tabs[dev] = tables.to(dev)
        return [{"shards": [{**shard, "tables": tabs[dev]}
                            for shard, dev in zip(layer, self.mesh.devices)]}
                for layer in pool.caches]

    # -------------------------------------------------------- accounting
    def memory_report(self) -> dict:
        """Logical against per-device bytes: the target's parameters
        (split ones summed over shards, replicated ones once) and the
        pools' capacity (all blocks, K/V and scales; the draft pool's
        too, as JAX counts it), the per-device numbers counted on shard 0
        (which holds every replicated parameter whole)."""
        shards = self.model.shards

        def nbytes(t):
            return t.numel() * t.element_size()

        p_total = sum(
            sum(nbytes(s[name]) for s in shards)
            if rule_for(name, self._rules).axis is not None
            else nbytes(t) for name, t in shards[0].items())
        p_shard = sum(nbytes(t) for t in shards[0].values())
        pools = [p for p in (self.pool, self.draft_pool) if p is not None]
        k_total = sum(nbytes(t) for pool in pools
                      for _, layer in pool.layer_states()
                      for t in layer.values())
        k_shard = sum(nbytes(t) for pool in pools
                      for layer in pool.shard_caches(0)
                      for t in layer.values())
        return {"mesh_devices": self.mesh_devices,
                "params_bytes": p_total,
                "params_bytes_per_device": p_shard,
                "kv_capacity_bytes": k_total,
                "kv_capacity_bytes_per_device": k_shard,
                "bytes_total": p_total + k_total,
                "bytes_per_device": p_shard + k_shard}
