"""GPT-2's forward over M parameter shards — what XLA's partitioner
makes of the JAX model under the sharded engine's
``auto_partitioner_scope``, and under the tensor-parallel train step
(``parallel/gspmd.py``).

:class:`ShardedGPT2` runs the model's own forward (``GPT2.forward`` and
``Block.forward``) over the model's own replicated modules (the position
embedding, the LayerNorms, the dropouts), with the split layers swapped
in; only the split and the reductions are new here. The same layers
serve a paged cache (the sharded serve engine) and no cache (training,
differentiable: the shards' tensors are the train step's leaves):

- :class:`ShardedEmbedding`: the token embedding when the vocabulary
  divides by M. Each shard gathers the ids in its slice (zeros
  elsewhere) and a psum assembles the rows; the tied LM head is
  vocab-sliced with an all-gather of the logits. Otherwise the model's
  own embedding serves, replicated;
- :class:`ShardedAttention`: qkv column-parallel by whole heads, each
  shard's attention on its heads, the projection row-parallel. With no
  cache: causal flash attention per shard (B1-B3: ``attn_impl`` "auto",
  "flash" or "flash_shmap"; "xla" composed). On a paged cache: the
  port's paged branches on the shard's pool shard
  (:func:`~nezha_tpu_torch.models.gpt2.paged_attention` with
  ``nested=True``): a decode step (B7, B8 on int8 pools, or composed
  under ``decode_impl="xla"``), a prefill chunk (B9/B10, or composed
  under ``prefill_impl="xla"``), a speculative verify window (composed,
  over the shard's own pool rows); ``NEZHA_NO_NESTED_KERNELS`` sends
  decode and prefill to the composed paths. An int8 chunk's error sample
  is the max over shards. In sequence mode (``seq_variant`` set) a
  prefill chunk's attention goes to :func:`~.seq_prefill.
  seq_prefill_attention`: q/k/v move from the head domain to the
  sequence domain by all-to-all and the output moves back, the move XLA
  makes around the JAX ``shard_map``;
- :class:`ShardedMLP`: fc column-parallel, the projection row-parallel.

A row-parallel layer sums the shards' partial products (one psum, fp32,
rank order) and then adds its replicated bias. The residual stream lives
on the model's device; on a mesh whose devices repeat it, the hand-overs
to the shards are free.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from nezha_tpu_torch.models.gpt2 import (GPT2, Attention, Block,
                                         paged_attention)
from nezha_tpu_torch.nn.layers import linear
from nezha_tpu_torch.ops import causal_mask, dot_product_attention, gelu
from nezha_tpu_torch.ops.cuda import flash_attention
from nezha_tpu_torch.parallel.expert import MoE
from nezha_tpu_torch.parallel.mesh import Mesh, device_scope, pmax, psum
from nezha_tpu_torch.serve.sharded.reshard import (Split, place_variables,
                                                   rule_for)
from nezha_tpu_torch.serve.sharded.seq_prefill import (heads_to_seq,
                                                       seq_prefill_attention,
                                                       seq_to_heads)


def _to_shards(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    return [x.to(dev) for dev in mesh.devices]


def _row_parallel(policy, partials, bias, device):
    """psum of the shards' partial products, then the bias."""
    y = psum([t.float() for t in partials])[0].to(device)
    return policy.cast_output(policy.cast_to_compute(y)
                              + policy.cast_to_compute(bias))


def column_parallel(mesh: Mesh, x: torch.Tensor, weights, policy,
                    heads: int = 0) -> List[torch.Tensor]:
    """The shards' column-parallel products of ``x`` (one ``(w, b)`` a
    shard, each on its device); with ``heads`` > 0 each fused qkv product
    is returned as its q, k and v ``[3, B, heads/M, S, D]``."""
    outs = [linear(xr, w, b, policy)
            for xr, (w, b) in zip(_to_shards(mesh, x), weights)]
    if not heads:
        return outs
    b, s = x.shape[:2]
    hh = heads // mesh.size
    return [o.reshape(b, s, 3, hh, -1).permute(2, 0, 3, 1, 4)
            for o in outs]


def local_attention(mesh: Mesh, qkv: Sequence[torch.Tensor], impl: str,
                    causal: bool, mask: Optional[torch.Tensor] = None,
                    kv_lengths: Optional[torch.Tensor] = None
                    ) -> List[torch.Tensor]:
    """Each shard's training attention on its heads (``qkv[r]`` its
    ``[3, B, H/M, S, D]``): the flash kernels (B1-B3) for "flash" and
    "flash_shmap", else composed under ``mask`` (or the causal mask)."""
    outs = []
    for r, dev in enumerate(mesh.devices):
        q, k, v = qkv[r]
        with device_scope(dev):
            if impl in ("flash", "flash_shmap"):
                outs.append(flash_attention(
                    q, k, v, causal=causal,
                    kv_lengths=None if kv_lengths is None
                    else kv_lengths.to(dev)))
            else:
                m = (causal_mask(q.shape[2], q.shape[2], device=dev)
                     if mask is None else mask.to(dev))
                outs.append(dot_product_attention(q, k, v, mask=m))
    return outs


def row_parallel_heads(mesh: Mesh, outs: Sequence[torch.Tensor], weights,
                       bias, policy, device) -> torch.Tensor:
    """The attention projection, row-parallel: shard r's heads ``[B,
    H/M, S, D]`` against its rows of the projection, then the psum and
    the replicated bias on ``device``."""
    partials = []
    for o, w in zip(outs, weights):
        b, hh, s, d = o.shape
        partials.append(policy.cast_to_compute(
            o.transpose(1, 2).reshape(b, s, hh * d))
            @ policy.cast_to_compute(w))
    return _row_parallel(policy, partials, bias, device)


class ShardedEmbedding(nn.Module):
    """The vocab-sliced token embedding and tied head; ``tables[r]`` is
    shard r's rows, on its device."""

    def __init__(self, tables: Sequence[torch.Tensor], mesh: Mesh, policy):
        super().__init__()
        self.tables, self.mesh, self.policy = list(tables), mesh, policy

    @property
    def embedding(self) -> torch.Tensor:
        """The whole table on shard 0's device (the fused loss head's
        ``wte``; differentiable into the shards)."""
        dev = self.tables[0].device
        return torch.cat([t.to(dev) for t in self.tables])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = []
        for r, (dev, table) in enumerate(zip(self.mesh.devices,
                                             self.tables)):
            local = ids.to(dev) - r * table.shape[0]
            hit = (local >= 0) & (local < table.shape[0])
            e = table[local.clamp(0, table.shape[0] - 1)]
            rows.append(self.policy.cast_to_compute(
                torch.where(hit[..., None], e, 0.0)))
        return psum(rows)[0].to(ids.device)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        pol = self.policy
        logits = [pol.cast_to_compute(xr) @ pol.cast_to_compute(table).t()
                  for xr, table in zip(_to_shards(self.mesh, x),
                                       self.tables)]
        return torch.cat([t.to(x.device) for t in logits], dim=-1)


class ShardedAttention(Attention):
    """One layer's attention over the mesh; called as :class:`Attention`:
    with no cache (training), or on a paged cache, where ``cache`` is
    ``{"shards": [shard r's cache dict, ...]}``."""

    def __init__(self, attn: Attention, shards, pre: str, mesh: Mesh,
                 policy, seq_variant: Optional[str]):
        nn.Module.__init__(self)    # Attention.__init__ would draw weights
        self.cfg, self.impl, self.policy = attn.cfg, attn.impl, policy
        self.mesh, self.seq_variant, self.drop = mesh, seq_variant, attn.drop
        self.qkv_w = [(p[pre + "qkv.w"], p[pre + "qkv.b"]) for p in shards]
        self.proj_w = [p[pre + "proj.w"] for p in shards]
        self.proj_b = attn.proj.b

    def forward(self, x, cache: Optional[dict] = None, pos=None,
                active=None, prefill=False):
        cfg, pol = self.cfg, self.policy
        qkv = column_parallel(self.mesh, x, self.qkv_w, pol,
                              heads=cfg.num_heads)
        if cache is None:
            outs = local_attention(self.mesh, qkv, self.impl, causal=True)
            return self.drop(row_parallel_heads(
                self.mesh, outs, self.proj_w, self.proj_b, pol, x.device))
        q, k, v = ([t[j] for t in qkv] for j in range(3))     # [B,hh,S,D]
        shards = cache["shards"]
        quant = "k_scale" in shards[0]
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        if self.seq_variant is not None and not per_row:
            outs, qerr = self._seq_attention(q, k, v, shards, int(pos))
            if quant:
                cache["qerr"] = qerr
        else:
            outs = []
            for r, dev in enumerate(self.mesh.devices):
                with device_scope(dev):
                    outs.append(paged_attention(
                        q[r], k[r], v[r], shards[r],
                        pos.to(dev) if per_row else int(pos),
                        None if active is None else active.to(dev), cfg,
                        nested=True))
            if quant and not per_row:
                cache["qerr"] = pmax([sd["qerr"] for sd in shards])[0]
        return row_parallel_heads(self.mesh, outs, self.proj_w,
                                  self.proj_b, pol, x.device)

    def _seq_attention(self, q, k, v, shards, pos: int):
        """A prefill chunk through the sequence-sharded attention: head
        domain -> sequence domain and back."""
        b = q[0].shape[0]
        starts = [torch.full((b,), pos, dtype=torch.int32, device=dev)
                  for dev in self.mesh.devices]
        quant = "k_scale" in shards[0]
        scales = (([sd["k_scale"] for sd in shards],
                   [sd["v_scale"] for sd in shards]) if quant else None)
        outs, qerr = seq_prefill_attention(
            heads_to_seq(q), heads_to_seq(k), heads_to_seq(v),
            [sd["k"] for sd in shards], [sd["v"] for sd in shards],
            [sd["tables"] for sd in shards], starts,
            variant=self.seq_variant, block_scales=scales)
        return seq_to_heads(outs), (qerr[0] if quant else None)


class ShardedMLP(nn.Module):
    """One layer's MLP over the mesh."""

    def __init__(self, mlp, shards, pre: str, mesh: Mesh, policy):
        super().__init__()
        self.policy, self.mesh, self.drop = policy, mesh, mlp.drop
        self.fc = [(p[pre + "fc.w"], p[pre + "fc.b"]) for p in shards]
        self.proj_w = [p[pre + "proj.w"] for p in shards]
        self.proj_b = mlp.proj.b

    def forward(self, x):
        pol = self.policy
        partials = [pol.cast_to_compute(gelu(h)) @ pol.cast_to_compute(pw)
                    for h, pw in zip(column_parallel(self.mesh, x, self.fc,
                                                     pol), self.proj_w)]
        return self.drop(_row_parallel(pol, partials, self.proj_b,
                                       x.device))


class _ShardedBlock(Block):
    """``Block.forward`` over the model block's LayerNorms and the split
    attention and MLP."""

    def __init__(self, block: Block, attn: ShardedAttention,
                 mlp: ShardedMLP):
        nn.Module.__init__(self)    # Block.__init__ would draw new weights
        self.ln_1, self.attn = block.ln_1, attn
        self.ln_2, self.mlp = block.ln_2, mlp


class ShardedGPT2(GPT2):
    """Inference-only GPT-2 over ``mesh``: ``model``'s parameters placed
    per ``rules`` (:func:`~.reshard.serve_tp_rules`) into :attr:`shards`
    (one ``{name: tensor}`` per shard), or ``shards`` already placed so,
    whose replicated parameters are then copied into ``model``'s
    modules, which the forward runs. Called like the model's
    paged-cache forward — ``(tokens, cache=rows, pos=..., active=...)``
    -> fp32 logits on the model's device — where ``rows[layer]`` is
    ``{"shards": [shard r's cache dict, ...]}``."""

    def __init__(self, model: GPT2, mesh: Mesh,
                 rules: Sequence[Tuple[str, Split]],
                 seq_variant: Optional[str] = None,
                 shards: Optional[Sequence[dict]] = None):
        nn.Module.__init__(self)    # GPT2.__init__ would draw new weights
        self.cfg, self.policy, self.mesh = model.cfg, model.policy, mesh
        if shards is None:
            shards = place_variables(dict(model.named_parameters()), mesh,
                                     rules)
        else:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if rule_for(name, rules).axis is None:
                        p.copy_(shards[0][name])
        self.shards = list(shards)
        pol = model.policy
        self.wte = (ShardedEmbedding([p["wte.embedding"]
                                      for p in self.shards], mesh, pol)
                    if rule_for("wte.embedding", rules).axis is not None
                    else model.wte)
        self.wpe, self.drop, self.ln_f = model.wpe, model.drop, model.ln_f
        # A MoE block's expert layer stays the model's (replicated; the
        # tensor-parallel train step swaps in its ep-split layer).
        self.h = nn.ModuleList(
            _ShardedBlock(
                blk,
                ShardedAttention(blk.attn, self.shards, f"h.{i}.attn.", mesh,
                                 pol, seq_variant),
                blk.mlp if isinstance(blk.mlp, MoE) else
                ShardedMLP(blk.mlp, self.shards, f"h.{i}.mlp.", mesh, pol))
            for i, blk in enumerate(model.h))
