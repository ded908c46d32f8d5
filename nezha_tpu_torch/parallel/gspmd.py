"""Tensor-parallel training over a one-process mesh (counterpart of
``nezha_tpu/parallel/gspmd.py``).

JAX annotates parameter shardings and lets XLA's partitioner insert the
collectives. PyTorch has no partitioner, so the port writes the split out:
the model's split layers are replaced by column- and row-parallel layers
(the sharded serve engine's, ``serve/sharded/model.py``, which run with
or without a cache), and autograd differentiates through them:

- qkv and fc are column-parallel, qkv by whole heads (shard r holds the
  q, k and v columns of heads ``[r H/M, (r + 1) H/M)``), so each shard's
  attention runs on its own heads: the flash kernels B1-B3 per shard for
  ``attn_impl`` "auto", "flash" and "flash_shmap" (JAX's TPU policy under
  a tp mesh), composed for "xla";
- the attention and MLP projections are row-parallel: the shards' partial
  products are summed in fp32, in rank order, then the replicated bias is
  added;
- the token embedding is split by vocabulary where M divides it (each
  shard gathers the ids in its slice, a psum assembles the rows; the tied
  head is vocab-sliced), else replicated;
- everything else (LayerNorms, position embeddings, BERT's MLM dense and
  bias) is replicated and runs once, on the residual stream, which lives
  on the model's device. ``ln_impl="pallas"`` runs B4/B5 there.

A mesh ``dp=D,tp=M`` (:func:`make_gspmd_mesh`) is D groups of an M-shard
tp mesh. One process drives it, as JAX's gspmd is one controller: each
dp group runs its rows of the batch, the loss is the whole batch's (as
JAX's), and the gradients of the groups' forwards add up in the shared
parameter leaves — the dp gradient psum. One process shares its leaves,
so a group's devices repeat group 0's (the CPU repeated, or one card with
``devices=[cuda:0] * n``); dp groups on other cards need one process
each, which is not ported (ROADMAP A7).

The optimizer updates each shard's leaves with the shard's own state, so
it must be elementwise per tensor (SGD, momentum, AdamW, accumulation,
the global-norm clip, whose norm adds every shard once); the layerwise
trust ratios of LARS and LAMB and Adafactor's factored statistics would
see a shard, not the tensor. A save (:meth:`GSPMDTrainStep.shard_leaves`)
writes JAX's train-state keys and JAX's shards: the leaf split M ways
along the axis of JAX's rule, contiguously (JAX's fused qkv split is
column-contiguous, not by head), so JAX's ``restore_sharded`` reads a
port save and the port reads JAX's.

:func:`auto_partitioner_scope` is the eval scope: inside it a plain model
with ``attn_impl="flash_shmap"`` runs the flash kernels on each head group
of the scope's mesh (:func:`scoped_tp_flash`, JAX's nested ``shard_map``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nezha_tpu_torch.models.bert import Bert, EncoderLayer
from nezha_tpu_torch.models.gpt2 import GPT2
from nezha_tpu_torch.ops import gelu
from nezha_tpu_torch.ops.attention import make_attention_mask
from nezha_tpu_torch.ops.cuda import flash_attention
from nezha_tpu_torch.optim.optimizers import Optimizer, state_leaves
from nezha_tpu_torch.parallel.mesh import (Mesh, check_groups_repeat,
                                           device_scope, group_mesh)
from nezha_tpu_torch.serve.sharded.model import (ShardedEmbedding,
                                                 ShardedGPT2, _row_parallel,
                                                 column_parallel,
                                                 local_attention,
                                                 row_parallel_heads)
from nezha_tpu_torch.serve.sharded.reshard import (GPT2_TP_RULES,
                                                   REPLICATED, Split,
                                                   rule_for, shard_slice)
from nezha_tpu_torch.train.loop import (TrainStep, batch_to_device,
                                        grads_of)

Rules = List[Tuple[str, Split]]

# BERT's table, the JAX one's order and coverage over the port's names.
BERT_TP_RULES: Rules = [
    (r".*\.qkv\.w$", Split(1, groups=3)),
    (r".*\.qkv\.b$", Split(0, groups=3)),
    (r".*\.attn_out\.w$", Split(0)),
    (r".*\.fc\.w$", Split(1)),
    (r".*\.fc\.b$", Split(0)),
    (r".*\.fc_out\.w$", Split(0)),
    (r"^tok_emb\.embedding$", Split(0)),
    (r".*\.(attn_out|fc_out)\.b$", REPLICATED),
    (r".*_ln\.(scale|bias)$", REPLICATED),
    (r"^(pos|type)_emb\.embedding$", REPLICATED),
    (r"^mlm_bias$", REPLICATED),
    (r"^mlm_dense\.(w|b)$", REPLICATED),
]

_EMBEDDING = {GPT2: r"^wte\.embedding$", Bert: r"^tok_emb\.embedding$"}

# ------------------------------------------------------------ the scope
_AUTO_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "nezha_torch_gspmd_mesh", default=None)


def auto_partitioner_mesh():
    """The mesh of the enclosing :func:`auto_partitioner_scope` (None
    outside one, or when it was given none)."""
    return _AUTO_MESH.get()


@contextlib.contextmanager
def auto_partitioner_scope(mesh=None):
    """Run model code as under JAX's gspmd trace: a plain model's
    ``attn_impl="flash_shmap"`` then runs the flash kernels on each head
    group of ``mesh`` (a :class:`Mesh` with a ``tp`` axis or a
    :class:`GspmdMesh`). The train CLI evaluates a tensor-parallel state
    inside it."""
    token = _AUTO_MESH.set(mesh)
    try:
        yield
    finally:
        _AUTO_MESH.reset(token)


def _tp_mesh(mesh) -> Optional[Mesh]:
    if isinstance(mesh, GspmdMesh):
        return mesh.group(0)
    if isinstance(mesh, Mesh) and mesh.axis_name == "tp":
        return mesh
    return None


def scoped_tp_flash(q, k, v, num_heads: int, causal: bool,
                    kv_lengths=None) -> torch.Tensor:
    """JAX's ``_tp_sharded_flash`` for a plain model: ``[B, H, S, D]``
    q/k/v split into the scope mesh's tp head groups, the flash kernels
    on each group on its device, the outputs concatenated back. Raises
    ``ValueError`` (JAX's) outside a scope whose tp axis divides the
    heads."""
    mesh = _tp_mesh(auto_partitioner_mesh())
    if mesh is None or num_heads % mesh.size:
        raise ValueError(
            f"attn_impl='flash_shmap' needs an enclosing gspmd trace "
            f"carrying a mesh with a 'tp' axis dividing num_heads="
            f"{num_heads} (make_gspmd_train_step or "
            f"auto_partitioner_scope(mesh=...)); got {mesh}")
    hh = num_heads // mesh.size
    outs = []
    for r, dev in enumerate(mesh.devices):
        part = [t[:, r * hh:(r + 1) * hh].to(dev).contiguous()
                for t in (q, k, v)]
        with device_scope(dev):
            outs.append(flash_attention(
                *part, causal=causal,
                kv_lengths=None if kv_lengths is None
                else kv_lengths.to(dev)))
    return torch.cat([o.to(q.device) for o in outs], dim=1)


# ------------------------------------------------------------- the mesh
@dataclasses.dataclass(frozen=True)
class GspmdMesh:
    """``dp`` groups of a ``tp`` x ``ep`` mesh, laid out as JAX's
    ``(dp, tp, ep)`` mesh: group g's device ``(t, e)`` is
    ``devices[(g * tp + t) * ep + e]``. The tp shards of a group are its
    devices at ``e = 0`` (:meth:`group`), the ep shards those at ``t = 0``
    (:meth:`ep_group`). ``ep`` is None for a mesh without the axis."""

    devices: Tuple[torch.device, ...]
    dp: int
    tp: int
    ep: Optional[int] = None

    @property
    def shape(self) -> Dict[str, int]:
        out = {"dp": self.dp, "tp": self.tp}
        if self.ep is not None:
            out["ep"] = self.ep
        return out

    def _block(self, g: int) -> Tuple[torch.device, ...]:
        n = self.tp * (self.ep or 1)
        return self.devices[g * n:(g + 1) * n]

    def group(self, g: int) -> Mesh:
        return Mesh(self._block(g)[::self.ep or 1], "tp")

    def ep_group(self, g: int) -> Mesh:
        return Mesh(self._block(g)[:self.ep or 1], "ep")

    def ways(self, split: Split) -> int:
        """The shards a split leaf has: tp, or ep for the expert stacks."""
        return (self.ep or 1) if split.mesh_axis == "ep" else self.tp

    def submesh(self, split: Split) -> Mesh:
        return self.ep_group(0) if split.mesh_axis == "ep" else self.group(0)


def make_gspmd_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None,
                    device_type: str = "cuda") -> GspmdMesh:
    """The ``{"dp": D, "tp": M}`` mesh, or ``{"dp", "tp", "ep"}`` for a MoE
    model's expert axis, on ``devices`` (None: the visible cards on
    ``cuda``, the CPU repeated on ``cpu``). One axis of size -1 (``tp``
    or ``ep``) takes the visible cards left to it; it needs cards (and no
    repeated ``devices``). A dp group on other devices than group 0's
    raises :class:`NotPortedError` (one process a group, ROADMAP A7)."""
    sizes, devs = group_mesh(axes, ("tp", "ep"), "gspmd", devices,
                             device_type)
    mesh = GspmdMesh(tuple(devs), sizes["dp"], sizes["tp"], sizes.get("ep"))
    check_groups_repeat([mesh._block(g) for g in range(mesh.dp)], "gspmd")
    return mesh


# ------------------------------------------------------------- the rules
def tp_rules(model: nn.Module, tp: int) -> Rules:
    """The model's table (:data:`GPT2_TP_RULES` or :data:`BERT_TP_RULES`),
    with the token embedding replicated where ``tp`` does not divide the
    vocabulary; a MoE GPT-2's under ``gpt2_moe_gspmd_rules`` (the expert
    stacks over ``ep``)."""
    for cls, emb in _EMBEDDING.items():
        if isinstance(model, cls):
            table = GPT2_TP_RULES if cls is GPT2 else BERT_TP_RULES
            if model.cfg.vocab_size % max(int(tp), 1):
                table = [(pat, REPLICATED if pat == emb else split)
                         for pat, split in table]
            if cls is GPT2 and model.cfg.moe_experts:
                from nezha_tpu_torch.parallel.expert import \
                    gpt2_moe_gspmd_rules
                return gpt2_moe_gspmd_rules(table)
            return list(table)
    raise ValueError(f"no tensor-parallel rule table for "
                     f"{type(model).__name__}; --parallel gspmd supports "
                     f"gpt2_124m, bert_base_zero1")


def param_specs_from_rules(params: Dict[str, Any], rules: Rules,
                           strict: bool = False) -> Dict[str, Split]:
    """``{name: Split}`` for ``params`` (names to tensors) by first-match
    rules; unmatched leaves replicate. ``strict``: every rule must match a
    parameter and every non-scalar parameter a rule, else ``ValueError``
    (a renamed layer fails loudly instead of replicating)."""
    compiled = [(re.compile(pat), split) for pat, split in rules]
    hits = [0] * len(compiled)
    unmatched: List[str] = []
    specs = {}
    for name, leaf in params.items():
        for i, (pat, split) in enumerate(compiled):
            if pat.match(name):
                hits[i] += 1
                specs[name] = split
                break
        else:
            if getattr(leaf, "ndim", 1) > 0:
                unmatched.append(name)
            specs[name] = REPLICATED
    if strict:
        problems = []
        dead = [rules[i][0] for i, h in enumerate(hits) if h == 0]
        if dead:
            problems.append(f"rules matching no parameter: {dead}")
        if unmatched:
            problems.append(f"parameters matched by no rule: {unmatched}")
        if problems:
            raise ValueError(
                "strict sharding-rule check failed: " + "; ".join(problems))
    return specs


def opt_state_specs(opt_state: Any, param_specs: Dict[str, Split]) -> Any:
    """The optimizer state's placement: a tensor keyed by a parameter's
    name takes that parameter's split (at any depth, so a wrapper's
    nested state follows too); counters and anything else replicate."""
    if isinstance(opt_state, dict):
        return {k: (param_specs[k] if k in param_specs
                    and not isinstance(v, dict)
                    else opt_state_specs(v, param_specs))
                for k, v in opt_state.items()}
    return REPLICATED


# ----------------------------------------------------------- placement
def shard_key(name: str, r: int) -> str:
    """The flat key of shard r of a split parameter."""
    return f"{name}@{r}"


def unshard(parts: Sequence[torch.Tensor], split: Split) -> torch.Tensor:
    """The inverse of :func:`~nezha_tpu_torch.serve.sharded.reshard.
    shard_slice`: the shards' parts (on shard 0's device) back into the
    whole tensor."""
    if split.axis is None:
        return parts[0]
    dev = parts[0].device
    per = parts[0].shape[split.axis] // split.groups
    return torch.cat([p.to(dev).narrow(split.axis, g * per, per)
                      for g in range(split.groups) for p in parts],
                     dim=split.axis)


def _place_tree(tree: Any, specs: Any, mesh, leaf_fn) -> Any:
    """A nested dict of tensors keyed by parameter names -> the same with
    each split tensor replaced by its shards under flat keys (over the
    mesh's tp or ep shards, by the split's axis)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        sp = specs.get(k, REPLICATED) if isinstance(specs, dict) else specs
        if isinstance(v, dict):
            out[k] = _place_tree(v, sp, mesh, leaf_fn)
        elif torch.is_tensor(v) and sp.axis is not None:
            sub = mesh.submesh(sp) if isinstance(mesh, GspmdMesh) else mesh
            for r, dev in enumerate(sub.devices):
                out[shard_key(k, r)] = leaf_fn(
                    shard_slice(v.detach(), sp, r, sub.size).to(dev)
                    .contiguous())
        else:
            out[k] = v
    return out


def shard_train_state(state: Dict[str, Any], mesh, param_specs
                      ) -> Dict[str, Any]:
    """Lay a whole train state ``{"variables": {name: tensor},
    "opt_state": ..., "rng": ...}`` out over ``mesh``'s tp (or, for the
    expert stacks, ep) shards (group 0's devices, which every dp group
    shares): a split leaf becomes one leaf a shard under
    :func:`shard_key`, a replicated one stays as it is; the optimizer
    state follows :func:`opt_state_specs`."""
    return {
        "variables": _place_tree(state["variables"], param_specs, mesh,
                                 lambda t: t.requires_grad_(True)),
        "opt_state": _place_tree(state["opt_state"], opt_state_specs(
            state["opt_state"], param_specs), mesh, lambda t: t),
        "rng": state.get("rng")}


def shard_batch_gspmd(mesh: GspmdMesh, batch: dict) -> List[dict]:
    """The batch's rows split over the dp groups: one dict a group, on
    the group's first device."""
    n = len(next(iter(batch.values())))
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not split over dp="
                         f"{mesh.dp} groups")
    rows = n // mesh.dp
    return [batch_to_device({k: v[g * rows:(g + 1) * rows]
                             for k, v in batch.items()},
                            mesh.group(g).devices[0])
            for g in range(mesh.dp)]


# ------------------------------------------------- tensor-parallel BERT
class ShardedEncoderLayer(EncoderLayer):
    """BERT's post-LN encoder layer over the mesh: qkv and fc
    column-parallel, attn_out and fc_out row-parallel, the LayerNorms and
    dropout the layer's own. Attention follows ``attn_impl`` as the
    layer does: flash per shard (B1-B3, non-causal, ``kv_lengths``) for
    "flash", "flash_shmap" and "auto" without a mask; composed under a
    padding mask ("flash" and "flash_shmap" refuse one)."""

    def __init__(self, layer: EncoderLayer, shards, pre: str, mesh: Mesh,
                 policy):
        nn.Module.__init__(self)   # EncoderLayer.__init__ draws weights
        self.cfg, self.policy, self.mesh = layer.cfg, policy, mesh
        self.attn_ln, self.out_ln, self.drop = (layer.attn_ln,
                                                layer.out_ln, layer.drop)
        self.qkv_w = [(p[pre + "qkv.w"], p[pre + "qkv.b"]) for p in shards]
        self.attn_out_w = [p[pre + "attn_out.w"] for p in shards]
        self.attn_out_b = layer.attn_out.b
        self.fc_w = [(p[pre + "fc.w"], p[pre + "fc.b"]) for p in shards]
        self.fc_out_w = [p[pre + "fc_out.w"] for p in shards]
        self.fc_out_b = layer.fc_out.b

    def forward(self, x, mask=None, kv_lengths=None):
        cfg, pol, mesh = self.cfg, self.policy, self.mesh
        impl = cfg.attn_impl
        if impl == "auto":
            impl = "flash" if mask is None else "xla"
        if impl in ("flash", "flash_shmap") and mask is not None:
            raise ValueError(f"attn_impl={impl!r} cannot apply an "
                             f"arbitrary padding mask; use right-padded "
                             f"batches with kv_lengths, or 'xla'")
        if impl == "xla" and kv_lengths is not None and mask is None:
            s = x.shape[1]
            mask = make_attention_mask(
                torch.arange(s, device=x.device)[None, :]
                < kv_lengths.clamp_min(1)[:, None])
        qkv = column_parallel(mesh, x, self.qkv_w, pol,
                              heads=cfg.num_heads)
        outs = local_attention(
            mesh, qkv, impl, causal=False, mask=mask,
            kv_lengths=kv_lengths if impl != "xla" else None)
        att = self.drop(row_parallel_heads(mesh, outs, self.attn_out_w,
                                           self.attn_out_b, pol, x.device))
        x = self.attn_ln(x + att)
        partials = [pol.cast_to_compute(gelu(h, approximate=False))
                    @ pol.cast_to_compute(w)
                    for h, w in zip(column_parallel(mesh, x, self.fc_w, pol),
                                    self.fc_out_w)]
        y = _row_parallel(pol, partials, self.fc_out_b, x.device)
        return self.out_ln(x + y)


class ShardedBert(Bert):
    """``Bert.forward`` over the model's replicated modules with the split
    layers swapped in (the counterpart of :class:`ShardedGPT2`)."""

    def __init__(self, model: Bert, mesh: Mesh, rules: Rules,
                 shards: Sequence[dict]):
        nn.Module.__init__(self)   # Bert.__init__ would draw new weights
        self.cfg, self.policy, self.mesh = model.cfg, model.policy, mesh
        self.shards = list(shards)
        self.tok_emb = (ShardedEmbedding([p["tok_emb.embedding"]
                                          for p in self.shards], mesh,
                                         model.policy)
                        if rule_for("tok_emb.embedding", rules).axis
                        is not None else model.tok_emb)
        self.pos_emb, self.type_emb = model.pos_emb, model.type_emb
        self.emb_ln, self.drop = model.emb_ln, model.drop
        self.mlm_dense, self.mlm_ln = model.mlm_dense, model.mlm_ln
        self.mlm_bias = model.mlm_bias
        self.layers = nn.ModuleList(
            ShardedEncoderLayer(layer, self.shards, f"layers.{i}.", mesh,
                                model.policy)
            for i, layer in enumerate(model.layers))


def tp_model(model: nn.Module, mesh: Mesh, rules: Rules,
             shards: Sequence[dict]) -> nn.Module:
    """The tensor-parallel module of ``model`` over ``mesh`` with its
    split parameters ``shards`` (one ``{name: tensor}`` a shard)."""
    if isinstance(model, GPT2):
        return ShardedGPT2(model, mesh, rules, shards=shards)
    if isinstance(model, Bert):
        return ShardedBert(model, mesh, rules, shards)
    raise ValueError(f"no tensor-parallel module for "
                     f"{type(model).__name__}")


def _cat_outputs(outs: List[Any]) -> Any:
    """The dp groups' outputs as one batch's: logits concatenated, a
    fused-head dict's ``hidden`` concatenated (its table is shared)."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], dict):
        return {**outs[0], "hidden": torch.cat([o["hidden"] for o in outs])}
    return torch.cat(outs)


# -------------------------------------------------------- the train step
class GSPMDTrainStep(TrainStep):
    """``step(batch) -> {"loss"}`` over a :class:`GspmdMesh`; see the
    module. ``params`` maps flat keys (a replicated parameter's name, or
    :func:`shard_key` of a split one) to the leaves the optimizer
    updates: the model's own replicated parameters, and each shard's part
    of a split one on its device (the model's whole tensor is released).
    :attr:`model` stays the given module (its dropouts, its config);
    :attr:`tp_model` runs the forward. The saves are per-shard in JAX's
    layout (``sharded``)."""

    sharded = True
    rank, world = 0, 1

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, mesh: GspmdMesh,
                 param_specs: Optional[Dict[str, Split]] = None):
        from nezha_tpu_torch.models.convert import jax_leaf_names
        self.model, self.optimizer, self.loss_fn = model, optimizer, loss_fn
        self.mesh = mesh
        self.device = next(model.parameters()).device
        tpm = mesh.group(0)
        if model.cfg.num_heads % mesh.tp:
            raise ValueError(f"num_heads={model.cfg.num_heads} not "
                             f"divisible by tp={mesh.tp}: qkv splits by "
                             f"whole heads")
        names = dict(model.named_parameters())
        if param_specs is None:
            param_specs = param_specs_from_rules(
                names, tp_rules(model, mesh.tp), strict=True)
        self.specs = param_specs
        self.jax_names = jax_leaf_names(model)
        self.shapes = {n: tuple(p.shape) for n, p in names.items()}
        placed = shard_train_state({"variables": names, "opt_state": {}},
                                   mesh, param_specs)["variables"]
        shards = [{} for _ in range(tpm.size)]
        for n, p in names.items():
            split = param_specs[n]
            for r in range(tpm.size if split.mesh_axis == "tp" else 0):
                shards[r][n] = (p if split.axis is None
                                else placed[shard_key(n, r)])
            if split.axis is not None:
                # The shards hold it now: no whole copy stays behind.
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.params = placed
        rules = [("^" + re.escape(n) + "$", s) for n, s in
                 param_specs.items()]
        self.tp_model = tp_model(model, tpm, rules, shards)
        # A MoE GPT-2 routes over the whole batch, as JAX's gspmd does
        # (one capacity from the global token count): its dp groups' rows
        # go through one forward, on the devices they share.
        self.route_globally = isinstance(model, GPT2) and bool(
            model.cfg.moe_experts)
        if self.route_globally:
            from nezha_tpu_torch.parallel.expert import MoE, ShardedMoE
            epm = mesh.ep_group(0)
            for i, blk in enumerate(self.tp_model.h):
                if isinstance(blk.mlp, MoE):
                    pre = f"h.{i}.mlp."
                    w = [[placed[shard_key(pre + k, r)]
                          for r in range(epm.size)]
                         for k in ("w_in", "w_out")]
                    blk.mlp = ShardedMoE(blk.mlp, w[0], w[1], epm)
        self.opt_state = optimizer.init(self.params)

    # ------------------------------------------------------------ step
    def loss_and_grads(self, batch):
        """-> (fp32 loss, ``{flat key: gradient}``): each dp group's rows
        through the tensor-parallel forward, the whole batch's loss. A
        list is taken as :func:`shard_batch_gspmd`'s groups."""
        groups = (batch if isinstance(batch, list)
                  else shard_batch_gspmd(self.mesh, batch))
        groups = [batch_to_device(g, self.device) for g in groups]
        self.tp_model.train()
        whole = {k: torch.cat([g[k] for g in groups]) for k in groups[0]}
        out = (self.tp_model(whole) if self.route_globally
               else _cat_outputs([self.tp_model(g) for g in groups]))
        loss = self.loss_fn(out, whole).float()
        return loss.detach(), grads_of(loss, self.params)

    # -------------------------------------------------- whole tensors
    def _logical(self, flat: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Flat-keyed tensors -> whole tensors by parameter name."""
        out = {}
        for n, split in self.specs.items():
            if split.axis is None:
                if n in flat:
                    out[n] = flat[n]
            elif shard_key(n, 0) in flat:
                out[n] = unshard([flat[shard_key(n, r)]
                                  for r in range(self.mesh.ways(split))],
                                 split)
        return out

    @torch.no_grad()
    def gathered_variables(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, by the model's names (a gather)."""
        return {n: t.detach().clone() for n, t in
                self._logical(self.params).items()}

    def _state_groups(self):
        """The optimizer state by whole leaf: ``(path with the parameter's
        name, flat paths of its parts, split)``, or a counter's
        ``(path, None, None)``."""
        seen = {}
        for path, leaf in state_leaves(self.opt_state):
            key = path[-1]
            name, _, r = key.rpartition("@")
            if (torch.is_tensor(leaf) and r.isdigit()
                    and name in self.specs):
                logical = path[:-1] + (name,)
                if logical not in seen:
                    split = self.specs[name]
                    seen[logical] = ([path[:-1] + (shard_key(name, i),)
                                      for i in range(self.mesh.ways(split))],
                                     split)
            elif torch.is_tensor(leaf):
                seen[path] = ([path], REPLICATED)
            else:
                seen[path] = (None, None)
        return seen

    def _node(self, path):
        node = self.opt_state
        for k in path:
            node = node[k]
        return node

    # ------------------------------------------------- per-shard saves
    def _jax_shards(self, t: torch.Tensor, split: Split):
        """A whole tensor as JAX's shards under its rule: M contiguous
        pieces along the split axis (whole when replicated or when M does
        not divide it), each with its global index."""
        from nezha_tpu_torch.models.convert import _to_jax_leaf
        from nezha_tpu_torch.train.sharded_checkpoint import ShardedLeaf
        arr = _to_jax_leaf(t, False)
        shape = arr.shape
        full = [(0, n) for n in shape]
        m = self.mesh.ways(split)
        if split.axis is None or shape[split.axis] % m:
            return ShardedLeaf(shape, str(arr.dtype), [(tuple(full), arr)])
        step = shape[split.axis] // m
        pieces = []
        for r in range(m):
            idx = list(full)
            idx[split.axis] = (r * step, (r + 1) * step)
            sl = [slice(a, b) for a, b in idx]
            pieces.append((tuple(idx), np.ascontiguousarray(arr[tuple(sl)])))
        return ShardedLeaf(shape, str(arr.dtype), pieces)

    def shard_leaves(self, rng) -> Dict[str, Any]:
        """The JAX gspmd train state as per-shard host leaves: variables
        and optimizer tensors in JAX's shards, counters and ``rng``
        whole."""
        from nezha_tpu_torch.models.convert import opt_state_key
        from nezha_tpu_torch.train.sharded_checkpoint import whole
        whole_params = self._logical(self.params)
        out = {f"variables/{key}": self._jax_shards(
                   whole_params[n].detach(), self.specs[n])
               for n, (key, _) in self.jax_names.items()}
        for logical, (parts, split) in self._state_groups().items():
            key = opt_state_key(logical, self.jax_names)
            if parts is None:
                out[key] = whole(np.asarray(int(self._node(logical)),
                                            np.int32))
                continue
            t = (unshard([self._node(p) for p in parts], split)
                 if split.axis is not None else self._node(parts[0]))
            out[key] = self._jax_shards(t.detach(), split)
        out["rng"] = whole(np.asarray(rng, np.uint32))
        return out

    def restore_request(self):
        """Every leaf whole: variables, optimizer tensors and counters,
        and the key (``restore_sharded``'s template)."""
        from nezha_tpu_torch.models.convert import opt_state_key
        req = {f"variables/{key}": (self.shapes[n], None)
               for n, (key, _) in self.jax_names.items()}
        req["rng"] = ((2,), None)
        for logical, (parts, split) in self._state_groups().items():
            key = opt_state_key(logical, self.jax_names)
            shape = (() if parts is None
                     else self.shapes.get(logical[-1],
                                          tuple(self._node(parts[0]).shape)))
            req[key] = (shape, None)
        return req

    @torch.no_grad()
    def load_restored(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install a restored state (whole leaves by JAX key): each split
        tensor cut into this mesh's shards."""
        from nezha_tpu_torch.models.convert import opt_state_key

        def put(leaves, whole_arr, split):
            t = torch.from_numpy(np.ascontiguousarray(whole_arr))
            for r, leaf in enumerate(leaves):
                part = (shard_slice(t, split, r, self.mesh.ways(split))
                        if split.axis is not None else t)
                leaf.copy_(part.to(device=leaf.device, dtype=leaf.dtype))

        for n, (key, _) in self.jax_names.items():
            split = self.specs[n]
            leaves = ([self.params[n]] if split.axis is None else
                      [self.params[shard_key(n, r)]
                       for r in range(self.mesh.ways(split))])
            put(leaves, arrays[f"variables/{key}"], split)
        for logical, (parts, split) in self._state_groups().items():
            arr = arrays[opt_state_key(logical, self.jax_names)]
            if parts is None:
                node = self._node(logical[:-1])
                node[logical[-1]] = int(np.asarray(arr))
            else:
                put([self._node(p) for p in parts], arr, split)


def make_gspmd_train_step(model: nn.Module, optimizer: Optimizer,
                          loss_fn: Callable, mesh: GspmdMesh,
                          param_specs: Optional[Dict[str, Split]] = None
                          ) -> GSPMDTrainStep:
    """The tensor-parallel train step (:class:`GSPMDTrainStep`): dp over
    the mesh's groups, tp per ``param_specs`` (None: the model's table,
    strictly)."""
    return GSPMDTrainStep(model, optimizer, loss_fn, mesh, param_specs)


__all__ = ["BERT_TP_RULES", "GPT2_TP_RULES", "GSPMDTrainStep", "GspmdMesh",
           "ShardedBert", "auto_partitioner_mesh", "auto_partitioner_scope",
           "make_gspmd_mesh", "make_gspmd_train_step", "opt_state_specs",
           "param_specs_from_rules", "scoped_tp_flash", "shard_batch_gspmd",
           "shard_key", "shard_train_state", "tp_model", "tp_rules",
           "unshard"]
