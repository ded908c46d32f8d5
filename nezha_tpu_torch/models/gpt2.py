"""GPT-2 (124M by default) — counterpart of ``nezha_tpu/models/gpt2.py``.

Pre-LN blocks, tanh-GELU MLP, weights tied between the token embedding
and the LM head, logits returned in fp32. Parameter names follow the JAX
package (``wte.embedding``, ``h.{i}.attn.qkv.w``, ...), so weights carry
across by name (``models/convert.py``). The model builds on ``cuda``
unless given ``device="cpu"`` or a CPU generator.

Three attention paths:

- no cache (training, and the plain reference forward): causal
  attention through the flash kernels (``attn_impl`` "flash", which
  "auto" resolves to on every device: the wrapper launches the CUDA
  kernels on CUDA tensors and runs their plain versions on CPU tensors)
  or composed of tensor ops (``attn_impl="xla"``). ``"flash_shmap"`` runs
  the flash kernels on each head group of the enclosing tensor-parallel
  scope's mesh (``parallel.gspmd.auto_partitioner_scope``), as JAX's
  nested ``shard_map``; outside such a scope it raises ``ValueError``
  (the tensor-parallel model, ``parallel/gspmd.py``, splits the heads
  itself). "ring" and "ulysses" are the sequence-parallel attentions:
  only the sequence-parallel step (``parallel/sequence_parallel.py``)
  runs such a model, driving each layer's modules on every shard and
  crossing the shards in :meth:`Attention.attend_shards`; a plain forward
  raises ``ValueError``. Dropout follows the embeddings, each attention
  projection and each MLP projection, in training mode only;
- a paged cache (the serve engine's block pool): ``cache`` is one
  ``{"k", "v", "tables"}`` dict per layer, pools shaped ``[N, H, bs, D]``
  and ``tables [B, M]`` int32. The forward writes this call's K/V into
  the pools IN PLACE (JAX returns new pools; here the engine's buffers
  are updated where they lie) and attends through the CUDA kernels
  (``ops/cuda``). A ``[B]`` ``pos`` tensor is a decode step (one token
  per row at its own depth; the composed path over the gathered blocks
  when ``decode_impl`` refuses the kernel) or, with ``s > 1`` tokens a
  row, a speculative verify window: the window's positions scatter
  through the table (past capacity, and every position of a
  non-emitting row, to scratch block 0) and attend by the composed path
  under a ``[B, 1, s, L]`` mask. An ``int`` ``pos`` is a prefill chunk at
  that offset. Call under ``torch.no_grad()``. A dict that also holds
  ``k_scale``/``v_scale`` ``[N, H]`` is an int8 pool (``ServeConfig.
  kv_dtype="int8"``): a decode step requantizes each row's current block
  with the token inserted (:func:`_quant_decode_write`) and attends
  through the int8 decode kernel; a prefill chunk runs the int8 prefill
  kernel, which writes the chunk's blocks itself and leaves the chunk's
  largest dequant error, a device scalar, in ``cache["qerr"]``.
  ``prefill_impl="xla"`` turns a prefill chunk to tensor ops: the write
  (requantized block by block on an int8 pool) and the composed
  attention over the gathered blocks, as JAX's fallback path;
- a dense cache (``models/generate.py``): ``cache`` is one ``{"k", "v"}``
  dict per layer, buffers ``[B, H, L, D]``. The forward writes this
  call's K/V into them IN PLACE, clamped as JAX's ``dynamic_update_slice``
  clamps: an ``int`` ``pos`` writes the chunk at ``pos`` (start clamped to
  ``[0, L - S]``), a ``[B]`` ``pos`` writes one token per row (clamped to
  ``[0, L - 1]``), or a verify window of ``s`` tokens per row, whose
  positions past ``L`` and whose non-emitting rows are dropped.
  ``prefill=True`` at ``pos == 0`` attends the chunk itself with the
  flash kernel; a single-token step attends ``[0, pos]`` with the dense
  flash-decode kernel (``decode_impl``); everything else takes attention
  composed of tensor ops over the whole buffer.

LayerNorms take ``ln_impl``: "xla" (tensor ops) or "pallas" (the fused
LayerNorm kernels, ``ops/cuda/layer_norm.py``).

``moe_experts`` > 0 makes every ``moe_every``-th block's MLP a routed
expert layer (``parallel/expert.py``); a forward without a cache then
returns ``{"logits", "aux_loss"}`` (or the fused-head dict with
``"aux_loss"``), the MoE layers' load-balance losses weighted by
``moe_aux_weight``, which ``lm_loss`` adds. ``remat`` recomputes each
block in the backward of a training forward without a cache
(``nn/remat.py``: the dropout masks replayed). ``scan_layers`` keeps the
blocks as one layer-stacked module, ``h_scan`` (``nn/scan.py``; JAX's
``ScannedBlocks``): its forward without a cache applies it layer by
layer, and with a cache it slices the stack a layer at a time, each
layer's cache at its unrolled index. :func:`stack_layer_params` and
:func:`unstack_layer_params` convert parameter trees between the
layouts.

Environment switches, read each time a path is resolved, turn the
serving kernels off without a config change, as in the JAX package:
``NEZHA_NO_DECODE_KERNEL`` sends every single-token decode step (dense
and paged, float and int8) down the composed path that
``decode_impl="xla"`` takes, and ``NEZHA_NO_PREFILL_KERNEL`` every paged
prefill chunk down ``prefill_impl="xla"``'s. Each beats a config's
"kernel". ``NEZHA_NO_NESTED_KERNELS`` does both for the per-shard
attention of a mesh (:func:`paged_attention` with ``nested=True``, the
sharded serve engine's), where JAX's kernels run nested in a
``shard_map``.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import List, Optional, Union

import torch
from torch import nn

from nezha_tpu_torch.nn import (Dropout, Embedding, LayerNorm, Linear,
                                resolve_device)
from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.nn.remat import checkpoint, dropout_generators
from nezha_tpu_torch.nn.scan import (layer_slice, scan_stack_apply,
                                     scan_stack_init, stack_prefixed_params,
                                     unstack_prefixed_params)
from nezha_tpu_torch.ops import causal_mask, dot_product_attention, gelu
from nezha_tpu_torch.ops.cuda import (flash_attention,
                                      flash_decode_attention,
                                      paged_decode_attention,
                                      paged_prefill_attention)
from nezha_tpu_torch.ops.losses import lm_objective
from nezha_tpu_torch.ops.quant import (dequantize_kv_block, quantize_kv_block,
                                      sanitize)
from nezha_tpu_torch.tensor.policy import DEFAULT_POLICY, Policy, bf16_policy


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_positions: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0
    # "auto" | "flash" | "xla" | "flash_shmap" | "ring" | "ulysses": "auto"
    # is "flash" on every device (the kernel wrapper picks the CUDA kernel
    # or its plain version by the tensors' device), and under a
    # tensor-parallel mesh the flash kernels on each shard's heads; "xla"
    # is attention composed of tensor ops; "flash_shmap" the flash kernels
    # per head group of the enclosing tensor-parallel scope; "ring" and
    # "ulysses" the sequence-parallel attentions over the shards of the
    # sp train step (the mesh axis sp_axis).
    attn_impl: str = "auto"
    sp_axis: str = "sp"
    # ring/ulysses: None (auto) and True run the flash kernels per hop or
    # per head group (their plain versions on CPU tensors); False the
    # composed attention (JAX's escape hatch).
    sp_use_flash: Optional[bool] = None
    # Single-token decode (dense or paged): "auto" takes the flash-decode
    # kernel unless attn_impl is "xla"; "kernel" always; "xla" never
    # (attention composed of tensor ops).
    decode_impl: str = "auto"
    # A paged prefill chunk, as decode_impl: "auto"/"kernel" take the
    # flash-prefill kernels (B9 float, B10 int8 with its fused write);
    # "xla" writes the chunk by tensor ops and attends by the composed
    # path over the gathered blocks.
    prefill_impl: str = "auto"
    # "xla": LayerNorm in tensor ops; "pallas": the fused kernels.
    ln_impl: str = "xla"
    # 0: forward returns fp32 logits. -1: forward returns {"hidden",
    # "wte", "chunk"} and lm_loss computes the CE from compute-dtype
    # logits with the fp32 upcast inside the logsumexp. > 0: the same
    # dict, and the CE runs over slices of this many positions, one
    # slice's logits live at a time (ops.losses.chunked_lm_cross_entropy).
    fused_loss_chunk: int = 0
    # Mixture-of-experts: > 0 swaps the MLP of every moe_every-th block
    # (blocks 1, 3, 5, ... at 2) for a top-k routed expert layer
    # (parallel/expert.py); the forward then also returns the weighted
    # load-balance loss, which lm_loss adds.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    moe_aux_weight: float = 0.01
    # Keep each block's input only and recompute the block in the
    # backward (training without a cache).
    remat: bool = False
    # The layer-stacked trunk (nn/scan.py): the blocks' parameters live
    # under "h_scan" with a leading [num_layers] dim (JAX's layout) and
    # one block module runs every layer.
    scan_layers: bool = False


SP_ATTN_IMPLS = ("ring", "ulysses")
ATTN_IMPLS = ("auto", "flash", "xla", "flash_shmap") + SP_ATTN_IMPLS


def check_config(cfg: GPT2Config) -> None:
    """Refuse, typed, what the JAX model has and this port does not."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.decode_impl not in ("auto", "kernel", "xla"):
        raise ValueError(f"unknown decode_impl {cfg.decode_impl!r}")
    if cfg.prefill_impl not in ("auto", "kernel", "xla"):
        raise ValueError(f"unknown prefill_impl {cfg.prefill_impl!r}")
    if cfg.ln_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown ln_impl {cfg.ln_impl!r}")
    if cfg.fused_loss_chunk < -1:
        raise ValueError(f"fused_loss_chunk must be 0, -1 or > 0, got "
                         f"{cfg.fused_loss_chunk}")
    if cfg.scan_layers and cfg.moe_experts:
        raise ValueError("scan_layers requires homogeneous blocks; "
                         "incompatible with moe_experts")
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {cfg.dropout}")


# The environment switches that turn serving kernels off (JAX's names).
NO_DECODE_KERNEL = "NEZHA_NO_DECODE_KERNEL"
NO_PREFILL_KERNEL = "NEZHA_NO_PREFILL_KERNEL"
NO_NESTED_KERNELS = "NEZHA_NO_NESTED_KERNELS"


def decode_kernel_ok(cfg: GPT2Config, nested: bool = False) -> bool:
    """Whether a single-token decode step, dense or paged, takes its
    flash-decode kernel (JAX ``_decode_flash_ok``): ``NEZHA_NO_DECODE_
    KERNEL`` refuses it first (and, for a mesh's per-shard attention,
    ``nested``, ``NEZHA_NO_NESTED_KERNELS``: JAX's
    ``_decode_flash_shmap_mesh``), then "kernel" forces it, "xla"
    refuses it, "auto" follows ``attn_impl``, which here resolves to the
    kernels on every device unless it is "xla"."""
    if os.environ.get(NO_DECODE_KERNEL) or (
            nested and os.environ.get(NO_NESTED_KERNELS)):
        return False
    if cfg.decode_impl == "auto":
        return cfg.attn_impl != "xla"
    return cfg.decode_impl == "kernel"


def prefill_kernel_ok(cfg: GPT2Config, nested: bool = False) -> bool:
    """Whether a paged prefill chunk takes the flash-prefill kernels (JAX
    ``_prefill_flash_ok``): ``NEZHA_NO_PREFILL_KERNEL`` refuses them
    first (``nested``: also ``NEZHA_NO_NESTED_KERNELS``), then "kernel"
    forces them, "xla" refuses them, "auto" follows ``attn_impl``, as
    :func:`decode_kernel_ok` does."""
    if os.environ.get(NO_PREFILL_KERNEL) or (
            nested and os.environ.get(NO_NESTED_KERNELS)):
        return False
    if cfg.prefill_impl == "auto":
        return cfg.attn_impl != "xla"
    return cfg.prefill_impl == "kernel"


def _quant_decode_write(pool, scales, blk, off, row) -> None:
    """One decode token's K (or V) into an int8 block pool, IN PLACE, at
    block granularity: each row's target block is dequantized, its
    positions past the write offset zeroed (a freshly bound block holds
    a previous occupant's int8, which must not inflate the new scale),
    the new row inserted, and the block requantized with a fresh
    per-(block, head) scale. Positions below ``off`` re-round only if the
    absmax moved. ``pool [N, H, bs, D]`` int8, ``scales [N, H]`` fp32,
    ``blk``/``off [B]``, ``row [B, H, D]``. Rows write distinct blocks,
    except rows routed to scratch block 0, whose content is unspecified."""
    bs = pool.shape[2]
    deq = pool[blk].float() * scales[blk][:, :, None, None]    # [B,H,bs,D]
    idx = torch.arange(bs, device=pool.device)
    keep = (idx[None, :] < off[:, None])[:, None, :, None]
    sel = (idx[None, :] == off[:, None])[:, None, :, None]
    deq = torch.where(sel, row.float()[:, :, None, :],
                      torch.where(keep, deq, 0.0))
    pool[blk], scales[blk] = quantize_kv_block(deq)


def _quant_prefill_write(pool, scales, tab, pos: int, new, s: int
                         ) -> torch.Tensor:
    """One prefill chunk's K (or V) ``new [b, H, s, D]`` into an int8 block
    pool at offset ``pos`` through ``tab [b, M]``, IN PLACE. The window
    is the ``ceil(s/bs) + 1`` blocks from ``pos // bs``: per touched
    block, positions below the chunk keep their dequantized content,
    chunk positions take the new values and positions past the chunk are
    zeroed, then the block is requantized with a fresh scale. Window rows
    past the chunk's last block (the slack when ``pos`` is block-aligned)
    go to scratch block 0 with zero content. -> the largest dequant error
    over the written positions (a device scalar). The write half of the
    int8 prefill kernel's plain version, and the oracle its kernel is
    held to."""
    bs = pool.shape[2]
    m = tab.shape[1]
    dev = pool.device
    t = min((s - 1) // bs + 2, m)
    tbi_raw = pos // bs + torch.arange(t, device=dev)           # [T]
    touched = tbi_raw <= (pos + s - 1) // bs
    blks = torch.where(touched[None, :],
                       tab.long()[:, tbi_raw.clamp(0, m - 1)], 0)   # [b, T]
    deq = pool[blks].float() * scales[blks][..., None, None]  # [b,T,H,bs,D]
    wpos = tbi_raw[:, None] * bs + torch.arange(bs, device=dev)[None, :]
    keep = (wpos < pos) & touched[:, None]                      # [T, bs]
    in_chunk = (wpos >= pos) & (wpos < pos + s) & touched[:, None]
    neww = new.float()[:, :, (wpos - pos).clamp(0, s - 1), :]  # [b,H,T,bs,D]
    neww = neww.permute(0, 2, 1, 3, 4)                          # [b,T,H,bs,D]
    deq = torch.where(in_chunk[None, :, None, :, None], neww,
                      torch.where(keep[None, :, None, :, None], deq, 0.0))
    qn, sn = quantize_kv_block(deq)
    err = torch.where((keep | in_chunk)[None, :, None, :, None],
                      sanitize(deq) - qn.float() * sn[..., None, None],
                      0.0).abs().max()
    pool[blks], scales[blks] = qn, sn
    return err


def float_prefill_write(kp, vp, tab, pos, k, v) -> None:
    """One prefill chunk's K/V ``[b, H, s, D]`` into float pools
    ``[N, H, bs, D]`` at offset ``pos`` (an int or a 0-d tensor) through
    ``tab [b, M]``, IN PLACE, as one scatter: positions clamped to the
    last one, as the JAX write is (the engine never lets a chunk spill
    past capacity, so no two writes share an index)."""
    s = k.shape[2]
    bs, m = kp.shape[2], tab.shape[1]
    ppos = (pos + torch.arange(s, device=k.device)).clamp(max=m * bs - 1)
    bi = (ppos // bs).clamp(0, m - 1)
    blk = tab.long()[:, bi]                                    # [b, s]
    off = (ppos % bs)[None, :]                                 # [1, s]
    kp[blk, :, off, :] = k.transpose(1, 2).to(kp.dtype)
    vp[blk, :, off, :] = v.transpose(1, 2).to(vp.dtype)


def _gathered_attention(q, kp, vp, tab, pos, scales) -> torch.Tensor:
    """The composed paged attention (JAX ``_apply_paged``'s last branch):
    gather each row's blocks into a dense ``[B, H, L, D]`` view (an int8
    pool dequantized with the kernels' expression), then masked attention
    of the ``s`` queries of a row, at ``pos + j``, over ``[0, pos + j]``.
    Unbound table entries gather scratch, always at or past the row's
    length, so always masked."""
    b, h, s, d = q.shape
    tab = tab.long()
    k_all, v_all = kp[tab], vp[tab]                      # [B, M, H, bs, D]
    if scales is not None:
        k_all = dequantize_kv_block(k_all, scales[0][tab], q.dtype)
        v_all = dequantize_kv_block(v_all, scales[1][tab], q.dtype)
    cap = k_all.shape[1] * k_all.shape[3]
    k_all = k_all.permute(0, 2, 1, 3, 4).reshape(b, h, cap, d)
    v_all = v_all.permute(0, 2, 1, 3, 4).reshape(b, h, cap, d)
    abs_q = pos.long()[:, None] + torch.arange(s, device=q.device)
    attendable = (torch.arange(cap, device=q.device)[None, None, :]
                  <= abs_q[:, :, None])[:, None]                # [B,1,s,L]
    mask = torch.where(attendable, 0.0, float("-inf"))
    return dot_product_attention(q, k_all.to(q.dtype), v_all.to(q.dtype),
                                 mask=mask)


def _residual_init(cfg: GPT2Config):
    return init_lib.normal(0.02 / (2 * cfg.num_layers) ** 0.5)


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, policy: Policy,
                 generator: torch.Generator, device=None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.impl = "flash" if cfg.attn_impl == "auto" else cfg.attn_impl
        self.qkv = Linear(h, 3 * h, kernel_init=init_lib.normal(0.02),
                          policy=policy, generator=generator, device=device)
        self.proj = Linear(h, h, kernel_init=_residual_init(cfg),
                           policy=policy, generator=generator, device=device)
        self.drop = Dropout(cfg.dropout, dropout_generator)

    def heads(self, x: torch.Tensor):
        """``[B, S, h]`` -> q, k, v ``[B, H, S, D]`` (views of one qkv
        product)."""
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.cfg.num_heads,
                                  h // self.cfg.num_heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        return qkv[0], qkv[1], qkv[2]

    def project(self, out: torch.Tensor, drop: bool = True) -> torch.Tensor:
        """Attention's ``[B, H, S, D]`` -> the projection ``[B, S, h]``,
        then dropout (``drop``)."""
        b, _, s, _ = out.shape
        out = self.proj(out.transpose(1, 2).reshape(b, s, -1))
        return self.drop(out) if drop else out

    def attend_shards(self, qs: List[torch.Tensor], ks: List[torch.Tensor],
                      vs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sequence-parallel attention over the shards' blocks
        (``qs[r]`` the queries of positions ``[r S_loc, (r + 1) S_loc)``
        on shard r's device): causal ring attention (``parallel.ring``)
        or Ulysses (``parallel.sequence_parallel``), each with
        ``sp_use_flash``."""
        if self.impl == "ring":
            from nezha_tpu_torch.parallel.ring import ring_attention
            return ring_attention(qs, ks, vs, causal=True,
                                  use_flash=self.cfg.sp_use_flash)
        if self.impl == "ulysses":
            from nezha_tpu_torch.parallel.sequence_parallel import \
                ulysses_attention
            return ulysses_attention(qs, ks, vs, causal=True,
                                     use_flash=self.cfg.sp_use_flash)
        raise ValueError(f"attn_impl={self.impl!r} is not a "
                         f"sequence-parallel attention (ring or ulysses)")

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                pos: Union[int, torch.Tensor, None] = None,
                active: Optional[torch.Tensor] = None,
                prefill: bool = False) -> torch.Tensor:
        cfg = self.cfg
        s = x.shape[1]
        q, k, v = self.heads(x)                            # [B, H, S, D]
        if cache is None:
            if self.impl in SP_ATTN_IMPLS:
                raise ValueError(
                    f"attn_impl={self.impl!r} attends across the shards of "
                    f"a sequence-parallel step (parallel.sequence_parallel."
                    f"make_sp_train_step); evaluate with attn_impl 'auto' "
                    f"(models.gpt2.with_overrides)")
            if self.impl == "flash_shmap":
                from nezha_tpu_torch.parallel.gspmd import scoped_tp_flash
                out = scoped_tp_flash(q, k, v, cfg.num_heads, causal=True)
            elif self.impl == "flash":
                out = flash_attention(q, k, v, causal=True)
            else:
                out = dot_product_attention(
                    q, k, v, mask=causal_mask(s, s, device=x.device))
        elif "tables" not in cache:
            out = self._dense(q, k, v, cache, pos, active, prefill)
        else:
            out = paged_attention(q, k, v, cache, pos, active, cfg)
        return self.project(out, drop=cache is None)

    def _dense(self, q, k, v, cache, pos, active, prefill: bool):
        """The dense-cache branch (JAX ``Attention.apply``, cache without
        ``"tables"``): write K/V in place, then attend."""
        kc, vc = cache["k"], cache["v"]
        b, _, s, _ = q.shape
        cap = kc.shape[2]
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        if per_row and s > 1:
            # A verify window: a per-position scatter that DROPS positions
            # past capacity and every position of a non-emitting row (a
            # clamped window start would overwrite valid prefix K/V). A
            # dropped position writes back what its clamped index holds,
            # one window position at a time, so that no two writes of a
            # call share an index and no boolean index syncs the host.
            rows = torch.arange(b, device=q.device)
            for j in range(s):
                at = pos.long() + j
                keep = at < cap
                if active is not None:
                    keep = keep & active
                at = at.clamp(max=cap - 1)
                for c, new in ((kc, k), (vc, v)):
                    c[rows, :, at, :] = torch.where(
                        keep[:, None, None], new[:, :, j, :].to(c.dtype),
                        c[rows, :, at, :])
        elif per_row:
            at = pos.long().clamp(0, cap - 1)
            rows = torch.arange(b, device=q.device)
            kc[rows, :, at, :] = k[:, :, 0, :].to(kc.dtype)
            vc[rows, :, at, :] = v[:, :, 0, :].to(vc.dtype)
        else:
            pos = int(pos)
            at = min(max(pos, 0), cap - s)
            kc[:, :, at:at + s, :] = k.to(kc.dtype)
            vc[:, :, at:at + s, :] = v.to(vc.dtype)
        if (prefill and s > 1 and not per_row and pos == 0
                and self.impl == "flash"):
            # Nothing precedes the prompt: causal flash attention within
            # the chunk is the whole answer (the JAX path pads S to 128
            # for the TPU's blocks; the CUDA kernel takes any S).
            return flash_attention(q, k, v, causal=True)
        if not prefill and s == 1 and decode_kernel_ok(self.cfg):
            lengths = (pos if per_row else torch.full(
                (b,), pos, device=q.device)) + 1
            if active is not None:
                lengths = torch.where(active, lengths, 0)
            return flash_decode_attention(q.contiguous(), kc, vc,
                                          lengths.to(torch.int32))
        steps = torch.arange(s, device=q.device)
        if per_row:
            abs_q = pos.long()[:, None] + steps[None, :]          # [B, s]
            attendable = (torch.arange(cap, device=q.device)[None, None, :]
                          <= abs_q[:, :, None])[:, None]         # [B,1,s,L]
        else:
            attendable = (torch.arange(cap, device=q.device)[None, :]
                          <= (pos + steps)[:, None])              # [s, L]
        mask = torch.where(attendable, 0.0, float("-inf"))
        return dot_product_attention(q, kc.to(q.dtype), vc.to(q.dtype),
                                     mask=mask)

    @staticmethod
    def _decode_paged(q, k, v, cache, pos, active, use_kernel: bool = True):
        """One token per row at its own depth (``_apply_paged``'s per-row
        branch): write K/V at ``pos`` through the table — clamped to the
        last position, inactive rows routed to scratch block 0 — then
        attend ``[0, pos]`` with the flash-decode kernel; inactive rows
        get length 0 and attend nothing. An int8 pool requantizes the
        written blocks (:func:`_quant_decode_write`) and attends through
        the int8 kernel. ``use_kernel=False`` (``decode_impl="xla"``)
        attends by the composed path over the gathered blocks."""
        kp, vp, tab = cache["k"], cache["v"], cache["tables"]
        bs, m = kp.shape[2], tab.shape[1]
        pos_w = pos.long().clamp(max=m * bs - 1)
        bi = (pos_w // bs).clamp(0, m - 1)
        blk = tab.long().gather(1, bi[:, None])[:, 0]
        off = pos_w % bs
        lengths = pos.int() + 1
        if active is not None:
            blk = torch.where(active, blk, 0)
            off = torch.where(active, off, 0)
            lengths = torch.where(active, lengths, 0)
        scales = None
        if "k_scale" in cache:
            scales = (cache["k_scale"], cache["v_scale"])
            _quant_decode_write(kp, scales[0], blk, off, k[:, :, 0, :])
            _quant_decode_write(vp, scales[1], blk, off, v[:, :, 0, :])
        else:
            kp[blk, :, off, :] = k[:, :, 0, :].to(kp.dtype)
            vp[blk, :, off, :] = v[:, :, 0, :].to(vp.dtype)
        if not use_kernel:
            return _gathered_attention(q, kp, vp, tab, pos, scales)
        return paged_decode_attention(q.contiguous(), kp, vp,
                                      lengths.int(), tab,
                                      block_scales=scales)

    @staticmethod
    def _verify_paged(q, k, v, cache, pos, active):
        """A speculative verify window: ``s`` tokens per row from its own
        ``pos`` (JAX ``_apply_paged``'s ``per_row and s > 1`` branch). The
        window scatters through the table; a position past the table's
        capacity, and every position of a non-emitting row, goes to
        scratch block 0 (a position past the row's bound frontier finds a
        scratch entry in the table already). An int8 pool requantizes one
        window position at a time (:func:`_quant_decode_write`), so that
        the window lands exactly as ``s`` single-token decodes would.
        Attention is the composed path over the gathered blocks."""
        kp, vp, tab = cache["k"], cache["v"], cache["tables"]
        s = q.shape[2]
        bs, m = kp.shape[2], tab.shape[1]
        cap = m * bs
        ppos = pos.long()[:, None] + torch.arange(s, device=q.device)
        route = ppos >= cap
        if active is not None:
            route = route | ~active[:, None]
        ppos_c = ppos.clamp(max=cap - 1)
        bi = (ppos_c // bs).clamp(0, m - 1)
        blk = torch.where(route, 0, tab.long().gather(1, bi))     # [B, s]
        off = torch.where(route, 0, ppos_c % bs)
        scales = None
        if "k_scale" in cache:
            scales = (cache["k_scale"], cache["v_scale"])
            for j in range(s):
                _quant_decode_write(kp, scales[0], blk[:, j], off[:, j],
                                    k[:, :, j, :])
                _quant_decode_write(vp, scales[1], blk[:, j], off[:, j],
                                    v[:, :, j, :])
        else:
            kp[blk, :, off, :] = k.transpose(1, 2).to(kp.dtype)
            vp[blk, :, off, :] = v.transpose(1, 2).to(vp.dtype)
        return _gathered_attention(q, kp, vp, tab, pos, scales)

    @staticmethod
    def _prefill_paged(q, k, v, cache, pos: int, use_kernel: bool = True):
        """A prompt chunk at offset ``pos``: one scatter of the chunk's
        K/V through the table (:func:`float_prefill_write`), and the
        flash-prefill kernel, which reads the pool only below ``pos`` —
        write and attention commute. An int8 pool takes the int8 prefill
        kernel instead, which writes the chunk's blocks itself, after its
        attention has read them, and whose error sample lands in
        ``cache["qerr"]``. ``use_kernel=False`` (``prefill_impl="xla"``)
        writes the chunk first (:func:`_quant_prefill_write` on an int8
        pool, the float scatter otherwise) and attends by the composed
        path over the gathered blocks (:func:`_gathered_attention`)."""
        kp, vp, tab = cache["k"], cache["v"], cache["tables"]
        b = q.shape[0]
        starts = torch.full((b,), pos, dtype=torch.int32, device=q.device)
        if not use_kernel:
            scales = None
            if "k_scale" in cache:
                scales = (cache["k_scale"], cache["v_scale"])
                s = k.shape[2]
                ek = _quant_prefill_write(kp, scales[0], tab, pos, k, s)
                ev = _quant_prefill_write(vp, scales[1], tab, pos, v, s)
                cache["qerr"] = torch.maximum(ek, ev)
            else:
                float_prefill_write(kp, vp, tab, pos, k, v)
            return _gathered_attention(q, kp, vp, tab, starts, scales)
        if "k_scale" in cache:
            out, cache["qerr"] = paged_prefill_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), kp, vp, tab,
                starts, block_scales=(cache["k_scale"], cache["v_scale"]))
            return out
        float_prefill_write(kp, vp, tab, pos, k, v)
        return paged_prefill_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), kp, vp, tab, starts)


def paged_attention(q, k, v, cache: dict, pos, active, cfg: GPT2Config,
                    nested: bool = False) -> torch.Tensor:
    """The paged-cache branches of :class:`Attention` on one pool (a
    single-device pool, or one shard's heads and pool shard under a
    mesh, ``nested=True``): a ``[B]`` ``pos`` with ``s > 1`` query rows
    is a speculative verify window (composed), with one a decode step
    (the flash-decode kernel unless :func:`decode_kernel_ok` refuses
    it); an ``int`` ``pos`` is a prefill chunk (the flash-prefill
    kernels unless :func:`prefill_kernel_ok` refuses them)."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if q.shape[2] > 1:
            return Attention._verify_paged(q, k, v, cache, pos, active)
        return Attention._decode_paged(
            q, k, v, cache, pos, active,
            use_kernel=decode_kernel_ok(cfg, nested))
    return Attention._prefill_paged(q, k, v, cache, int(pos),
                                    use_kernel=prefill_kernel_ok(cfg,
                                                                 nested))


class MLPBlock(nn.Module):
    def __init__(self, cfg: GPT2Config, policy: Policy,
                 generator: torch.Generator, device=None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        h, m = cfg.hidden_size, cfg.hidden_size * cfg.mlp_ratio
        self.fc = Linear(h, m, kernel_init=init_lib.normal(0.02),
                         policy=policy, generator=generator, device=device)
        self.proj = Linear(m, h, kernel_init=_residual_init(cfg),
                           policy=policy, generator=generator, device=device)
        self.drop = Dropout(cfg.dropout, dropout_generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.proj(gelu(self.fc(x))))


class Block(nn.Module):
    """Pre-LN block; with ``use_moe`` its MLP is a routed expert layer
    (:class:`~nezha_tpu_torch.parallel.expert.MoE`)."""

    def __init__(self, cfg: GPT2Config, policy: Policy,
                 generator: torch.Generator, device=None,
                 dropout_generator: Optional[torch.Generator] = None,
                 use_moe: bool = False):
        super().__init__()
        h = cfg.hidden_size
        self.ln_1 = LayerNorm(h, policy=policy, device=device,
                              impl=cfg.ln_impl)
        self.attn = Attention(cfg, policy, generator, device,
                              dropout_generator)
        self.ln_2 = LayerNorm(h, policy=policy, device=device,
                              impl=cfg.ln_impl)
        if use_moe:
            from nezha_tpu_torch.parallel.expert import MoE, MoEConfig
            self.mlp = MoE(MoEConfig(d_model=h, d_ff=h * cfg.mlp_ratio,
                                     num_experts=cfg.moe_experts,
                                     top_k=cfg.moe_top_k),
                           policy=policy, generator=generator)
        else:
            self.mlp = MLPBlock(cfg, policy, generator, device,
                                dropout_generator)

    def forward_aux(self, x, cache=None, pos=None, active=None,
                    prefill=False):
        """-> (output, the MoE layer's aux loss or None)."""
        x = x + self.attn(self.ln_1(x), cache=cache, pos=pos, active=active,
                          prefill=prefill)
        return self.mlp_residual(x)

    def mlp_residual(self, x):
        """The block's second half, ``x + mlp(ln_2(x))`` -> (output, the
        MoE layer's aux loss or None)."""
        y = self.mlp(self.ln_2(x))
        y, aux = y if isinstance(y, tuple) else (y, None)
        return x + y, aux

    def forward(self, x, cache=None, pos=None, active=None, prefill=False):
        return self.forward_aux(x, cache, pos, active, prefill)[0]


class GPT2(nn.Module):
    """``forward(tokens [B, S])`` -> fp32 logits ``[B, S, vocab]``, or
    the fused-head dict (``GPT2Config.fused_loss_chunk``). ``forward``
    also takes ``{"tokens": [B, S + 1]}`` (inputs are ``tokens[:, :-1]``,
    the convention of :func:`lm_loss`).

    Weights are drawn at construction from ``generator`` (a fresh
    generator on ``device`` — ``cuda`` when None — seeded with 0 when
    None). Dropout masks come from a generator of their own, seeded from
    that stream after the weights."""

    def __init__(self, cfg: GPT2Config = GPT2Config(),
                 policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        check_config(cfg)
        device = resolve_device(device, generator)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.cfg = cfg
        self.policy = policy
        drop_gen = torch.Generator(device=device)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, policy=policy,
                             generator=generator)
        self.wpe = Embedding(cfg.max_positions, cfg.hidden_size,
                             embedding_init=init_lib.normal(0.01),
                             policy=policy, generator=generator)
        self.drop = Dropout(cfg.dropout, drop_gen)
        blocks = [Block(cfg, policy, generator, device, drop_gen,
                        use_moe=bool(cfg.moe_experts)
                        and i % cfg.moe_every == cfg.moe_every - 1)
                  for i in range(cfg.num_layers)]
        if cfg.scan_layers:
            # The same draws as the unrolled blocks, then stacked.
            self.h_scan = scan_stack_init(blocks)
            self.h = nn.ModuleList()
        else:
            self.h = nn.ModuleList(blocks)
        self.ln_f = LayerNorm(cfg.hidden_size, policy=policy, device=device,
                              impl=cfg.ln_impl)
        drop_gen.manual_seed(int(torch.randint(
            2 ** 62, (1,), generator=generator, device=device)))

    def forward(self, tokens, cache: Optional[List[dict]] = None,
                pos: Union[int, torch.Tensor, None] = None,
                active: Optional[torch.Tensor] = None,
                prefill: bool = False):
        """``cache``/``pos``/``active``/``prefill``: see the module
        docstring. ``active`` ([B] bool, decode only) marks the rows whose
        token is emitted; the others attend nothing (and, in the paged
        cache, write scratch). ``prefill=True`` promises the chunk is the
        whole prefix of a dense cache written from position 0."""
        if isinstance(tokens, dict):
            tokens = tokens["tokens"][:, :-1]
        s = tokens.shape[1]
        if s > self.cfg.max_positions:
            raise ValueError(f"sequence length {s} exceeds max_positions "
                             f"{self.cfg.max_positions}")
        x = self.embed(tokens, pos)
        remat = self.cfg.remat and self.training and cache is None
        if self.cfg.scan_layers:
            if cache is None:
                x = scan_stack_apply(self.h_scan, x, self.cfg.num_layers,
                                     remat=remat, pos=pos)
            else:
                # Decode: one layer's slice of the stack at a time, each
                # layer's cache at its unrolled index.
                for i in range(self.cfg.num_layers):
                    x = torch.func.functional_call(
                        self.h_scan, layer_slice(self.h_scan, i), (x,),
                        dict(cache=cache[i], pos=pos, active=active,
                             prefill=prefill))
        terms = []
        for i, block in enumerate(self.h):
            if remat:
                # Only the block's input is kept; the backward recomputes
                # the block, its dropout masks replayed.
                x, aux = checkpoint(block.forward_aux, x, pos=pos,
                                    generators=dropout_generators(block))
            else:
                x, aux = block.forward_aux(
                    x, cache=None if cache is None else cache[i], pos=pos,
                    active=active, prefill=prefill)
            if aux is not None:
                terms.append(aux)
        return self.head(x, terms if cache is None else [],
                         fused=cache is None)

    def embed(self, tokens: torch.Tensor,
              pos: Union[int, torch.Tensor, None] = None) -> torch.Tensor:
        """Token plus position embeddings of ``tokens [B, S]``, then
        dropout. An ``int`` ``pos`` offsets the positions (a prefill chunk,
        or a sequence-parallel shard's first global position); a ``[B]``
        tensor offsets each row."""
        steps = torch.arange(tokens.shape[1], device=tokens.device)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            positions = pos.long()[:, None] + steps[None, :]
        else:
            positions = (0 if pos is None else int(pos)) + steps[None, :]
        return self.drop(self.wte(tokens) + self.wpe(positions))

    def head(self, x: torch.Tensor, terms: List[torch.Tensor],
             fused: bool = True):
        """``ln_f`` and the tied head of the last block's output: fp32
        logits, or (``fused`` and ``fused_loss_chunk``) the fused-head
        dict; with MoE ``terms`` (the layers' aux losses) also their
        weighted sum."""
        x = self.ln_f(x)
        # The MoE layers' load-balance losses, weighted (JAX harvests them
        # out of the blocks' state); a cached forward carries none.
        aux = self.cfg.moe_aux_weight * sum(terms) if terms else None
        if self.cfg.fused_loss_chunk and fused:
            # The LM head moves into the loss (lm_loss); gradients reach
            # the tied table through this dict.
            out = {"hidden": x, "wte": self.wte.embedding,
                   "chunk": self.cfg.fused_loss_chunk}
            if aux is not None:
                out["aux_loss"] = aux
            return out
        logits = self.wte.attend(x).float()
        if aux is not None:
            return {"logits": logits, "aux_loss": aux}
        return logits


def gpt2_124m(policy: Optional[Policy] = None,
              generator: Optional[torch.Generator] = None, device=None,
              **overrides) -> GPT2:
    return GPT2(GPT2Config(**overrides), policy=policy or bf16_policy(),
                generator=generator, device=device)


def with_overrides(model: GPT2, **overrides) -> GPT2:
    """``model`` under ``dataclasses.replace(model.cfg, **overrides)``
    over the SAME parameter tensors (JAX rebuilds the module tree around
    a replaced config and passes the same variables): every module is
    copied shallowly — parameters, buffers and generators shared — and
    each copy that holds the config gets the new one."""
    cfg = dataclasses.replace(model.cfg, **overrides)
    check_config(cfg)

    def clone(mod: nn.Module) -> nn.Module:
        new = copy.copy(mod)
        new._modules = {name: clone(child)
                        for name, child in mod._modules.items()}
        if isinstance(new, (GPT2, Attention)):
            new.cfg = cfg
        if isinstance(new, Attention):
            new.impl = "flash" if cfg.attn_impl == "auto" else cfg.attn_impl
        return new

    return clone(model)


def stack_layer_params(params: dict, num_layers: int) -> dict:
    """Unrolled GPT-2 params (a JAX-layout tree, ``h0`` .. ``h{L-1}``) ->
    the scan layout (``h_scan`` with a leading layer dim). Non-trunk
    entries pass through."""
    return stack_prefixed_params(params, "h", num_layers, "h_scan")


def unstack_layer_params(params: dict, num_layers: int) -> dict:
    """Scan-layout GPT-2 params -> the unrolled ``h{i}`` layout."""
    return unstack_prefixed_params(params, "h", num_layers, "h_scan")


def lm_loss(out, batch: dict) -> torch.Tensor:
    """Next-token CE over ``{"tokens": [B, S + 1]}`` batches; ``out`` is
    dense logits or the fused-head dict."""
    return lm_objective(out, batch["tokens"][:, 1:])
