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
  or composed of tensor ops (``attn_impl="xla"``). Dropout follows the
  embeddings, each attention projection and each MLP projection, in
  training mode only;
- a paged cache (the serve engine's block pool): ``cache`` is one
  ``{"k", "v", "tables"}`` dict per layer, pools shaped ``[N, H, bs, D]``
  and ``tables [B, M]`` int32. The forward writes this call's K/V into
  the pools IN PLACE (JAX returns new pools; here the engine's buffers
  are updated where they lie) and attends through the CUDA kernels
  (``ops/cuda``). A ``[B]`` ``pos`` tensor is a decode step (one token
  per row at its own depth); an ``int`` ``pos`` is a prefill chunk at
  that offset. Call under ``torch.no_grad()``;
- a dense cache (``models/generate.py``): ``cache`` is one ``{"k", "v"}``
  dict per layer, buffers ``[B, H, L, D]``. The forward writes this
  call's K/V into them IN PLACE, clamped as JAX's ``dynamic_update_slice``
  clamps: an ``int`` ``pos`` writes the chunk at ``pos`` (start clamped to
  ``[0, L - S]``), a ``[B]`` ``pos`` writes one token per row (clamped to
  ``[0, L - 1]``). ``prefill=True`` at ``pos == 0`` attends the chunk
  itself with the flash kernel; a single-token step attends ``[0, pos]``
  with the dense flash-decode kernel (``decode_impl``); everything else
  takes attention composed of tensor ops over the whole buffer.

LayerNorms take ``ln_impl``: "xla" (tensor ops) or "pallas" (the fused
LayerNorm kernels, ``ops/cuda/layer_norm.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch
from torch import nn

from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.nn import (Dropout, Embedding, LayerNorm, Linear,
                                resolve_device)
from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.ops import causal_mask, dot_product_attention, gelu
from nezha_tpu_torch.ops.cuda import (flash_attention,
                                      flash_decode_attention,
                                      paged_decode_attention,
                                      paged_prefill_attention)
from nezha_tpu_torch.ops.losses import lm_objective
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
    # "auto" | "flash" | "xla": "auto" is "flash" on every device (the
    # kernel wrapper picks the CUDA kernel or its plain version by the
    # tensors' device); "xla" is attention composed of tensor ops.
    attn_impl: str = "auto"
    # Single-token dense-cache decode: "auto" takes the flash-decode
    # kernel unless attn_impl is "xla"; "kernel" always; "xla" never
    # (attention composed of tensor ops).
    decode_impl: str = "auto"
    # "xla": LayerNorm in tensor ops; "pallas": the fused kernels.
    ln_impl: str = "xla"
    # 0: forward returns fp32 logits. -1: forward returns {"hidden",
    # "wte", "chunk"} and lm_loss computes the CE from compute-dtype
    # logits with the fp32 upcast inside the logsumexp.
    fused_loss_chunk: int = 0
    # Knobs of the JAX model this port refuses (NotPortedError).
    moe_experts: int = 0
    remat: bool = False
    scan_layers: bool = False


_NOT_PORTED_ATTN = ("ring", "ulysses", "flash_shmap")


def check_config(cfg: GPT2Config) -> None:
    """Refuse, typed, what the JAX model has and this port does not."""
    if cfg.attn_impl in _NOT_PORTED_ATTN:
        raise NotPortedError(f"attn_impl={cfg.attn_impl!r} is not ported "
                             f"(sequence/tensor-parallel attention)")
    if cfg.attn_impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.decode_impl not in ("auto", "kernel", "xla"):
        raise ValueError(f"unknown decode_impl {cfg.decode_impl!r}")
    if cfg.ln_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown ln_impl {cfg.ln_impl!r}")
    if cfg.fused_loss_chunk > 0:
        raise NotPortedError(f"fused_loss_chunk={cfg.fused_loss_chunk} "
                             f"(the chunked loss scan) is not ported")
    if cfg.fused_loss_chunk not in (0, -1):
        raise ValueError(f"fused_loss_chunk must be 0, -1 or > 0, got "
                         f"{cfg.fused_loss_chunk}")
    for knob in ("moe_experts", "remat", "scan_layers"):
        if getattr(cfg, knob):
            raise NotPortedError(f"{knob} is not ported")
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {cfg.dropout}")


def decode_kernel_ok(cfg: GPT2Config) -> bool:
    """Whether a single-token dense-cache step takes the flash-decode
    kernel (JAX ``_decode_flash_ok``): "kernel" forces it, "xla" refuses
    it, "auto" follows ``attn_impl``, which here resolves to the kernels
    on every device unless it is "xla"."""
    if cfg.decode_impl == "auto":
        return cfg.attn_impl != "xla"
    return cfg.decode_impl == "kernel"


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

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                pos: Union[int, torch.Tensor, None] = None,
                active: Optional[torch.Tensor] = None,
                prefill: bool = False) -> torch.Tensor:
        cfg = self.cfg
        b, s, h = x.shape
        d = h // cfg.num_heads
        qkv = self.qkv(x).reshape(b, s, 3, cfg.num_heads, d)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                   # [B, H, S, D]
        if cache is None:
            if self.impl == "flash":
                out = flash_attention(q, k, v, causal=True)
            else:
                out = dot_product_attention(
                    q, k, v, mask=causal_mask(s, s, device=x.device))
        elif "tables" not in cache:
            out = self._dense(q, k, v, cache, pos, active, prefill)
        elif isinstance(pos, torch.Tensor) and pos.dim() == 1:
            out = self._decode_paged(q, k, v, cache, pos, active)
        else:
            out = self._prefill_paged(q, k, v, cache, int(pos))
        out = self.proj(out.transpose(1, 2).reshape(b, s, h))
        return self.drop(out) if cache is None else out

    def _dense(self, q, k, v, cache, pos, active, prefill: bool):
        """The dense-cache branch (JAX ``Attention.apply``, cache without
        ``"tables"``): write K/V in place, then attend."""
        kc, vc = cache["k"], cache["v"]
        b, _, s, _ = q.shape
        cap = kc.shape[2]
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        if per_row and s > 1:
            raise NotPortedError("per-row positions with more than one "
                                 "token per row (speculative verify "
                                 "windows) on the dense cache are not "
                                 "ported")
        if per_row:
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
    def _decode_paged(q, k, v, cache, pos, active):
        """One token per row at its own depth (``_apply_paged``'s per-row
        branch): write K/V at ``pos`` through the table — clamped to the
        last position, inactive rows routed to scratch block 0 — then
        attend ``[0, pos]`` with the flash-decode kernel; inactive rows
        get length 0 and attend nothing."""
        if q.shape[2] != 1:
            raise ValueError(
                f"per-row positions take one token per row, got "
                f"{q.shape[2]} (speculative verify windows are not ported)")
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
        kp[blk, :, off, :] = k[:, :, 0, :].to(kp.dtype)
        vp[blk, :, off, :] = v[:, :, 0, :].to(vp.dtype)
        return paged_decode_attention(q.contiguous(), kp, vp,
                                      lengths.int(), tab)

    @staticmethod
    def _prefill_paged(q, k, v, cache, pos: int):
        """A prompt chunk at offset ``pos``: one scatter of the chunk's
        K/V through the table (positions clamped to the last one, as the
        JAX write is; the engine never lets a chunk spill past capacity,
        so no two writes share an index), and the flash-prefill kernel,
        which reads the pool only below ``pos`` — write and attention
        commute."""
        kp, vp, tab = cache["k"], cache["v"], cache["tables"]
        b, _, s, _ = q.shape
        bs, m = kp.shape[2], tab.shape[1]
        ppos = (pos + torch.arange(s, device=q.device)).clamp(max=m * bs - 1)
        bi = (ppos // bs).clamp(0, m - 1)
        blk = tab.long()[:, bi]                                # [b, s]
        off = (ppos % bs)[None, :]                             # [1, s]
        kp[blk, :, off, :] = k.transpose(1, 2).to(kp.dtype)
        vp[blk, :, off, :] = v.transpose(1, 2).to(vp.dtype)
        starts = torch.full((b,), pos, dtype=torch.int32, device=q.device)
        return paged_prefill_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), kp, vp, tab, starts)


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
    def __init__(self, cfg: GPT2Config, policy: Policy,
                 generator: torch.Generator, device=None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        h = cfg.hidden_size
        self.ln_1 = LayerNorm(h, policy=policy, device=device,
                              impl=cfg.ln_impl)
        self.attn = Attention(cfg, policy, generator, device,
                              dropout_generator)
        self.ln_2 = LayerNorm(h, policy=policy, device=device,
                              impl=cfg.ln_impl)
        self.mlp = MLPBlock(cfg, policy, generator, device,
                            dropout_generator)

    def forward(self, x, cache=None, pos=None, active=None, prefill=False):
        x = x + self.attn(self.ln_1(x), cache=cache, pos=pos, active=active,
                          prefill=prefill)
        return x + self.mlp(self.ln_2(x))


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
        self.h = nn.ModuleList(Block(cfg, policy, generator, device,
                                     drop_gen)
                               for _ in range(cfg.num_layers))
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
        steps = torch.arange(s, device=tokens.device)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            positions = pos.long()[:, None] + steps[None, :]
        else:
            positions = (0 if pos is None else int(pos)) + steps[None, :]
        x = self.drop(self.wte(tokens) + self.wpe(positions))
        for i, block in enumerate(self.h):
            x = block(x, cache=None if cache is None else cache[i], pos=pos,
                      active=active, prefill=prefill)
        x = self.ln_f(x)
        if self.cfg.fused_loss_chunk and cache is None:
            # The LM head moves into the loss (lm_loss); gradients reach
            # the tied table through this dict.
            return {"hidden": x, "wte": self.wte.embedding,
                    "chunk": self.cfg.fused_loss_chunk}
        return self.wte.attend(x).float()


def gpt2_124m(policy: Optional[Policy] = None,
              generator: Optional[torch.Generator] = None, device=None,
              **overrides) -> GPT2:
    return GPT2(GPT2Config(**overrides), policy=policy or bf16_policy(),
                generator=generator, device=device)


def lm_loss(out, batch: dict) -> torch.Tensor:
    """Next-token CE over ``{"tokens": [B, S + 1]}`` batches; ``out`` is
    dense logits or the fused-head dict."""
    return lm_objective(out, batch["tokens"][:, 1:])
