"""GPT-2 (124M by default) — counterpart of ``nezha_tpu/models/gpt2.py``.

Pre-LN blocks, tanh-GELU MLP, weights tied between the token embedding
and the LM head, logits returned in fp32. Parameter names follow the JAX
package (``wte.embedding``, ``h.{i}.attn.qkv.w``, ...), so weights carry
across by name (``models/convert.py``).

Two attention paths:

- no cache: causal attention composed of tensor ops — the plain reference
  forward;
- a paged cache (the serve engine's block pool): ``cache`` is one
  ``{"k", "v", "tables"}`` dict per layer, pools shaped ``[N, H, bs, D]``
  and ``tables [B, M]`` int32. The forward writes this call's K/V into
  the pools IN PLACE (JAX returns new pools; here the engine's buffers
  are updated where they lie) and attends through the CUDA kernels
  (``ops/cuda``). A ``[B]`` ``pos`` tensor is a decode step (one token
  per row at its own depth); an ``int`` ``pos`` is a prefill chunk at
  that offset. Call under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch
from torch import nn

from nezha_tpu_torch.nn import Embedding, LayerNorm, Linear
from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.ops import causal_mask, dot_product_attention, gelu
from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                      paged_prefill_attention)
from nezha_tpu_torch.tensor.policy import DEFAULT_POLICY, Policy, bf16_policy


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_positions: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4


def _residual_init(cfg: GPT2Config):
    return init_lib.normal(0.02 / (2 * cfg.num_layers) ** 0.5)


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, policy: Policy,
                 generator: torch.Generator, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.qkv = Linear(h, 3 * h, kernel_init=init_lib.normal(0.02),
                          policy=policy, generator=generator, device=device)
        self.proj = Linear(h, h, kernel_init=_residual_init(cfg),
                           policy=policy, generator=generator, device=device)

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                pos: Union[int, torch.Tensor, None] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, h = x.shape
        d = h // cfg.num_heads
        qkv = self.qkv(x).reshape(b, s, 3, cfg.num_heads, d)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                   # [B, H, S, D]
        if cache is None:
            out = dot_product_attention(
                q, k, v, mask=causal_mask(s, s, device=x.device))
        elif isinstance(pos, torch.Tensor) and pos.dim() == 1:
            out = self._decode_paged(q, k, v, cache, pos, active)
        else:
            out = self._prefill_paged(q, k, v, cache, int(pos))
        out = out.transpose(1, 2).reshape(b, s, h)
        return self.proj(out)

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
                 generator: torch.Generator, device=None):
        super().__init__()
        h, m = cfg.hidden_size, cfg.hidden_size * cfg.mlp_ratio
        self.fc = Linear(h, m, kernel_init=init_lib.normal(0.02),
                         policy=policy, generator=generator, device=device)
        self.proj = Linear(m, h, kernel_init=_residual_init(cfg),
                           policy=policy, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(gelu(self.fc(x)))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, policy: Policy,
                 generator: torch.Generator, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.ln_1 = LayerNorm(h, policy=policy, device=device)
        self.attn = Attention(cfg, policy, generator, device)
        self.ln_2 = LayerNorm(h, policy=policy, device=device)
        self.mlp = MLPBlock(cfg, policy, generator, device)

    def forward(self, x, cache=None, pos=None, active=None):
        x = x + self.attn(self.ln_1(x), cache=cache, pos=pos, active=active)
        return x + self.mlp(self.ln_2(x))


class GPT2(nn.Module):
    """``forward(tokens [B, S])`` -> fp32 logits ``[B, S, vocab]``.

    Weights are drawn at construction from ``generator`` (a fresh
    generator on ``device`` seeded with 0 when None)."""

    def __init__(self, cfg: GPT2Config = GPT2Config(),
                 policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator(device=device or "cpu")
            generator.manual_seed(0)
        device = generator.device
        self.cfg = cfg
        self.policy = policy
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, policy=policy,
                             generator=generator)
        self.wpe = Embedding(cfg.max_positions, cfg.hidden_size,
                             embedding_init=init_lib.normal(0.01),
                             policy=policy, generator=generator)
        self.h = nn.ModuleList(Block(cfg, policy, generator, device)
                               for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, policy=policy, device=device)

    def forward(self, tokens: torch.Tensor,
                cache: Optional[List[dict]] = None,
                pos: Union[int, torch.Tensor, None] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``cache``/``pos``/``active``: see the module docstring.
        ``active`` ([B] bool, decode only) marks the rows whose token is
        emitted; the others write scratch and attend nothing."""
        s = tokens.shape[1]
        if s > self.cfg.max_positions:
            raise ValueError(f"sequence length {s} exceeds max_positions "
                             f"{self.cfg.max_positions}")
        steps = torch.arange(s, device=tokens.device)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            positions = pos.long()[:, None] + steps[None, :]
        else:
            positions = (0 if pos is None else int(pos)) + steps[None, :]
        x = self.wte(tokens) + self.wpe(positions)
        for i, block in enumerate(self.h):
            x = block(x, cache=None if cache is None else cache[i], pos=pos,
                      active=active)
        x = self.ln_f(x)
        return self.wte.attend(x).float()


def gpt2_124m(policy: Optional[Policy] = None,
              generator: Optional[torch.Generator] = None, device=None,
              **overrides) -> GPT2:
    return GPT2(GPT2Config(**overrides), policy=policy or bf16_policy(),
                generator=generator, device=device)
