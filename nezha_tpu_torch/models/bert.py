"""BERT-base with an MLM head — counterpart of ``nezha_tpu/models/bert.py``.

A bidirectional post-LN encoder with erf GELU; the MLM decoder is tied
to the token embedding, with a free output bias ``mlm_bias``. Parameter
names follow the JAX package (``tok_emb.embedding``,
``layers.{i}.qkv.w``, ``mlm_bias``, ...), so weights carry across by name
(``models/convert.py`` :func:`bert_from_jax`). The model builds on
``cuda`` unless given ``device="cpu"`` or a CPU generator.

Batches are dicts: ``{"tokens": [B, S], "segment_ids": [B, S],
"labels": [B, S]}`` with -100 at the positions the loss skips, and
optionally one of

- ``padding_mask`` ``[B, S]`` (True at real tokens): an additive mask
  over the keys, which only composed attention can apply;
- ``kv_lengths`` ``[B]`` (right-padded rows): keys at or past a row's
  length are masked, clamped to >= 1 as the kernel clamps them. Query
  rows past a length still attend the row's first keys; their labels
  should be -100.

Attention (``attn_impl``): "flash" runs the flash kernels non-causal
(``ops/cuda``: the CUDA kernels on CUDA tensors, their plain versions on
CPU tensors), with ``kv_lengths`` when given; "xla" is attention
composed of tensor ops, over a prefix mask built from ``kv_lengths``
when no padding mask is given; "auto" is "flash" unless the batch holds
a padding mask, then "xla"; "flash_shmap" runs the flash kernels on each
head group of the enclosing tensor-parallel scope's mesh
(``parallel.gspmd``; outside one it raises ``ValueError``). "flash" and
"flash_shmap" refuse a padding mask, as in JAX. LayerNorms take ``ln_impl``: "xla" (tensor
ops) or "pallas" (the fused LayerNorm kernels). ``scan_layers`` keeps
the encoder as one layer-stacked module, ``layers_scan`` (``nn/scan.py``,
JAX's ``ScannedEncoder``), applied layer by layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from nezha_tpu_torch.nn import (Dropout, Embedding, LayerNorm, Linear,
                                resolve_device)
from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.nn.scan import scan_stack_apply, scan_stack_init
from nezha_tpu_torch.ops import dot_product_attention, gelu
from nezha_tpu_torch.ops.attention import make_attention_mask
from nezha_tpu_torch.ops.cuda import flash_attention
from nezha_tpu_torch.ops.losses import (
    lm_ce_from_fused, softmax_cross_entropy_with_integer_labels)
from nezha_tpu_torch.tensor.policy import DEFAULT_POLICY, Policy, bf16_policy


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_positions: int = 512
    type_vocab_size: int = 2
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0
    # Published BERT checkpoints use 1e-12.
    ln_eps: float = 1e-12
    # 0: forward returns fp32 logits. -1: in training, forward returns
    # {"hidden", "wte", "bias", "chunk"} and mlm_loss computes the CE
    # from compute-dtype logits with the fp32 upcast inside the
    # logsumexp. > 0: the same dict, and the CE runs over slices of this
    # many positions (ops.losses.chunked_lm_cross_entropy).
    fused_loss_chunk: int = 0
    # "auto" | "flash" | "xla" | "flash_shmap" (see the module
    # docstring).
    attn_impl: str = "auto"
    # "xla": LayerNorm in tensor ops; "pallas": the fused kernels.
    ln_impl: str = "xla"
    # The layer-stacked encoder (nn/scan.py): the layers' parameters live
    # under "layers_scan" with a leading [num_layers] dim (JAX's layout).
    scan_layers: bool = False


def check_config(cfg: BertConfig) -> None:
    """Refuse, typed, what the JAX model has and this port does not."""
    if cfg.attn_impl not in ("auto", "flash", "xla", "flash_shmap"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.ln_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown ln_impl {cfg.ln_impl!r}")
    if cfg.fused_loss_chunk < -1:
        raise ValueError(f"fused_loss_chunk must be 0, -1 or > 0, got "
                         f"{cfg.fused_loss_chunk}")
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {cfg.dropout}")


class EncoderLayer(nn.Module):
    """Post-LN encoder layer (the original BERT topology): attention,
    its projection and dropout, ``attn_ln(x + att)``; the erf-GELU MLP,
    ``out_ln(x + y)``."""

    def __init__(self, cfg: BertConfig, policy: Policy,
                 generator: torch.Generator, device=None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        lin = dict(kernel_init=init_lib.normal(0.02), policy=policy,
                   generator=generator, device=device)
        ln = dict(eps=cfg.ln_eps, policy=policy, device=device,
                  impl=cfg.ln_impl)
        self.qkv = Linear(h, 3 * h, **lin)
        self.attn_out = Linear(h, h, **lin)
        self.attn_ln = LayerNorm(h, **ln)
        self.fc = Linear(h, h * cfg.mlp_ratio, **lin)
        self.fc_out = Linear(h * cfg.mlp_ratio, h, **lin)
        self.out_ln = LayerNorm(h, **ln)
        self.drop = Dropout(cfg.dropout, dropout_generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, h = x.shape
        d = h // cfg.num_heads
        qkv = self.qkv(x).reshape(b, s, 3, cfg.num_heads, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)               # [B, H, S, D]
        impl = cfg.attn_impl
        if impl == "auto":
            impl = "flash" if mask is None else "xla"
        if impl in ("flash", "flash_shmap"):
            if mask is not None:
                raise ValueError(f"attn_impl={impl!r} cannot apply an "
                                 f"arbitrary padding mask; use right-padded "
                                 f"batches with kv_lengths, or 'xla'")
            if impl == "flash":
                att = flash_attention(q, k, v, causal=False,
                                      kv_lengths=kv_lengths)
            else:
                from nezha_tpu_torch.parallel.gspmd import scoped_tp_flash
                att = scoped_tp_flash(q, k, v, cfg.num_heads, causal=False,
                                      kv_lengths=kv_lengths)
        else:
            if kv_lengths is not None and mask is None:
                # The flash path's right-padding contract, composed: a
                # prefix mask from the lengths, clamped to >= 1 so a
                # zero-length row attends position 0 (as the kernel).
                keep = (torch.arange(s, device=x.device)[None, :]
                        < kv_lengths.clamp_min(1)[:, None])
                mask = make_attention_mask(keep)
            att = dot_product_attention(q, k, v, mask=mask)
        att = self.drop(self.attn_out(att.transpose(1, 2).reshape(b, s, h)))
        x = self.attn_ln(x + att)
        y = self.fc_out(gelu(self.fc(x), approximate=False))
        return self.out_ln(x + y)


class Bert(nn.Module):
    """``forward(batch)`` -> MLM logits ``[B, S, vocab]`` in fp32, or in
    training with ``fused_loss_chunk=-1`` the fused-head dict. The
    decoder is tied to ``tok_emb``, plus the free ``mlm_bias``.

    Weights are drawn at construction from ``generator`` (a fresh
    generator on ``device`` — ``cuda`` when None — seeded with 0 when
    None). Dropout masks come from a generator of their own, seeded from
    that stream after the weights."""

    def __init__(self, cfg: BertConfig = BertConfig(),
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
        h = cfg.hidden_size
        drop_gen = torch.Generator(device=device)
        self.tok_emb = Embedding(cfg.vocab_size, h, policy=policy,
                                 generator=generator)
        self.pos_emb = Embedding(cfg.max_positions, h,
                                 embedding_init=init_lib.normal(0.02),
                                 policy=policy, generator=generator)
        self.type_emb = Embedding(cfg.type_vocab_size, h, policy=policy,
                                  generator=generator)
        self.emb_ln = LayerNorm(h, eps=cfg.ln_eps, policy=policy,
                                device=device, impl=cfg.ln_impl)
        self.drop = Dropout(cfg.dropout, drop_gen)
        layers = [EncoderLayer(cfg, policy, generator, device, drop_gen)
                  for _ in range(cfg.num_layers)]
        if cfg.scan_layers:
            # The same draws as the unrolled layers, then stacked.
            self.layers_scan = scan_stack_init(layers)
            self.layers = nn.ModuleList()
        else:
            self.layers = nn.ModuleList(layers)
        self.mlm_dense = Linear(h, h, kernel_init=init_lib.normal(0.02),
                                policy=policy, generator=generator,
                                device=device)
        self.mlm_ln = LayerNorm(h, eps=cfg.ln_eps, policy=policy,
                                device=device, impl=cfg.ln_impl)
        self.mlm_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=policy.param_dtype, device=device))
        drop_gen.manual_seed(int(torch.randint(
            2 ** 62, (1,), generator=generator, device=device)))

    def forward(self, batch: dict):
        tokens = batch["tokens"]
        segment_ids = batch.get("segment_ids")
        padding_mask = batch.get("padding_mask")
        kv_lengths = batch.get("kv_lengths")
        if kv_lengths is not None and padding_mask is not None:
            raise ValueError("pass either padding_mask or kv_lengths, "
                             "not both")
        s = tokens.shape[1]
        if s > self.cfg.max_positions:
            raise ValueError(f"sequence length {s} exceeds max_positions "
                             f"{self.cfg.max_positions}")
        x = self.tok_emb(tokens) + self.pos_emb(
            torch.arange(s, device=tokens.device)[None, :])
        if segment_ids is not None:
            x = x + self.type_emb(segment_ids)
        x = self.drop(self.emb_ln(x))
        mask = (make_attention_mask(padding_mask)
                if padding_mask is not None else None)
        if self.cfg.scan_layers:
            x = scan_stack_apply(self.layers_scan, x, self.cfg.num_layers,
                                 mask=mask, kv_lengths=kv_lengths)
        for layer in self.layers:
            x = layer(x, mask=mask, kv_lengths=kv_lengths)
        y = self.mlm_ln(gelu(self.mlm_dense(x), approximate=False))
        if self.cfg.fused_loss_chunk and self.training:
            # The tied decoder moves into the loss (mlm_loss); gradients
            # reach the table and the bias through this dict.
            return {"hidden": y, "wte": self.tok_emb.embedding,
                    "bias": self.mlm_bias,
                    "chunk": self.cfg.fused_loss_chunk}
        logits = self.tok_emb.attend(y) + self.policy.cast_to_compute(
            self.mlm_bias)
        return logits.float()


def bert_base(policy: Optional[Policy] = None,
              generator: Optional[torch.Generator] = None, device=None,
              **overrides) -> Bert:
    return Bert(BertConfig(**overrides), policy=policy or bf16_policy(),
                generator=generator, device=device)


def mlm_loss(out, batch: dict) -> torch.Tensor:
    """MLM CE over the positions whose label is not -100; ``out`` is
    dense logits or the fused-head dict."""
    if isinstance(out, dict):
        return lm_ce_from_fused(out, batch["labels"], ignore_index=-100)
    return softmax_cross_entropy_with_integer_labels(
        out, batch["labels"], ignore_index=-100)
