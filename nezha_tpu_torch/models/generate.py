"""Autoregressive decoding for GPT-2 with a KV cache (counterpart of
``nezha_tpu/models/generate.py``).

One prefill writes the whole prompt into preallocated per-layer caches
(``[B, H, max_len, D]``, updated in place) and returns the last
position's logits; then N - 1 single-token forwards, one per generated
token but the last, each sampling from the previous step's logits. The
loop is plain Python over tensors on the model's device. The prefill at
position 0 runs the flash kernel, each decode step the dense
flash-decode kernel (``GPT2Config.decode_impl``).

Sampling: greedy (``temperature=0``), temperature, top-k, and top-p
(nucleus), with draws from an explicit ``torch.Generator``. The draws
cannot match JAX's threefry bits for the same seed; greedy tokens match
the JAX function's.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from nezha_tpu_torch.models.gpt2 import GPT2


def init_cache(model: GPT2, batch_size: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16) -> List[dict]:
    """Fixed-size per-layer K/V buffers, ``[B, H, max_len, D]`` each, on
    the model's device."""
    cfg = model.cfg
    device = model.wte.embedding.device
    shape = (batch_size, cfg.num_heads, max_len,
             cfg.hidden_size // cfg.num_heads)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: Optional[int],
            top_p: Optional[float] = None) -> torch.Tensor:
    """logits ``[B, V]`` -> token ids ``[B]``. top-k truncation applies
    before top-p nucleus filtering (JAX ``_sample``, the HF convention)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / max(temperature, 1e-6)
    if top_k is not None:
        top_k = max(1, min(int(top_k), logits.shape[-1]))
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        # The smallest prefix of descending-probability tokens whose mass
        # reaches top_p; the rank-0 term keeps the top token even at
        # top_p <= 0, so the set is never empty.
        desc = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        exclusive = probs.cumsum(dim=-1) - probs
        rank = torch.arange(desc.shape[-1], device=logits.device)
        keep = (exclusive < top_p) | (rank == 0)
        threshold = torch.where(keep, desc, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: GPT2, prompt: torch.Tensor, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             cache_dtype: torch.dtype = torch.bfloat16,
             eos_id: Optional[int] = None,
             pad_id: Optional[int] = None) -> torch.Tensor:
    """``prompt [B, S]`` -> ``[B, S + max_new_tokens]`` token ids on the
    model's device.

    ``temperature=0`` is greedy decoding; otherwise categorical sampling
    (optionally top-k truncated and/or top-p filtered) with draws from
    ``generator`` (on the model's device; the default generator when
    None).

    ``eos_id``: rows that emit it stop — their cache position keeps
    advancing, but every later token is ``pad_id`` (``eos_id`` when
    None), so rows read ``... eos pad pad``.
    """
    device = model.wte.embedding.device
    prompt = torch.as_tensor(prompt, device=device).long()
    b, s = prompt.shape
    max_len = s + max_new_tokens
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    if max_len > model.cfg.max_positions:
        raise ValueError(f"prompt+new = {max_len} exceeds max_positions "
                         f"{model.cfg.max_positions}")
    pad = eos_id if pad_id is None else pad_id
    done = torch.zeros(b, dtype=torch.bool, device=device)

    def emit(logits):
        nonlocal done
        tok = _sample(logits, generator, temperature, top_k, top_p)
        if eos_id is not None:
            tok = torch.where(done, pad, tok)
            done = done | (tok == eos_id)
        return tok

    cache = init_cache(model, b, max_len, cache_dtype)
    training = model.training
    model.eval()          # inference: no dropout (JAX's training=False)
    try:
        logits = model(prompt, cache=cache, pos=0, prefill=True)[:, -1]
        tokens = []
        # The last token needs no forward: N - 1 forwards for N tokens.
        for i in range(max_new_tokens - 1):
            tokens.append(emit(logits))
            logits = model(tokens[-1][:, None], cache=cache,
                           pos=s + i)[:, -1]
        tokens.append(emit(logits))
    finally:
        model.train(training)
    return torch.cat([prompt, torch.stack(tokens, dim=1)], dim=1)
