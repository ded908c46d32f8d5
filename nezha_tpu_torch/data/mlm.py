"""Dynamic BERT masking over token streams (counterpart of
``nezha_tpu/data/mlm.py``): for the same batches and seed, the same
arrays as the JAX package, bit for bit (the same ``RandomState`` draws in
the same order).

Per batch, ``mask_rate`` of the positions are chosen; of those 80% become
``mask_token``, 10% a uniformly random id, 10% stay; ``labels`` hold the
original id at chosen positions and -100 elsewhere. The rows are full
length (no padding), so BERT's attention stays on the flash kernels.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np


def mlm_batches_from_tokens(batches: Iterable, vocab_size: int,
                            mask_token: int = 103,
                            mask_rate: float = 0.15,
                            seed: int = 0,
                            drop_last_column: bool = False) -> Iterator[dict]:
    """-> ``{"tokens", "labels", "segment_ids"}`` int32 [B, S] batches.

    ``drop_last_column=True`` for GPT-shape ``[B, S+1]`` sources (the
    native ``TokenLoader``) whose trailing next-token column MLM doesn't
    use."""
    if not 0 < mask_rate < 1:
        raise ValueError(f"mask_rate must be in (0, 1), got {mask_rate}")
    if not 0 <= mask_token < vocab_size:
        raise ValueError(f"mask_token {mask_token} outside vocab "
                         f"[0, {vocab_size})")
    r = np.random.RandomState(seed)
    for b in batches:
        tokens = np.asarray(b["tokens"] if isinstance(b, dict) else b)
        if tokens.ndim != 2:
            raise ValueError(f"expected [B, S] tokens, got {tokens.shape}")
        if drop_last_column:
            tokens = tokens[:, :-1]
        tokens = tokens.astype(np.int32, copy=True)
        if tokens.max(initial=0) >= vocab_size or tokens.min(initial=0) < 0:
            # Loud: an out-of-range id would reach the embedding gather.
            raise ValueError(
                f"token ids outside [0, {vocab_size}) in the stream "
                f"(min {tokens.min()}, max {tokens.max()}; wrong "
                f"--data-dir for this model?)")
        sel = r.rand(*tokens.shape) < mask_rate
        labels = np.where(sel, tokens, -100).astype(np.int32)
        roll = r.rand(*tokens.shape)
        masked = sel & (roll < 0.8)
        random_sub = sel & (roll >= 0.8) & (roll < 0.9)
        tokens[masked] = mask_token
        tokens[random_sub] = r.randint(
            0, vocab_size, int(random_sub.sum()), dtype=np.int32)
        yield {"tokens": tokens, "labels": labels,
               "segment_ids": np.zeros_like(tokens)}
