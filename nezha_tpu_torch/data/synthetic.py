"""Synthetic GPT-2 token batches, BERT MLM batches and ImageNet-shaped
image batches (counterpart of ``nezha_tpu/data/synthetic.py``, numpy only).

The same seed draws the same arrays as the JAX package's generators (the
same ``RandomState`` draws in the same order), so both packages train on
identical batches.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_image_batches(batch_size: int, image_size: int = 224,
                            num_classes: int = 1000,
                            seed: int = 0) -> Iterator[dict]:
    """``{"image": [B, H, W, 3] f32 in [0, 1), "label": [B] int32}``: a
    pool of four batches drawn once, yielded in turn forever."""
    r = np.random.RandomState(seed)
    shape = (batch_size, image_size, image_size, 3)
    pool = []
    for _ in range(4):
        pool.append({"image": r.rand(*shape).astype(np.float32),
                     "label": r.randint(0, num_classes, size=batch_size
                                        ).astype(np.int32)})
    i = 0
    while True:
        yield pool[i % len(pool)]
        i += 1


def synthetic_token_batches(batch_size: int, seq_len: int = 1024,
                            vocab_size: int = 50257,
                            seed: int = 0) -> Iterator[dict]:
    """GPT-2-style LM batches ``{"tokens": [B, S + 1] int32}`` (the model
    shifts them into inputs and targets): a pool of four batches drawn
    once, yielded in turn forever."""
    r = np.random.RandomState(seed)
    pool = [{"tokens": r.randint(0, vocab_size,
                                 size=(batch_size, seq_len + 1)
                                 ).astype(np.int32)}
            for _ in range(4)]
    i = 0
    while True:
        yield pool[i % len(pool)]
        i += 1


def synthetic_mlm_batches(batch_size: int, seq_len: int = 512,
                          vocab_size: int = 30522, mask_rate: float = 0.15,
                          seed: int = 0,
                          mask_token: int = 103) -> Iterator[dict]:
    """BERT MLM batches ``{"tokens", "labels", "segment_ids"}``, each
    ``[B, S]`` int32: about ``mask_rate`` of the positions hold
    ``mask_token`` in ``tokens`` and the original token in ``labels``,
    every other label is -100; ``segment_ids`` are zero. No
    ``padding_mask``: the rows are full length, and a mask (all True)
    would send the model to composed attention. A pool of four batches
    drawn once, yielded in turn forever."""
    r = np.random.RandomState(seed)
    pool = []
    for _ in range(4):
        tokens = r.randint(0, vocab_size,
                           size=(batch_size, seq_len)).astype(np.int32)
        labels = np.full_like(tokens, -100)
        mask = r.rand(batch_size, seq_len) < mask_rate
        labels[mask] = tokens[mask]
        tokens = tokens.copy()
        tokens[mask] = mask_token
        pool.append({"tokens": tokens, "labels": labels,
                     "segment_ids": np.zeros_like(tokens)})
    i = 0
    while True:
        yield pool[i % len(pool)]
        i += 1
