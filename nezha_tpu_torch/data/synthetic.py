"""Synthetic GPT-2 token batches and ImageNet-shaped image batches
(counterpart of ``nezha_tpu/data/synthetic.py``, numpy only).

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
