"""Synthetic GPT-2 token batches (counterpart of
``nezha_tpu/data/synthetic.py`` ``synthetic_token_batches``, numpy only).

The same seed draws the same tokens as the JAX package's generator, so
both packages train on identical batches.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


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
