"""MNIST (counterpart of ``nezha_tpu/data/mnist.py``, numpy only).

Reads the standard IDX files, gzipped or not, from
``$NEZHA_DATA_DIR/mnist`` (else ``~/.cache/nezha_tpu/mnist``). With no
dataset on disk it falls back to the JAX package's deterministic
synthetic set: MNIST's shapes, each class a fixed template plus noise, so
an MLP's loss falls and its accuracy climbs. Every draw is the JAX
package's, so both packages see identical batches.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray]


def _data_dir() -> Path:
    root = os.environ.get("NEZHA_DATA_DIR")
    if root:
        return Path(root) / "mnist"
    return Path.home() / ".cache" / "nezha_tpu" / "mnist"


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find(dirpath: Path, stem: str) -> Optional[Path]:
    for suffix in ("", ".gz"):
        p = dirpath / (stem + suffix)
        if p.exists():
            return p
    return None


def _synthetic_mnist(n_train: int = 8192, n_test: int = 1024
                     ) -> Tuple[Split, Split]:
    """Class templates (seed 0) plus 0.3 Gaussian noise, clipped to [0,
    1]: train draws from seed 1, test from seed 2."""
    templates = np.random.RandomState(0).rand(10, 28, 28).astype(np.float32)

    def make(n: int, seed: int) -> Split:
        r = np.random.RandomState(seed)
        labels = r.randint(0, 10, size=n).astype(np.int32)
        images = templates[labels] + 0.3 * r.randn(n, 28, 28).astype(
            np.float32)
        return np.clip(images, 0.0, 1.0), labels

    return make(n_train, 1), make(n_test, 2)


def load_mnist() -> Tuple[Split, Split]:
    """-> ((train_x, train_y), (test_x, test_y)): images float32 in [0,
    1] of shape [N, 28, 28], labels int32."""
    d = _data_dir()
    files = [_find(d, stem) for stem in (
        "train-images-idx3-ubyte", "train-labels-idx1-ubyte",
        "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")]
    if not all(files):
        return _synthetic_mnist()
    xtr, ytr, xte, yte = (_read_idx(f) for f in files)
    return ((xtr.astype(np.float32) / 255.0, ytr.astype(np.int32)),
            (xte.astype(np.float32) / 255.0, yte.astype(np.int32)))


def mnist_batches(batch_size: int, split: str = "train", seed: int = 0,
                  epochs: Optional[int] = None) -> Iterator[dict]:
    """``{"image": [B, 28, 28], "label": [B]}`` numpy batches; the train
    split is reshuffled each epoch (``RandomState(seed)``), the test
    split runs in order; a partial last batch is dropped."""
    (xtr, ytr), (xte, yte) = load_mnist()
    x, y = (xtr, ytr) if split == "train" else (xte, yte)
    n = x.shape[0]
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    rng = np.random.RandomState(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if split == "train" else np.arange(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            yield {"image": x[idx], "label": y[idx]}
        epoch += 1
