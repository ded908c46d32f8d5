"""The port's binding to the native loaders (``nezha_tpu_torch/data/
native.py``) and its MLM masking (``data/mlm.py``) against the JAX
package's. With one worker, the same file and seed, every batch of the
port's ``TokenLoader``, ``ImageRecordLoader`` and ``MnistLoader`` equals
JAX's bitwise; with more workers the port keeps what
``tests/test_native_loader.py`` pins (epoch coverage, shard partitions,
decorrelated token shards, refusals). The library builds from
``csrc/dataloader.cpp`` alone into ``build/nezha_tpu_torch/`` and never
writes under ``csrc/``; a failed build raises ``NativeLoaderError``."""

import struct

import numpy as np
import pytest

from nezha_tpu.data import mlm as jax_mlm
from nezha_tpu.data import native as jax_native
from nezha_tpu_torch.data import mlm, native


def _write_idx(d, n=64, rows=4, cols=4, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, size=(n, rows, cols)).astype(np.uint8)
    labels = (np.arange(n) % 10).astype(np.uint8)
    img, lbl = d / "images-idx3-ubyte", d / "labels-idx1-ubyte"
    img.write_bytes(struct.pack(">IIII", 2051, n, rows, cols)
                    + images.tobytes())
    lbl.write_bytes(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(img), str(lbl)


def _records(d, n=32, size=12, seed=0):
    p = str(d / "r.nzr")
    rng = np.random.RandomState(seed)
    native.write_image_records(
        p, rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8),
        np.arange(n))
    return p


def _take(loader, n):
    with loader as ld:
        it = iter(ld)
        return [{k: v.copy() for k, v in next(it).items()}
                for _ in range(n)]


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_token_loader_bitwise_jax(tmp_path, dtype):
    p = str(tmp_path / "t.bin")
    np.random.RandomState(1).randint(0, 60000, 5000).astype(dtype).tofile(p)
    kw = dict(seq_len=32, batch_size=4, dtype=dtype, seed=5, num_workers=1)
    mine = _take(native.TokenLoader(p, **kw), 6)
    _assert_batches_equal(mine, _take(jax_native.TokenLoader(p, **kw), 6))
    src = np.fromfile(p, dtype=dtype).astype(np.int32)
    row = mine[0]["tokens"][0]
    starts = np.flatnonzero(src[:-32] == row[0])
    assert any(np.array_equal(src[s:s + 33], row) for s in starts)


@pytest.mark.parametrize("augment", [True, False])
def test_image_record_loader_bitwise_jax(tmp_path, augment):
    p = _records(tmp_path)
    kw = dict(batch_size=4, crop=8, seed=3, num_workers=1,
              train_augment=augment, epochs=1)
    mine = _take(native.ImageRecordLoader(p, **kw), 8)
    _assert_batches_equal(mine, _take(jax_native.ImageRecordLoader(p, **kw),
                                      8))
    assert mine[0]["image"].shape == (4, 8, 8, 3)
    assert native.nzr_count(p) == 32


def test_mnist_loader_bitwise_jax(tmp_path):
    img, lbl = _write_idx(tmp_path)
    kw = dict(batch_size=8, seed=2, num_workers=1, epochs=2)
    mine = _take(native.MnistLoader(img, lbl, **kw), 16)
    _assert_batches_equal(mine, _take(jax_native.MnistLoader(img, lbl, **kw),
                                      16))
    assert mine[0]["image"].shape == (8, 16)
    assert 0.0 <= mine[0]["image"].min() and mine[0]["image"].max() <= 1.0


def test_more_workers_cover_each_epoch_once(tmp_path):
    img, lbl = _write_idx(tmp_path)
    with native.MnistLoader(img, lbl, batch_size=8, epochs=1,
                            num_workers=3) as ld:
        labels = np.concatenate([b["label"] for b in ld])
    assert sorted(labels.tolist()) == sorted((np.arange(64) % 10).tolist())
    p = _records(tmp_path)
    with native.ImageRecordLoader(p, batch_size=8, epochs=1, num_workers=3,
                                  train_augment=False) as ld:
        seen = np.concatenate([b["label"] for b in ld])
    assert sorted(seen.tolist()) == list(range(32))


def test_record_shards_partition_and_token_shards_differ(tmp_path):
    p = _records(tmp_path)
    served = []
    for idx in range(2):
        with native.ImageRecordLoader(p, batch_size=4, epochs=1,
                                      num_workers=2, train_augment=False,
                                      seed=7, shard_index=idx,
                                      shard_count=2) as ld:
            served.append(set(np.concatenate([b["label"] for b in ld])
                              .tolist()))
    assert not served[0] & served[1]
    assert served[0] | served[1] == set(range(32))
    t = str(tmp_path / "t.bin")
    np.arange(4096, dtype=np.uint16).tofile(t)
    outs = [_take(native.TokenLoader(t, seq_len=16, batch_size=4, seed=3,
                                     num_workers=1, shard_index=i,
                                     shard_count=2), 1)[0]["tokens"]
            for i in range(2)]
    assert not np.array_equal(outs[0], outs[1])


def test_refusals_are_typed(tmp_path):
    bad = tmp_path / "bad.nzr"
    bad.write_bytes(b"XXXX" + bytes(16))
    with pytest.raises(native.NativeLoaderError):
        native.ImageRecordLoader(str(bad), batch_size=2)
    short = tmp_path / "short.bin"
    np.arange(8, dtype=np.uint16).tofile(short)
    with pytest.raises(native.NativeLoaderError):
        native.TokenLoader(str(short), seq_len=16, batch_size=2)
    with pytest.raises(ValueError, match="dtype"):
        native.TokenLoader(str(short), seq_len=4, batch_size=2,
                           dtype=np.float32)
    # A writer unwound by an exception leaves count 0: the loader refuses.
    path = tmp_path / "torn.nzr"
    with pytest.raises(RuntimeError):
        with native.ImageRecordWriter(str(path), 4, 4) as w:
            w.append(np.zeros((4, 4, 3), np.uint8), 1)
            raise RuntimeError("crash mid-pack")
    with pytest.raises(native.NativeLoaderError):
        native.ImageRecordLoader(str(path), batch_size=1)


def test_library_builds_alone_under_build_not_csrc(tmp_path, monkeypatch):
    assert native.library_path().is_relative_to(native.ROOT / "build" /
                                                "nezha_tpu_torch")
    csrc = native.ROOT / "csrc"
    before = sorted(p.relative_to(csrc) for p in csrc.rglob("*"))
    out = tmp_path / "lib" / "libnezha_loader.so"
    native._build(out)
    assert out.exists()
    assert sorted(p.relative_to(csrc) for p in csrc.rglob("*")) == before
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(native.NativeLoaderError, match="build failed"):
        native._build(tmp_path / "other" / "libnezha_loader.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeLoaderError, match="cannot run"):
        native._build(tmp_path / "third" / "libnezha_loader.so")


@pytest.mark.parametrize("drop", [False, True])
def test_mlm_batches_bitwise_jax(drop):
    r = np.random.RandomState(0)
    width = 33 if drop else 32
    src = [{"tokens": r.randint(5, 300, (4, width)).astype(np.int32)}
           for _ in range(5)]
    kw = dict(vocab_size=300, mask_token=4, seed=9, drop_last_column=drop)
    mine = list(mlm.mlm_batches_from_tokens(iter(src), **kw))
    _assert_batches_equal(mine, list(jax_mlm.mlm_batches_from_tokens(
        iter(src), **kw)))
    assert mine[0]["tokens"].shape == (4, 32)
    for bad in (dict(kw, mask_rate=1.5), dict(kw, mask_token=300)):
        with pytest.raises(ValueError):
            next(mlm.mlm_batches_from_tokens(iter(src), **bad))
    with pytest.raises(ValueError, match="outside"):
        next(mlm.mlm_batches_from_tokens(
            iter([{"tokens": np.full((2, 8), 400)}]), vocab_size=300))
