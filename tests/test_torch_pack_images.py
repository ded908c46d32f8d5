"""Image packing in the port (``data/images.py``, ``cli/pack_images.py``)
on the CPU, against the JAX package's ``nezha-pack-images`` on the same
folders (tests/test_pack_images.py's cases):

- the NZR1 files and ``classes.txt`` byte-equal to JAX's, for a flat
  ``<class>/`` folder (the seeded stratified split) and a ``train/`` +
  ``val/`` folder, JPEGs and PNGs mixed;
- the layouts, determinism and the resize geometry;
- JAX's rejections: no classes, a ``--val-fraction`` of 1, a lone
  ``train/``, differing class lists, and a writer that dies mid-file;
- pack, then train and evaluate the tiny ResNet from the records through
  the port's train CLI.

Every image is written here with PIL; no dataset is read.
"""

import os

import numpy as np
import pytest
from PIL import Image

from nezha_tpu_torch.cli import pack_images as pack_cli
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.data.images import (list_image_folder, load_image,
                                         pack_image_folder)
from nezha_tpu_torch.data.native import (ImageRecordLoader,
                                         ImageRecordWriter,
                                         NativeLoaderError)


def _write_images(root, classes, per_class, size=(48, 56), seed=0):
    """An ImageFolder tree of encoded images, PNG and JPEG alternating
    (the pack path decodes both)."""
    rng = np.random.RandomState(seed)
    for cls in classes:
        d = os.path.join(root, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.randint(0, 256, (*size, 3), dtype=np.uint8)
            fmt = "png" if i % 2 == 0 else "jpg"
            Image.fromarray(arr).save(os.path.join(d, f"img{i}.{fmt}"))


def _pack(argv):
    return pack_cli.run(pack_cli.build_parser().parse_args(argv))


def _files(out):
    return {name: (out / name).read_bytes()
            for name in ("train.nzr", "val.nzr", "classes.txt")
            if (out / name).exists()}


@pytest.mark.parametrize("layout", ["flat", "train_val"])
def test_records_byte_equal_to_jax(tmp_path, layout):
    from nezha_tpu.cli.pack_images import build_parser as jax_parser
    from nezha_tpu.cli.pack_images import run as jax_run

    src = tmp_path / "src"
    if layout == "flat":
        _write_images(str(src), ["cat", "dog", "emu"], per_class=5)
        extra = ["--val-fraction", "0.34", "--seed", "3"]
    else:
        _write_images(str(src / "train"), ["a", "b"], per_class=3)
        _write_images(str(src / "val"), ["a", "b"], per_class=2, seed=7)
        extra = []
    common = [str(src), "--size", "24", "--workers", "3"] + extra
    mine = _pack(common + ["--out-dir", str(tmp_path / "mine")])
    theirs = jax_run(jax_parser().parse_args(
        common + ["--out-dir", str(tmp_path / "jax")]))
    for key in ("num_train", "num_val", "num_classes", "classes", "size"):
        assert mine[key] == theirs[key], key
    got, want = _files(tmp_path / "mine"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["classes.txt", "train.nzr",
                                            "val.nzr"]
    for name in want:
        assert got[name] == want[name], name


def test_flat_layout_split_and_loader_roundtrip(tmp_path):
    src, out = tmp_path / "src", tmp_path / "out"
    _write_images(str(src), ["cat", "dog", "emu"], per_class=6)
    summary = _pack([str(src), "--out-dir", str(out), "--size", "32",
                     "--val-fraction", "0.34"])
    assert summary["classes"] == ["cat", "dog", "emu"]
    assert summary["num_train"] + summary["num_val"] == 18
    assert summary["num_val"] == 6   # round(6 * 0.34) = 2 a class
    assert (out / "classes.txt").read_text().split() == ["cat", "dog", "emu"]
    samples, classes = list_image_folder(str(src))
    assert len(samples) == 18 and classes == ["cat", "dog", "emu"]
    with ImageRecordLoader(str(out / "train.nzr"), batch_size=4,
                           train_augment=False, epochs=1) as loader:
        assert loader.num_examples == summary["num_train"]
        batch = next(iter(loader))
    assert batch["image"].shape == (4, 32, 32, 3)
    assert set(np.asarray(batch["label"]).tolist()) <= {0, 1, 2}


def test_train_val_layout_and_determinism(tmp_path):
    src = tmp_path / "src"
    _write_images(str(src / "train"), ["a", "b"], per_class=3)
    _write_images(str(src / "val"), ["a", "b"], per_class=2, seed=7)
    s1 = pack_image_folder(str(src), str(tmp_path / "o1"), size=16)
    s2 = pack_image_folder(str(src), str(tmp_path / "o2"), size=16,
                           workers=1)
    assert s1["num_train"] == 6 and s1["num_val"] == 4
    assert _files(tmp_path / "o1") == _files(tmp_path / "o2")
    # A class only val/ has shifts every later label: refused.
    os.makedirs(src / "val" / "stray")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        str(src / "val" / "stray" / "x.png"))
    with pytest.raises(SystemExit, match="class lists differ"):
        _pack([str(src), "--out-dir", str(tmp_path / "o3"), "--size", "16"])


def test_load_image_resize_geometry(tmp_path):
    """Short-side resize and a center crop: any aspect ratio lands at
    size x size x 3; a grayscale source is converted to RGB. The same
    pixels as JAX's."""
    from nezha_tpu.data.images import load_image as jax_load_image

    tall = tmp_path / "tall.png"
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (100, 30), dtype=np.uint8)).save(str(tall))
    out = load_image(str(tall), 24)
    assert out.shape == (24, 24, 3) and out.dtype == np.uint8
    assert out.tobytes() == jax_load_image(str(tall), 24).tobytes()


def test_pack_rejects_bad_inputs(tmp_path):
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no class subdirectories"):
        _pack([str(empty), "--out-dir", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="val-fraction"):
        _pack([str(empty), "--out-dir", str(tmp_path / "o"),
               "--val-fraction", "1.0"])
    with pytest.raises(SystemExit, match="--size must be positive"):
        _pack([str(empty), "--out-dir", str(tmp_path / "o"), "--size", "0"])
    src = tmp_path / "lone"
    _write_images(str(src / "train"), ["a", "b"], per_class=2)
    with pytest.raises(SystemExit, match="counterpart"):
        _pack([str(src), "--out-dir", str(tmp_path / "o")])


def test_writer_crash_leaves_invalid_file(tmp_path):
    """A pack that dies mid-write keeps the header's count at 0, which
    the loader refuses."""
    p = tmp_path / "crash.nzr"
    with pytest.raises(RuntimeError, match="boom"):
        with ImageRecordWriter(str(p), 8, 8, 3) as wr:
            wr.append(np.zeros((8, 8, 3), np.uint8), 0)
            raise RuntimeError("boom")
    assert np.frombuffer(p.read_bytes()[4:20], np.int32)[0] == 0
    with pytest.raises(NativeLoaderError):
        ImageRecordLoader(str(p), batch_size=1)


def test_pack_then_train_e2e(tmp_path):
    """Images -> records -> the port's train CLI trains and evaluates on
    them (the records path, not synthetic data)."""
    src, out = tmp_path / "src", tmp_path / "data"
    _write_images(str(src), [f"c{i}" for i in range(4)], per_class=8,
                  size=(40, 44))
    assert pack_cli.main([str(src), "--out-dir", str(out), "--size", "36",
                          "--val-fraction", "0.25"]) == 0
    metrics = train_cli.run(train_cli.parse_args([
        "--config", "resnet50_imagenet", "--model-preset", "tiny",
        "--device", "cpu", "--steps", "2", "--batch-size", "8",
        "--log-every", "1", "--data-dir", str(out), "--crop", "32",
        "--eval"]))
    assert np.isfinite(metrics["loss"])
    assert metrics["eval_count"] == 8   # every packed val record, once
