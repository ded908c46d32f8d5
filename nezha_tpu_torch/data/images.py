"""Image-dataset prep: a directory of real images -> NZR1 record files
(a copy of ``nezha_tpu/data/images.py``; the port carries its own, since
the JAX package cannot be imported without JAX).

JPEG/PNG decode happens exactly once, here (csrc/dataloader.cpp keeps the
hot loader decode-free by design: "pre-decoded raw images in a flat record
file"); the C++ loader (``data/native.py`` ``ImageRecordLoader``) then
streams fixed-size uint8 records with crop/flip augmentation on worker
threads. ImageFolder layout in, `train.nzr`/`val.nzr`/`classes.txt` out,
``python -m nezha_tpu_torch.cli.train --data-dir`` consumes them
directly.

Layouts accepted by :func:`pack_image_folder`:

* ``src/train/<class>/*.jpg`` + ``src/val/<class>/*.jpg`` — packed as-is
  (the ImageNet convention); both splits share one class list.
* ``src/<class>/*.jpg`` — a deterministic stratified val split is drawn
  per class (``val_fraction``, seeded).

Images are resized short-side to ``size`` (bilinear) and center-cropped to
``size x size`` — the stored record leaves room for the loader's random
``--crop`` at train time (store 256, crop 224 is the classic recipe).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

from nezha_tpu_torch.data.native import ImageRecordWriter

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


def list_image_folder(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """ImageFolder layout -> (sorted [(path, label)], sorted class names).

    Classes are the immediate subdirectories of ``root``, labeled in sorted
    order (the torchvision convention, so label maps line up for anyone
    migrating). Deterministic: both lists are sorted, never os.listdir
    order.
    """
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)) and not d.startswith("."))
    if not classes:
        raise ValueError(f"no class subdirectories under {root!r}")
    samples = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for dirpath, _, files in os.walk(cdir):
            for f in sorted(files):
                if f.lower().endswith(IMAGE_EXTENSIONS):
                    samples.append((os.path.join(dirpath, f), label))
    if not samples:
        raise ValueError(f"no images with extensions {IMAGE_EXTENSIONS} "
                         f"under {root!r}")
    samples.sort()
    return samples, classes


def load_image(path: str, size: int) -> np.ndarray:
    """Decode + short-side resize + center crop -> uint8 [size, size, 3].

    PIL is a prep-time-only dependency (the training path never imports
    it), matching the loader's decode-free design.
    """
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = size / min(w, h)
        nw, nh = max(size, round(w * scale)), max(size, round(h * scale))
        im = im.resize((nw, nh), Image.BILINEAR)
        left, top = (nw - size) // 2, (nh - size) // 2
        im = im.crop((left, top, left + size, top + size))
        return np.asarray(im, np.uint8)


def _split_train_val(samples: Sequence[Tuple[str, int]], val_fraction: float,
                     seed: int):
    """Deterministic stratified split: per class, a seeded shuffle takes the
    first ``round(n * val_fraction)`` files for val (at least 1 when the
    class has >= 2 images and val_fraction > 0 — a val split with absent
    classes would silently skew eval accuracy)."""
    by_class: Dict[int, List[Tuple[str, int]]] = {}
    for s in samples:
        by_class.setdefault(s[1], []).append(s)
    train, val = [], []
    for label in sorted(by_class):
        rows = by_class[label]
        rng = np.random.RandomState(seed + label)
        order = rng.permutation(len(rows))
        n_val = round(len(rows) * val_fraction)
        if val_fraction > 0 and len(rows) >= 2:
            n_val = max(1, n_val)
        n_val = min(n_val, len(rows) - 1)  # never empty a class's train side
        val.extend(rows[i] for i in order[:n_val])
        train.extend(rows[i] for i in order[n_val:])
    return sorted(train), sorted(val)


def pack_split(samples: Sequence[Tuple[str, int]], out_path: str, size: int,
               workers: int = 8) -> int:
    """Decode ``samples`` on a thread pool (PIL releases the GIL during
    decode/resize) and stream them into ``out_path``. Returns the record
    count. Record order is the (sorted) sample order — the loader owns
    shuffling, so packing stays reproducible."""
    workers = max(1, workers)
    with ImageRecordWriter(out_path, size, size, 3) as wr:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            # Bounded windows, not one big map: at most O(workers) decoded
            # images are ever in flight, so a lagging writer (slow disk)
            # cannot buffer the dataset into memory.
            chunk = workers * 4
            for start in range(0, len(samples), chunk):
                window = samples[start:start + chunk]
                decoded = pool.map(lambda s: load_image(s[0], size), window)
                for (_, label), img in zip(window, decoded):
                    wr.append(img, label)
        return wr.count


def pack_image_folder(src: str, out_dir: str, size: int = 256,
                      val_fraction: float = 0.1, seed: int = 0,
                      workers: int = 8) -> dict:
    """Pack an image directory into ``out_dir/{train.nzr, val.nzr,
    classes.txt}``. Returns a summary dict (counts, classes, paths)."""
    train_dir = os.path.join(src, "train")
    val_dir = os.path.join(src, "val")
    if os.path.isdir(train_dir) != os.path.isdir(val_dir):
        # A lone train/ (or val/) would otherwise be reinterpreted as the
        # flat layout — with 'train' itself becoming the single class and
        # every image mislabeled 0. Reject instead.
        present = "train" if os.path.isdir(train_dir) else "val"
        raise ValueError(
            f"{src!r} has a {present}/ subdirectory but not its "
            f"counterpart; provide both train/ and val/ (packed as-is) or "
            f"neither (flat <class>/ layout with --val-fraction split)")
    if os.path.isdir(train_dir) and os.path.isdir(val_dir):
        train, train_classes = list_image_folder(train_dir)
        val, val_classes = list_image_folder(val_dir)
        if val_classes != train_classes:
            # A val class missing from train (or vice versa) would shift
            # every later label — reject rather than mislabel the dataset.
            raise ValueError(
                f"train/ and val/ class lists differ: "
                f"{sorted(set(train_classes) ^ set(val_classes))}")
        classes = train_classes
    else:
        samples, classes = list_image_folder(src)
        train, val = _split_train_val(samples, val_fraction, seed)

    os.makedirs(out_dir, exist_ok=True)
    paths = {"train_path": os.path.join(out_dir, "train.nzr"),
             "val_path": os.path.join(out_dir, "val.nzr"),
             "classes_path": os.path.join(out_dir, "classes.txt")}
    n_train = pack_split(train, paths["train_path"], size, workers)
    n_val = pack_split(val, paths["val_path"], size, workers) if val else 0
    if not val:
        # An empty NZR1 is invalid by design (the loader rejects n=0);
        # don't leave a stale one behind from a previous pack either.
        if os.path.exists(paths["val_path"]):
            os.remove(paths["val_path"])
        paths["val_path"] = None
    with open(paths["classes_path"], "w") as f:
        f.write("\n".join(classes) + "\n")
    return {"num_train": n_train, "num_val": n_val, "num_classes":
            len(classes), "classes": classes, "size": size, **paths}
