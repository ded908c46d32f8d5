"""The native C++ batch loaders (``csrc/dataloader.cpp``), bound with
``ctypes`` (counterpart of ``nezha_tpu/data/native.py`` and the loader
half of ``nezha_tpu/runtime/native.py``).

The library builds at first use, from ``csrc/dataloader.cpp`` alone
(``csrc/Makefile``'s flags)::

    g++ -O2 -std=c++17 -fPIC -Wall -Wextra -pthread -shared \\
        -o libnezha_loader.so csrc/dataloader.cpp

into ``build/nezha_tpu_torch/dataloader-<digest>/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the source and
the flags. Processes that race on a cold build take an ``flock`` and
the library appears by an atomic rename, so none loads a half-written
file. There is no fallback: a failed build, a missing compiler or a
missing symbol raises :class:`NativeLoaderError`.

Worker threads decode, shuffle and assemble batches into a bounded
queue; each ``next`` is one GIL-releasing copy into numpy arrays. The
loaders yield numpy arrays, as the JAX package's do: the trainer moves
them to the device. With one worker and the same file and seed a loader
yields the JAX package's batches bit for bit (both drive the same C++).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "dataloader.cpp"
BUILD_ROOT = ROOT / "build" / "nezha_tpu_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeLoaderError(RuntimeError):
    """The loader library did not build or load, or a loader refused its
    file (the C++ side's message)."""


def library_path(source: Path = SOURCE, stem: str = "dataloader",
                 name: str = "libnezha_loader.so") -> Path:
    """Where ``source``'s library builds: ``build/nezha_tpu_torch/<stem>-
    <digest>/<name>``, the digest over the flags and the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_ROOT / f"{stem}-{h.hexdigest()[:16]}" / name


def _build(out: Path, source: Path = SOURCE,
           error: type = NativeLoaderError) -> None:
    """Compile ``source`` alone into ``out`` under an ``flock``; a failed
    build raises ``error``."""
    import fcntl

    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():            # built while we waited
            return
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        what = source.stem
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                   str(source)],
                                  capture_output=True, text=True)
        except OSError as e:
            raise error(f"{what} build: cannot run {cxx}: {e}") from e
        if proc.returncode != 0 or not tmp.exists():
            raise error(f"{what} build failed ({cxx} exit "
                        f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)


def build_library(source: Path, stem: str, name: str,
                  error: type) -> Path:
    """The path of ``source``'s library, built first when its digest is
    new (see :func:`library_path`, :func:`_build`)."""
    out = library_path(source, stem, name)
    if not out.exists():
        _build(out, source, error)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.nz_loader_error.restype = c.c_char_p
    lib.nz_mnist_open.restype = c.c_void_p
    lib.nz_mnist_open.argtypes = [c.c_char_p, c.c_char_p, c.c_int,
                                  c.c_uint64, c.c_int, c.c_int, c.c_int,
                                  c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.nz_tokens_open.restype = c.c_void_p
    lib.nz_tokens_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int,
                                   c.c_uint64, c.c_int, c.c_int, c.c_int,
                                   c.c_int, c.POINTER(c.c_long)]
    lib.nz_records_open.restype = c.c_void_p
    lib.nz_records_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int,
                                    c.c_uint64, c.c_int, c.c_int, c.c_int,
                                    c.c_int, c.c_int, c.c_int,
                                    c.POINTER(c.c_int), c.POINTER(c.c_int),
                                    c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.nz_loader_next.restype = c.c_int
    lib.nz_loader_next.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                   c.POINTER(c.c_int32)]
    lib.nz_loader_close.argtypes = [c.c_void_p]
    return lib


def load_library() -> ctypes.CDLL:
    """Build (when its digest is new) and load the loader library."""
    global _lib
    with _lock:
        if _lib is None:
            out = build_library(SOURCE, "dataloader", "libnezha_loader.so",
                                NativeLoaderError)
            try:
                _lib = _declare(ctypes.CDLL(str(out)))
            except (OSError, AttributeError) as e:
                raise NativeLoaderError(f"loader library {out}: {e}") from e
        return _lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class _Closable:
    _h = None

    def _opened(self, handle) -> None:
        if not handle:
            raise NativeLoaderError(self._lib.nz_loader_error().decode())
        self._h = handle

    def close(self) -> None:
        if self._h:
            self._lib.nz_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class MnistLoader(_Closable):
    """Shuffled MNIST batches from IDX files: ``{"image": float32 [B,
    784] in [0, 1], "label": int32 [B]}``. ``epochs <= 0`` streams
    forever, reshuffling each epoch."""

    def __init__(self, images_path: str, labels_path: str, batch_size: int,
                 seed: int = 0, num_workers: int = 2, queue_depth: int = 4,
                 epochs: int = 0):
        self._lib = load_library()
        n, dim = ctypes.c_int(), ctypes.c_int()
        self._opened(self._lib.nz_mnist_open(
            str(images_path).encode(), str(labels_path).encode(),
            int(batch_size), int(seed), int(num_workers), int(queue_depth),
            int(epochs), ctypes.byref(n), ctypes.byref(dim)))
        self.num_examples = n.value
        self.example_dim = dim.value
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[dict]:
        while True:
            images = np.empty((self.batch_size, self.example_dim), np.float32)
            labels = np.empty((self.batch_size,), np.int32)
            if self._lib.nz_loader_next(self._h, _f32(images),
                                        _i32(labels)) <= 0:
                return
            yield {"image": images, "label": labels}


class ImageRecordLoader(_Closable):
    """Batches from an NZR1 record file: ``{"image": float32 [B, ch, cw,
    C] in [0, 1], "label": int32 [B]}``, a random crop and horizontal flip
    with ``train_augment``, else the center crop. ``epochs <= 0`` streams
    forever. Shard ``shard_index`` of ``shard_count`` takes the batches
    ``b % shard_count == shard_index`` of each epoch's shared shuffle."""

    def __init__(self, path: str, batch_size: int, crop: int = 0,
                 seed: int = 0, num_workers: int = 2, queue_depth: int = 4,
                 epochs: int = 0, train_augment: bool = True,
                 shard_index: int = 0, shard_count: int = 1):
        self._lib = load_library()
        n, h, w, c = (ctypes.c_int() for _ in range(4))
        self._opened(self._lib.nz_records_open(
            str(path).encode(), int(batch_size), int(crop), int(crop),
            int(seed), int(num_workers), int(queue_depth), int(epochs),
            1 if train_augment else 0, int(shard_index), int(shard_count),
            ctypes.byref(n), ctypes.byref(h), ctypes.byref(w),
            ctypes.byref(c)))
        self.num_examples = n.value
        self.shape = (h.value, w.value, c.value)
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[dict]:
        while True:
            images = np.empty((self.batch_size, *self.shape), np.float32)
            labels = np.empty((self.batch_size,), np.int32)
            if self._lib.nz_loader_next(self._h, _f32(images),
                                        _i32(labels)) <= 0:
                return
            yield {"image": images, "label": labels}


class ImageRecordWriter:
    """Streaming NZR1 writer (``b"NZR1"``, int32 count, h, w, c, then
    per record an int32 label and the uint8 HWC image). The count is
    written on ``close``; leaving a ``with`` block by an exception leaves
    it 0, which the loader refuses, so a crashed pack cannot pass for a
    whole file."""

    def __init__(self, path: str, h: int, w: int, c: int = 3):
        self.shape = (int(h), int(w), int(c))
        self._n = 0
        self._f = open(path, "wb")
        self._f.write(b"NZR1")
        self._f.write(np.asarray([0, *self.shape], np.int32).tobytes())

    def append(self, image: np.ndarray, label: int) -> None:
        image = np.ascontiguousarray(image, np.uint8)
        if image.shape != self.shape:
            raise ValueError(f"image shape {image.shape} != record shape "
                             f"{self.shape}")
        self._f.write(np.int32(label).tobytes())
        self._f.write(image.tobytes())
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def close(self) -> None:
        if self._f is not None:
            self._f.seek(4)
            self._f.write(np.int32(self._n).tobytes())
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            if self._f is not None:
                self._f.close()
                self._f = None
        else:
            self.close()


def write_image_records(path: str, images: np.ndarray,
                        labels: np.ndarray) -> None:
    """An NZR1 file from ``images`` uint8 [N, H, W, C] and ``labels``
    int [N]."""
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.asarray(labels, np.int32)
    if images.ndim != 4 or labels.shape[0] != images.shape[0]:
        raise ValueError("images must be [N,H,W,C] with matching labels")
    n, h, w, c = images.shape
    with ImageRecordWriter(path, h, w, c) as wr:
        for i in range(n):
            wr.append(images[i], int(labels[i]))


def nzr_count(path: str) -> int:
    """The record count in an NZR1 header."""
    with open(path, "rb") as f:
        header = f.read(8)
    return int(np.frombuffer(header[4:8], np.int32)[0])


class TokenLoader(_Closable):
    """Random ``[B, seq_len + 1]`` windows of a flat uint16 or int32
    token file, forever: ``{"tokens": int32 [B, seq_len + 1]}``. Each
    shard draws its own window stream (a seed split)."""

    _DTYPES = {np.dtype(np.uint16): 2, np.dtype(np.int32): 4}

    def __init__(self, path: str, seq_len: int, batch_size: int,
                 dtype=np.uint16, seed: int = 0, num_workers: int = 2,
                 queue_depth: int = 4, shard_index: int = 0,
                 shard_count: int = 1):
        code = self._DTYPES.get(np.dtype(dtype))
        if code is None:
            raise ValueError("dtype must be uint16 or int32")
        self._lib = load_library()
        n = ctypes.c_long()
        self._opened(self._lib.nz_tokens_open(
            str(path).encode(), code, int(seq_len), int(batch_size),
            int(seed), int(num_workers), int(queue_depth), int(shard_index),
            int(shard_count), ctypes.byref(n)))
        self.num_tokens = n.value
        self.batch_size = batch_size
        self.seq_len = seq_len

    def __iter__(self) -> Iterator[dict]:
        while True:
            out = np.empty((self.batch_size, self.seq_len + 1), np.int32)
            if self._lib.nz_loader_next(self._h, None, _i32(out)) <= 0:
                return
            yield {"tokens": out}
