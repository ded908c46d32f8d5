"""Per-shard checkpoints in the JAX package's layout (counterpart of
``nezha_tpu/train/sharded_checkpoint.py``): each process writes the
shards it owns, so no host ever holds the whole ZeRO-1 optimizer state,
and a save of either package restores in the other.

Layout of ``step_<N:08d>.sharded/``:

- ``shards_p<proc>.npz``: this process's shards, ``<leaf key>::<i>``;
- ``meta_p<proc>.json``: ``{"leaves": {key: {"shape", "dtype", "shards":
  [{"key", "index": [[start, stop], ...]}]}}, "world": <processes>}``,
  each index a shard's place in the leaf's global shape;
- ``COMPLETE_p<proc>``: written last, after an fsync of the directory. A
  directory without every marker its world names is a torn save, which
  :func:`latest_step` ignores.

Leaf keys are the JAX train state's paths (``variables/params/...``,
``opt_state/mu/...``, ``rng``). Replicated leaves are written by
process 0 alone; other processes list them with no shards. bf16 data is
stored as its uint16 bytes with dtype ``bfloat16`` (the JAX package's
byte view). A restore assembles each requested slice from every stored
shard that overlaps it, so a save at one world size restores at another.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nezha_tpu_torch.train.checkpoint import _fsync_dir

Index = Tuple[Tuple[int, int], ...]
_STEP_DIR = re.compile(r"step_(\d+)\.sharded$")


@dataclasses.dataclass
class ShardedLeaf:
    """One leaf as this process saves it: its global shape and dtype
    name, and the shards it owns as (index, host array)."""
    shape: Tuple[int, ...]
    dtype: str
    shards: List[Tuple[Index, np.ndarray]] = dataclasses.field(
        default_factory=list)


def host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` and its dtype name; bf16 as its uint16
    bytes."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
    arr = np.array(t.numpy(), copy=True)
    return arr, str(arr.dtype)


def to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The inverse of :func:`host_array`."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr, np.dtype(dtype)))


def whole(arr: np.ndarray, dtype: Optional[str] = None) -> ShardedLeaf:
    """A leaf held whole by this process."""
    arr = np.asarray(arr)
    return ShardedLeaf(arr.shape, dtype or str(arr.dtype),
                       [(tuple((0, n) for n in arr.shape), arr)])


def step_dir(ckpt_dir: str, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}.sharded"


def _default_proc() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_sharded(ckpt_dir: str, leaves: Dict[str, ShardedLeaf], step: int,
                 keep_last: Optional[int] = None, proc: Optional[int] = None,
                 world: Optional[int] = None) -> str:
    """Write this process's shards of ``leaves`` under
    ``step_<N>.sharded``; -> the directory. ``proc``/``world`` default to
    ``torch.distributed``'s rank and size (0 and 1 without a group).
    ``keep_last=N`` then prunes all but the N newest complete saves."""
    if proc is None or world is None:
        proc, world = _default_proc()
    out = _write(ckpt_dir, leaves, step, proc, world)
    if keep_last is not None and keep_last > 0:
        prune_old_sharded(ckpt_dir, keep_last)
    return out


def _write(ckpt_dir: str, leaves: Dict[str, ShardedLeaf], step: int,
           proc: int, world: int) -> str:
    d = step_dir(ckpt_dir, step)
    d.mkdir(parents=True, exist_ok=True)
    arrays = {}
    meta = {"leaves": {}, "world": int(world)}
    for key, leaf in leaves.items():
        entry = {"shape": [int(n) for n in leaf.shape], "dtype": leaf.dtype,
                 "shards": []}
        for i, (idx, data) in enumerate(leaf.shards):
            skey = f"{key}::{i}"
            arrays[skey] = np.asarray(data)
            entry["shards"].append({"key": skey,
                                    "index": [list(se) for se in idx]})
        meta["leaves"][key] = entry
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, d / f"shards_p{proc}.npz")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    mtmp = d / f"meta_p{proc}.json.tmp"
    with open(mtmp, "w") as f:
        f.write(json.dumps(meta))
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, d / f"meta_p{proc}.json")
    # The marker vouches only for durable data: fsync the renames first.
    _fsync_dir(d)
    (d / f"COMPLETE_p{proc}").touch()
    _fsync_dir(d)
    return str(d)


def _is_complete(d: Path) -> bool:
    try:
        metas = list(d.glob("meta_p*.json"))
        if not metas:
            return False
        world = json.loads(metas[0].read_text()).get("world", 1)
        return all((d / f"COMPLETE_p{i}").exists() for i in range(world))
    except (OSError, ValueError):
        # A concurrent pruner may remove the dir between glob and read.
        return False


def prune_old_sharded(ckpt_dir: str, keep_last: int) -> None:
    """Delete all but the ``keep_last`` newest complete sharded saves.
    Torn directories are never counted or touched; every rank may prune
    after its save, and no error here escapes (the save succeeded)."""
    try:
        complete = sorted(p for p in Path(ckpt_dir).glob("step_*.sharded")
                          if _STEP_DIR.match(p.name) and _is_complete(p))
        for p in complete[:-keep_last]:
            shutil.rmtree(p, ignore_errors=True)
    except OSError as e:
        warnings.warn(f"checkpoint retention pruning failed (the save "
                      f"itself succeeded): {e}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete sharded save's step, or None. A torn save
    newer than it is ignored with a warning."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps, torn = [], []
    for p in d.glob("step_*.sharded"):
        m = _STEP_DIR.match(p.name)
        if not m or not list(p.glob("meta_p*.json")):
            continue
        (steps if _is_complete(p) else torn).append(int(m.group(1)))
    chosen = max(steps) if steps else None
    for step in torn:
        if chosen is None or step > chosen:
            warnings.warn(f"ignoring torn sharded checkpoint "
                          f"{step_dir(ckpt_dir, step)} (missing COMPLETE "
                          f"markers)")
    return chosen


def checkpoint_keys(ckpt_dir: str, step: int) -> List[str]:
    """The leaf keys of one sharded save, read from its metadata alone
    (no array is loaded)."""
    keys: Dict[str, None] = {}
    for meta_path in sorted(step_dir(ckpt_dir, step).glob("meta_p*.json")):
        keys.update(dict.fromkeys(json.loads(meta_path.read_text())[
            "leaves"]))
    return list(keys)


class _ShardStore:
    """Every stored shard of one save, read lazily from the npz files."""

    def __init__(self, d: Path):
        self.leaves: dict = {}
        self._files = []
        for meta_path in sorted(d.glob("meta_p*.json")):
            proc = re.search(r"meta_p(\d+)\.json$", meta_path.name).group(1)
            z = np.load(d / f"shards_p{proc}.npz")
            self._files.append(z)
            meta = json.loads(meta_path.read_text())
            for key, info in meta["leaves"].items():
                entry = self.leaves.setdefault(
                    key, {"shape": tuple(info["shape"]),
                          "dtype": info["dtype"], "shards": []})
                for sh in info["shards"]:
                    entry["shards"].append((sh["index"], z, sh["key"]))

    def _np_dtype(self, key: str) -> np.dtype:
        dt = self.leaves[key]["dtype"]
        return np.dtype(np.uint16) if dt == "bfloat16" else np.dtype(dt)

    def read(self, key: str, want: Sequence[Tuple[int, int]]) -> np.ndarray:
        """The slice ``want`` ([start, stop) per dim, which may reach past
        the stored shape: that part is zeros) from the overlapping
        shards."""
        entry = self.leaves[key]
        dtype = self._np_dtype(key)
        if not want:  # a scalar
            _, z, skey = entry["shards"][0]
            return np.asarray(z[skey]).astype(dtype)
        stored = [(0, n) for n in entry["shape"]]
        out = np.zeros([b - a for a, b in want], dtype)
        need = int(np.prod([max(0, min(b, s1) - max(a, s0)) for (a, b), (
            s0, s1) in zip(want, stored)]))
        filled = 0
        for sidx, z, skey in entry["shards"]:
            src, dst = [], []
            for (s0, s1), (w0, w1) in zip(sidx, want):
                lo, hi = max(s0, w0), min(s1, w1)
                if lo >= hi:
                    break
                src.append(slice(lo - s0, hi - s0))
                dst.append(slice(lo - w0, hi - w0))
            else:
                block = np.asarray(z[skey])[tuple(src)]
                out[tuple(dst)] = block
                filled += block.size
        if filled < need:
            raise ValueError(f"stored shards do not cover the requested "
                             f"slice of {key!r} (missing process files?)")
        return out

    def close(self) -> None:
        for z in self._files:
            z.close()


# A restore request: (global shape, slice or None for the whole leaf).
Request = Tuple[Tuple[int, ...], Optional[Index]]


def restore_sharded(ckpt_dir: str, template: Dict[str, Request],
                    step: Optional[int] = None
                    ) -> Tuple[Dict[str, Tuple[np.ndarray, str]], int]:
    """Read each template leaf's requested slice (its whole global shape
    when the slice is None) from ``step`` (default: the newest complete
    save) -> ({key: (array, dtype name)}, step). A shape that differs from
    the saved one raises, except for a 1-D ``opt_state/`` leaf: ZeRO-1's
    flat optimizer state is zero-padded to a multiple of the world size,
    so one saved at another world size restores with the padding cut or
    added, provided the cut part is zeros."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no sharded checkpoints in {ckpt_dir}")
    store = _ShardStore(step_dir(ckpt_dir, step))
    try:
        out = {}
        for key, (shape, index) in template.items():
            if key not in store.leaves:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            saved = store.leaves[key]["shape"]
            shape = tuple(shape)
            if shape != saved:
                if not (key.startswith("opt_state/")
                        and len(shape) == len(saved) == 1):
                    raise ValueError(f"shape mismatch for {key!r}: template "
                                     f"{shape} vs saved {saved}")
                if saved[0] > shape[0] and np.any(store.read(
                        key, [(shape[0], saved[0])])):
                    raise ValueError(f"{key!r}: the saved tail past "
                                     f"{shape[0]} elements is not padding")
            want = [tuple(se) for se in index] if index is not None \
                else [(0, n) for n in shape]
            out[key] = (store.read(key, want), store.leaves[key]["dtype"])
        return out, step
    finally:
        store.close()


def try_restore_sharded(ckpt_dir: str, template: Dict[str, Request]):
    """:func:`restore_sharded` of the newest complete save, or (None, 0)
    when there is none."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, 0
    return restore_sharded(ckpt_dir, template, step)


class AsyncCheckpointer:
    """Sharded saves written on a background thread: the caller pays the
    host copies (already in ``leaves``), the files are written off the
    training thread. One save is in flight at a time; a second waits for
    the first. :meth:`wait` commits it and raises its error, if any."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_write_seconds: Optional[float] = None

    def save(self, ckpt_dir: str, leaves: Dict[str, ShardedLeaf], step: int,
             keep_last: Optional[int] = None, proc: Optional[int] = None,
             world: Optional[int] = None) -> None:
        import time

        self.wait()
        if proc is None or world is None:
            proc, world = _default_proc()

        def work():
            t0 = time.perf_counter()
            try:
                save_sharded(ckpt_dir, leaves, step, keep_last, proc, world)
            except BaseException as e:  # raised by the next wait()/save()
                self._error = e
            self.last_write_seconds = time.perf_counter() - t0

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    @property
    def pending(self) -> bool:
        """A save was started and not yet waited for."""
        return self._thread is not None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
