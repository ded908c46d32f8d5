"""Checkpoints in the JAX package's npz format (counterpart of
``nezha_tpu/train/checkpoint.py``): a checkpoint written by either
package restores in the other.

A checkpoint is ``step_<N:08d>.npz`` holding one array per leaf, keyed
by the leaf's path in the JAX train state (``variables/params/...``,
``variables/state/...``, ``opt_state/step``, ``opt_state/mu/...``,
``rng``; :func:`nezha_tpu_torch.models.convert.train_state_to_jax` maps
a module and its optimizer state onto those keys), and a
``__manifest__`` entry: JSON with the CRC32, shape and dtype of every
leaf. The functions here take and return such flat ``{key: array}``
dicts.

- :func:`save_checkpoint` writes a temp file in the directory, fsyncs
  it, renames it into place and fsyncs the directory, so a crash leaves
  the old checkpoints and at worst a stray ``*.tmp``, which nothing
  reads; ``keep_last`` then prunes all but the newest N.
- :func:`verify_checkpoint` reads one back and checks it against its
  manifest: a torn zip, a leaf set that differs from the manifest or a
  CRC32 mismatch raises :class:`CheckpointCorrupt`.
- :func:`restore_checkpoint` reads the leaves a template names (others
  are ignored), cast to the template's dtypes.
- :func:`try_restore` walks from the newest step to the oldest and
  returns the first that verifies, noting each corrupt one on stderr.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import zlib
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from nezha_tpu_torch import faults

MANIFEST_VERSION = 1
MANIFEST_KEY = "__manifest__"
_STEP_FILE = re.compile(r"step_(\d+)\.npz$")

Flat = Dict[str, np.ndarray]


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed verification: a torn zip, a truncated leaf, a
    leaf set that differs from its manifest, or a CRC32 mismatch."""


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_dir(path: Path) -> None:
    fd = os.open(str(path), os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def checkpoint_path(ckpt_dir: str, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}.npz"


def save_checkpoint(ckpt_dir: str, flat: Mapping[str, np.ndarray],
                    step: int, keep_last: Optional[int] = None) -> str:
    """Durably write ``flat`` as ``step_<N>.npz``; -> its path. The
    leaves go in key order (the JAX package's tree order) with the
    manifest after them; ``keep_last=N`` prunes all but the N newest
    checkpoints once the new one is in place."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    if MANIFEST_KEY in flat:
        raise ValueError(f"{MANIFEST_KEY!r} is reserved for the "
                         f"checkpoint's manifest")
    flat = {k: np.asarray(flat[k]) for k in sorted(flat, key=_tree_order)}
    final = checkpoint_path(ckpt_dir, step)
    manifest = json.dumps({
        "manifest_version": MANIFEST_VERSION,
        "step": int(step),
        "leaves": {k: {"crc32": _leaf_crc(v), "shape": list(v.shape),
                       "dtype": str(v.dtype)}
                   for k, v in flat.items()},
    })
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat, **{MANIFEST_KEY: np.asarray(manifest)})
            f.flush()
            os.fsync(f.fileno())
        # A fault here leaves only the temporary file, which is removed:
        # the previous checkpoint stays the newest.
        faults.point("checkpoint.save")
        os.replace(tmp, final)
        _fsync_dir(d)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if keep_last is not None and keep_last > 0:
        prune_old_checkpoints(ckpt_dir, keep_last)
    return str(final)


def _tree_order(key: str) -> Tuple[str, ...]:
    """JAX flattens a dict tree in sorted key order at every level."""
    return tuple(key.split("/"))


def prune_old_checkpoints(ckpt_dir: str, keep_last: int) -> None:
    """Delete all but the ``keep_last`` newest ``step_*.npz`` files (a
    file another process deleted first is skipped)."""
    entries = sorted(p for p in Path(ckpt_dir).glob("step_*.npz")
                     if _STEP_FILE.match(p.name))
    for p in entries[:-keep_last]:
        try:
            p.unlink()
        except FileNotFoundError:
            pass


def checkpoint_steps(ckpt_dir: str) -> List[int]:
    """Every step on disk, ascending (listed, not verified)."""
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    return sorted(int(m.group(1)) for p in d.glob("step_*.npz")
                  if (m := _STEP_FILE.match(p.name)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def checkpoint_keys(ckpt_dir: str, step: int) -> List[str]:
    """The entry names of one checkpoint, read from the zip directory
    alone (no array is decompressed)."""
    with np.load(checkpoint_path(ckpt_dir, step)) as z:
        return list(z.files)


def verify_checkpoint(ckpt_dir: str, step: int) -> Flat:
    """Load and check one checkpoint; -> its leaves (the manifest
    removed). Raises :class:`CheckpointCorrupt` when it is torn or
    disagrees with its manifest, ``FileNotFoundError`` when the step is
    not on disk. A checkpoint without a manifest passes on a clean read
    alone."""
    path = checkpoint_path(ckpt_dir, step)
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint for step {step} in "
                                f"{ckpt_dir}")
    try:
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
    except Exception as e:  # torn zip, truncated entry, bad header
        raise CheckpointCorrupt(
            f"{path.name}: unreadable ({type(e).__name__}: {e})") from e
    if MANIFEST_KEY not in flat:
        return flat
    try:
        leaves = json.loads(str(flat.pop(MANIFEST_KEY)))["leaves"]
    except Exception as e:
        raise CheckpointCorrupt(
            f"{path.name}: unreadable embedded manifest "
            f"({type(e).__name__}: {e})") from e
    missing = set(leaves) - set(flat)
    extra = set(flat) - set(leaves)
    if missing or extra:
        raise CheckpointCorrupt(
            f"{path.name}: leaf set disagrees with manifest "
            f"(missing {sorted(missing)}, extra {sorted(extra)})")
    for key, meta in leaves.items():
        if _leaf_crc(flat[key]) != meta["crc32"]:
            raise CheckpointCorrupt(
                f"{path.name}: CRC32 mismatch for leaf {key!r}")
    return flat


def _select(template: Mapping, flat: Flat) -> Flat:
    """The leaves ``template`` names, cast to its dtypes (a template
    value is an array or a dtype)."""
    out = {}
    for key, leaf in template.items():
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        val = flat[key]
        dtype = np.dtype(getattr(leaf, "dtype", leaf))
        out[key] = val.astype(dtype) if val.dtype != dtype else val
    return out


def restore_checkpoint(ckpt_dir: str, template: Mapping,
                       step: Optional[int] = None) -> Tuple[Flat, int]:
    """-> (the leaves ``template`` names, step), from ``step`` or the
    newest checkpoint, verified first (:func:`verify_checkpoint`)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return _select(template, verify_checkpoint(ckpt_dir, step)), step


def try_restore(ckpt_dir: str, template: Mapping
                ) -> Tuple[Optional[Flat], int]:
    """The resume entry: the newest checkpoint that verifies, as
    :func:`restore_checkpoint` returns it, or ``(None, 0)``. A corrupt
    one (a save cut short) is noted on stderr and the walk goes on to
    the step before it."""
    for step in reversed(checkpoint_steps(ckpt_dir)):
        try:
            return _select(template, verify_checkpoint(ckpt_dir, step)), step
        except CheckpointCorrupt as e:
            print(f"skipping corrupt checkpoint at step {step}: {e}",
                  file=sys.stderr)
        except FileNotFoundError:
            print(f"checkpoint for step {step} vanished (concurrent "
                  f"prune?); falling back", file=sys.stderr)
    return None, 0
