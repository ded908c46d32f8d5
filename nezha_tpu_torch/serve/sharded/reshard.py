"""GPT-2 parameters -> M per-shard parameter sets on a serve mesh
(counterpart of ``nezha_tpu/serve/sharded/reshard.py``).

The split is Megatron's, from the same table the JAX package trains and
serves with (``nezha_tpu/parallel/gspmd.py`` ``GPT2_TP_RULES``):
column-parallel qkv and fc (their output features split), row-parallel
attention and MLP projections (their input features split), a
vocab-sharded token embedding, everything else replicated. GSPMD is free
to lay a split out as it likes; explicit shards must own whole heads, so
the fused qkv weight ``[hidden, 3 * hidden]`` splits each of its q, k and
v thirds by head group: shard r takes the q, k and v columns of heads
``[r * H/M, (r + 1) * H/M)``, and the attention projection's rows follow
the same grouping (which is its contiguous split). The embedding
replicates when the vocabulary does not divide by M (GPT-2's 50257
divides by none of 2, 4, 8).

:func:`reshard_checkpoint` streams a training checkpoint onto the mesh
one leaf at a time (the path behind ``cli/reshard.py`` and ``cli/serve.py
--mesh M --ckpt-dir``): a dense npz, each leaf CRC32-checked against the
checkpoint's embedded manifest as it is read, or a per-shard
``step_*.sharded`` save, each shard's part read from exactly the stored
shards that overlap it. Host memory stays bounded by the largest leaf,
and no device ever holds a split leaf whole. :func:`save_serve_checkpoint`
writes the placed shards in the per-shard layout under the JAX package's
``variables/params/...`` keys, so that either package reads the other's
serve checkpoint, and :func:`verify_roundtrip` proves such a save
bitwise. A missing or corrupt leaf raises :class:`ReshardError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.models.convert import _to_jax_path, jax_leaf_names
from nezha_tpu_torch.nn.scan import scan_source
from nezha_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Split:
    """How one parameter lies over the mesh: ``axis`` is split M ways
    (None: replicated); with ``groups`` > 1 the axis holds that many
    fused blocks (qkv's q | k | v), each split M ways and shard r taking
    its part of every block. ``mesh_axis`` names the mesh axis it splits
    over: ``tp``, or ``ep`` for a MoE layer's expert stacks."""

    axis: Optional[int] = None
    groups: int = 1
    mesh_axis: str = "tp"


REPLICATED = Split()

# Port parameter names (``h.0.attn.qkv.w``) -> placement; the JAX
# table's order and coverage.
GPT2_TP_RULES: List[Tuple[str, Split]] = [
    (r".*\.qkv\.w$", Split(1, groups=3)),
    (r".*\.qkv\.b$", Split(0, groups=3)),
    (r".*\.attn\.proj\.w$", Split(0)),
    (r".*\.mlp\.fc\.w$", Split(1)),
    (r".*\.mlp\.fc\.b$", Split(0)),
    (r".*\.mlp\.proj\.w$", Split(0)),
    (r"^wte\.embedding$", Split(0)),
    (r".*\.(attn|mlp)\.proj\.b$", REPLICATED),
    (r".*\.ln_\d+\.(scale|bias)$", REPLICATED),
    (r"^ln_f\.(scale|bias)$", REPLICATED),
    (r"^wpe\.embedding$", REPLICATED),
]


def serve_tp_rules(model_cfg, mesh_devices: int
                   ) -> List[Tuple[str, Split]]:
    """The serving table: :data:`GPT2_TP_RULES`, except that the token
    embedding replicates when ``vocab_size % mesh_devices``."""
    rules = []
    for pat, split in GPT2_TP_RULES:
        if (pat == r"^wte\.embedding$"
                and model_cfg.vocab_size % max(int(mesh_devices), 1)):
            split = REPLICATED
        rules.append((pat, split))
    return rules


def rule_for(name: str, rules: Sequence[Tuple[str, Split]]) -> Split:
    """The first rule matching ``name``; an unmatched name raises."""
    for pat, split in rules:
        if re.match(pat, name):
            return split
    raise ValueError(f"no serve placement rule covers parameter {name!r}")


def shard_slice(t: torch.Tensor, split: Split, r: int,
                m: int) -> torch.Tensor:
    """Shard r's part of ``t`` under ``split`` (the tensor itself when
    replicated)."""
    if split.axis is None:
        return t
    size = t.shape[split.axis]
    if size % (split.groups * m):
        raise ValueError(f"axis {split.axis} of {tuple(t.shape)} does not "
                         f"split into {split.groups} x {m} parts")
    block = size // split.groups
    part = block // m
    return torch.cat([t.narrow(split.axis, g * block + r * part, part)
                      for g in range(split.groups)], dim=split.axis)


def place_variables(params: Dict[str, torch.Tensor], mesh: Mesh,
                    rules: Sequence[Tuple[str, Split]]
                    ) -> List[Dict[str, torch.Tensor]]:
    """A GPT-2 ``state_dict``-like ``{name: tensor}`` -> one dict per
    shard, each on its shard's device: split leaves hold shard r's
    contiguous part, replicated leaves the whole tensor (shared by shards
    on one device)."""
    m = mesh.size
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(m)]
    for name, t in params.items():
        split = rule_for(name, rules)
        t = t.detach()
        for r, dev in enumerate(mesh.devices):
            part = shard_slice(t, split, r, m)
            shards[r][name] = (part.to(dev) if split.axis is None
                               else part.to(dev).contiguous())
    return shards


class ReshardError(RuntimeError):
    """A training checkpoint that cannot be put onto the serve mesh: none
    there, a torn file, a CRC32 mismatch, a missing leaf, a shape that
    differs from the model's, or stored shards that do not cover a
    slice. The serve CLI refuses to start on it."""


def _pieces(split: Split, r: int, m: int, shape: Sequence[int]
            ) -> List[Tuple[Tuple[Tuple[int, int], ...], int, int]]:
    """Shard r's contiguous pieces of a leaf of global ``shape``: (the
    global index ``((start, stop), ...)``, the piece's start and length
    along the split axis within the shard's part). One piece a fused
    block (qkv has three); the whole leaf when replicated."""
    full = [(0, int(n)) for n in shape]
    if split.axis is None:
        return [(tuple(full), 0, 0)]
    block = shape[split.axis] // split.groups
    part = block // m
    out = []
    for g in range(split.groups):
        idx = list(full)
        idx[split.axis] = (g * block + r * part, g * block + (r + 1) * part)
        out.append((tuple(idx), g * part, part))
    return out


def _serve_names(model) -> Dict[str, Tuple[str, torch.Tensor]]:
    """Parameter name -> (its JAX key under ``variables/``, the
    parameter), in the model's order."""
    params = dict(model.named_parameters())
    return {n: (key, params[n]) for n, (key, _) in
            jax_leaf_names(model).items() if n in params}


def _place(names, rules, mesh: Mesh,
           read: Callable[[str, str, Split, Tuple], List[np.ndarray]]
           ) -> List[Dict[str, torch.Tensor]]:
    """Build the per-shard dicts leaf by leaf. ``read(name, key, split,
    shape)`` -> shard r's pieces (host arrays, :func:`_pieces` order) for
    every r, or one whole array when replicated; each is cast to the
    parameter's dtype and moved to its shard's device, and a replicated
    leaf is one tensor per distinct device."""
    m = mesh.size
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(m)]
    for name, (key, p) in names.items():
        split = rule_for(name, rules)
        shape = tuple(p.shape)
        if split.axis is not None and shape[split.axis] % (split.groups * m):
            raise ReshardError(f"{key}: axis {split.axis} of {shape} does "
                               f"not split into {split.groups} x {m} "
                               f"parts")
        got = read(name, key, split, shape)
        if split.axis is None:
            per_dev = {}
            for r, dev in enumerate(mesh.devices):
                if dev not in per_dev:
                    per_dev[dev] = torch.from_numpy(got[0]).to(
                        device=dev, dtype=p.dtype)
                shards[r][name] = per_dev[dev]
            continue
        for r, dev in enumerate(mesh.devices):
            part = torch.cat([torch.from_numpy(a) for a in got[r]],
                             dim=split.axis)
            shards[r][name] = part.to(device=dev, dtype=p.dtype).contiguous()
    return shards


def reshard_checkpoint(ckpt_dir: str, model, mesh: Mesh, *,
                       step: Optional[int] = None, rules=None
                       ) -> Tuple[List[Dict[str, torch.Tensor]], int]:
    """Put a training checkpoint onto the serve mesh one leaf at a time;
    -> (one ``{name: tensor}`` per shard, on its device, as
    :func:`place_variables` lays them out; the step).

    Sources, in order: the dense npz of ``step`` (default: the newest),
    each leaf CRC32-checked against the embedded manifest before it is
    placed; then the per-shard save of ``step`` (default: the newest
    complete one), each shard's part assembled from the stored shards that
    overlap it. A ``--scan-layers`` trunk (``h_scan``, JAX's
    ``_reshard_scan_npz``) is read once a stacked leaf and sliced per
    layer onto the unrolled serve model's ``h{i}`` leaves; any
    integrity or geometry fault raises :class:`ReshardError`, as does an
    injected ``serve.reshard`` fault. ``model`` gives the parameter names,
    shapes and dtypes. The load is one ``serve.reshard_s`` span."""
    from nezha_tpu_torch.train import checkpoint as ckpt
    from nezha_tpu_torch.train import sharded_checkpoint as sck

    try:
        faults.point("serve.reshard")
    except faults.InjectedFault as e:
        raise ReshardError(f"injected reshard fault: {e}") from e
    if rules is None:
        rules = serve_tp_rules(model.cfg, mesh.size)
    names = _serve_names(model)
    with obs.span("serve.reshard_s", ckpt_dir=str(ckpt_dir),
                  mesh=int(mesh.size)) as sp:
        dense_step = (step if step is not None
                      else ckpt.latest_step(ckpt_dir))
        if dense_step is not None:
            npz = ckpt.checkpoint_path(ckpt_dir, dense_step)
            if npz.exists():
                out = _reshard_npz(str(npz), names, rules, mesh)
                sp.set(source="npz", step=int(dense_step))
                return out, int(dense_step)
        sstep = step if step is not None else sck.latest_step(ckpt_dir)
        if sstep is not None:
            sdir = sck.step_dir(ckpt_dir, sstep)
            if sdir.is_dir():
                out = _reshard_sharded_dir(sdir, names, rules, mesh)
                sp.set(source="sharded", step=int(sstep))
                return out, int(sstep)
    raise ReshardError(f"no training checkpoint (npz or sharded) in "
                       f"{ckpt_dir!r}")


def _candidates(key: str, present):
    """-> (stored key, layer or None): the leaf under the train state's
    layout or the graph engine's, else its layer's slice of a scan
    trunk's stacked leaf (``h{i}/...`` -> ``h_scan/...`` at ``i``)."""
    for cand in (f"variables/{key}", key):
        if cand in present:
            return cand, None
    hit = scan_source(key, "h", "h_scan")
    if hit is not None:
        skey, i = hit
        for cand in (f"variables/{skey}", skey):
            if cand in present:
                return cand, i
    return None, None


def _reshard_npz(path: str, names, rules, mesh: Mesh):
    """One dense npz onto the mesh: ``np.load`` reads one entry at a
    time, and each leaf's CRC32 is checked against the manifest before
    it reaches a device (a checkpoint without a manifest has nothing to
    check against)."""
    from nezha_tpu_torch.train.checkpoint import MANIFEST_KEY

    base = os.path.basename(path)
    try:
        z = np.load(path)
    except Exception as e:
        raise ReshardError(f"{base}: unreadable ({type(e).__name__}: "
                           f"{e})") from e
    try:
        files = set(z.files)
        manifest = None
        if MANIFEST_KEY in files:
            try:
                manifest = json.loads(str(z[MANIFEST_KEY]))["leaves"]
            except Exception as e:
                raise ReshardError(f"{base}: unreadable embedded manifest "
                                   f"({type(e).__name__}: {e})") from e

        stacked = {}   # a scan trunk's leaves, each read and checked once

        def checked(cand: str) -> np.ndarray:
            try:
                arr = z[cand]
            except Exception as e:
                raise ReshardError(f"{base}: leaf {cand!r} unreadable "
                                   f"({type(e).__name__}: {e})") from e
            if manifest is not None:
                meta = manifest.get(cand)
                if meta is None:
                    raise ReshardError(f"leaf {cand!r} missing from the "
                                       f"checkpoint manifest")
                crc = zlib.crc32(np.ascontiguousarray(
                    arr).tobytes()) & 0xFFFFFFFF
                if crc != meta["crc32"]:
                    raise ReshardError(f"CRC32 mismatch for leaf {cand!r} "
                                       f"-- checkpoint corrupt, refusing to "
                                       f"serve it")
            return arr

        def leaf(key: str) -> np.ndarray:
            cand, layer = _candidates(key, files)
            if cand is None:
                raise ReshardError(f"checkpoint missing leaf {key!r}")
            if layer is None:
                return checked(cand)
            if cand not in stacked:
                stacked[cand] = checked(cand)
            return stacked[cand][layer]

        def read(name, key, split, shape):
            arr = leaf(key)
            if tuple(arr.shape) != shape:
                raise ReshardError(f"shape mismatch for {key!r}: serve "
                                   f"model {shape} vs saved "
                                   f"{tuple(arr.shape)}")
            if split.axis is None:
                return [arr]
            return [[arr[tuple(slice(a, b) for a, b in idx)]
                     for idx, _, _ in _pieces(split, r, mesh.size, shape)]
                    for r in range(mesh.size)]

        return _place(names, rules, mesh, read)
    finally:
        z.close()


def _open_store(sdir: Path):
    from nezha_tpu_torch.train.sharded_checkpoint import _ShardStore

    try:
        return _ShardStore(Path(sdir))
    except Exception as e:
        raise ReshardError(f"{Path(sdir).name}: unreadable shard store "
                           f"({type(e).__name__}: {e})") from e


def _reshard_sharded_dir(sdir: Path, names, rules, mesh: Mesh):
    """A per-shard save onto the mesh: each shard's pieces are read
    (``_ShardStore.read``) from exactly the stored shards that overlap
    them. The format carries completion markers, not CRCs; a missing
    process file shows as a slice the stored shards do not cover."""
    from nezha_tpu_torch.train.sharded_checkpoint import to_tensor

    store = _open_store(sdir)
    try:
        def read(name, key, split, shape):
            cand, layer = _candidates(key, store.leaves)
            if cand is None:
                raise ReshardError(f"checkpoint missing leaf {key!r}")
            entry = store.leaves[cand]
            saved = tuple(entry["shape"])[0 if layer is None else 1:]
            if saved != shape:
                raise ReshardError(f"shape mismatch for {key!r}: serve "
                                   f"model {shape} vs saved {saved}")

            def piece(idx):
                try:
                    if layer is None:
                        arr = store.read(cand, idx)
                    else:   # the layer's slice of the stacked leaf
                        arr = store.read(cand, ((layer, layer + 1),)
                                         + tuple(idx))[0]
                except (ValueError, KeyError, OSError) as e:
                    raise ReshardError(f"stored shards do not cover "
                                       f"{key!r}: {e}") from e
                if entry["dtype"] == "bfloat16":   # its uint16 bytes
                    arr = to_tensor(arr, "bfloat16").float().numpy()
                return arr

            if split.axis is None:
                return [piece(tuple((0, n) for n in shape))]
            return [[piece(idx) for idx, _, _ in
                     _pieces(split, r, mesh.size, shape)]
                    for r in range(mesh.size)]

        return _place(names, rules, mesh, read)
    finally:
        store.close()


def _leaves_for_save(shards, rules):
    """The per-shard save's leaves of placed ``shards``: each split leaf
    as its pieces at their global indices, each replicated leaf once."""
    from nezha_tpu_torch.train.sharded_checkpoint import (ShardedLeaf,
                                                          host_array)

    m = len(shards)
    leaves = {}
    for name in shards[0]:
        key = f"variables/params/{_to_jax_path(name)}"
        split = rule_for(name, rules)
        shape = list(shards[0][name].shape)
        if split.axis is not None:
            shape[split.axis] *= m
        leaf = None
        for r in range(m if split.axis is not None else 1):
            t = shards[r][name]
            for idx, start, size in _pieces(split, r, m, shape):
                piece = t if split.axis is None else t.narrow(
                    split.axis, start, size)
                arr, dtype = host_array(piece.contiguous())
                if leaf is None:
                    leaf = ShardedLeaf(tuple(shape), dtype)
                leaf.shards.append((idx, arr))
        leaves[key] = leaf
    return leaves


def save_serve_checkpoint(out_dir: str, shards, step: int, rules) -> str:
    """Write placed ``shards`` (laid out by ``rules``) as a serve-topology
    per-shard checkpoint, ``out_dir/step_<N>.sharded`` under
    ``variables/params/...`` keys, which :func:`reshard_checkpoint` (and
    the JAX package's) reads onto a mesh of any size; -> its directory."""
    from nezha_tpu_torch.train import sharded_checkpoint as sck

    return sck.save_sharded(out_dir, _leaves_for_save(shards, rules), step,
                            proc=0, world=1)


def verify_roundtrip(out_dir: str, shards, step: int, rules) -> List[str]:
    """Read a :func:`save_serve_checkpoint` back and compare each piece
    of each leaf with the live shards' bytes; -> the keys that differ or
    are missing (empty: the round trip is exact)."""
    from nezha_tpu_torch.train import sharded_checkpoint as sck

    store = _open_store(sck.step_dir(out_dir, step))
    bad: List[str] = []
    try:
        for key, leaf in _leaves_for_save(shards, rules).items():
            if key not in store.leaves or (
                    store.leaves[key]["dtype"] != leaf.dtype):
                bad.append(key)
                continue
            if any(store.read(key, idx).tobytes() != arr.tobytes()
                   for idx, arr in leaf.shards):
                bad.append(key)
    finally:
        store.close()
    return bad
