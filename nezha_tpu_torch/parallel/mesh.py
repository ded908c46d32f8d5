"""The serve mesh and its collectives, in one process (counterpart of
``nezha_tpu/parallel/mesh.py`` ``make_mesh`` and of the ``lax``
collectives the sequence-sharded prefill uses).

A :class:`Mesh` is a list of ``torch.device``s under one axis name: shard
``r`` keeps its tensors on ``mesh.devices[r]``. A device may appear more
than once: ``[cpu] * M`` is the counterpart of the forced host devices
every JAX mesh test runs on, and ``[cuda:0] * M`` runs an M-shard mesh on
one card (its shards then run one after another). An :class:`SpMesh`
(:func:`make_sp_mesh`) is ``dp`` groups of such a mesh on the ``sp``
axis, the sequence-parallel train step's.

The collectives take per-shard lists (``xs[r]`` on shard r's device) and
return per-shard lists; each moves tensors between the shards' devices
in rank order:

- :func:`all_to_all` — ``lax.all_to_all(..., tiled=True)``;
- :func:`ppermute` — ``lax.ppermute``;
- :func:`psum` / :func:`pmax` — ``lax.psum`` / ``lax.pmax``, reduced in
  rank order on shard 0's device, so every shard gets the same bits;
- :func:`psum_scatter` / :func:`all_gather` — the tiled
  ``lax.psum_scatter`` / ``lax.all_gather`` over axis 0 (the graph IR's
  ``reduce_scatter`` and ``all_gather`` nodes).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[r]`` holds shard r; ``axis_name`` names the one axis."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "tp"

    @property
    def size(self) -> int:
        return len(self.devices)


def _default_devices(device_type: str, count: int) -> List[torch.device]:
    """The visible cards on ``cuda`` (all of them, however many; never
    one repeated), the CPU repeated ``count`` times on ``cpu``."""
    if device_type == "cpu":
        return [torch.device("cpu")] * count
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(n)]
    raise ValueError(f"a mesh runs on cuda or cpu, not {device_type!r}")


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current card>``, the device its tensors
    report."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None,
              device_type: str = "cuda") -> Mesh:
    """A one-axis mesh, e.g. ``make_mesh({"tp": 4})``, on the first
    devices of ``devices`` — None: the visible cards
    (``device_type="cuda"``) or the CPU repeated (``"cpu"``). Asking for
    more devices than the list holds raises ``ValueError``."""
    if len(axes) != 1:
        raise ValueError(f"the port's mesh has one axis, got {dict(axes)}")
    (name, size), = axes.items()
    if size < 1:
        raise ValueError(f"mesh axis {name!r} needs size >= 1, got {size}")
    if devices is None:
        devices = _default_devices(device_type, size)
    devs = [_indexed(torch.device(d)) for d in devices]
    if size > len(devs):
        raise ValueError(
            f"a mesh of {size} shards needs {size} devices, only "
            f"{len(devs)} visible (name a mesh's devices with devices=, "
            f"which may repeat one)")
    return Mesh(tuple(devs[:size]), name)


def group_mesh(axes: Dict[str, int], inner: Sequence[str], kind: str,
               devices: Optional[Sequence] = None,
               device_type: str = "cuda"
               ) -> Tuple[Dict[str, int], List[torch.device]]:
    """The sizes and devices of a one-process mesh of ``dp`` groups over
    the ``inner`` axes (gspmd's ``tp`` and ``ep``, the pipeline's ``pp``);
    the first of ``inner`` must be present. One inner axis of size -1
    takes the visible cards left to it (cards only, ``devices`` None).
    ``devices`` None: the visible cards on ``cuda``, the CPU repeated on
    ``cpu``. -> (``{axis: size}`` in ``("dp",) + inner`` order, the
    mesh's devices)."""
    names = ("dp",) + tuple(inner)
    unknown = sorted(set(axes) - set(names))
    if unknown or "dp" not in axes or inner[0] not in axes:
        raise ValueError(f"a {kind} mesh has the axes dp and {inner[0]}"
                         + (f" (and {', '.join(inner[1:])})"
                            if len(inner) > 1 else "")
                         + f", got {dict(axes)}")
    sizes = {a: int(axes[a]) for a in names if a in axes}
    if sizes["dp"] < 1:
        raise ValueError(f"mesh axis dp needs size >= 1, got {sizes['dp']}")
    for axis, size in sizes.items():
        if size != -1 or axis == "dp":
            continue
        if devices is not None or device_type != "cuda":
            raise ValueError(f"{axis}=-1 takes the visible cards: give "
                             f"{axis}=M with a repeated device or on the "
                             f"CPU")
        rest = 1
        for a, v in sizes.items():
            rest *= v if a != axis else 1
        sizes[axis] = len(_default_devices("cuda", 0)) // max(rest, 1)
    for axis in inner:
        if sizes.get(axis, 1) < 1:
            raise ValueError(f"mesh axis {axis} needs size >= 1, got "
                             f"{sizes[axis]} (too few visible cards for "
                             f"dp={sizes['dp']}?)")
    n = 1
    for v in sizes.values():
        n *= v
    if devices is None:
        devices = (_default_devices(device_type, n) if device_type == "cuda"
                   else [torch.device(device_type)] * n)
    devs = [_indexed(torch.device(d)) for d in devices]
    if n > len(devs):
        shape = " x ".join(f"{a}={v}" for a, v in sizes.items())
        raise ValueError(
            f"a {shape} mesh needs {n} devices, only {len(devs)} visible "
            f"(name the devices, which may repeat one)")
    return sizes, devs[:n]


def check_groups_repeat(groups: Sequence[Sequence[torch.device]],
                        kind: str) -> None:
    """One process drives one set of shards: every dp group's devices
    must be group 0's, else :class:`NotPortedError` (ROADMAP A7)."""
    from nezha_tpu_torch.errors import NotPortedError
    for g in range(1, len(groups)):
        if tuple(groups[g]) != tuple(groups[0]):
            raise NotPortedError(
                f"dp group {g} runs on {list(groups[g])}, group 0 on "
                f"{list(groups[0])}: one process drives one set of "
                f"shards, so dp groups on other cards need a process each "
                f"(multi-process {kind}, ROADMAP A7)")


@dataclasses.dataclass(frozen=True)
class SpMesh:
    """``dp`` groups of ``sp`` sequence shards (JAX's ``make_mesh({"dp":
    D, "sp": S})``): group g's shard s is ``devices[g * sp + s]``, shard
    id ``g * sp + s``."""

    devices: Tuple[torch.device, ...]
    dp: int
    sp: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    def group(self, g: int = 0) -> Mesh:
        """Dp group g's sequence shards as a one-axis ``sp`` mesh."""
        return Mesh(self.devices[g * self.sp:(g + 1) * self.sp], "sp")


def make_sp_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None,
                 device_type: str = "cuda") -> SpMesh:
    """The ``{"dp": D, "sp": S}`` mesh on ``devices`` (None: the visible
    cards on ``cuda``, the CPU repeated on ``cpu``; one card repeated
    when named so); ``sp=-1`` takes the visible cards left to each dp
    group. A dp group on other devices than group 0's raises
    :class:`NotPortedError` (ROADMAP A7)."""
    sizes, devs = group_mesh(axes, ("sp",), "sequence-parallel", devices,
                             device_type)
    mesh = SpMesh(tuple(devs), sizes["dp"], sizes["sp"])
    check_groups_repeat([mesh.group(g).devices for g in range(mesh.dp)],
                        "sequence-parallel")
    return mesh


def device_scope(device: torch.device):
    """Make ``device`` the current card while a shard launches kernels on
    it (a kernel launches on the current device); a no-op off cuda."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _check(xs: Sequence[torch.Tensor]) -> int:
    if not xs:
        raise ValueError("a collective needs one tensor per shard")
    return len(xs)


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """Tiled all-to-all: shard r splits ``xs[r]`` into M equal chunks
    along ``split_axis`` and sends chunk j to shard j, which concatenates
    the chunks it receives, in the senders' rank order, along
    ``concat_axis``."""
    m = _check(xs)
    if xs[0].shape[split_axis] % m:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{xs[0].shape[split_axis]} does not split {m} ways")
    parts = [x.chunk(m, dim=split_axis) for x in xs]
    return [torch.cat([parts[src][dst].to(xs[dst].device)
                       for src in range(m)], dim=concat_axis).contiguous()
            for dst in range(m)]


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]],
             copy: bool = True) -> List[torch.Tensor]:
    """``out[dst] = xs[src]`` for each ``(src, dst)`` pair, on ``dst``'s
    device; a shard no pair sends to gets zeros. ``copy=False`` hands a
    tensor already on ``dst``'s device on as it is (a block that travels
    on a repeated device moves by reference)."""
    m = _check(xs)
    out: List[Optional[torch.Tensor]] = [None] * m
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"ppermute: shard {dst} receives twice")
        out[dst] = xs[src].to(xs[dst].device, copy=copy)
    return [torch.zeros_like(xs[r]) if o is None else o
            for r, o in enumerate(out)]


def ring_perm(m: int) -> List[Tuple[int, int]]:
    """The ring hop ``r -> r + 1 (mod m)``."""
    return [(r, (r + 1) % m) for r in range(m)]


def _reduce(xs: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    _check(xs)
    dev0 = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(dev0))
    return [acc if x.device == dev0 else acc.to(x.device) for x in xs]


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over shards, ``((x0 + x1) + x2) + ...`` on shard 0's
    device, given to every shard."""
    return _reduce(xs, torch.add)


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise max over shards, given to every shard."""
    return _reduce(xs, torch.maximum)


def psum_scatter(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled reduce-scatter over axis 0 (``lax.psum_scatter(...,
    scatter_dimension=0, tiled=True)``): the rank-order sum of
    :func:`psum`, cut into M equal chunks, chunk r to shard r."""
    m = _check(xs)
    if xs[0].shape[0] % m:
        raise ValueError(f"psum_scatter: axis 0 of size {xs[0].shape[0]} "
                         f"does not split {m} ways")
    total = psum(xs)[0]
    return [c.to(x.device) for c, x in zip(total.chunk(m, dim=0), xs)]


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled all-gather over axis 0 (``lax.all_gather(..., axis=0,
    tiled=True)``): the shards' tensors concatenated in rank order, on
    every shard's device."""
    _check(xs)
    return [torch.cat([y.to(x.device) for y in xs], dim=0) for x in xs]


__all__ = ["Mesh", "SpMesh", "all_gather", "all_to_all", "device_scope",
           "make_mesh", "make_sp_mesh", "pmax", "ppermute", "psum",
           "psum_scatter", "ring_perm"]
