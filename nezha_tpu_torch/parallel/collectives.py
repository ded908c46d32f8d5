"""Collectives over a ``torch.distributed`` process group (counterpart of
``nezha_tpu/parallel/collectives.py``, whose wrappers run inside
``shard_map`` over a named mesh axis).

Each function takes a tensor or a dict of tensors and a group (None: the
default group) and returns the same structure. The leaves of one dtype
travel as one bucket, one collective call for all of them: a gradient
dict of two hundred tensors is one ``all_reduce``, and every element
comes out as the per-leaf collective would give it. The tensors must lie
on the group's device (CUDA for ``nccl``, the CPU for ``gloo``).

Each public function counts one call of its op and the bytes one rank
hands it in the telemetry registry (``collective.<op>.calls`` and
``.payload_bytes``) while a run is active. The JAX package counts once
per traced program; the port, which runs eagerly, counts once per call,
so a train step's payload per call is JAX's per program. The dp and
ZeRO-1 steps count their own payloads (at the wire's width) and call the
unrecorded forms (``_all_reduce_mean``, ``_all_gather``,
``_reduce_scatter``), so no payload counts twice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from nezha_tpu_torch import obs


def record_tree(op: str, tree: Any) -> None:
    """Count one call of ``op`` carrying ``tree`` (the bytes one rank
    contributes); nothing unless a telemetry run is active."""
    if obs.enabled():
        obs.record_collective(op, tree_bytes(tree))


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def world_size(group=None) -> int:
    return dist.get_world_size(group)


def _leaves(tree: Any) -> List[torch.Tensor]:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def _rebuild(tree: Any, leaves: List[torch.Tensor]) -> Any:
    return dict(zip(tree, leaves)) if isinstance(tree, dict) else leaves[0]


def _by_dtype(leaves: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _bucketed(tree: Any, one: Callable[[List[torch.Tensor]],
                                       List[torch.Tensor]]) -> Any:
    """Apply ``one`` (a list of same-dtype leaves -> their results) to
    each dtype's leaves, keeping the tree's order."""
    leaves = _leaves(tree)
    out: List[Any] = [None] * len(leaves)
    for idx in _by_dtype(leaves).values():
        for i, r in zip(idx, one([leaves[i] for i in idx])):
            out[i] = r
    return _rebuild(tree, out)


def _sum_rows(xs: List[torch.Tensor], group,
              divisor: Optional[int] = None) -> List[torch.Tensor]:
    """The group's elementwise sums of ``xs`` in one all-reduce, divided
    by ``divisor`` when given (one division for the whole bucket: a
    launch a leaf costs the host more than the step's device work at
    world 1). Each leaf flattens in its memory order, which every rank
    shares, so a channels_last leaf is a view both ways and its sum keeps
    its layout (an update that mixes layouts runs strided)."""
    perms = [sorted(range(x.dim()), key=lambda d: -x.stride(d)) for x in xs]
    flat = torch.cat([x.permute(p).reshape(-1) for x, p in zip(xs, perms)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if divisor is not None:
        flat = _divide(flat, divisor)
    out = []
    for f, x, p in zip(flat.split([x.numel() for x in xs]), xs, perms):
        back = sorted(range(len(p)), key=p.__getitem__)
        out.append(f.view([x.shape[d] for d in p]).permute(back))
    return out


def all_reduce_sum(tree: Any, group=None) -> Any:
    record_tree("all_reduce", tree)
    return _bucketed(tree, lambda xs: _sum_rows(xs, group))


def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` as a true division (a tensor divisor: a Python scalar
    divides as a multiply by its reciprocal on the card); an integer
    ``x`` gives fp32, as JAX's ``pmean`` does."""
    if not x.is_floating_point():
        x = x.float()
    return x / torch.full_like(x, n)


def all_reduce_mean(tree: Any, group=None) -> Any:
    """The sum over the group divided by its size, per leaf."""
    record_tree("all_reduce", tree)
    return _all_reduce_mean(tree, group)


def _all_reduce_mean(tree: Any, group=None) -> Any:
    n = world_size(group)
    return _bucketed(tree, lambda xs: _sum_rows(xs, group, n))


def all_gather(tree: Any, group=None, axis: int = 0,
               tiled: bool = True) -> Any:
    """Every rank's leaf, concatenated along ``axis`` (``tiled``) or
    stacked in a new leading axis, in rank order."""
    record_tree("all_gather", tree)
    return _all_gather(tree, group, axis, tiled)


def _all_gather(tree: Any, group=None, axis: int = 0,
                tiled: bool = True) -> Any:
    n = world_size(group)

    def one(xs):
        flat = torch.cat([x.reshape(-1) for x in xs])
        out = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(out, flat, group=group)
        out = out.view(n, -1)
        res = []
        for x, part in zip(xs, out.split([x.numel() for x in xs], dim=1)):
            g = part.reshape(n, *x.shape).movedim(0, axis)
            res.append(g.flatten(axis, axis + 1) if tiled else g)
        return res

    return _bucketed(tree, one)


def reduce_scatter(tree: Any, group=None, axis: int = 0) -> Any:
    """Sum over the group, then rank r keeps the r-th of ``n`` equal
    slices along ``axis`` (the ZeRO-1 gradient path). Each leaf's
    ``axis`` must be a multiple of the group's size."""
    record_tree("reduce_scatter", tree)
    return _reduce_scatter(tree, group, axis)


def _reduce_scatter(tree: Any, group=None, axis: int = 0) -> Any:
    n = world_size(group)

    def one(xs):
        moved = [x.movedim(axis, 0) for x in xs]
        for m in moved:
            if m.shape[0] % n:
                raise ValueError(f"reduce_scatter: axis {axis} of size "
                                 f"{m.shape[0]} is not a multiple of the "
                                 f"group's {n} ranks")
        rows = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
        out = rows.new_empty(rows.shape[1])
        dist.reduce_scatter_tensor(out, rows.reshape(-1),
                                   op=dist.ReduceOp.SUM, group=group)
        return [part.reshape(m.shape[0] // n, *m.shape[1:]).movedim(0, axis)
                for m, part in zip(moved, out.split(
                    [m.numel() // n for m in moved]))]

    return _bucketed(tree, one)


def barrier(group=None, device=None) -> None:
    """A device barrier: an all-reduce of one element on ``device`` (the
    group's: ``cuda`` for nccl), waited for on the host."""
    if device is None:
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    one = torch.ones(1, device=device)
    dist.all_reduce(one, group=group)
    if one.is_cuda:
        torch.cuda.synchronize(one.device)


def allreduce_bus_bandwidth(payload_bytes: int, seconds: float,
                            world: int) -> float:
    """NCCL's bus bandwidth of a ring all-reduce: ``bytes * 2 (n - 1) /
    n / seconds``; 0 at one rank, where nothing crosses a link."""
    if seconds <= 0:
        return 0.0
    return payload_bytes * (2.0 * (world - 1) / world) / seconds
