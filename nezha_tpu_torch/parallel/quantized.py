"""The int8 gradient wire (counterpart of
``nezha_tpu/parallel/quantized.py``): block-scaled int8 collectives,
EQuARX-style for the dp all-reduce and ZeRO++-style for ZeRO-1.

An all-reduce is a reduce-scatter then an all-gather, each phase
quantized:

1. each rank quantizes its rows in blocks of ``block`` elements (int8
   and one fp32 scale a block, :func:`nezha_tpu_torch.ops.quant.
   quantize_blocks`), sends row r to rank r with ``all_to_all_single``,
   dequantizes the ``n`` rows it received and sums them in fp32, then
   divides by ``n``: the mean of the chunk it owns;
2. the owned chunk is quantized again and all-gathered, then
   dequantized.

Per element a phase carries ``1 + 4 / block`` bytes instead of 4. Sums
stay fp32; only the wire is int8. Every rank dequantizes the same bytes
in phase 2, so every rank ends with the same values. Leaves under
``min_numel`` elements, and integer leaves, take the exact fp32 path.

The leaves of a call travel together: their int8 rows, and their
scales, go in one ``all_to_all_single`` each (one ``all_gather`` each in
phase 2), laid out leaf after leaf, so each element is quantized in the
block the per-leaf JAX collective gives it.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nezha_tpu_torch.ops.quant import dequantize, quantize_blocks
from nezha_tpu_torch import obs
from nezha_tpu_torch.parallel.collectives import (_divide, _leaves,
                                                  _rebuild, all_reduce_mean,
                                                  world_size)

# Leaves below this many elements ride the exact path.
DEFAULT_MIN_NUMEL = 4096


def quantize_roundtrip(x: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Quantize and dequantize ``x`` once: the error of one wire hop."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    q, s = quantize_blocks(flat, block)
    return dequantize(q, s).reshape(-1)[:x.numel()].reshape(x.shape).to(
        x.dtype)


def should_quantize(leaf: torch.Tensor, min_numel: int) -> bool:
    """The wire's cutoff, shared by dp and ZeRO-1: float leaves of at
    least ``min_numel`` elements go int8."""
    return leaf.is_floating_point() and leaf.numel() >= min_numel


def split_quantized_leaves(tree: Any, min_numel: int
                           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``(quantized, exact)``: the leaves on each side of the cutoff."""
    quant, exact = [], []
    for leaf in _leaves(tree):
        (quant if should_quantize(leaf, min_numel) else exact).append(leaf)
    return quant, exact


def _exchange(q: torch.Tensor, s: torch.Tensor, group):
    """``all_to_all_single`` of int8 rows ``[n, ...]`` and their scales."""
    qt, st = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(qt, q.contiguous(), group=group)
    dist.all_to_all_single(st, s.contiguous(), group=group)
    return qt, st


def _gather(q: torch.Tensor, s: torch.Tensor, n: int, group):
    qg = q.new_empty((n, *q.shape[1:]))
    sg = s.new_empty((n, *s.shape[1:]))
    dist.all_gather_into_tensor(qg, q.contiguous(), group=group)
    dist.all_gather_into_tensor(sg, s.contiguous(), group=group)
    return qg, sg


def reduce_scatter_mean_many(flats: List[torch.Tensor], group=None,
                             block: int = 512) -> List[torch.Tensor]:
    """:func:`quantized_reduce_scatter_mean` of several arrays in one
    exchange: ``flats[i]`` [n * chunk_i] -> this rank's mean chunk_i."""
    n = world_size(group)
    rows, chunks = [], []
    for flat in flats:
        r = flat.float().reshape(n, -1)
        chunks.append(r.shape[1])
        rows.append(F.pad(r, (0, (-r.shape[1]) % block)))
    q, s = quantize_blocks(torch.cat(rows, dim=1), block)
    qt, st = _exchange(q, s, group)
    owned = _divide(torch.sum(dequantize(qt, st), dim=0), n).reshape(-1)
    return [o[:c] for o, c in zip(
        owned.split([r.shape[1] for r in rows]), chunks)]


def all_gather_many(chunks: List[torch.Tensor], group=None,
                    block: int = 512) -> List[torch.Tensor]:
    """:func:`quantized_all_gather` of several chunks in one exchange."""
    n = world_size(group)
    padded = [F.pad(c.float().reshape(-1), (0, (-c.numel()) % block))
              for c in chunks]
    q, s = quantize_blocks(torch.cat(padded).reshape(1, -1), block)
    qg, sg = _gather(q, s, n, group)
    full = dequantize(qg, sg).reshape(n, -1)
    return [part[:, :c.numel()].reshape(-1) for c, part in zip(
        chunks, full.split([p.numel() for p in padded], dim=1))]


def quantized_reduce_scatter_mean(flat: torch.Tensor, group=None,
                                  block: int = 512) -> torch.Tensor:
    """int8-wire mean reduce-scatter: ``flat`` [world * chunk] fp32 ->
    this rank's mean chunk [chunk] (ZeRO-1's gradient phase). Rows are
    padded to the block internally."""
    return reduce_scatter_mean_many([flat], group, block)[0]


def quantized_all_gather(chunk: torch.Tensor, group=None,
                         block: int = 512) -> torch.Tensor:
    """int8-wire tiled all-gather: a rank's [chunk] -> [world * chunk]
    fp32 (ZeRO-1's update phase)."""
    return all_gather_many([chunk], group, block)[0]


def all_reduce_mean_many(xs: List[torch.Tensor], group=None,
                         block: int = 512) -> List[torch.Tensor]:
    """int8-wire all-reduce-mean of several arrays: each padded to ``n``
    block-aligned chunks, reduce-scattered, then all-gathered. Counts
    nothing: its callers count the payload."""
    n = world_size(group)
    flats = []
    for x in xs:
        per = -(-x.numel() // (n * block)) * block
        flats.append(F.pad(x.float().reshape(-1), (0, n * per - x.numel())))
    owned = reduce_scatter_mean_many(flats, group, block)
    full = all_gather_many(owned, group, block)
    return [f[:x.numel()].reshape(x.shape).to(x.dtype)
            for f, x in zip(full, xs)]


def quantized_all_reduce_mean(tree: Any, group=None, block: int = 512,
                              min_numel: int = DEFAULT_MIN_NUMEL) -> Any:
    """The gradient mean over the group with int8 payloads for float
    leaves of at least ``min_numel`` elements; the others take the exact
    mean. Counts the int8 leaves as one ``all_reduce_int8`` at the
    wire's width, the others as one ``all_reduce``."""
    leaves = _leaves(tree)
    qi = [i for i, t in enumerate(leaves) if should_quantize(t, min_numel)]
    ei = sorted(set(range(len(leaves))) - set(qi))
    out: List[Any] = [None] * len(leaves)
    if qi:
        if obs.enabled():
            obs.record_collective("all_reduce_int8", sum(
                wire_payload_bytes(leaves[i].numel(), block) for i in qi))
        for i, r in zip(qi, all_reduce_mean_many([leaves[i] for i in qi],
                                                 group, block)):
            out[i] = r
    if ei:
        exact = all_reduce_mean({str(i): leaves[i] for i in ei}, group)
        for i in ei:
            out[i] = exact[str(i)]
    return _rebuild(tree, out)


def wire_payload_bytes(numel: int, block: int = 512) -> int:
    """Bytes of one quantized phase of ``numel`` fp32 elements: the
    block-padded int8 data and an fp32 scale a block (4 bytes an element
    on the exact path). See :func:`quantized_wire_bytes` for both
    phases."""
    padded = -(-numel // block) * block
    return padded + (padded // block) * 4


def quantized_wire_bytes(numel: int, block: int = 512, world: int = 8) -> int:
    """Bytes one rank puts on the wire for one quantized all-reduce of
    ``numel`` fp32 elements: both phases, ``(n - 1) / n`` of the payload
    leaving the device."""
    per = -(-numel // (world * block)) * block
    payload = world * per * 1 + world * (per // block) * 4
    return int(2 * payload * (world - 1) / world)
