"""Head-sharded paged KV pool: one logical pool, M physical shards
(counterpart of ``nezha_tpu/serve/sharded/pool.py``).

:class:`ShardedPagedSlotPool` is the port's :class:`PagedSlotPool` laid
out over a serve mesh: every layer's K/V pools (``[num_blocks, H/M,
block_size, D]``) and int8 scale rows (``[num_blocks, H/M]``) exist once
per shard, on the shard's device, each holding its head group
``[r * H/M, (r + 1) * H/M)`` of every block. Everything host-side is
inherited unchanged: the free list, ref counts, per-slot block tables
and the prefix trie, because a block is a logical unit — binding,
copy-on-write and eviction decide about block identities, which every
shard shares. Copy-on-write copies the block on every shard.

``caches[layer]`` is the list of the M shards' dicts of that layer.

The block wire (export and install for migration and peer pulls) needs
gather-on-export and a scatter over the shards, which are not ported:
those methods raise :class:`NotPortedError` (ROADMAP A6), and the host
tier is refused by :class:`~.engine.ShardedEngine`.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.parallel.mesh import Mesh
from nezha_tpu_torch.serve.slots import PagedSlotPool


class ShardedPagedSlotPool(PagedSlotPool):
    """The paged pool with its device state split by heads over ``mesh``;
    host bookkeeping inherited unchanged."""

    def __init__(self, model_cfg, capacity: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, *, mesh: Mesh,
                 block_size: int = 16, num_blocks=None,
                 prefix_cache: bool = True, eviction: str = "lru",
                 quantized: bool = False):
        tp = mesh.size
        if model_cfg.num_heads % tp:
            raise ValueError(
                f"num_heads={model_cfg.num_heads} not divisible by the "
                f"mesh's tp={tp}: the KV pools shard on the head axis")
        self.mesh = mesh
        self.num_heads = model_cfg.num_heads
        super().__init__(model_cfg, capacity, max_len, dtype,
                         block_size=block_size, num_blocks=num_blocks,
                         prefix_cache=prefix_cache, eviction=eviction,
                         quantized=quantized, device=mesh.devices[0])

    def _alloc_layer(self, heads: int, d: int, kv_dtype: torch.dtype,
                     device):
        hh = heads // self.mesh.size
        return [super(ShardedPagedSlotPool, self)._alloc_layer(
                    hh, d, kv_dtype, dev) for dev in self.mesh.devices]

    def layer_states(self) -> List[Tuple[int, dict]]:
        return [(li, shard) for li, layer in enumerate(self.caches)
                for shard in layer]

    def shard_caches(self, r: int) -> List[dict]:
        """Shard r's per-layer dicts."""
        return [layer[r] for layer in self.caches]

    # ------------------------------------------------------- migration
    def export_block_payload(self, slot, nblocks):
        raise NotPortedError("exporting KV blocks from a head-sharded pool "
                             "(gather-on-export) is not ported (ROADMAP A6)")

    def export_prefix_payload(self, tokens):
        raise NotPortedError("exporting KV blocks from a head-sharded pool "
                             "(gather-on-export) is not ported (ROADMAP A6)")

    def install_block_payload(self, tokens, layers, origin="migrate"):
        raise NotPortedError("installing KV blocks into a head-sharded pool "
                             "is not ported (ROADMAP A6)")

    # ------------------------------------------------------ accounting
    @property
    def shard_devices(self) -> int:
        """Mesh size M: how many physical shards the logical pool has."""
        return self.mesh.size

    @property
    def bytes_resident_per_shard(self) -> int:
        """Device bytes one shard holds for the resident blocks: the head
        axis divides exactly, so each shard carries ``bytes_resident /
        M``."""
        return self.bytes_resident // self.shard_devices

    # -------------------------------------------------------- invariants
    def leak_check(self) -> None:
        """The ref-count books, plus per shard: every layer of every shard
        still holds exactly ``H/M`` heads of all ``num_blocks`` blocks on
        its own device (a rebuilt or gathered pool would multiply
        resident bytes by M)."""
        super().leak_check()
        hh = self.num_heads // self.shard_devices
        for li, layer in enumerate(self.caches):
            if len(layer) != self.shard_devices:
                raise AssertionError(
                    f"layer {li} has {len(layer)} shards, not "
                    f"{self.shard_devices}")
            for r, shard in enumerate(layer):
                for key, leaf in shard.items():
                    if (leaf.shape[0] != self.num_blocks
                            or leaf.shape[1] != hh):
                        raise AssertionError(
                            f"layer {li} shard {r} {key!r} is "
                            f"{tuple(leaf.shape)}: not {hh} heads of "
                            f"{self.num_blocks} blocks")
                    if leaf.device != self.mesh.devices[r]:
                        raise AssertionError(
                            f"layer {li} shard {r} {key!r} left its "
                            f"device {self.mesh.devices[r]} "
                            f"({leaf.device})")
