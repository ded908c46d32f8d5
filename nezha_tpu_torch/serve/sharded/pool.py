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

The block wire and the host tier compose as in JAX, in the one full-head
int8+scales layout (mesh-blind: a mesh-2 export equals a one-device
export byte for byte):

- gather-on-export: :meth:`_gather_blocks` gathers the blocks on every
  shard and concatenates the shards' head groups, in shard order, on
  shard 0's device (a float pool quantizes per shard first: the scale is
  per (block, head), so that is the full block's quantization);
- scatter-on-install: :meth:`_scatter_blocks` splits a full-head payload
  by head groups and writes each shard's part on its device.

So ``export_block_payload``, ``export_prefix_payload`` and
``install_block_payload`` serve migration and peer pulls, and the host
tier's demotion (a gather into one full-head entry) and promotion (a
scatter of the entries) run unchanged through ``serve/slots.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from nezha_tpu_torch.parallel.mesh import Mesh
from nezha_tpu_torch.serve.slots import (_WIRE_KEYS,
                                         _gather_blocks_quantized,
                                         _gather_quantize_blocks,
                                         _scatter_blocks_dequant,
                                         _scatter_blocks_quantized,
                                         PagedSlotPool)


class ShardedPagedSlotPool(PagedSlotPool):
    """The paged pool with its device state split by heads over ``mesh``;
    host bookkeeping inherited unchanged."""

    def __init__(self, model_cfg, capacity: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, *, mesh: Mesh,
                 block_size: int = 16, num_blocks=None,
                 prefix_cache: bool = True, eviction: str = "lru",
                 quantized: bool = False, host_blocks: int = 0):
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
                         quantized=quantized, host_blocks=host_blocks,
                         device=mesh.devices[0])

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

    # ------------------------------------------------------------ wire
    @property
    def wire_device(self) -> torch.device:
        return self.mesh.devices[0]

    def _gather_blocks(self, idx):
        """Gather-on-export: every shard's blocks ``idx``, their head
        groups concatenated in shard order on shard 0's device."""
        gather = (_gather_blocks_quantized if self.quantized
                  else _gather_quantize_blocks)
        parts = [gather(self.shard_caches(r), idx.to(dev))
                 for r, dev in enumerate(self.mesh.devices)]
        dev0 = self.wire_device
        return [{k: torch.cat([p[li][k].to(dev0) for p in parts], dim=1)
                 for k in _WIRE_KEYS} for li in range(self.num_layers)]

    def _scatter_blocks(self, idx, payload) -> None:
        """Scatter-on-install: a full-head payload split by head groups,
        shard r's part written on its device."""
        scatter = (_scatter_blocks_quantized if self.quantized
                   else _scatter_blocks_dequant)
        hh = self.num_heads // self.shard_devices
        for r, dev in enumerate(self.mesh.devices):
            part = [{k: v[:, r * hh:(r + 1) * hh].to(dev)
                     for k, v in layer.items()} for layer in payload]
            scatter(self.shard_caches(r), idx.to(dev), part)

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
