"""KV pools for the serving engine (counterpart of
``nezha_tpu/serve/slots.py``): the dense :class:`SlotPool` and the
block-paged :class:`PagedSlotPool` with its :class:`PrefixTrie` (bf16, f32
and int8 pools). Both share one slot-level contract (``alloc``/``free``/
``num_free``/``occupancy``), which is the scheduler's whole view.

The dense pool holds one ``{"k", "v"}`` dict per layer of buffers shaped
``[capacity, H, max_len, D]``: one worst-case reservation per admitted
request, with no blocks, no prefix cache and no eviction.

A pool's ``mirror`` is a second pool shadowing its slot lifecycle (the
speculative engine's draft KV pool): ``alloc`` claims the same slot index
in the mirror and ``free`` frees it there in the same call, so the
draft's cache rows for a request always live at the target's slot, and
``leak_check`` audits both.

The paged pool's device state is one ``{"k", "v"}`` dict per layer of
pools shaped ``[num_blocks, H, block_size, D]``; an int8 pool
(``quantized=True``) adds ``{"k_scale", "v_scale"}``, one fp32 scale per
(block, head), ``[num_blocks, H]``, so that every move of a block (the
copy-on-write copy) moves its scales with it. Unlike JAX's immutable
arrays these tensors are updated IN PLACE: the model's cache path scatters each
dispatch's K/V into them, and copy-on-write copies one block over another
where it lies. Host state is the block free list, per-block reference
counts, per-slot block tables (``tables_host [capacity, blocks_per_slot]``
int32, uploaded per dispatch) and the prefix trie.

Invariants (``leak_check`` asserts them):

- block 0 is scratch: never allocated, never ref-counted; freed slots'
  table rows reset to it and non-emitting rows' writes land in it;
- a block is written only while its ref count is exactly 1
  (:meth:`PagedSlotPool.prepare_write` copies a shared block first);
- every non-free block's ref count equals the slots binding it plus one
  if a trie node caches it;
- releasing the last reference returns the block to the free list.

Freeing is bookkeeping only: stale K/V stays in a freed block, which is
safe because a new occupant writes (or references blocks holding exactly)
every position before attention covers it.

The ``serve.kv.*`` instruments (prefix hits, copy-on-write copies,
demotions, promotions, fleet hits by tier) count beside the plain
attributes; the fault point ``serve.kv.bind`` is armed at every block
allocation and ``serve.kv.promote`` at every promotion (an injected error
there degrades the request to a cold prefill).
"""

from __future__ import annotations

import collections
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.ops.quant import dequantize_kv_block, quantize_kv_block


class KVBlocksExhausted(RuntimeError):
    """Typed backpressure: binding found no free block even after
    eviction. ``slot`` is the slot being grown (None at admission)."""

    def __init__(self, msg: str, slot: Optional[int] = None):
        super().__init__(msg)
        self.slot = slot


class SlotPool:
    """The dense layout: per-layer ``{"k", "v"}`` buffers ``[capacity, H,
    max_len, D]`` in ``dtype`` on ``device`` (zeroed), and a LIFO free
    list of slot indices. The model's dense cache path writes a slot's
    rows IN PLACE through :func:`read_slot`'s view."""

    paged = False
    quantized = False
    # A dense pool keeps no host tier.
    host_blocks = 0
    host_blocks_used = 0

    def __init__(self, model_cfg, capacity: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        self.capacity = capacity
        self.max_len = max_len
        self.dtype = dtype
        heads = model_cfg.num_heads
        d = model_cfg.hidden_size // heads
        self._slot_bytes = (2 * model_cfg.num_layers * heads * max_len * d
                            * dtype.itemsize)
        shape = (capacity, heads, max_len, d)
        self.caches = [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for _ in range(model_cfg.num_layers)]
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self.mirror = None

    def alloc(self) -> Optional[int]:
        """-> a free slot index, or None when every slot is occupied."""
        slot = self._free.pop() if self._free else None
        if slot is not None and self.mirror is not None:
            self.mirror.claim(slot)
        return slot

    def claim(self, slot: int) -> None:
        """Take a SPECIFIC free slot (the mirror path: the leader pool
        chose the index). Raises ValueError when the slot is not free."""
        self._free.remove(slot)

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.capacity:
            raise ValueError(f"slot {slot} out of range [0, {self.capacity})")
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free (double free)")
        self._free.append(slot)
        if self.mirror is not None:
            self.mirror.free(slot)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return self.capacity - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.num_active / self.capacity

    @property
    def blocks_used(self) -> int:
        """Reserved rows in slot units (a dense pool has no blocks)."""
        return self.num_active

    @property
    def bytes_resident(self) -> int:
        """A worst-case ``max_len`` K/V row pair per active slot."""
        return self.num_active * self._slot_bytes

    def leak_check(self) -> None:
        """Assert the free list holds distinct in-range slots, and that a
        mirror's free list agrees slot for slot (its own books checked
        too)."""
        if (len(set(self._free)) != len(self._free)
                or not all(0 <= s < self.capacity for s in self._free)):
            raise AssertionError(f"slot free list corrupt: {self._free}")
        _check_mirror(self, self._free)


def read_slot(pool_leaf: torch.Tensor, slot: int) -> torch.Tensor:
    """One slot's rows of a pooled dense cache leaf ``[capacity, H, L,
    D]`` -> ``[1, H, L, D]``, a VIEW: the model's in-place cache writes
    through it land in the pool."""
    return pool_leaf.narrow(0, slot, 1)


def write_slot(pool_leaf: torch.Tensor, chunk_leaf: torch.Tensor,
               slot: int) -> torch.Tensor:
    """Write ``chunk_leaf [1, H, P, D]`` (``P <= L``) over the first ``P``
    positions of ``slot``'s rows, IN PLACE, cast to the pool dtype. ->
    ``pool_leaf``."""
    pool_leaf[slot:slot + 1, :, :chunk_leaf.shape[2]] = chunk_leaf.to(
        pool_leaf.dtype)
    return pool_leaf


def _check_mirror(pool, free_slots) -> None:
    """The mirror column of ``leak_check``: the mirror's free slots equal
    ``free_slots`` (lifecycle lockstep), and its own books balance."""
    mirror = pool.mirror
    if mirror is None:
        return
    theirs = (mirror._free_slots if isinstance(mirror, PagedSlotPool)
              else mirror._free)
    if sorted(theirs) != sorted(free_slots):
        raise AssertionError(f"draft pool slot drift: mirror free "
                             f"{sorted(theirs)} != {sorted(free_slots)}")
    mirror.leak_check()


class _TrieNode:
    __slots__ = ("tokens", "block", "children", "parent", "tick")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: Optional["_TrieNode"], tick: int):
        self.tokens = tokens
        self.block = block
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.parent = parent
        self.tick = tick


class PrefixTrie:
    """Prefix-reuse index over FULL blocks of prompt tokens: a node is one
    cached block keyed by the ``block_size`` tokens it holds, childed
    under the node of the preceding block. A full block is never written
    again, so cached content is immutable. The trie holds one pool
    reference per node; eviction (leaf-first, least recently used) drops
    it."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root: Dict[Tuple[int, ...], _TrieNode] = {}
        self._nodes: set = set()
        self._leaves: set = set()
        self._tick = itertools.count()

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def blocks(self) -> List[int]:
        return [n.block for n in self._nodes]

    def match(self, tokens: Sequence[int]) -> List[int]:
        """-> block ids of the longest cached full-block prefix of
        ``tokens``; touches the matched nodes (LRU)."""
        bs = self.block_size
        out: List[int] = []
        children = self.root
        i = 0
        while i + bs <= len(tokens):
            node = children.get(tuple(int(t) for t in tokens[i:i + bs]))
            if node is None:
                break
            node.tick = next(self._tick)
            out.append(node.block)
            children = node.children
            i += bs
        return out

    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               take_ref) -> int:
        """Index the full-block prefix of ``tokens`` under ``blocks``;
        ``take_ref(block)`` runs once per newly inserted node. Existing
        nodes are kept (first writer wins). -> nodes inserted."""
        bs = self.block_size
        children = self.root
        parent: Optional[_TrieNode] = None
        inserted = 0
        for bi in range(len(tokens) // bs):
            key = tuple(int(t) for t in tokens[bi * bs:(bi + 1) * bs])
            node = children.get(key)
            if node is None:
                node = _TrieNode(key, int(blocks[bi]), parent,
                                 next(self._tick))
                children[key] = node
                self._nodes.add(node)
                self._leaves.add(node)
                if parent is not None:
                    self._leaves.discard(parent)
                take_ref(node.block)
                inserted += 1
            else:
                node.tick = next(self._tick)
            parent = node
            children = node.children
        return inserted

    def evict(self, want: int, release, only=None,
              on_evict: Optional[Callable] = None) -> int:
        """Drop up to ``want`` cached blocks, leaf-first and LRU-first;
        ``only(block)`` filters candidates (the pool passes "ref count is
        exactly 1", so an eviction always frees a block).
        ``on_evict(path_tokens, block)`` runs for each victim before its
        release, with the full root-to-node token path (the pool's
        host-tier demotion hook: the block still holds the node's
        content then). -> evicted."""
        evicted = 0
        while evicted < want:
            leaves = [n for n in self._leaves
                      if only is None or only(n.block)]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.tick)
            self._remove(victim)
            if on_evict is not None:
                on_evict(self._path_tokens(victim), victim.block)
            release(victim.block)
            evicted += 1
        return evicted

    @staticmethod
    def _path_tokens(node: _TrieNode) -> Tuple[int, ...]:
        """The full root-to-``node`` token path: the prompt prefix whose
        K/V the node's block (with its ancestors') holds. The host tier
        keys on it, since a block's content depends on every preceding
        token."""
        parts: List[Tuple[int, ...]] = []
        while node is not None:
            parts.append(node.tokens)
            node = node.parent
        return tuple(t for tok in reversed(parts) for t in tok)

    def clear(self, release) -> int:
        n = len(self._nodes)
        for node in self._nodes:
            release(node.block)
        self.root = {}
        self._nodes = set()
        self._leaves = set()
        return n

    def _remove(self, node: _TrieNode) -> None:
        siblings = node.parent.children if node.parent else self.root
        siblings.pop(node.tokens, None)
        self._nodes.discard(node)
        self._leaves.discard(node)
        if node.parent is not None and not node.parent.children:
            self._leaves.add(node.parent)


# ---------------------------------------------------- block wire ops
# Block export/install for KV migration (``serve/migrate.py`` carries the
# wire) and the host tier. JAX jits these as pool maintenance; here they
# are plain tensor ops on the pool's device, queued on its current
# stream. ``caches`` is the pool's list of per-layer dicts and ``idx`` an
# int64 tensor of block indices on the pool's device. The wire layout is
# the pool's own (``[n, H, bs, D]`` int8 plus ``[n, H]`` fp32 scales), so
# a gathered block is the same bytes with no transpose.
_WIRE_KEYS = ("k", "v", "k_scale", "v_scale")


def _gather_blocks_quantized(caches, idx):
    """int8 pool -> wire: the blocks and their scale rows, verbatim (a
    migrated block lands on the destination bit-identical)."""
    return [{k: layer[k].index_select(0, idx) for k in _WIRE_KEYS}
            for layer in caches]


def _gather_quantize_blocks(caches, idx):
    """bf16/f32 pool -> wire: the blocks quantized to int8 with one fp32
    scale per (block, head) (``ops/quant.py``; lossy at amax/254 a
    block)."""
    out = []
    for layer in caches:
        entry = {}
        for kv in ("k", "v"):
            q, sc = quantize_kv_block(layer[kv].index_select(0, idx))
            entry[kv] = q
            entry[f"{kv}_scale"] = sc
        out.append(entry)
    return out


def _scatter_blocks_quantized(caches, idx, payload) -> None:
    """Wire -> int8 pool, IN PLACE: int8 blocks and scale rows written
    verbatim at the fresh (ref == 1) indices."""
    for layer, pay in zip(caches, payload):
        for k in _WIRE_KEYS:
            layer[k].index_copy_(0, idx, pay[k].to(layer[k].dtype))


def _scatter_blocks_dequant(caches, idx, payload) -> None:
    """Wire -> bf16/f32 pool, IN PLACE: the int8 blocks dequantized to
    the pool dtype and written at the fresh indices."""
    for layer, pay in zip(caches, payload):
        for kv in ("k", "v"):
            layer[kv].index_copy_(0, idx, dequantize_kv_block(
                pay[kv], pay[f"{kv}_scale"], layer[kv].dtype))


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` without a host sync: on a card the copy
    goes through pinned memory and is queued on the current stream."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _block_index(blocks, device) -> torch.Tensor:
    """Block ids -> an int64 index tensor on ``device`` (no host sync)."""
    return _to_device(torch.tensor([int(b) for b in blocks],
                                   dtype=torch.long), device)


def _host_layers(layers) -> List[Dict[str, np.ndarray]]:
    """Per-layer wire tensors -> numpy host arrays (a device-to-host copy
    that waits for the device)."""
    return [{k: v.cpu().numpy() for k, v in layer.items()}
            for layer in layers]


class _HostEntry(list):
    """One demoted block: per-layer ``{"k", "v", "k_scale", "v_scale"}``
    host arrays shaped ``[1, H, bs, D]`` / ``[1, H]``. On a card the
    arrays are views of row ``slot`` of the pool's pinned arena, filled
    by an asynchronous copy that ``ready`` (a CUDA event) marks; any host
    read of them goes through :meth:`wait` first. On the CPU they are
    plain arrays and ``ready`` is None."""

    def __init__(self, layers, slot: Optional[int] = None, ready=None):
        super().__init__(layers)
        self.slot = slot
        self.ready = ready

    def wait(self) -> "_HostEntry":
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        return self


class _PinnedArena:
    """The host tier's pinned memory on a card, allocated once: per wire
    key one ``[rows, num_layers, ...]`` tensor, a row an entry, so a
    demotion is one copy a key and an entry's layers are views of one
    row. ``rows`` is the tier's budget plus one request's worth of blocks:
    a promotion holds the rows of the entries it moves until their
    uploads are queued, while its own allocations may demote others."""

    def __init__(self, rows: int, num_layers: int, heads: int,
                 block_size: int, d: int):
        self.keys = {
            "k": torch.empty((rows, num_layers, heads, block_size, d),
                             dtype=torch.int8, pin_memory=True),
            "v": torch.empty((rows, num_layers, heads, block_size, d),
                             dtype=torch.int8, pin_memory=True),
            "k_scale": torch.empty((rows, num_layers, heads),
                                   dtype=torch.float32, pin_memory=True),
            "v_scale": torch.empty((rows, num_layers, heads),
                                   dtype=torch.float32, pin_memory=True)}
        self.num_layers = num_layers
        self._free = list(range(rows - 1, -1, -1))

    def take(self) -> int:
        return self._free.pop()

    def give(self, row: int) -> None:
        self._free.append(row)

    def layers(self, row: int) -> List[Dict[str, np.ndarray]]:
        """Row ``row`` as per-layer numpy views ``[1, ...]``."""
        views = {k: t[row].numpy() for k, t in self.keys.items()}
        return [{k: v[li][None] for k, v in views.items()}
                for li in range(self.num_layers)]


class PagedSlotPool:
    """Ref-counted KV blocks + per-slot block tables, pools on ``device``.

    ``model_cfg`` supplies ``num_layers``, ``num_heads`` and
    ``hidden_size``; ``dtype`` is the pool storage dtype (bf16 by
    default), unless ``quantized``: then the pools are int8 with
    zero-initialised fp32 scales (0 * 0 dequantizes to exact zeros, as a
    zeroed float pool does). ``bytes_per_block`` is one block's device
    footprint over all layers: K and V, plus their scales.

    ``host_blocks`` > 0 (int8 pools with the prefix cache only) keeps a
    host tier: a trie block that LRU eviction drops is DEMOTED first, its
    int8 payload and scales copied into a host LRU of up to
    ``host_blocks`` entries keyed by the block's full prompt-prefix token
    path, and :meth:`bind_for_prompt` PROMOTES consecutively host-cached
    blocks past a device match back into fresh blocks. On a card the tier
    lives in one pinned arena allocated here; the copies are queued on the
    pool device's current stream, so a promoted block's upload precedes
    the prefill that reads it without a host sync.

    The block wire (:meth:`export_block_payload`,
    :meth:`export_prefix_payload`, :meth:`install_block_payload`) moves
    blocks in the int8+scales layout ``serve/migrate.py`` encodes;
    ``fleet_hits`` counts, per request with a hit, the tiers its reused
    blocks came from (``device``, ``host``, or ``peer`` for blocks a peer
    pull installed, on their first reuse)."""

    def __init__(self, model_cfg, capacity: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, eviction: str = "lru",
                 quantized: bool = False, host_blocks: int = 0,
                 device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if eviction not in ("lru", "none"):
            raise ValueError(
                f"eviction must be 'lru' or 'none', got {eviction!r}")
        if host_blocks < 0:
            raise ValueError(
                f"host_blocks must be >= 0, got {host_blocks}")
        if host_blocks and not quantized:
            # Only int8 blocks ARE the wire format (a lossless round
            # trip); a bf16 tier would serve quantize-dequant blocks that
            # differ from a fresh prefill.
            raise ValueError(
                "host_blocks requires a quantized (int8) pool — the "
                "demoted payload is the int8+scales block verbatim")
        if host_blocks and not prefix_cache:
            raise ValueError(
                "host_blocks requires prefix_cache (demotion feeds off "
                "trie eviction; without the trie the tier is inert)")
        self.capacity = capacity
        self.max_len = max_len
        self.dtype = dtype
        self.block_size = block_size
        self.blocks_per_slot = math.ceil(max_len / block_size)
        if num_blocks is None:
            # Dense-equivalent capacity (+1 for scratch).
            num_blocks = 1 + capacity * self.blocks_per_slot
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is "
                             f"scratch), got {num_blocks}")
        self.num_blocks = num_blocks
        self.prefix_cache_enabled = prefix_cache
        self.eviction = eviction
        self.quantized = quantized
        heads = model_cfg.num_heads
        d = model_cfg.hidden_size // heads
        kv_dtype = torch.int8 if quantized else dtype
        self.num_layers = model_cfg.num_layers
        # One block of one layer, every head: the wire's and the host
        # tier's geometry, whatever the device layout.
        self.block_shape = (heads, block_size, d)
        self.caches = [self._alloc_layer(heads, d, kv_dtype, device)
                       for _ in range(model_cfg.num_layers)]
        kv_bytes = heads * block_size * d * kv_dtype.itemsize
        scale_bytes = heads * 4 if quantized else 0
        self.bytes_per_block = 2 * model_cfg.num_layers * (kv_bytes
                                                           + scale_bytes)
        self.tables_host = np.zeros((capacity, self.blocks_per_slot),
                                    np.int32)
        self._free_slots: List[int] = list(range(capacity - 1, -1, -1))
        self._free_blocks: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs = np.zeros((num_blocks,), np.int64)
        self._bound = np.zeros((capacity,), np.int32)
        self.trie = PrefixTrie(block_size)
        self.cow_copies = 0
        self.prefix_hits = 0
        # The host tier: demoted entries, LRU-ordered (oldest first),
        # keyed by the full prompt-prefix token path.
        self.host_blocks = host_blocks
        self._host_tier: "collections.OrderedDict[Tuple[int, ...], _HostEntry]" \
            = collections.OrderedDict()
        self._host_bytes = 0
        self.demotions = 0
        self.promotions = 0
        self.promote_failures = 0
        self._arena = None
        if host_blocks and torch.device(device).type == "cuda":
            self._arena = _PinnedArena(
                host_blocks + self.blocks_per_slot, model_cfg.num_layers,
                heads, block_size, d)
        # Blocks whose content a peer pull installed: their first trie hit
        # counts as a "peer" hit, then they are plain device cache.
        self._peer_blocks: set = set()
        self.fleet_hits = {"device": 0, "host": 0, "peer": 0}
        self.mirror = None

    def _alloc_layer(self, heads: int, d: int, kv_dtype: torch.dtype,
                     device):
        """One layer's device state: ``{"k", "v"}`` pools ``[num_blocks,
        heads, block_size, d]`` (plus the ``[num_blocks, heads]`` scales
        of an int8 pool), zeroed."""
        shape = (self.num_blocks, heads, self.block_size, d)
        layer = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
                 "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
        if self.quantized:
            for name in ("k_scale", "v_scale"):
                layer[name] = torch.zeros((self.num_blocks, heads),
                                          dtype=torch.float32, device=device)
        return layer

    @property
    def wire_device(self) -> torch.device:
        """The device the wire's index tensors and staged payloads live
        on."""
        return self.caches[0]["k"].device

    def _gather_blocks(self, idx: torch.Tensor) -> List[Dict[str,
                                                              torch.Tensor]]:
        """Blocks ``idx`` (on :attr:`wire_device`) -> per-layer wire
        tensors, every head: verbatim from an int8 pool, quantized from a
        float one. A sharded pool overrides it (gather-on-export)."""
        gather = (_gather_blocks_quantized if self.quantized
                  else _gather_quantize_blocks)
        return gather(self.caches, idx)

    def _scatter_blocks(self, idx: torch.Tensor, payload) -> None:
        """Per-layer wire tensors (every head, on :attr:`wire_device`)
        into blocks ``idx``, IN PLACE: verbatim into an int8 pool,
        dequantized into a float one. A sharded pool overrides it
        (scatter-on-install)."""
        scatter = (_scatter_blocks_quantized if self.quantized
                   else _scatter_blocks_dequant)
        scatter(self.caches, idx, payload)

    def layer_states(self) -> List[Tuple[int, dict]]:
        """``(layer index, dict of device tensors)`` for every piece of
        device state: one dict per layer here."""
        return list(enumerate(self.caches))

    # ------------------------------------------------------ slot layer
    def alloc(self) -> Optional[int]:
        """-> a free slot index (holding no blocks), or None."""
        slot = self._free_slots.pop() if self._free_slots else None
        if slot is not None and self.mirror is not None:
            self.mirror.claim(slot)
        return slot

    def claim(self, slot: int) -> None:
        """Take a SPECIFIC free slot (the mirror path). Raises ValueError
        when the slot is not free."""
        self._free_slots.remove(slot)

    def free(self, slot: int) -> None:
        """Release the slot and drop its block references; a mirror frees
        the same slot, and its own blocks, in the same call."""
        if not 0 <= slot < self.capacity:
            raise ValueError(f"slot {slot} out of range [0, {self.capacity})")
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} is already free (double free)")
        self.release_blocks(slot)
        self._free_slots.append(slot)
        if self.mirror is not None:
            self.mirror.free(slot)

    def release_blocks(self, slot: int) -> None:
        """Drop the slot's block references without freeing the slot."""
        for i in range(int(self._bound[slot])):
            self._release(int(self.tables_host[slot, i]))
        self.tables_host[slot, :] = 0
        self._bound[slot] = 0

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def num_active(self) -> int:
        return self.capacity - len(self._free_slots)

    @property
    def occupancy(self) -> float:
        return self.num_active / self.capacity

    # ----------------------------------------------------- block layer
    @property
    def blocks_used(self) -> int:
        return self.num_blocks - 1 - len(self._free_blocks)

    @property
    def bytes_resident(self) -> int:
        """Device bytes the resident blocks hold, K/V plus scales."""
        return self.blocks_used * self.bytes_per_block

    @property
    def trie_only_blocks(self) -> int:
        return sum(1 for b in self.trie.blocks if self._refs[b] == 1)

    def available_blocks(self) -> int:
        """Free blocks plus what eviction could reclaim — the scheduler's
        admission budget."""
        n = len(self._free_blocks)
        if self.eviction == "lru":
            n += self.trie_only_blocks
        return n

    def blocks_for_span(self, end: int) -> int:
        return math.ceil(min(end, self.max_len) / self.block_size)

    @property
    def max_request_blocks(self) -> int:
        return min(self.blocks_per_slot, self.num_blocks - 1)

    def _alloc_block(self, slot: Optional[int]) -> int:
        """Pop a free block, evicting one LRU trie-only block (ref == 1:
        its release frees it) when the list is dry; with a host tier the
        victim is demoted first. Raises :class:`KVBlocksExhausted`; the
        ``serve.kv.bind`` point raises an injected error here, which the
        engine's callers surface as the same exhaustion."""
        faults.point("serve.kv.bind")
        if not self._free_blocks and self.eviction == "lru":
            self.trie.evict(1, self._release,
                            only=lambda b: self._refs[b] == 1,
                            on_evict=(self._demote if self.host_blocks
                                      else None))
        if not self._free_blocks:
            raise KVBlocksExhausted(
                f"no free KV blocks ({self.blocks_used}/"
                f"{self.num_blocks - 1} in use, {len(self.trie)} cached)",
                slot=slot)
        b = self._free_blocks.pop()
        self._refs[b] = 1
        return b

    def _release(self, block: int) -> None:
        if block == 0:
            return
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._free_blocks.append(block)
            # A freed block's peer tag dies with it: the index will hold
            # unrelated content next.
            self._peer_blocks.discard(block)
        elif self._refs[block] < 0:
            raise AssertionError(
                f"block {block} ref count went negative (double release)")

    # ------------------------------------------------------- host tier
    @property
    def host_blocks_used(self) -> int:
        """Demoted blocks resident in the host tier."""
        return len(self._host_tier)

    @property
    def host_bytes_resident(self) -> int:
        """Host bytes the demoted payloads hold (int8 data and fp32 scale
        rows, all layers)."""
        return self._host_bytes

    @staticmethod
    def _entry_bytes(entry) -> int:
        return sum(a.nbytes for layer in entry for a in layer.values())

    def _drop_host(self, key: Tuple[int, ...]) -> Optional[_HostEntry]:
        """Take ``key``'s entry out of the tier, its bytes and arena row
        released. -> the entry, or None."""
        entry = self._host_tier.pop(key, None)
        if entry is not None:
            self._host_bytes -= self._entry_bytes(entry)
            if entry.slot is not None:
                self._arena.give(entry.slot)
        return entry

    def _make_room(self, key: Tuple[int, ...]) -> None:
        """Drop ``key``'s old entry and the oldest entries (for good:
        there is no colder tier) until one more fits the cap."""
        self._drop_host(key)
        while len(self._host_tier) >= self.host_blocks:
            self._drop_host(next(iter(self._host_tier)))

    def _host_put(self, key: Tuple[int, ...], entry: _HostEntry) -> None:
        """Insert one entry at the tier's MRU end with the byte books
        adjusted and the LRU cap applied: the one place the accounting
        that :meth:`leak_check`'s host column audits is kept (demotion
        and the failed-promote restore both come here). The cap is
        applied before the insert, so the arena never holds more rows
        than it allows."""
        self._make_room(key)
        self._host_tier[key] = entry
        self._host_bytes += self._entry_bytes(entry)

    def _demote(self, path_tokens: Tuple[int, ...], block: int) -> None:
        """The trie-eviction hook: copy ``block``'s int8 payload and
        scales into the host tier before the block returns to the free
        list. On a card the gather and the device-to-host copy into an
        arena row are queued on the current stream, ahead of any later
        write to the block, and an event marks the copy's end; on the
        CPU the copy is immediate."""
        idx = _block_index([block], self.wire_device)
        if self._arena is None:
            entry = _HostEntry(_host_layers(self._gather_blocks(idx)))
        else:
            # Room first: a dropped entry gives its arena row back. A key
            # of every layer is one gathered stack, then one copy.
            self._make_room(tuple(path_tokens))
            row = self._arena.take()
            gathered = self._gather_blocks(idx)
            for k, t in self._arena.keys.items():
                t[row].copy_(torch.cat([g[k] for g in gathered]),
                             non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            entry = _HostEntry(self._arena.layers(row), row, ready)
        self._host_put(tuple(path_tokens), entry)
        self.demotions += 1
        obs.counter("serve.kv.demotions_total").inc()

    def _promote(self, slot: int, tokens: List[int],
                 start_blocks: int) -> int:
        """Extend a device trie match through the host tier: promote the
        longest run of consecutively host-cached blocks past the
        ``start_blocks`` device-matched ones into fresh blocks, scatter
        their payload in, index them in the trie and bind them to
        ``slot``. The block holding position ``n - 1`` is never promoted:
        the last prompt token always re-runs, so that block would be
        copied on write at once, one allocation past what admission
        budgeted. The move is exclusive (entries leave the tier before
        the allocations, so a demotion those trigger cannot drop them).
        If the pool cannot hold the span, the allocations are released,
        the entries restored through :meth:`_host_put` (which re-applies
        the cap) and the request prefills cold: ``promote_failures``
        counts it, as it does an injected ``serve.kv.promote`` error (the
        entries then stay in the tier). -> blocks promoted."""
        bs = self.block_size
        limit = min((len(tokens) - 1) // bs, self.blocks_per_slot)
        keys: List[Tuple[int, ...]] = []
        entries: List[_HostEntry] = []
        bi = start_blocks
        while bi < limit:
            key = tuple(tokens[:(bi + 1) * bs])
            entry = self._host_tier.get(key)
            if entry is None:
                break
            keys.append(key)
            entries.append(entry)
            bi += 1
        if not entries:
            return 0
        with obs.span("serve.kv.promote_s", blocks=len(entries)):
            try:
                faults.point("serve.kv.promote")
            except faults.InjectedFault:
                self.promote_failures += 1
                return 0
            return self._promote_entries(slot, tokens, start_blocks, keys,
                                         entries)

    def _promote_entries(self, slot: int, tokens: List[int],
                         start_blocks: int, keys, entries) -> int:
        """The move of :meth:`_promote` once the entries are chosen."""
        bs = self.block_size
        bi = start_blocks + len(entries)
        for key, entry in zip(keys, entries):
            self._host_tier.pop(key)
            self._host_bytes -= self._entry_bytes(entry)
        blocks: List[int] = []
        try:
            for _ in entries:
                blocks.append(self._alloc_block(slot))
        except KVBlocksExhausted:
            for b in blocks:
                self._release(b)
            for key, entry in zip(keys, entries):
                self._host_put(key, entry)
            self.promote_failures += 1
            return 0
        # One upload and one index_copy_ a pool leaf for the whole span
        # (JAX scatters in power-of-two runs only to bound its compiled
        # programs; eager ops need no such bound). Queued on the current
        # stream before the prefill chunks that read the blocks.
        dev = self.wire_device
        idx = _block_index(blocks, dev)
        if self._arena is None:
            payload = [{k: torch.from_numpy(np.concatenate(
                            [e[li][k] for e in entries]))
                        for k in _WIRE_KEYS}
                       for li in range(self.num_layers)]
        else:
            stacked = {}
            for k, t in self._arena.keys.items():
                buf = torch.empty((len(entries),) + tuple(t.shape[1:]),
                                  dtype=t.dtype, device=dev)
                for i, e in enumerate(entries):
                    buf[i].copy_(t[e.slot], non_blocking=True)
                stacked[k] = buf
            payload = [{k: stacked[k][:, li] for k in _WIRE_KEYS}
                       for li in range(self.num_layers)]
            # The uploads are queued ahead of any later copy into these
            # rows, on the same stream: the rows are free to reuse.
            for e in entries:
                self._arena.give(e.slot)
        self._scatter_blocks(idx, payload)

        def take_ref(block: int) -> None:
            self._refs[block] += 1

        # Re-index under the trie, bind the span to the slot, drop the
        # allocation refs: each promoted block ends at ref 2 (trie and
        # slot), as a device prefix hit's does.
        path = ([int(b) for b in self.tables_host[slot, :start_blocks]]
                + blocks)
        self.trie.insert(tokens[:bi * bs], path, take_ref)
        for i, b in enumerate(blocks):
            self._refs[b] += 1
            self.tables_host[slot, start_blocks + i] = b
        self._bound[slot] = start_blocks + len(blocks)
        for b in blocks:
            self._release(b)
        self.promotions += len(blocks)
        obs.counter("serve.kv.promotions_total").inc(len(blocks))
        return len(blocks)

    def clear_host_tier(self) -> int:
        """Drop every demoted entry. -> entries dropped."""
        n = len(self._host_tier)
        for key in list(self._host_tier):
            self._drop_host(key)
        return n

    # -------------------------------------------------- prompt binding
    def bind_for_prompt(self, slot: int, tokens: Sequence[int]) -> int:
        """Match the prompt's full-block prefix against the trie and take
        references on the cached blocks; with a host tier, extend the
        match through host-demoted blocks (:meth:`_promote`). ->
        ``shared_len``: leading positions the slot now holds,
        block-aligned but capped at ``len(tokens) - 1`` so the last
        prompt token always re-runs (its logits seed decoding). The cap
        can put the first write inside the last shared block;
        :meth:`prepare_write` copies it then. Each request with a hit
        counts once in ``fleet_hits`` for each tier it reused."""
        if self._bound[slot]:
            raise ValueError(f"slot {slot} already holds blocks")
        toks = [int(t) for t in tokens]
        shared: List[int] = []
        if self.prefix_cache_enabled:
            shared = self.trie.match(toks)
        for i, b in enumerate(shared):
            self._refs[b] += 1
            self.tables_host[slot, i] = b
        self._bound[slot] = len(shared)
        nshared = len(shared)
        promoted = 0
        if self.host_blocks and self.prefix_cache_enabled:
            promoted = self._promote(slot, toks, nshared)
            nshared += promoted
        if nshared:
            tiers = []
            pulled = self._peer_blocks.intersection(shared)
            if pulled:
                self._peer_blocks.difference_update(pulled)
                tiers.append("peer")
            if len(pulled) < len(shared):
                tiers.append("device")
            if promoted:
                tiers.append("host")
            for t in tiers:
                self.fleet_hits[t] += 1
                obs.counter(f"serve.kv.fleet_hits_{t}_total").inc()
            obs.counter("serve.kv.fleet_hits_total").inc()
        return min(nshared * self.block_size, len(toks) - 1)

    def count_prefix_hit(self) -> None:
        self.prefix_hits += 1
        obs.counter("serve.kv.prefix_hits_total").inc()

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Post-prefill: index the prompt's full blocks in the trie, which
        takes its own reference per new node. -> nodes inserted."""
        if not self.prefix_cache_enabled:
            return 0
        nfull = len(tokens) // self.block_size
        if nfull == 0 or self._bound[slot] < nfull:
            return 0

        def take_ref(block: int) -> None:
            self._refs[block] += 1

        return self.trie.insert(
            list(tokens)[:nfull * self.block_size],
            [int(b) for b in self.tables_host[slot, :nfull]], take_ref)

    # ------------------------------------------------------ write path
    def _copy_block(self, src: int, dst: int) -> None:
        """The copy-on-write move, in place across every layer's K and V
        (and their scale rows)."""
        for _, layer in self.layer_states():
            for pool in layer.values():
                pool[dst].copy_(pool[src])

    def prepare_write(self, slot: int, start: int, end: int) -> None:
        """Make positions ``[start, end)`` of ``slot`` writable: bind fresh
        blocks past the bound frontier and copy any block in the span
        whose ref count exceeds 1. Raises :class:`KVBlocksExhausted`."""
        bs = self.block_size
        end = min(end, self.blocks_per_slot * bs)
        first = min(start // bs, int(self._bound[slot]))
        last = math.ceil(end / bs)
        for bi in range(first, last):
            if bi < self._bound[slot]:
                b = int(self.tables_host[slot, bi])
                if self._refs[b] > 1:
                    nb = self._alloc_block(slot)
                    self._copy_block(b, nb)
                    self.tables_host[slot, bi] = nb
                    self._release(b)
                    self.cow_copies += 1
                    obs.counter("serve.kv.cow_copies_total").inc()
            else:
                if bi != self._bound[slot]:
                    raise AssertionError(
                        f"non-contiguous bind: slot {slot} bound "
                        f"{int(self._bound[slot])} blocks, write wants "
                        f"block {bi}")
                self.tables_host[slot, bi] = self._alloc_block(slot)
                self._bound[slot] = bi + 1

    # ------------------------------------------------------- migration
    def digest_entries(self):
        """Yield ``(path_tokens, tier)`` for every cached prefix this
        pool could serve: device trie paths first (hottest first, by LRU
        tick), then host-tier keys (newest first), the recency order the
        fleet digest truncates against. Host bookkeeping only; callers
        hold the scheduler's lock."""
        if self.prefix_cache_enabled:
            for node in sorted(self.trie._nodes,
                               key=lambda n: n.tick, reverse=True):
                yield self.trie._path_tokens(node), "device"
        for key in reversed(self._host_tier):
            yield key, "host"

    def _gather_wire(self, blocks: Sequence[int]):
        """Device blocks -> per-layer wire host arrays: verbatim from an
        int8 pool, quantized from a float one."""
        return _host_layers(self._gather_blocks(
            _block_index(blocks, self.wire_device)))

    def export_block_payload(self, slot: int, nblocks: int
                             ) -> Tuple[List[Dict[str, np.ndarray]], int]:
        """The first ``nblocks`` bound blocks of ``slot`` in the
        int8+scales wire layout: -> (per-layer ``{"k", "v", "k_scale",
        "v_scale"}`` numpy arrays ``[n, H, bs, D]`` / ``[n, H]``, payload
        bytes). int8 pools export verbatim, float pools quantize on the
        device first. Read-only: the slot's references stay (releasing
        them is the ACK's job)."""
        if not 1 <= nblocks <= int(self._bound[slot]):
            raise ValueError(
                f"cannot export {nblocks} block(s) from slot {slot}: "
                f"{int(self._bound[slot])} bound")
        host = self._gather_wire(self.tables_host[slot, :nblocks])
        nbytes = sum(a.nbytes for layer in host for a in layer.values())
        return host, nbytes

    def export_prefix_payload(self, tokens: Sequence[int]
                              ) -> Tuple[List[int],
                                         List[Dict[str, np.ndarray]], int]:
        """Peer-pull export: the longest cached full-block prefix of
        ``tokens`` this pool holds (the device trie match, extended
        through consecutively host-cached blocks) in the wire layout,
        touching no slot. -> ``(covered tokens, per-layer wire arrays,
        payload bytes)``; no coverage is ``([], [], 0)``. Read-only:
        refs, trie and host tier stay as they are."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        blocks: List[int] = []
        if self.prefix_cache_enabled:
            blocks = self.trie.match(toks)
        host_entries: List[_HostEntry] = []
        bi = len(blocks)
        while (bi + 1) * bs <= len(toks):
            entry = self._host_tier.get(tuple(toks[:(bi + 1) * bs]))
            if entry is None:
                break
            host_entries.append(entry.wait())
            bi += 1
        nblocks = len(blocks) + len(host_entries)
        if nblocks == 0:
            return [], [], 0
        parts = [self._gather_wire(blocks)] if blocks else []
        parts += host_entries
        host = [{k: np.concatenate([p[li][k] for p in parts], axis=0)
                 for k in _WIRE_KEYS}
                for li in range(self.num_layers)]
        nbytes = sum(a.nbytes for layer in host for a in layer.values())
        return toks[:nblocks * bs], host, nbytes

    def install_block_payload(self, tokens: Sequence[int],
                              layers: List[Dict[str, np.ndarray]],
                              origin: str = "migrate") -> int:
        """Install a wire payload into the PREFIX CACHE: fresh blocks (ref
        == 1, owned by nobody), the payload scattered in (verbatim into
        an int8 pool, dequantized into a float one), and the blocks
        indexed in the trie under ``tokens``' full-block prefix. A request
        then binds them through :meth:`bind_for_prompt` like any prefix
        hit. -> blocks newly referenced by the trie (0 when the prefix was
        cached already, the payload is empty or the prefix cache is off).
        Raises :class:`KVBlocksExhausted` (nothing leaked) when the pool
        cannot hold the span, and ``ValueError`` for a payload whose
        geometry differs from this pool's. ``origin="peer"`` tags the new
        blocks so that their first reuse counts as a peer hit."""
        nblocks = int(layers[0]["k"].shape[0]) if layers else 0
        if nblocks == 0 or not self.prefix_cache_enabled:
            return 0
        bs = self.block_size
        if len(tokens) < nblocks * bs:
            raise ValueError(
                f"payload carries {nblocks} block(s) but only "
                f"{len(tokens)} token(s) key them "
                f"(block_size {bs})")
        shape = self.block_shape
        got = tuple(layers[0]["k"].shape[1:])
        if len(layers) != self.num_layers or got != shape:
            raise ValueError(
                f"payload geometry mismatch: {len(layers)} layer(s) of "
                f"blocks shaped {got}, pool has {self.num_layers} "
                f"layer(s) shaped {shape}")
        blocks: List[int] = []
        try:
            for _ in range(nblocks):
                blocks.append(self._alloc_block(None))
        except KVBlocksExhausted:
            for b in blocks:
                self._release(b)
            raise
        dev = self.wire_device
        idx = _block_index(blocks, dev)
        payload = [{k: torch.from_numpy(np.array(v)).to(dev)
                    for k, v in layer.items()} for layer in layers]
        self._scatter_blocks(idx, payload)
        new_blocks: List[int] = []

        def take_ref(block: int) -> None:
            self._refs[block] += 1
            new_blocks.append(block)

        inserted = self.trie.insert(
            [int(t) for t in tokens][:nblocks * bs], blocks, take_ref)
        if origin == "peer":
            self._peer_blocks.update(new_blocks)
        # Drop the allocation refs: blocks the trie took stay cached at
        # ref 1; blocks it already had under the same path are freed
        # (first writer won).
        for b in blocks:
            self._release(b)
        return inserted

    # ------------------------------------------------------- accounting
    def clear_prefix_cache(self) -> int:
        return self.trie.clear(self._release)

    def leak_check(self) -> None:
        """Assert the ref-count books balance: every non-free block is
        explained by slot bindings plus trie nodes, and free plus held
        blocks cover the pool. An int8 pool must also still hold int8
        pools and both ``[num_blocks, H]`` scale buffers in every layer:
        a block and its scales share one index, which is what makes
        copy-on-write and freeing carry the scales. A mirror's free slots
        must agree with this pool's, and its books balance too."""
        if self.quantized:
            for li, layer in self.layer_states():
                for kv in ("k", "v"):
                    if layer[kv].dtype != torch.int8:
                        raise AssertionError(
                            f"layer {li} {kv} pool dtype drifted to "
                            f"{layer[kv].dtype} (expected int8)")
                    sc = layer.get(f"{kv}_scale")
                    want = (self.num_blocks, layer[kv].shape[1])
                    if sc is None or tuple(sc.shape) != want:
                        raise AssertionError(
                            f"layer {li} {kv}_scale buffer missing or "
                            f"mis-shaped: "
                            f"{None if sc is None else tuple(sc.shape)} "
                            f"(expected {want})")
        self._check_host_tier()
        expect = np.zeros((self.num_blocks,), np.int64)
        for slot in range(self.capacity):
            if slot in self._free_slots:
                continue
            for i in range(int(self._bound[slot])):
                expect[self.tables_host[slot, i]] += 1
        for b in self.trie.blocks:
            expect[b] += 1
        expect[0] = 0
        if not np.array_equal(expect, self._refs):
            bad = np.flatnonzero(expect != self._refs)
            raise AssertionError(
                f"KV block ref-count leak at blocks {bad.tolist()}: "
                f"expected {expect[bad].tolist()}, "
                f"recorded {self._refs[bad].tolist()}")
        # Peer tags may only name held blocks: a tag on a freed block
        # would count an unrelated binding as a peer hit.
        untagged = [b for b in self._peer_blocks if self._refs[b] <= 0]
        if untagged:
            raise AssertionError(
                f"peer tier tags leaked past release: blocks "
                f"{sorted(untagged)} are tagged but free")
        n_free = len(self._free_blocks)
        n_held = int(np.count_nonzero(self._refs))
        if n_free + n_held != self.num_blocks - 1:
            raise AssertionError(
                f"KV block leak: {n_free} free + {n_held} held != "
                f"{self.num_blocks - 1} allocatable")
        _check_mirror(self, self._free_slots)

    def _check_host_tier(self) -> None:
        """The host column of :meth:`leak_check`: entries within the
        budget, byte books balanced, each entry shaped as this pool's
        blocks and keyed by a whole number of blocks, and on a card every
        entry on its own arena row."""
        if not (self.host_blocks or self._host_tier):
            return
        if len(self._host_tier) > self.host_blocks:
            raise AssertionError(
                f"host tier holds {len(self._host_tier)} entries, "
                f"budget {self.host_blocks} — the LRU cap leaked")
        nbytes = sum(self._entry_bytes(e) for e in self._host_tier.values())
        if nbytes != self._host_bytes:
            raise AssertionError(
                f"host tier byte books off: {self._host_bytes} "
                f"recorded, {nbytes} resident")
        shape = self.block_shape
        for key, entry in self._host_tier.items():
            if len(key) % self.block_size or \
                    len(key) // self.block_size == 0:
                raise AssertionError(
                    f"host tier key length {len(key)} is not a "
                    f"whole number of blocks (bs {self.block_size})")
            if (len(entry) != self.num_layers
                    or tuple(entry[0]["k"].shape) != (1,) + shape):
                raise AssertionError(
                    f"host tier entry geometry drifted: "
                    f"{len(entry)} layer(s) shaped "
                    f"{tuple(entry[0]['k'].shape)}, pool has "
                    f"{self.num_layers} layer(s) of [1, "
                    f"{', '.join(str(x) for x in shape)}] blocks")
        if self._arena is not None:
            rows = [e.slot for e in self._host_tier.values()]
            free = self._arena._free
            if (len(set(rows)) != len(rows) or set(rows) & set(free)
                    or len(rows) + len(free) != len(
                        self._arena.keys["k"])):
                raise AssertionError(
                    f"host arena rows drifted: {len(rows)} held, "
                    f"{len(free)} free of {len(self._arena.keys['k'])}")
