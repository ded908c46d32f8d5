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
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


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

    def evict(self, want: int, release, only=None) -> int:
        """Drop up to ``want`` cached blocks, leaf-first and LRU-first;
        ``only(block)`` filters candidates (the pool passes "ref count is
        exactly 1", so an eviction always frees a block). -> evicted."""
        evicted = 0
        while evicted < want:
            leaves = [n for n in self._leaves
                      if only is None or only(n.block)]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.tick)
            self._remove(victim)
            release(victim.block)
            evicted += 1
        return evicted

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


class PagedSlotPool:
    """Ref-counted KV blocks + per-slot block tables, pools on ``device``.

    ``model_cfg`` supplies ``num_layers``, ``num_heads`` and
    ``hidden_size``; ``dtype`` is the pool storage dtype (bf16 by
    default), unless ``quantized``: then the pools are int8 with
    zero-initialised fp32 scales (0 * 0 dequantizes to exact zeros, as a
    zeroed float pool does). ``bytes_per_block`` is one block's device
    footprint over all layers: K and V, plus their scales."""

    def __init__(self, model_cfg, capacity: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, eviction: str = "lru",
                 quantized: bool = False, device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if eviction not in ("lru", "none"):
            raise ValueError(
                f"eviction must be 'lru' or 'none', got {eviction!r}")
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
        if not self._free_blocks and self.eviction == "lru":
            self.trie.evict(1, self._release,
                            only=lambda b: self._refs[b] == 1)
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
        elif self._refs[block] < 0:
            raise AssertionError(
                f"block {block} ref count went negative (double release)")

    # -------------------------------------------------- prompt binding
    def bind_for_prompt(self, slot: int, tokens: Sequence[int]) -> int:
        """Match the prompt's full-block prefix against the trie and take
        references on the cached blocks. -> ``shared_len``: leading
        positions the slot now holds, block-aligned but capped at
        ``len(tokens) - 1`` so the last prompt token always re-runs (its
        logits seed decoding). The cap can put the first write inside the
        last shared block; :meth:`prepare_write` copies it then."""
        if self._bound[slot]:
            raise ValueError(f"slot {slot} already holds blocks")
        shared: List[int] = []
        if self.prefix_cache_enabled:
            shared = self.trie.match([int(t) for t in tokens])
        for i, b in enumerate(shared):
            self._refs[b] += 1
            self.tables_host[slot, i] = b
        self._bound[slot] = len(shared)
        return min(len(shared) * self.block_size, len(tokens) - 1)

    def count_prefix_hit(self) -> None:
        self.prefix_hits += 1

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
            else:
                if bi != self._bound[slot]:
                    raise AssertionError(
                        f"non-contiguous bind: slot {slot} bound "
                        f"{int(self._bound[slot])} blocks, write wants "
                        f"block {bi}")
                self.tables_host[slot, bi] = self._alloc_block(slot)
                self._bound[slot] = bi + 1

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
        n_free = len(self._free_blocks)
        n_held = int(np.count_nonzero(self._refs))
        if n_free + n_held != self.num_blocks - 1:
            raise AssertionError(
                f"KV block leak: {n_free} free + {n_held} held != "
                f"{self.num_blocks - 1} allocatable")
        _check_mirror(self, self._free_slots)
