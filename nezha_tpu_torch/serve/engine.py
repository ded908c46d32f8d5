"""The continuous-batching engine on the paged KV pool (counterpart of
``ServeConfig`` and ``Engine`` in ``nezha_tpu/serve/engine.py``).

The engine knows slots, not requests. ``prefill(slot, tokens, ...)``
loads one request (however many chunks that takes) and ``step(active)``
decodes one block of up to ``decode_horizon`` tokens for every row:

- **prefill** pads each prompt chunk to a static bucket width (powers of
  two up to ``max_prefill_len``, then any ``long_prefill_buckets``);
  longer prompts run as a greedy largest-fit plan of chunks at advancing
  offsets (:meth:`Engine._plan_chunks`), through the model's paged
  prefill path (the flash-prefill kernel). A prompt's full-block prefix
  is first matched against the prefix cache: matched blocks are
  referenced, not recomputed, and only the suffix prefills. The last
  REAL row's logits seed decoding.
- **step** runs ``decode_horizon`` single-token steps as a Python loop,
  all on the device: per-row sampling from the carried logits, the
  forward at per-row positions (the flash-decode kernel), and the per-row
  EOS / budget / health masks that stop a row's sampling and K/V writes
  the moment it finishes — the host sees the ``[B, H]`` token block and
  per-row emitted counts once per dispatch.

With ``kv_dtype="int8"`` the pool stores int8 K/V with one fp32 scale per
(block, head): prefill chunks run the int8 prefill kernel (attention plus
the chunk's block write) and decode steps requantize each row's current
block and run the int8 decode kernel. Each prefill chunk's largest
dequant error (the max over layers) is appended to
:attr:`Engine.quant_errors`.

Blocks are bound and copied-on-write on the host BEFORE each dispatch, so
in-program writes land only in blocks the row owns, with non-emitting
rows routed to the scratch block. JAX compiles one program per bucket;
PyTorch runs eagerly, so there is no program set to freeze here (CUDA
graphs are later work). Token ids are validated by the scheduler, not
here.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                      paged_prefill_attention,
                                      paged_prefill_qoff_attention,
                                      paged_quant_decode_attention,
                                      paged_quant_prefill_attention)
from nezha_tpu_torch.serve.sampling import finite_rows, split_and_sample
from nezha_tpu_torch.serve.slots import KVBlocksExhausted, PagedSlotPool


def default_prefill_buckets(max_prefill_len: int) -> Tuple[int, ...]:
    """Powers of two from 8 up to (and ending exactly at)
    ``max_prefill_len`` — e.g. 32 -> (8, 16, 32), 24 -> (8, 16, 24)."""
    buckets: List[int] = []
    b = 8
    while b < max_prefill_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_prefill_len)
    return tuple(buckets)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving shapes and the paged pool's settings.

    ``max_batch_size`` is the slot count, ``max_len`` the per-slot KV
    capacity (prompt + generated), ``max_prefill_len`` the widest prefill
    chunk, ``prefill_buckets`` the chunk pad widths (``()``: powers of
    two, ending at ``max_prefill_len``), ``k_max`` the top-k cap,
    ``queue_capacity`` the scheduler's bound, ``pad_id`` the token fed to
    non-emitting rows, ``cache_dtype`` the pool dtype, ``decode_horizon``
    the tokens per step dispatch. ``kv_block_size``, ``kv_num_blocks``
    (None: dense-equivalent), ``prefix_cache`` and ``kv_eviction``
    ("lru" | "none") configure the paged pool; ``kv_dtype`` "bf16" keeps
    K/V in ``cache_dtype``, "int8" stores int8 blocks with one fp32
    scale per (block, head): about twice the resident blocks in the same
    device memory, at a dequant error of at most amax/254 per block.

    ``long_prefill_buckets`` are extra chunk widths above
    ``max_prefill_len`` (strictly increasing, at most ``max_len``): a long
    prompt prefills in a few wide chunks instead of many
    ``max_prefill_len`` strides; ``()`` keeps the classic plan.
    ``prefill_mode`` "sequence" spreads each prefill chunk's attention
    over the mesh of a :class:`~nezha_tpu_torch.serve.sharded.
    ShardedEngine` (the single-device engine refuses it), in the layout
    ``seq_prefill_variant`` names: "ulysses", "ring" or "auto" (ulysses).

    The remaining fields exist to refuse, typed (:class:`NotPortedError`),
    the settings of the JAX engine this port does not serve yet."""

    max_batch_size: int = 4
    max_len: int = 128
    max_prefill_len: int = 32
    prefill_buckets: Tuple[int, ...] = ()
    k_max: int = 64
    queue_capacity: int = 16
    pad_id: int = 0
    cache_dtype: torch.dtype = torch.bfloat16
    decode_horizon: int = 1
    kv_block_size: int = 16
    kv_num_blocks: Optional[int] = None
    prefix_cache: bool = True
    kv_eviction: str = "lru"
    kv_dtype: str = "bf16"
    prefill_mode: str = "replicated"
    long_prefill_buckets: Tuple[int, ...] = ()
    seq_prefill_variant: str = "auto"
    # Not ported: each must keep its default.
    kv_layout: str = "paged"
    kv_host_blocks: int = 0
    speculative: Optional[Any] = None
    priority_weights: Optional[Any] = None
    tenant_queue_cap: Optional[int] = None
    preemption: bool = False

    def __post_init__(self):
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                             f"{self.kv_dtype!r}")
        if self.kv_dtype == "int8" and self.kv_layout != "paged":
            raise ValueError("kv_dtype='int8' requires kv_layout='paged' "
                             "(scales are per-block state)")
        refusals = (
            ("kv_layout", self.kv_layout != "paged",
             "only the paged layout is ported"),
            ("kv_host_blocks", self.kv_host_blocks != 0,
             "the host KV tier is not ported"),
            ("speculative", self.speculative is not None,
             "speculative decoding is not ported"),
            ("priority_weights", self.priority_weights is not None,
             "priority lanes are not ported"),
            ("tenant_queue_cap", self.tenant_queue_cap is not None,
             "tenant queue caps are not ported"),
            ("preemption", bool(self.preemption),
             "preemption is not ported"),
        )
        for name, refused, why in refusals:
            if refused:
                raise NotPortedError(
                    f"ServeConfig.{name}={getattr(self, name)!r}: {why}")
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.kv_block_size < 1:
            raise ValueError(
                f"kv_block_size must be >= 1, got {self.kv_block_size}")
        if self.kv_num_blocks is not None and self.kv_num_blocks < 2:
            raise ValueError(f"kv_num_blocks must be >= 2 (block 0 is "
                             f"scratch), got {self.kv_num_blocks}")
        if self.kv_eviction not in ("lru", "none"):
            raise ValueError(f"kv_eviction must be 'lru' or 'none', got "
                             f"{self.kv_eviction!r}")
        if self.decode_horizon < 1:
            raise ValueError(
                f"decode_horizon must be >= 1, got {self.decode_horizon}")
        if not 1 <= self.max_prefill_len <= self.max_len:
            raise ValueError(f"need 1 <= max_prefill_len <= max_len, got "
                             f"{self.max_prefill_len} / {self.max_len}")
        if self.k_max < 1:
            raise ValueError("k_max must be >= 1")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if self.cache_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"cache_dtype must be bf16 or f32, got "
                             f"{self.cache_dtype}")
        buckets = tuple(self.prefill_buckets) or default_prefill_buckets(
            self.max_prefill_len)
        if list(buckets) != sorted(set(buckets)):
            raise ValueError(f"prefill_buckets must be strictly "
                             f"increasing, got {buckets}")
        if buckets[0] < 1 or buckets[-1] != self.max_prefill_len:
            raise ValueError(
                f"prefill_buckets must be >= 1 and end exactly at "
                f"max_prefill_len={self.max_prefill_len}, got {buckets}")
        object.__setattr__(self, "prefill_buckets", buckets)
        if self.prefill_mode not in ("replicated", "sequence"):
            raise ValueError(f"prefill_mode must be 'replicated' or "
                             f"'sequence', got {self.prefill_mode!r}")
        if self.seq_prefill_variant not in ("auto", "ulysses", "ring"):
            raise ValueError(f"seq_prefill_variant must be 'auto', "
                             f"'ulysses', or 'ring', got "
                             f"{self.seq_prefill_variant!r}")
        lb = tuple(self.long_prefill_buckets)
        if lb:
            if list(lb) != sorted(set(lb)):
                raise ValueError(f"long_prefill_buckets must be strictly "
                                 f"increasing, got {lb}")
            if lb[0] <= self.max_prefill_len or lb[-1] > self.max_len:
                raise ValueError(
                    f"long_prefill_buckets must lie in (max_prefill_len="
                    f"{self.max_prefill_len}, max_len={self.max_len}], got "
                    f"{lb}")
        object.__setattr__(self, "long_prefill_buckets", lb)

    @property
    def all_prefill_buckets(self) -> Tuple[int, ...]:
        """Every prefill chunk width, ascending: the classic buckets, then
        the long ones."""
        return tuple(self.prefill_buckets) + tuple(self.long_prefill_buckets)


# Prefill error samples an Engine keeps (the newest): the reference feeds
# them to a histogram, which waits for the port of ``obs/``.
QUANT_ERROR_SAMPLES = 4096


class Engine:
    """Device-side serving state over a GPT-2 module. ``step_calls``
    counts step dispatches and ``prefill_chunks`` prefill chunk
    dispatches; :meth:`kernel_launches` reads the attention kernels'
    launch counts; ``quant_errors`` holds the newest
    ``QUANT_ERROR_SAMPLES`` per-chunk prefill dequant errors of an int8
    pool (the samples of the reference's ``serve.kv.quant_error``)."""

    # Whether this engine class can serve prefill_mode="sequence": only
    # the mesh-sharded engine has a sequence axis to spread a chunk over.
    _seq_prefill_capable = False

    def __init__(self, model, cfg: ServeConfig = ServeConfig()):
        if cfg.max_len > model.cfg.max_positions:
            raise ValueError(f"max_len {cfg.max_len} exceeds the model's "
                             f"max_positions {model.cfg.max_positions}")
        if cfg.prefill_mode == "sequence" and not self._seq_prefill_capable:
            raise ValueError(
                "prefill_mode='sequence' requires the mesh-sharded engine "
                "(--mesh M with M > 1): the single-device engine has no "
                "sequence axis to shard over")
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.vocab = model.cfg.vocab_size
        self.k_max = min(cfg.k_max, self.vocab)
        self.pool = self._make_paged_pool(model.cfg)
        self.quant_errors = collections.deque(maxlen=QUANT_ERROR_SAMPLES)
        b, dev = cfg.max_batch_size, self.device
        # Host mirrors of each row's next write position and remaining
        # budget: the lazy binder sizes write windows without a sync.
        self.host_positions = np.zeros((b,), np.int64)
        self.host_budgets = np.zeros((b,), np.int64)
        self.host_temps = np.zeros((b,), np.float32)
        self.last_logits = torch.zeros((b, self.vocab), dtype=torch.float32,
                                       device=dev)
        self.step_ok: Optional[np.ndarray] = None
        self.positions = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.temps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.top_ks = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.top_ps = torch.ones((b,), dtype=torch.float32, device=dev)
        self.eos_ids = torch.full((b,), -1, dtype=torch.int32, device=dev)
        self.budgets = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.generators: List[Optional[torch.Generator]] = [None] * b
        self.step_calls = 0
        self.prefill_chunks = 0

    def _make_paged_pool(self, model_cfg) -> PagedSlotPool:
        """The KV pool (a subclass's hook: the sharded engine splits it
        over its mesh)."""
        cfg = self.cfg
        return PagedSlotPool(
            model_cfg, cfg.max_batch_size, cfg.max_len, cfg.cache_dtype,
            block_size=cfg.kv_block_size, num_blocks=cfg.kv_num_blocks,
            prefix_cache=cfg.prefix_cache, eviction=cfg.kv_eviction,
            quantized=cfg.kv_dtype == "int8", device=self.device)

    @staticmethod
    def kernel_launches() -> Dict[str, int]:
        """Launch counts of the attention kernels (process-wide; zero them
        through the wrappers' ``launches`` attributes)."""
        return {"paged_decode": paged_decode_attention.launches,
                "paged_prefill": paged_prefill_attention.launches,
                "paged_prefill_qoff": paged_prefill_qoff_attention.launches,
                "paged_quant_decode": paged_quant_decode_attention.launches,
                "paged_quant_prefill":
                    paged_quant_prefill_attention.launches}

    # -------------------------------------------------------- host API
    def _plan_chunks(self, n: int,
                     start: int = 0) -> List[Tuple[int, int, int]]:
        """``(offset, real_len, pad_width)`` chunks covering positions
        ``[start, n)``, greedy largest-fit over every bucket: while the
        remainder exceeds ``max_prefill_len``, either pad up into the
        smallest bucket holding all of it (only when that wastes less
        than one more stride would advance) or stride by the largest
        bucket that fits; then the smallest bucket holding the rest. With
        ``long_prefill_buckets=()`` that is full ``max_prefill_len``
        strides and a bucketed tail. A padded tail that would spill past
        ``max_len`` slides back over real tokens instead (rewriting them
        recomputes identical K/V; the pool copies any shared block the
        slide re-enters), so no chunk write ever passes capacity."""
        cfg = self.cfg
        p_max = cfg.max_prefill_len
        buckets = cfg.all_prefill_buckets
        chunks: List[Tuple[int, int, int]] = []
        off = start
        width = None
        while n - off > p_max:
            rem = n - off
            up = [w for w in buckets if w >= rem]
            stride = max(w for w in buckets if w <= rem)
            if up and up[0] - rem < stride:
                width = up[0]            # one wide pad-up tail
                break
            chunks.append((off, stride, stride))
            off += stride
        rem = n - off
        if width is None:
            width = next(w for w in buckets if w >= rem)
        if off + width > cfg.max_len:
            off, rem = max(n - width, 0), min(width, n)
        chunks.append((off, rem, width))
        return chunks

    def prefill_span(self, n: int) -> int:
        """Highest position (exclusive) a cold prefill of ``n`` tokens
        writes, pads included."""
        off, _, width = self._plan_chunks(n)[-1]
        return max(off + width, n)

    def prefill_blocks_needed(self, n: int) -> int:
        return self.pool.blocks_for_span(self.prefill_span(n))

    def _rows(self, tables: torch.Tensor) -> List[dict]:
        return [{**layer, "tables": tables} for layer in self.pool.caches]

    @torch.no_grad()
    def prefill(self, slot: int, tokens: Sequence[int], *, seed: int = 0,
                temperature: float = 0.0, top_k: Optional[int] = None,
                top_p: Optional[float] = None,
                eos_id: Optional[int] = None,
                max_new_tokens: Optional[int] = None) -> None:
        """Load one request into ``slot``: prompt K/V (prefix-cache hits
        referenced, the rest prefilled in chunks), position, generator,
        sampling parameters, EOS id and new-token budget. The first
        generated token comes from the next :meth:`step`."""
        n = len(tokens)
        cfg = self.cfg
        if not 1 <= n < cfg.max_len:
            raise ValueError(f"prompt length {n} not in [1, max_len-1="
                             f"{cfg.max_len - 1}]")
        cap = cfg.max_len - n
        budget = cap if max_new_tokens is None else min(max_new_tokens, cap)
        tokens = np.asarray(tokens, np.int64)
        start = self.pool.bind_for_prompt(slot, tokens.tolist())
        chunks = self._plan_chunks(n, start)
        try:
            self.pool.prepare_write(
                slot, min(off for off, _, _ in chunks),
                max(off + width for off, _, width in chunks))
        except KVBlocksExhausted:
            if start == 0:
                raise
            # The hit's own references pinned the blocks its copy-on-write
            # needed: fall back to a cold prefill, which admission budgeted.
            self.pool.release_blocks(slot)
            start = 0
            chunks = self._plan_chunks(n, 0)
            self.pool.prepare_write(
                slot, 0, max(off + width for off, _, width in chunks))
        if start > 0:
            self.pool.count_prefix_hit()
        self.host_positions[slot] = n
        self.host_budgets[slot] = budget
        dev = self.device
        rows = self._rows(torch.as_tensor(
            self.pool.tables_host[slot:slot + 1], device=dev))
        qerrs = []
        for off, ln, width in chunks:
            padded = np.zeros((1, width), np.int64)
            padded[0, :ln] = tokens[off:off + ln]
            logits = self.model(torch.as_tensor(padded, device=dev),
                                cache=rows, pos=off)
            self.prefill_chunks += 1
            last = logits[0, ln - 1]                 # last REAL row
            if self.pool.quantized:
                # Each layer left its chunk's error, a device scalar: read
                # once every chunk is dispatched, not between chunks.
                qerrs.append(torch.stack([r["qerr"] for r in rows]).max())
        if qerrs:
            self.quant_errors.extend(torch.stack(qerrs).tolist())
        off, ln, _ = chunks[-1]
        self.last_logits[slot] = last
        self.positions[slot] = off + ln
        self.temps[slot] = temperature
        self.top_ks[slot] = 0 if top_k is None else top_k
        self.top_ps[slot] = 1.0 if top_p is None else top_p
        self.eos_ids[slot] = -1 if eos_id is None else eos_id
        self.budgets[slot] = budget
        self.host_temps[slot] = temperature
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.generators[slot] = gen
        self.pool.register_prefix(slot, tokens.tolist())

    def _bind_decode_windows(self, active: np.ndarray, cap: int) -> None:
        """Make every active row's write window for this block
        (``[pos, pos + min(cap, budget))``, clamped to capacity) owned by
        the row before the dispatch. Raises :class:`KVBlocksExhausted`
        carrying the row's slot."""
        for slot in np.flatnonzero(np.asarray(active, bool)):
            pos_h = int(self.host_positions[slot])
            need = min(cap, max(int(self.host_budgets[slot]), 0))
            if need == 0:
                continue
            start = min(pos_h, self.cfg.max_len - 1)
            end = max(min(pos_h + need, self.cfg.max_len), start + 1)
            self.pool.prepare_write(int(slot), start, end)

    @torch.no_grad()
    def step(self, active: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Decode one block of up to ``decode_horizon`` tokens for every
        row; ``active`` is a ``[B]`` bool mask. -> ``(tokens [B, H],
        emitted [B])`` on the host: row r's tokens are
        ``tokens[r, :emitted[r]]``. Afterwards :attr:`step_ok` is False
        where a row's logits went non-finite."""
        self.step_calls += 1
        cfg = self.cfg
        active = np.asarray(active, bool)
        self._bind_decode_windows(active, cfg.decode_horizon)
        dev = self.device
        b = cfg.max_batch_size
        rows = self._rows(torch.as_tensor(self.pool.tables_host,
                                          device=dev))
        active_t = torch.as_tensor(active, device=dev)
        sampled = [int(r) for r in np.flatnonzero(active)
                   if self.host_temps[r] > 0]
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        ok = torch.ones((b,), dtype=torch.bool, device=dev)
        emitted = torch.zeros((b,), dtype=torch.int32, device=dev)
        last_logits, positions = self.last_logits, self.positions
        toks = []
        for _ in range(cfg.decode_horizon):
            ok = ok & finite_rows(last_logits)
            emit = active_t & ~done & ok & (emitted < self.budgets)
            tok = split_and_sample(self.generators, sampled, last_logits,
                                   self.temps, self.top_ks, self.top_ps,
                                   self.k_max)
            tok = torch.where(emit, tok, cfg.pad_id)
            logits = self.model(tok[:, None].long(), cache=rows,
                                pos=positions, active=emit)
            row_logits = logits[:, -1, :]
            ok = torch.where(emit, ok & finite_rows(row_logits), ok)
            counted = emit & ok
            emitted = emitted + counted.int()
            done = (done | (counted & (self.eos_ids >= 0)
                            & (tok == self.eos_ids))
                    | (counted & (emitted >= self.budgets)))
            last_logits = torch.where(emit[:, None], row_logits,
                                      last_logits)
            positions = torch.where(emit, positions + 1, positions)
            toks.append(tok)
        self.last_logits, self.positions = last_logits, positions
        self.budgets = (self.budgets - emitted).clamp_min(0)
        self.step_ok = ok.cpu().numpy()
        tok_h = torch.stack(toks, dim=1).cpu().numpy()
        emitted_h = emitted.cpu().numpy()
        self.host_positions += emitted_h.astype(np.int64)
        self.host_budgets -= emitted_h.astype(np.int64)
        return tok_h, emitted_h
