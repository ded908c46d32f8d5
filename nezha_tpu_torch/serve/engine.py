"""The continuous-batching engine on the paged KV pool (counterpart of
``ServeConfig`` and ``Engine`` in ``nezha_tpu/serve/engine.py``).

The engine knows slots, not requests. ``prefill(slot, tokens, ...)``
loads one request (however many chunks that takes) and ``step(active)``
decodes one block of up to ``decode_horizon`` tokens for every row:

- **prefill** pads each prompt chunk to a static bucket width (powers of
  two up to ``max_prefill_len``); prompts longer than that run as
  successive ``max_prefill_len`` chunks and a bucketed tail, at advancing
  offsets, through the model's paged prefill path (the flash-prefill
  kernel). A prompt's full-block prefix is first matched against the
  prefix cache: matched blocks are referenced, not recomputed, and only
  the suffix prefills. The last REAL row's logits seed decoding.
- **step** runs ``decode_horizon`` single-token steps as a Python loop,
  all on the device: per-row sampling from the carried logits, the
  forward at per-row positions (the flash-decode kernel), and the per-row
  EOS / budget / health masks that stop a row's sampling and K/V writes
  the moment it finishes — the host sees the ``[B, H]`` token block and
  per-row emitted counts once per dispatch.

Blocks are bound and copied-on-write on the host BEFORE each dispatch, so
in-program writes land only in blocks the row owns, with non-emitting
rows routed to the scratch block. JAX compiles one program per bucket;
PyTorch runs eagerly, so there is no program set to freeze here (CUDA
graphs are later work). Token ids are validated by the scheduler, not
here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                      paged_prefill_attention)
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
    ("lru" | "none") configure the paged pool.

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
    # Not ported: each must keep its default.
    kv_layout: str = "paged"
    kv_dtype: str = "bf16"
    kv_host_blocks: int = 0
    speculative: Optional[Any] = None
    prefill_mode: str = "replicated"
    long_prefill_buckets: Tuple[int, ...] = ()
    priority_weights: Optional[Any] = None
    tenant_queue_cap: Optional[int] = None
    preemption: bool = False

    def __post_init__(self):
        refusals = (
            ("kv_layout", self.kv_layout != "paged",
             "only the paged layout is ported"),
            ("kv_dtype", self.kv_dtype != "bf16",
             "int8 KV pools (and their kernels) are not ported"),
            ("kv_host_blocks", self.kv_host_blocks != 0,
             "the host KV tier is not ported"),
            ("speculative", self.speculative is not None,
             "speculative decoding is not ported"),
            ("prefill_mode", self.prefill_mode != "replicated",
             "sequence-sharded prefill is not ported"),
            ("long_prefill_buckets", tuple(self.long_prefill_buckets) != (),
             "long-prefill buckets are not ported"),
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


class Engine:
    """Device-side serving state over a GPT-2 module. ``step_calls``
    counts step dispatches; :meth:`kernel_launches` reads the attention
    kernels' launch counts."""

    def __init__(self, model, cfg: ServeConfig = ServeConfig()):
        if cfg.max_len > model.cfg.max_positions:
            raise ValueError(f"max_len {cfg.max_len} exceeds the model's "
                             f"max_positions {model.cfg.max_positions}")
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.vocab = model.cfg.vocab_size
        self.k_max = min(cfg.k_max, self.vocab)
        self.pool = PagedSlotPool(
            model.cfg, cfg.max_batch_size, cfg.max_len, cfg.cache_dtype,
            block_size=cfg.kv_block_size, num_blocks=cfg.kv_num_blocks,
            prefix_cache=cfg.prefix_cache, eviction=cfg.kv_eviction,
            device=self.device)
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

    @staticmethod
    def kernel_launches() -> Dict[str, int]:
        """Launch counts of the attention kernels (process-wide; zero them
        through the wrappers' ``launches`` attributes)."""
        return {"paged_decode": paged_decode_attention.launches,
                "paged_prefill": paged_prefill_attention.launches}

    # -------------------------------------------------------- host API
    def _plan_chunks(self, n: int,
                     start: int = 0) -> List[Tuple[int, int, int]]:
        """``(offset, real_len, pad_width)`` chunks covering positions
        ``[start, n)``: full ``max_prefill_len`` strides, then the
        smallest bucket holding the rest. A padded tail that would spill
        past ``max_len`` slides back over real tokens instead (rewriting
        them recomputes identical K/V; the pool copies any shared block
        the slide re-enters), so no chunk write ever passes capacity."""
        cfg = self.cfg
        p_max = cfg.max_prefill_len
        chunks: List[Tuple[int, int, int]] = []
        off = start
        while n - off > p_max:
            chunks.append((off, p_max, p_max))
            off += p_max
        rem = n - off
        width = next(w for w in cfg.prefill_buckets if w >= rem)
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
        for off, ln, width in chunks:
            padded = np.zeros((1, width), np.int64)
            padded[0, :ln] = tokens[off:off + ln]
            logits = self.model(torch.as_tensor(padded, device=dev),
                                cache=rows, pos=off)
            last = logits[0, ln - 1]                 # last REAL row
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
