"""The continuous-batching engine (counterpart of ``ServeConfig``,
``SpeculativeConfig``, ``self_draft`` and ``Engine`` in
``nezha_tpu/serve/engine.py``).

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
:attr:`Engine.quant_errors` and observed into ``serve.kv.quant_error``.

Telemetry and chaos sit where JAX's engine has them: the fault points
``serve.prefill`` and ``serve.step`` at the head of each call (an injected
error at a block bind surfaces as :class:`KVBlocksExhausted`), the data
points ``serve.prefill.logits``, ``serve.step.logits`` and
``serve.spec.verify`` on the carried logits, and the ``serve.prefill.*``
and ``serve.spec.*`` instruments beside the plain counters.

``kv_layout="dense"`` keeps one ``[capacity, H, max_len, D]`` reservation
a slot (:class:`~nezha_tpu_torch.serve.slots.SlotPool`): no block tables,
no prefix cache, no eviction. Its prefill chunks attend through the
composed masked path over the slot's rows, as JAX's engine does (its
chunk offset is traced, so it never takes the position-0 flash branch),
and its decode steps through the dense flash-decode kernel.

With ``speculative`` set, a DRAFT model (an explicit one, or the target's
first ``draft_layers`` blocks sharing the target's tensors: a self-draft)
keeps its own pool, mirroring the target pool's slot lifecycle, and a
step runs ``decode_horizon`` windows of: ``t0`` from the carried logits
(or the carried rejection residual), ``draft_k + 1`` draft decodes, one
``draft_k + 1``-wide target verify (the composed path), and the accepted
prefix cut at EOS, budget or a non-finite verify row. A greedy row emits
exactly the classic engine's tokens; a sampled row follows the lossless
rejection-sampling law, with its draws keyed on (seed, emitted count,
purpose) (:func:`~nezha_tpu_torch.serve.sampling.keyed_uniforms`).

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

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models.gpt2 import GPT2, prefill_kernel_ok, with_overrides
from nezha_tpu_torch.ops.cuda import (flash_decode_attention,
                                      paged_decode_attention,
                                      paged_prefill_attention,
                                      paged_prefill_qoff_attention,
                                      paged_quant_decode_attention,
                                      paged_quant_prefill_attention)
from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES as FLASH_LAUNCHES
from nezha_tpu_torch.serve.sampling import (accept_mask, categorical_rows,
                                            filter_logits, filtered_probs,
                                            finite_rows, keyed_uniforms,
                                            residual_logits, sample_tokens,
                                            split_and_sample)
from nezha_tpu_torch.serve.slots import (KVBlocksExhausted, PagedSlotPool,
                                         SlotPool, read_slot)


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
class SpeculativeConfig:
    """Speculative decoding (``ServeConfig.speculative``): ``draft_k``
    proposals a verify window, so a window emits 1 to ``draft_k + 1``
    tokens; ``draft_layers`` the self-draft's depth (the target's first N
    blocks, its own tensors; None: full depth, an identity draft whose
    accept rate is ~1). An explicit draft model fixes the draft's
    architecture, and ``draft_k`` still applies."""

    draft_k: int = 4
    draft_layers: Optional[int] = None


PRIORITY_CLASSES = ("interactive", "batch", "background")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving shapes, the pool's settings and the scheduler's policy.

    ``max_batch_size`` is the slot count, ``max_len`` the per-slot KV
    capacity (prompt + generated), ``max_prefill_len`` the widest prefill
    chunk, ``prefill_buckets`` the chunk pad widths (``()``: powers of
    two, ending at ``max_prefill_len``), ``k_max`` the top-k cap,
    ``queue_capacity`` the scheduler's bound, ``pad_id`` the token fed to
    non-emitting rows, ``cache_dtype`` the pool dtype, ``decode_impl``
    (None: the model's own) the decode attention "auto" | "kernel" |
    "xla", ``prefill_impl`` (None: the model's own) the paged prefill
    chunk's attention the same way ("xla": the composed path, with the
    chunk's write done by tensor ops), ``decode_horizon`` the tokens per
    step dispatch.

    ``kv_layout`` "paged" (the block pool) or "dense" (one worst-case
    reservation a slot). ``kv_block_size``, ``kv_num_blocks`` (None:
    dense-equivalent), ``prefix_cache`` and ``kv_eviction`` ("lru" |
    "none") configure the paged pool; ``kv_dtype`` "bf16" keeps K/V in
    ``cache_dtype``, "int8" (paged only) stores int8 blocks with one fp32
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

    ``speculative`` (a :class:`SpeculativeConfig`, or a dict of its
    fields) turns on speculative decoding. ``priority_weights`` are the
    WFQ admission-grant weights of the lanes ``interactive``, ``batch``
    and ``background`` (a mapping or name/weight pairs; None: 4:2:1),
    ``tenant_queue_cap`` one tenant's queued bound (None: none),
    ``preemption`` lets the scheduler suspend a lower-priority decode
    under slot or block pressure and resume it later, at most
    ``preemption_budget`` times a request.

    ``kv_host_blocks`` > 0 (paged int8 pools with the prefix cache and
    LRU eviction) keeps a host tier of that many demoted blocks under the
    target pool: evicted prefix-cache blocks move to host memory, and a
    returning prompt promotes them back instead of prefilling them."""

    max_batch_size: int = 4
    max_len: int = 128
    max_prefill_len: int = 32
    prefill_buckets: Tuple[int, ...] = ()
    k_max: int = 64
    queue_capacity: int = 16
    pad_id: int = 0
    cache_dtype: torch.dtype = torch.bfloat16
    decode_impl: Optional[str] = None
    prefill_impl: Optional[str] = None
    decode_horizon: int = 1
    kv_layout: str = "paged"
    kv_block_size: int = 16
    kv_num_blocks: Optional[int] = None
    prefix_cache: bool = True
    kv_eviction: str = "lru"
    kv_dtype: str = "bf16"
    prefill_mode: str = "replicated"
    long_prefill_buckets: Tuple[int, ...] = ()
    seq_prefill_variant: str = "auto"
    speculative: Optional[Any] = None
    priority_weights: Optional[Any] = None
    tenant_queue_cap: Optional[int] = None
    preemption: bool = False
    preemption_budget: int = 2
    kv_host_blocks: int = 0

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout must be 'paged' or 'dense', got "
                             f"{self.kv_layout!r}")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                             f"{self.kv_dtype!r}")
        if self.kv_dtype == "int8" and self.kv_layout != "paged":
            raise ValueError("kv_dtype='int8' requires kv_layout='paged' "
                             "(scales are per-block state; the dense pool "
                             "has no blocks)")
        if self.kv_host_blocks < 0:
            raise ValueError(f"kv_host_blocks must be >= 0, got "
                             f"{self.kv_host_blocks}")
        if self.kv_host_blocks:
            if self.kv_layout != "paged" or self.kv_dtype != "int8":
                raise ValueError(
                    "kv_host_blocks requires kv_layout='paged' and "
                    "kv_dtype='int8' — the host tier demotes the "
                    "int8+scales block payload verbatim (lossless); "
                    "a bf16 tier would serve quantize-dequant blocks "
                    "that differ from a fresh prefill")
            if not self.prefix_cache:
                raise ValueError(
                    "kv_host_blocks requires prefix_cache (demotion "
                    "feeds off trie eviction)")
            if self.kv_eviction != "lru":
                raise ValueError(
                    "kv_host_blocks requires kv_eviction='lru' "
                    "(demotion IS the eviction path; 'none' never "
                    "evicts, so the tier would be inert)")
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
        if self.speculative is not None:
            spec = self.speculative
            if isinstance(spec, dict):
                spec = SpeculativeConfig(**spec)
                object.__setattr__(self, "speculative", spec)
            if spec.draft_k < 1:
                raise ValueError(f"speculative.draft_k must be >= 1, got "
                                 f"{spec.draft_k}")
            if spec.draft_layers is not None and spec.draft_layers < 1:
                raise ValueError(f"speculative.draft_layers must be >= 1 "
                                 f"or None, got {spec.draft_layers}")
        if not 1 <= self.max_prefill_len <= self.max_len:
            raise ValueError(f"need 1 <= max_prefill_len <= max_len, got "
                             f"{self.max_prefill_len} / {self.max_len}")
        if self.k_max < 1:
            raise ValueError("k_max must be >= 1")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if self.decode_impl not in (None, "auto", "kernel", "xla"):
            raise ValueError(f"decode_impl must be None, 'auto', 'kernel', "
                             f"or 'xla'; got {self.decode_impl!r}")
        if self.prefill_impl not in (None, "auto", "kernel", "xla"):
            raise ValueError(f"prefill_impl must be None, 'auto', 'kernel', "
                             f"or 'xla'; got {self.prefill_impl!r}")
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
        if self.tenant_queue_cap is not None and self.tenant_queue_cap < 1:
            raise ValueError(f"tenant_queue_cap must be >= 1 or None, got "
                             f"{self.tenant_queue_cap}")
        if self.preemption_budget < 0:
            raise ValueError(f"preemption_budget must be >= 0, got "
                             f"{self.preemption_budget}")
        if self.priority_weights is not None:
            pw = self.priority_weights
            pairs = list(pw.items()) if isinstance(pw, dict) else list(pw)
            try:
                norm = {str(name): int(w) for name, w in pairs}
            except (TypeError, ValueError):
                raise ValueError(f"priority_weights must map priority names "
                                 f"to integer weights, got {pw!r}")
            if set(norm) != set(PRIORITY_CLASSES):
                raise ValueError(f"priority_weights must name exactly "
                                 f"{PRIORITY_CLASSES}, got {sorted(norm)}")
            if any(w < 1 for w in norm.values()):
                raise ValueError(
                    f"priority_weights must all be >= 1, got {norm}")
            object.__setattr__(self, "priority_weights",
                               tuple((c, norm[c]) for c in PRIORITY_CLASSES))

    @property
    def all_prefill_buckets(self) -> Tuple[int, ...]:
        """Every prefill chunk width, ascending: the classic buckets, then
        the long ones."""
        return tuple(self.prefill_buckets) + tuple(self.long_prefill_buckets)


def self_draft(model: GPT2, num_layers: Optional[int] = None) -> GPT2:
    """An early-exit SELF-DRAFT: the target truncated to its first
    ``num_layers`` blocks (None: full depth), over the target's own
    tensors (no copy). Draft quality moves only the accept rate: every
    emitted token is verified against the target."""
    cfg = model.cfg
    layers = cfg.num_layers if num_layers is None else int(num_layers)
    if not 1 <= layers <= cfg.num_layers:
        raise ValueError(f"draft_layers must be in [1, {cfg.num_layers}], "
                         f"got {layers}")
    draft = with_overrides(model, num_layers=layers)
    draft.h = draft.h[:layers]
    return draft


# Prefill error samples an Engine keeps (the newest), beside the
# ``serve.kv.quant_error`` histogram.
QUANT_ERROR_SAMPLES = 4096


class Engine:
    """Device-side serving state over a GPT-2 module (and, speculative, a
    draft). ``step_calls`` counts step dispatches and ``prefill_chunks``
    the target's prefill chunk dispatches; :meth:`kernel_launches` reads
    the attention kernels' launch counts (process-wide, so the draft's
    launches are counted with the target's); ``quant_errors`` holds the
    newest ``QUANT_ERROR_SAMPLES`` per-chunk prefill dequant errors of an
    int8 pool (the samples of the reference's ``serve.kv.quant_error``).
    Speculative, ``spec_verifies``, ``spec_draft_tokens`` and
    ``spec_accepted`` are the verify windows run, the proposals they
    charged (``draft_k`` each) and the proposals accepted."""

    # Whether this engine class can serve prefill_mode="sequence": only
    # the mesh-sharded engine has a sequence axis to spread a chunk over.
    _seq_prefill_capable = False

    def __init__(self, model, cfg: ServeConfig = ServeConfig(),
                 draft_model=None):
        if cfg.max_len > model.cfg.max_positions:
            raise ValueError(f"max_len {cfg.max_len} exceeds the model's "
                             f"max_positions {model.cfg.max_positions}")
        if cfg.prefill_mode == "sequence" and not self._seq_prefill_capable:
            raise ValueError(
                "prefill_mode='sequence' requires the mesh-sharded engine "
                "(--mesh M with M > 1): the single-device engine has no "
                "sequence axis to shard over")
        self.cfg = cfg
        model = self._impl_overrides(model)
        self.model = model
        self.device = next(model.parameters()).device
        self.vocab = model.cfg.vocab_size
        self.k_max = min(cfg.k_max, self.vocab)
        self.paged = cfg.kv_layout == "paged"
        # Whether paged prefill chunks go through the flash-prefill kernels.
        self.prefill_kernel_active = bool(self.paged
                                          and prefill_kernel_ok(model.cfg))
        self.kv_quant = cfg.kv_dtype == "int8"
        obs.gauge("serve.prefill.kernel_active").set(
            1.0 if self.prefill_kernel_active else 0.0)
        self.pool = (self._make_paged_pool(
                         model.cfg, num_blocks=cfg.kv_num_blocks,
                         prefix_cache=cfg.prefix_cache,
                         eviction=cfg.kv_eviction,
                         host_blocks=cfg.kv_host_blocks)
                     if self.paged else self._make_dense_pool(model.cfg))
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
        self.spec = cfg.speculative
        self.draft_model = None
        self.draft_pool = None
        if self.spec is not None:
            self._init_draft(draft_model)
        elif draft_model is not None:
            raise ValueError("draft_model requires ServeConfig.speculative")

    def _init_draft(self, draft_model) -> None:
        """The draft engine: its model (explicit, or a self-draft of the
        target), its pool — dense-equivalent blocks, no prefix cache, no
        eviction, the target's KV dtype, so that it is never the source of
        backpressure — mirrored by slot, and its carried state."""
        cfg = self.cfg
        if draft_model is not None:
            dm = self._impl_overrides(draft_model)
            if next(dm.parameters()).device != self.device:
                raise ValueError(
                    f"draft model on {next(dm.parameters()).device}, target "
                    f"on {self.device}: both must be on one device")
        else:
            dm = self_draft(self.model, self.spec.draft_layers)
        if dm.cfg.vocab_size != self.model.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dm.cfg.vocab_size} != target vocab "
                f"{self.model.cfg.vocab_size}: the accept test compares "
                f"distributions over one vocabulary")
        if cfg.max_len > dm.cfg.max_positions:
            raise ValueError(f"max_len {cfg.max_len} exceeds the draft "
                             f"model's max_positions {dm.cfg.max_positions}")
        self.draft_model = dm
        self.draft_pool = (self._make_paged_pool(
                               dm.cfg, num_blocks=None, prefix_cache=False,
                               eviction="none")
                           if self.paged else self._make_dense_pool(dm.cfg))
        self.pool.mirror = self.draft_pool
        b, dev = cfg.max_batch_size, self.device
        # True where a row's carried logits are the rejection residual
        # (already-filtered log-probs, drawn raw).
        self.residual = torch.zeros((b,), dtype=torch.bool, device=dev)
        # The keys of a row's speculative draws: its seed and the tokens
        # it has emitted since its prefill.
        self.seeds = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.emitted_counts = torch.zeros((b,), dtype=torch.int64,
                                          device=dev)
        self.spec_verifies = 0
        self.spec_draft_tokens = 0
        self.spec_accepted = 0

    def _impl_overrides(self, model):
        """The serving overrides of the model's decode and prefill
        attention (``ServeConfig.decode_impl``/``prefill_impl``): the same
        tensors under a replaced config, as JAX rebuilds its module
        tree."""
        over = {name: getattr(self.cfg, name)
                for name in ("decode_impl", "prefill_impl")
                if getattr(self.cfg, name) is not None
                and getattr(self.cfg, name) != getattr(model.cfg, name)}
        return with_overrides(model, **over) if over else model

    def _make_paged_pool(self, model_cfg, *, num_blocks, prefix_cache,
                         eviction, host_blocks=0) -> PagedSlotPool:
        """A paged pool, the target's or the draft's (a subclass's hook:
        the sharded engine splits it over its mesh). Only the target's
        gets a host tier: the draft pool keeps no prefix cache."""
        cfg = self.cfg
        return PagedSlotPool(
            model_cfg, cfg.max_batch_size, cfg.max_len, cfg.cache_dtype,
            block_size=cfg.kv_block_size, num_blocks=num_blocks,
            prefix_cache=prefix_cache, eviction=eviction,
            quantized=cfg.kv_dtype == "int8", host_blocks=host_blocks,
            device=self.device)

    def _make_dense_pool(self, model_cfg) -> SlotPool:
        cfg = self.cfg
        return SlotPool(model_cfg, cfg.max_batch_size, cfg.max_len,
                        cfg.cache_dtype, device=self.device)

    @staticmethod
    def kernel_launches() -> Dict[str, int]:
        """Launch counts of the attention kernels serving can run
        (process-wide; zero them through the wrappers' ``launches``
        attributes, and B1's through ``flash_attention.LAUNCHES``)."""
        return {"paged_decode": paged_decode_attention.launches,
                "paged_prefill": paged_prefill_attention.launches,
                "paged_prefill_qoff": paged_prefill_qoff_attention.launches,
                "paged_quant_decode": paged_quant_decode_attention.launches,
                "paged_quant_prefill":
                    paged_quant_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches,
                "flash_fwd": FLASH_LAUNCHES["flash_fwd"]}

    @property
    def tokens_per_dispatch(self) -> int:
        """Most tokens one step dispatch can emit a row:
        ``decode_horizon`` windows of ``draft_k + 1`` (``decode_horizon``
        without speculation)."""
        h = self.cfg.decode_horizon
        return h * (1 + self.spec.draft_k) if self.spec else h

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
        """Worst-case (no prefix hit) blocks an ``n``-token prompt binds
        at prefill. Paged layout only."""
        return self.pool.blocks_for_span(self.prefill_span(n))

    def _rows(self, tables: torch.Tensor) -> List[dict]:
        return [{**layer, "tables": tables} for layer in self.pool.caches]

    def _cache_rows(self, pool, slot: Optional[int] = None) -> List[dict]:
        """The model's cache argument over ``pool``: every row (``slot``
        None) or one slot's; a paged pool's dicts carry the uploaded
        block tables, a dense pool's are the slot's rows (views)."""
        if self.paged:
            tables = torch.as_tensor(
                pool.tables_host if slot is None
                else pool.tables_host[slot:slot + 1], device=self.device)
            if pool is self.pool:
                return self._rows(tables)
            return [{**layer, "tables": tables} for layer in pool.caches]
        if slot is None:
            return pool.caches
        return [{"k": read_slot(layer["k"], slot),
                 "v": read_slot(layer["v"], slot)} for layer in pool.caches]

    @torch.no_grad()
    def prefill(self, slot: int, tokens: Sequence[int], *, seed: int = 0,
                temperature: float = 0.0, top_k: Optional[int] = None,
                top_p: Optional[float] = None,
                eos_id: Optional[int] = None,
                max_new_tokens: Optional[int] = None) -> None:
        """Load one request into ``slot``: prompt K/V (on the paged layout
        prefix-cache hits referenced, the rest prefilled in chunks),
        position, generator, sampling parameters, EOS id and new-token
        budget; speculative, the prompt into the draft pool too (always a
        cold plan from 0: the draft pool caches no prefix). The first
        generated token comes from the next :meth:`step`."""
        faults.point("serve.prefill")
        n = len(tokens)
        cfg = self.cfg
        if not 1 <= n < cfg.max_len:
            raise ValueError(f"prompt length {n} not in [1, max_len-1="
                             f"{cfg.max_len - 1}]")
        cap = cfg.max_len - n
        budget = cap if max_new_tokens is None else min(max_new_tokens, cap)
        tokens = np.asarray(tokens, np.int64)
        start = 0
        if self.paged:
            start = self.pool.bind_for_prompt(slot, tokens.tolist())
        chunks = self._plan_chunks(n, start)
        if self.paged:
            try:
                self.pool.prepare_write(
                    slot, min(off for off, _, _ in chunks),
                    max(off + width for off, _, width in chunks))
            except KVBlocksExhausted:
                if start == 0:
                    raise
                # The hit's own references pinned the blocks its
                # copy-on-write needed: fall back to a cold prefill, which
                # admission budgeted.
                self.pool.release_blocks(slot)
                start = 0
                chunks = self._plan_chunks(n, 0)
                self.pool.prepare_write(
                    slot, 0, max(off + width for off, _, width in chunks))
            if start > 0:
                self.pool.count_prefix_hit()
        obs.counter("serve.prefill.chunks_total").inc(len(chunks))
        # The tokens the chunks push through the model (pads included, a
        # prefix hit's span not): the sharded engine's collective
        # estimate reads them.
        self.last_prefill_tokens = sum(w for _, _, w in chunks)
        self.last_prefill_chunks = len(chunks)
        # Re-pinned each call: a registry reset after warmup must keep it.
        obs.gauge("serve.prefill.kernel_active").set(
            1.0 if self.prefill_kernel_active else 0.0)
        self.host_positions[slot] = n
        self.host_budgets[slot] = budget
        rows = self._cache_rows(self.pool, slot)
        last = self._run_chunks(self.model, rows, tokens, chunks)
        off, ln, _ = chunks[-1]
        self.last_logits[slot] = last
        self.positions[slot] = off + ln
        self.temps[slot] = temperature
        self.top_ks[slot] = 0 if top_k is None else top_k
        self.top_ps[slot] = 1.0 if top_p is None else top_p
        self.eos_ids[slot] = -1 if eos_id is None else eos_id
        self.budgets[slot] = budget
        self.host_temps[slot] = temperature
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self.generators[slot] = gen
        if self.spec is not None:
            dchunks = self._plan_chunks(n, 0)
            if self.paged:
                self.draft_pool.prepare_write(
                    slot, 0, max(off + width for off, _, width in dchunks))
            self._run_chunks(self.draft_model,
                             self._cache_rows(self.draft_pool, slot),
                             tokens, dchunks, target=False)
            self.residual[slot] = False
            self.seeds[slot] = int(seed)
            self.emitted_counts[slot] = 0
        if self.paged:
            self.pool.register_prefix(slot, tokens.tolist())
        if faults.enabled():
            self.last_logits = faults.corrupt(
                "serve.prefill.logits", self.last_logits, rows=(slot,))

    def _run_chunks(self, model, rows, tokens: np.ndarray, chunks,
                    target: bool = True) -> torch.Tensor:
        """Every chunk through ``model`` at its offset -> the last chunk's
        last REAL row's logits. The target's int8 chunks leave their
        dequant errors, read once every chunk is dispatched."""
        dev = self.device
        qerrs = []
        kernel = target and self.paged and self.prefill_kernel_active
        for off, ln, width in chunks:
            if target:
                obs.histogram("serve.prefill.bucket_len").observe(width)
            # Recorded only inside the request's trace context.
            with obs.traced_span("serve.prefill.chunk", width=width,
                                 offset=off, tokens=ln):
                padded = np.zeros((1, width), np.int64)
                padded[0, :ln] = tokens[off:off + ln]
                ids = torch.as_tensor(padded, device=dev)
                if kernel:
                    # The chunk's dispatch through the flash-prefill
                    # kernels; an int8 pool writes every layer's K and V
                    # blocks inside the kernel.
                    with obs.span("serve.prefill.kernel_s", width=width):
                        logits = model(ids, cache=rows, pos=off)
                    if self.kv_quant:
                        obs.counter("serve.prefill.fused_writes_total").inc(
                            model.cfg.num_layers)
                else:
                    logits = model(ids, cache=rows, pos=off)
            last = logits[0, ln - 1]                 # last REAL row
            if target:
                self.prefill_chunks += 1
                if "qerr" in rows[0]:
                    qerrs.append(torch.stack([r["qerr"] for r in rows]).max())
        if qerrs:
            errs = torch.stack(qerrs).tolist()
            self.quant_errors.extend(errs)
            hist = obs.histogram("serve.kv.quant_error")
            for err in errs:
                hist.observe(err)
        return last

    def _bind_decode_windows(self, active: np.ndarray, cap: int,
                             pools) -> None:
        """Make every active row's write window for this block
        (``[pos, pos + min(cap, budget))``, clamped to capacity) owned by
        the row in each of ``pools`` before the dispatch. Raises
        :class:`KVBlocksExhausted` carrying the row's slot, for genuine
        exhaustion and an injected ``serve.kv.bind`` fault alike."""
        for slot in np.flatnonzero(np.asarray(active, bool)):
            pos_h = int(self.host_positions[slot])
            need = min(cap, max(int(self.host_budgets[slot]), 0))
            if need == 0:
                continue
            start = min(pos_h, self.cfg.max_len - 1)
            end = max(min(pos_h + need, self.cfg.max_len), start + 1)
            try:
                for pool in pools:
                    pool.prepare_write(int(slot), start, end)
            except faults.InjectedFault as e:
                raise KVBlocksExhausted(str(e), slot=int(slot)) from e

    @torch.no_grad()
    def step(self, active: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Decode one block for every row; ``active`` is a ``[B]`` bool
        mask. -> ``(tokens [B, W], emitted [B])`` on the host: row r's
        tokens are ``tokens[r, :emitted[r]]``, ``W`` is
        :attr:`tokens_per_dispatch`. Afterwards :attr:`step_ok` is False
        where a row's logits went non-finite."""
        faults.point("serve.step")
        self.step_calls += 1
        if self.spec is not None:
            return self._spec_step(np.asarray(active, bool))
        cfg = self.cfg
        active = np.asarray(active, bool)
        if self.paged:
            self._bind_decode_windows(active, cfg.decode_horizon,
                                      (self.pool,))
        dev = self.device
        b = cfg.max_batch_size
        rows = self._cache_rows(self.pool)
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
        if faults.enabled():
            last_logits = faults.corrupt(
                "serve.step.logits", last_logits,
                rows=lambda: np.flatnonzero(active))
        self.last_logits, self.positions = last_logits, positions
        self.budgets = (self.budgets - emitted).clamp_min(0)
        self.step_ok = ok.cpu().numpy()
        tok_h = torch.stack(toks, dim=1).cpu().numpy()
        emitted_h = emitted.cpu().numpy()
        self.host_positions += emitted_h.astype(np.int64)
        self.host_budgets -= emitted_h.astype(np.int64)
        return tok_h, emitted_h

    # ----------------------------------------------------- speculative
    def _spec_step(self, active: np.ndarray) -> Tuple[np.ndarray,
                                                      np.ndarray]:
        """``decode_horizon`` draft -> verify -> accept windows under the
        classic step's ``(tokens, emitted)`` contract: each row's emitted
        tokens are compacted left (a stable sort) in a ``[B, horizon *
        (draft_k + 1)]`` block. Everything stays on the device until one
        host copy of tokens, emitted counts, window counts and health."""
        cfg = self.cfg
        k = self.spec.draft_k
        w = k + 1
        if self.paged:
            # Both pools bind the same window; draft and verify writes past
            # it go to the scratch block through the unbound table tail.
            self._bind_decode_windows(active, cfg.decode_horizon * w,
                                      (self.pool, self.draft_pool))
        dev, b, v = self.device, cfg.max_batch_size, self.vocab
        rows = self._cache_rows(self.pool)
        drows = self._cache_rows(self.draft_pool)
        active_t = torch.as_tensor(active, device=dev)
        # Greedy batches skip every draw and every distribution.
        sampled = bool((self.host_temps[active] > 0).any())
        greedy = self.temps <= 0.0
        temps, top_ks, top_ps = self.temps, self.top_ks, self.top_ps
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        ok = torch.ones((b,), dtype=torch.bool, device=dev)
        emitted = torch.zeros((b,), dtype=torch.int32, device=dev)
        last, positions = self.last_logits, self.positions
        residual, counts = self.residual, self.emitted_counts
        jidx = torch.arange(w, device=dev)
        toks, masks, wins = [], [], []
        for _ in range(cfg.decode_horizon):
            ok = ok & finite_rows(last)
            emit0 = active_t & ~done & ok & (emitted < self.budgets)
            if sampled:
                u0 = keyed_uniforms(self.seeds, counts, 0, 1)[:, 0]
                t0 = torch.where(residual, categorical_rows(u0, last),
                                 sample_tokens(last, u0, temps, top_ks,
                                               top_ps, self.k_max))
            else:
                t0 = torch.argmax(last, dim=-1).int()
            t0 = torch.where(emit0, t0, cfg.pad_id)
            # k + 1 draft decodes: the last keeps the draft cache whole
            # for a window accepted in full.
            props, q_all = [], []
            tok_in = t0
            for j in range(w):
                dlog = self.draft_model(tok_in[:, None].long(), cache=drows,
                                        pos=positions + j,
                                        active=emit0)[:, -1, :]
                d = torch.argmax(dlog, dim=-1).int()
                if sampled and j < k:
                    fl = filter_logits(dlog, temps, top_ks, top_ps,
                                       self.k_max)
                    uj = keyed_uniforms(self.seeds, counts, 1 + j, 1)[:, 0]
                    d = torch.where(greedy, d, categorical_rows(uj, fl))
                    q_all.append(torch.softmax(fl, dim=-1))
                tok_in = torch.where(emit0, d, cfg.pad_id)
                props.append(tok_in)
            win = torch.stack([t0] + props[:k], dim=1)              # [B, w]
            vlog = self.model(win.long(), cache=rows, pos=positions,
                              active=emit0)                       # [B, w, V]
            okrow = torch.isfinite(vlog).all(dim=2).all(dim=1)
            ok = torch.where(emit0, ok & okrow, ok)
            tmax = torch.argmax(vlog, dim=-1).int()
            if sampled:
                pf = filtered_probs(
                    vlog[:, :k].reshape(b * k, v),
                    temps.repeat_interleave(k), top_ks.repeat_interleave(k),
                    top_ps.repeat_interleave(k), self.k_max).reshape(b, k, v)
                qf = torch.stack(q_all, dim=1)
                u = keyed_uniforms(self.seeds, counts, k + 2, k)
                acc = accept_mask(win[:, 1:], pf, qf, u, greedy, tmax[:, :k])
            else:
                acc = win[:, 1:] == tmax[:, :k]
            acc_full = torch.cat(
                [torch.ones((b, 1), dtype=torch.bool, device=dev), acc], 1)
            acc_prefix = torch.cumprod(acc_full.int(), dim=1).bool()
            is_eos = (self.eos_ids >= 0)[:, None] & (
                win == self.eos_ids[:, None])
            no_prior_eos = (torch.cumsum(is_eos.int(), dim=1)
                            - is_eos.int()) == 0
            within_budget = (emitted[:, None] + jidx[None, :]
                             < self.budgets[:, None])
            upd = emit0 & okrow
            emit_w = upd[:, None] & acc_prefix & no_prior_eos & within_budget
            e = emit_w.sum(dim=1).int()
            emitted = emitted + e
            done = (done | (emit_w & is_eos).any(dim=1)
                    | (upd & (emitted >= self.budgets)))
            # The next window's distribution: the target's logits after the
            # last emitted token, or, where a sampled row stopped at a
            # rejection, the residual, flagged so that it is drawn raw.
            e1 = e.clamp(1, w).long()
            nxt = vlog.gather(1, (e1 - 1)[:, None, None].expand(b, 1, v))[:, 0]
            if sampled:
                stop = e.clamp(max=w - 1).long()[:, None]
                rej = (upd & (e < w) & ~greedy
                       & no_prior_eos.gather(1, stop)[:, 0]
                       & within_budget.gather(1, stop)[:, 0]
                       & ~acc_full.gather(1, stop)[:, 0])
                ek = (e.clamp(1, k).long() - 1)[:, None, None].expand(b, 1, v)
                rlog = residual_logits(pf.gather(1, ek)[:, 0],
                                       qf.gather(1, ek)[:, 0])
                nxt = torch.where(rej[:, None], rlog, nxt)
                residual = torch.where(upd, rej, residual)
            last = torch.where(upd[:, None], nxt, last)
            positions = positions + e
            counts = counts + e
            toks.append(torch.where(emit_w, win, cfg.pad_id))
            masks.append(emit_w)
            wins.append(e)
        tok_flat = torch.cat(toks, dim=1)                    # [B, H * w]
        order = torch.argsort((~torch.cat(masks, dim=1)).int(), dim=1,
                              stable=True)
        tok_block = tok_flat.gather(1, order)
        if faults.enabled():
            # A nan/inf rule poisons one active row's carried logits: the
            # next dispatch retires only that row.
            last = faults.corrupt("serve.spec.verify", last,
                                  rows=lambda: np.flatnonzero(active))
        self.last_logits, self.positions = last, positions
        self.residual, self.emitted_counts = residual, counts
        self.budgets = (self.budgets - emitted).clamp_min(0)
        width = tok_block.shape[1]
        host = torch.cat([tok_block.int(), emitted[:, None],
                          torch.stack(wins, dim=1), ok.int()[:, None]],
                         dim=1).cpu().numpy()
        tok_h = host[:, :width]
        emitted_h = host[:, width]
        win_h = host[:, width + 1:-1]
        self.step_ok = host[:, -1].astype(bool)
        # Every window that emitted ran one verify; it accepted e - 1
        # proposals (its first token is the carried-logits sample) and is
        # charged all k.
        ran = win_h[active]
        ran = ran[ran > 0]
        if ran.size:
            verifies, accepted = int(ran.size), int((ran - 1).sum())
            self.spec_verifies += verifies
            self.spec_draft_tokens += verifies * k
            self.spec_accepted += accepted
            obs.counter("serve.spec.draft_tokens_total").inc(verifies * k)
            obs.counter("serve.spec.accepted_total").inc(accepted)
            hist = obs.histogram("serve.spec.accepted_len")
            for v in (ran - 1).tolist():
                hist.observe(v)
        self.host_positions += emitted_h.astype(np.int64)
        self.host_budgets -= emitted_h.astype(np.int64)
        return tok_h, emitted_h
