"""Admission, retirement and the serving loop (counterpart of
``nezha_tpu/serve/scheduler.py``).

One iteration: expire queued and suspended requests past their deadline
-> admit into free slots -> decode one block for every live row ->
retire rows on EOS, max-new-tokens or deadline -> admit again, so a slot
freed by retirement is refilled in the same iteration.

Admission is weighted fair queueing across priority lanes
(``interactive``, ``batch``, ``background``; 4:2:1 by default, or
``ServeConfig.priority_weights``): each lane keeps a virtual clock that a
grant advances by ``1 / weight``, the lane with the smallest clock is
served next (priority order breaks ties), and within a lane the tenants
take turns. Lower lanes are slowed, never starved; with every request in
one lane and one tenant (the defaults) it is the exact bounded FIFO. On
the paged layout a grant also needs the pool's free-plus-reclaimable
blocks to cover the pick's worst-case prefill.

``submit`` fails fast with :class:`QueueFull` past the queue's capacity,
with :class:`TenantOverLimit` (a :class:`QueueFull`) when the request's
tenant already holds ``tenant_queue_cap`` queued requests, and with
``ValueError`` for a request that can never be served.

With ``ServeConfig.preemption``, a pick that finds no slot (or, paged, no
blocks) suspends one live decode of strictly lower priority (lowest class
first, least progressed within it) whose ``preemption_budget`` is not
spent: on the paged layout with the prefix cache and LRU eviction the
victim's blocks (prompt and emitted tokens) are indexed in the prefix
trie first, so its resume prefix-hits them and prefills only the tail;
elsewhere the resume re-prefills cold. A suspended request resumes
ahead of queued work of equal or lower priority, with its context
(prompt and emitted tokens) and its remaining budget; its deadline keeps
running. One preemption per admission pass, unless ``slo_tracker`` (an
:class:`~nezha_tpu_torch.obs.SLOTracker` on interactive TTFT, fed each
interactive first token) reports a burn rate above 1. The
``scheduler.preempt`` fault point vetoes a preemption (the victim keeps
decoding).

Failures are request-scoped: a prefill error or non-finite logits retire
only that request (``FinishReason.ERROR``); KV block exhaustion during
decode retires the row that could not grow and the block is
re-dispatched for the rest.

A ``prefill_only`` request is prefilled and then PARKED (its slot and
blocks held, finished ``FinishReason.PREFILLED``) for a KV migration
(``serve/migrate.py``): :meth:`Scheduler.export_parked` ships its prompt's
full blocks in the wire format, :meth:`Scheduler.ack_parked` releases
them once the destination holds its copy (:meth:`Scheduler.
install_migrated`), :meth:`Scheduler.resume_parked` decodes it here
instead, and a park nobody claims within ``parked_ttl_s`` is reclaimed.
:meth:`Scheduler.export_prefix` and :meth:`Scheduler.install_pulled` are
the peer pull's two ends: a read-only export of a cached prefix, and its
install tagged as a peer's. Every device op of these runs under the
scheduler's lock, so it never interleaves with a step's in-place pool
writes. ``migrations``, ``migration_bytes`` and ``pull_bytes`` count
committed installs and their wire bytes. :meth:`Scheduler.
cancel_remaining` retires everything at a drain's cutoff, and
:meth:`Scheduler.fleet_digest` is the ``/healthz`` digest of the pool's
cached prefixes.

The ``serve.*`` instruments of JAX's scheduler count beside the plain
attributes (:func:`register_serve_instruments` pre-registers them all),
and a request's ``trace_id`` (minted here when no router minted one)
carries its lifecycle spans: ``serve.queue_wait``, ``serve.prefill``,
``serve.decode_window``, ``serve.decode``, ``serve.park``,
``serve.kv_export``. The wire's fault points are ``replica.kv_export`` and
``replica.kv_install``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.serve import fleetcache
from nezha_tpu_torch.serve.engine import PRIORITY_CLASSES, Engine
from nezha_tpu_torch.serve.migrate import MigrationError, encode_wire
from nezha_tpu_torch.serve.slots import KVBlocksExhausted


class QueueFull(Exception):
    """Admission queue at capacity — the backpressure signal."""


class TenantOverLimit(QueueFull):
    """One tenant's queued requests reached ``tenant_queue_cap``: the
    per-tenant backpressure signal (a :class:`QueueFull`, so a handler of
    that still sheds it)."""


# Priority classes, highest first.
PRIORITIES = PRIORITY_CLASSES
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}

# The default admission-grant split under full backlog: per 7 grants, 4
# interactive, 2 batch, 1 background.
_DEFAULT_WEIGHTS = (("interactive", 4), ("batch", 2), ("background", 1))

# Per-token decode latencies a Scheduler keeps (the newest), beside the
# ``serve.tpot_s`` histogram.
TPOT_SAMPLES = 4096

# How long a step stands aside after releasing the scheduler's lock when
# another thread waits on it (see _YieldingLock); 0 turns it off.
YIELD_S = 0.0005


class _YieldingLock:
    """The scheduler's re-entrant lock, counting the threads blocked on
    it. A lock is not fair: the decode loop, which takes it again the
    moment a step releases it, would win that race every time, and a
    ``submit`` (or a ``/healthz`` probe, a migration endpoint) from a
    handler thread would wait until the loop went idle, so that requests
    were admitted one after another instead of batched. ``step`` sleeps
    :data:`YIELD_S` after its release while ``waiting`` is non-zero."""

    def __init__(self):
        self._lock = threading.RLock()
        self._count = threading.Lock()
        self.waiting = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(blocking=False):
            return True
        if not blocking:
            return False
        with self._count:
            self.waiting += 1
        try:
            return self._lock.acquire(True, timeout)
        finally:
            with self._count:
                self.waiting -= 1

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "_YieldingLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class FinishReason:
    EOS = "eos"
    LENGTH = "length"          # max_new_tokens reached
    DEADLINE = "deadline"      # expired: queued, suspended, mid-decode or
                               # at a drain's cutoff
    ERROR = "error"            # prefill failure, non-finite logits, or no
                               # KV blocks — only this request is retired
    PREFILLED = "prefilled"    # prefill_only: prompt KV computed and
                               # parked for a migration, not an end state


@dataclasses.dataclass
class Request:
    """One generation request; ``deadline_s`` is a wall-clock budget in
    seconds from submit, ``priority`` its WFQ lane (one of
    :data:`PRIORITIES`) and ``tenant_id`` the tenant whose fair share and
    queue cap it counts against. ``prefill_only`` prefills the prompt and
    parks the slot for a migration instead of decoding. ``trace_id``: a
    router-minted id is kept, ``""`` means routed and sampled out, None
    lets this scheduler mint one."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    seed: int = 0
    deadline_s: Optional[float] = None
    request_id: Optional[str] = None
    prefill_only: bool = False
    priority: str = "interactive"
    tenant_id: str = "default"
    trace_id: Optional[str] = None


@dataclasses.dataclass
class RequestResult:
    request_id: str
    tokens: List[int]
    finish_reason: str
    ttft_s: Optional[float]    # None when it ended before a first token
    latency_s: float
    error: Optional[str] = None


@dataclasses.dataclass
class _Live:
    req: Request
    request_id: str
    submit_t: float
    deadline_t: Optional[float]
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    # Tracing state (None for untraced requests): the trace id and the
    # wall-clock milestones the lifecycle spans are emitted from (epoch
    # time: fragments from several processes stitch on one clock).
    trace_id: Optional[str] = None
    submit_wall: Optional[float] = None
    decode_t0_wall: Optional[float] = None
    first_token_wall: Optional[float] = None
    park_wall: Optional[float] = None
    preempt_count: int = 0


def register_serve_instruments() -> None:
    """Get-or-create JAX's whole serving instrument set, so that every
    serving run's summary carries every name (0 where nothing happened).
    Called at scheduler construction; again after a registry reset."""
    for c in ("admitted", "rejected", "expired", "retired", "tokens",
              "errors", "step_retries"):
        obs.counter(f"serve.{c}_total")
    obs.counter("serve.prefill.chunks_total")
    obs.gauge("serve.prefill.kernel_active")
    obs.counter("serve.prefill.fused_writes_total")
    obs.gauge("serve.prefill.seq_shards")
    obs.counter("serve.prefill.ring_hops_total")
    obs.counter("faults.injected_total")
    obs.counter("serve.kv.prefix_hits_total")
    obs.counter("serve.kv.cow_copies_total")
    obs.counter("serve.kv.migrations_total")
    obs.counter("serve.kv.migration_bytes")
    obs.gauge("serve.kv.blocks_used")
    obs.counter("serve.kv.demotions_total")
    obs.counter("serve.kv.promotions_total")
    obs.gauge("serve.kv.host_blocks_used")
    obs.gauge("serve.kv.host_bytes_resident")
    obs.counter("serve.kv.fleet_hits_total")
    obs.counter("serve.kv.fleet_hits_device_total")
    obs.counter("serve.kv.fleet_hits_host_total")
    obs.counter("serve.kv.fleet_hits_peer_total")
    obs.counter("serve.kv.pull_bytes")
    obs.gauge("serve.kv.bytes_resident")
    obs.gauge("serve.kv.quant_bits")
    obs.histogram("serve.kv.quant_error")
    obs.counter("serve.spec.draft_tokens_total")
    obs.counter("serve.spec.accepted_total")
    obs.histogram("serve.spec.accepted_len")
    obs.gauge("serve.mesh.devices")
    obs.counter("serve.mesh.collective_bytes")
    obs.gauge("serve.queue_depth")
    obs.gauge("serve.batch_occupancy")
    obs.histogram("serve.ttft_s")
    obs.histogram("serve.tpot_s")
    obs.counter("serve.preemptions_total")
    obs.counter("serve.resumes_total")
    obs.counter("serve.tenant_over_limit_total")
    obs.gauge("serve.preempted_live")
    for p in PRIORITIES:
        obs.histogram(f"serve.ttft_s.{p}")
    obs.histogram("serve.prefill.bucket_len")
    obs.histogram("serve.host_gap_s")
    obs.histogram("serve.decode.horizon")


class Scheduler:
    """Continuous batching over an :class:`Engine` with WFQ admission,
    tenant caps and preemption.

    ``on_token(request_id, token)`` streams each token and
    ``on_finish(result)`` fires at retirement, both on the thread driving
    :meth:`step`. ``submit`` is thread-safe. ``preemptions`` and
    ``resumes`` count suspensions and resumes; ``tpot_s`` holds the newest
    per-token decode latencies (a dispatch's time over the tokens it
    emitted the row, one sample a token)."""

    step_retry_backoff_s = 0.05

    # How long a parked (prefill_only) slot waits for its pull, ACK or
    # resume before the scheduler reclaims it: a destination that pulled
    # and died, or a lost ACK, costs the source at most this long.
    parked_ttl_s = 60.0

    # Cross-thread state and the lock that guards it: submit() and the
    # migration endpoints run on other threads than step().
    _LOCK_GUARDED = {"_lanes": "_lock", "_lane_vt": "_lock",
                     "_lane_rr": "_lock", "_queued_n": "_lock",
                     "_vt_now": "_lock", "_preempted": "_lock",
                     "preemptions": "_lock", "resumes": "_lock",
                     "_live": "_lock", "results": "_lock",
                     "_parked": "_lock", "migrations": "_lock",
                     "migration_bytes": "_lock", "pull_bytes": "_lock",
                     "_host_gap_t": "_lock", "_digest_cache": "_lock"}

    def __init__(self, engine: Engine,
                 on_token: Optional[Callable[[str, int], None]] = None,
                 on_finish: Optional[Callable[[RequestResult], None]] = None):
        self.engine = engine
        self.on_token = on_token
        self.on_finish = on_finish
        self.queue_capacity = engine.cfg.queue_capacity
        # WFQ state: lane -> tenant -> FIFO, each lane's virtual clock,
        # each lane's tenant ring (a tenant is in its lane and ring exactly
        # while its deque is non-empty), the queued count, and the clock
        # of the last grant (an idle lane re-enters at it).
        self._lanes: Dict[str, Dict[str, Deque[_Live]]] = {}
        self._lane_vt: Dict[str, float] = {}
        self._lane_rr: Dict[str, Deque[str]] = {}
        self._queued_n = 0
        self._vt_now = 0.0
        self._weights = dict(engine.cfg.priority_weights or _DEFAULT_WEIGHTS)
        # Suspended requests: request_id -> _Live (no slot held).
        self._preempted: Dict[str, _Live] = {}
        self.slo_tracker = None
        self.preemptions = 0
        self.resumes = 0
        self.tpot_s: Deque[float] = collections.deque(maxlen=TPOT_SAMPLES)
        self._live: Dict[int, _Live] = {}          # slot -> request state
        # Parked prefill_only requests: request_id -> (slot, live,
        # expires_t). Their slots hold the prompt's blocks and never
        # decode; step() reclaims them past the TTL.
        self._parked: Dict[str, tuple] = {}
        self.migrations = 0
        self.migration_bytes = 0
        self.pull_bytes = 0
        # The fleet digest, built at the first /healthz that asks.
        self._digest_cache = None
        self._lock = _YieldingLock()
        self._ids = itertools.count()
        self.results: Dict[str, RequestResult] = {}
        # End of the previous decode dispatch (None after an idle
        # stretch): serve.host_gap_s measures only gaps within decoding.
        self._host_gap_t: Optional[float] = None
        register_serve_instruments()
        pool = engine.pool
        obs.gauge("serve.kv.quant_bits").set(
            8 if getattr(pool, "quantized", False)
            else 8 * pool.dtype.itemsize)
        obs.gauge("serve.mesh.devices").set(
            getattr(engine, "mesh_devices", 1))

    # ------------------------------------------------------- admission
    def submit(self, req: Request) -> str:
        """Enqueue; -> the request id."""
        cfg = self.engine.cfg
        n = len(req.prompt)
        if n < 1:
            raise ValueError("prompt must be non-empty")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if n + req.max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt ({n}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds max_len {cfg.max_len}")
        if self.engine.paged:
            pool = self.engine.pool
            need = max(self.engine.prefill_blocks_needed(n),
                       pool.blocks_for_span(n + req.max_new_tokens))
            if need > pool.max_request_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks (block_size "
                    f"{pool.block_size}) but the pool can bind at most "
                    f"{pool.max_request_blocks} per request")
        vocab = self.engine.vocab
        if not all(0 <= int(t) < vocab for t in req.prompt):
            raise ValueError(f"prompt ids must be in [0, {vocab})")
        if req.priority not in _PRIORITY_RANK:
            raise ValueError(f"priority must be one of {PRIORITIES}, got "
                             f"{req.priority!r}")
        if not isinstance(req.tenant_id, str) or not req.tenant_id:
            raise ValueError(f"tenant_id must be a non-empty string, got "
                             f"{req.tenant_id!r}")
        # A router-minted id is kept; "" is the router's sampled-out
        # verdict (never re-minted here); None makes this the admission
        # edge that mints.
        if req.trace_id == "":
            trace_id = None
        elif req.trace_id is not None:
            trace_id = req.trace_id
        else:
            trace_id = obs.mint_trace_id()
        with self._lock:
            if self._queued_n >= self.queue_capacity:
                obs.counter("serve.rejected_total").inc()
                raise QueueFull(
                    f"admission queue at capacity {self.queue_capacity}")
            cap = cfg.tenant_queue_cap
            if cap is not None and self._tenant_depth(req.tenant_id) >= cap:
                obs.counter("serve.tenant_over_limit_total").inc()
                obs.counter("serve.rejected_total").inc()
                raise TenantOverLimit(
                    f"tenant {req.tenant_id!r} at queue cap {cap}")
            rid = req.request_id or f"req-{next(self._ids)}"
            now = time.monotonic()
            self._queue_push(_Live(
                req=req, request_id=rid, submit_t=now,
                deadline_t=None if req.deadline_s is None
                else now + req.deadline_s,
                trace_id=trace_id,
                submit_wall=time.time() if trace_id else None))
            obs.gauge("serve.queue_depth").set(self._queued_n)
        return rid

    # ------------------------------------------------------- iteration
    def step(self) -> int:
        """One serving iteration. -> tokens decoded (0 when idle)."""
        with self._lock:
            self._expire_queued()
            self._expire_parked()
            self._expire_preempted()
            self._admit()
            if self._live:
                emitted = self._decode()
            else:
                emitted = 0
                self._host_gap_t = None     # idle: no gap to measure
            self._admit()
            pool = self.engine.pool
            obs.gauge("serve.queue_depth").set(self._queued_n)
            obs.gauge("serve.batch_occupancy").set(pool.occupancy)
            obs.gauge("serve.kv.blocks_used").set(pool.blocks_used)
            obs.gauge("serve.kv.bytes_resident").set(pool.bytes_resident)
            obs.gauge("serve.kv.host_blocks_used").set(
                getattr(pool, "host_blocks_used", 0))
            obs.gauge("serve.kv.host_bytes_resident").set(
                getattr(pool, "host_bytes_resident", 0))
        if YIELD_S and self._lock.waiting:
            time.sleep(YIELD_S)
        return emitted

    def run_until_idle(self, max_iters: Optional[int] = None) -> int:
        """Drive :meth:`step` until queue and slots are empty. -> iters."""
        iters = 0
        while self.has_work():
            self.step()
            iters += 1
            if max_iters is not None and iters >= max_iters:
                break
        return iters

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queued_n or self._live or self._preempted)

    @property
    def queue_depth(self) -> int:
        """Queued requests, all lanes and tenants."""
        with self._lock:
            return self._queued_n

    @property
    def parked_count(self) -> int:
        """Requests parked for a KV migration."""
        with self._lock:
            return len(self._parked)

    @property
    def preempted_count(self) -> int:
        with self._lock:
            return len(self._preempted)

    def tenant_queue_depths(self) -> Dict[str, int]:
        """Queued requests by tenant, across lanes (empty when nothing is
        queued)."""
        with self._lock:
            out: Dict[str, int] = {}
            for lane in self._lanes.values():
                for tenant, dq in lane.items():
                    out[tenant] = out.get(tenant, 0) + len(dq)
            return out

    # ----------------------------------------------- WFQ queue plumbing
    def _tenant_depth(self, tenant: str) -> int:
        """[holds: _lock]"""
        return sum(len(lane[tenant]) for lane in self._lanes.values()
                   if tenant in lane)

    def _queue_push(self, live: _Live) -> None:
        """[holds: _lock]"""
        pri, tenant = live.req.priority, live.req.tenant_id
        lane = self._lanes.setdefault(pri, {})
        if not lane:
            # An idle lane re-enters at the current virtual time: it earned
            # no credit while empty.
            self._lane_vt[pri] = max(self._lane_vt.get(pri, 0.0),
                                     self._vt_now)
        dq = lane.get(tenant)
        if dq is None:
            lane[tenant] = dq = collections.deque()
            self._lane_rr.setdefault(pri, collections.deque()).append(tenant)
        dq.append(live)
        self._queued_n += 1

    def _pick_lane(self) -> Optional[str]:
        """[holds: _lock] The non-empty lane with the smallest virtual
        time; priority order breaks ties."""
        best = None
        for pri in PRIORITIES:
            if pri not in self._lanes:
                continue
            vt = self._lane_vt.get(pri, 0.0)
            if best is None or vt < best[0]:
                best = (vt, pri)
        return None if best is None else best[1]

    def _peek_next(self) -> Optional[_Live]:
        """[holds: _lock] The request :meth:`_pop_next` would grant."""
        pri = self._pick_lane()
        if pri is None:
            return None
        return self._lanes[pri][self._lane_rr[pri][0]][0]

    def _pop_next(self) -> Optional[_Live]:
        """[holds: _lock] Grant one admission: pop the pick, advance its
        lane's clock by 1/weight, rotate the lane's tenant ring."""
        pri = self._pick_lane()
        if pri is None:
            return None
        ring = self._lane_rr[pri]
        tenant = ring[0]
        dq = self._lanes[pri][tenant]
        live = dq.popleft()
        self._queued_n -= 1
        ring.rotate(-1)
        if not dq:
            del self._lanes[pri][tenant]
            ring.remove(tenant)
            if not self._lanes[pri]:
                del self._lanes[pri]
                del self._lane_rr[pri]
        vt = self._lane_vt.get(pri, 0.0)
        self._vt_now = max(self._vt_now, vt)
        self._lane_vt[pri] = vt + 1.0 / self._weights[pri]
        return live

    # -------------------------------------------------------- internals
    def _expire_queued(self) -> None:
        """[holds: _lock]"""
        now = time.monotonic()
        for pri in list(self._lanes):
            lane = self._lanes[pri]
            ring = self._lane_rr[pri]
            for tenant in list(lane):
                kept: Deque[_Live] = collections.deque()
                for live in lane[tenant]:
                    if live.deadline_t is not None and now >= live.deadline_t:
                        obs.counter("serve.expired_total").inc()
                        self._finish(live, FinishReason.DEADLINE)
                        self._queued_n -= 1
                    else:
                        kept.append(live)
                if kept:
                    lane[tenant] = kept
                else:
                    del lane[tenant]
                    ring.remove(tenant)
            if not lane:
                del self._lanes[pri]
                del self._lane_rr[pri]

    def _expire_parked(self) -> None:
        """[holds: _lock] Reclaim parks past their TTL: their "prefilled"
        answer was delivered, so this only frees the slot and blocks."""
        now = time.monotonic()
        for rid in [r for r, (_, _, exp) in self._parked.items()
                    if now >= exp]:
            slot, live, _ = self._parked.pop(rid)
            self.engine.pool.free(slot)
            self._emit_park_span(live, "expired")
            obs.counter("serve.expired_total").inc()
            obs.counter("serve.retired_total").inc()

    def _expire_preempted(self) -> None:
        """[holds: _lock] A deadline keeps running while a request is
        suspended: it retires with the tokens it already has."""
        now = time.monotonic()
        expired = [r for r, live in self._preempted.items()
                   if live.deadline_t is not None and now >= live.deadline_t]
        for rid in expired:
            live = self._preempted.pop(rid)
            obs.counter("serve.expired_total").inc()
            obs.counter("serve.retired_total").inc()
            self._finish(live, FinishReason.DEADLINE)
        if expired:
            obs.gauge("serve.preempted_live").set(len(self._preempted))

    # ------------------------------------------------------- preemption
    def _peek_preempted(self) -> Optional[_Live]:
        """[holds: _lock] The suspended request to resume next: highest
        priority first, oldest submit within it."""
        if not self._preempted:
            return None
        return min(self._preempted.values(),
                   key=lambda live: (_PRIORITY_RANK[live.req.priority],
                                     live.submit_t, live.request_id))

    def _pop_preempted(self, request_id: str) -> _Live:
        """[holds: _lock]"""
        live = self._preempted.pop(request_id)
        obs.gauge("serve.preempted_live").set(len(self._preempted))
        return live

    def _slo_burning(self) -> bool:
        """[holds: _lock] True when the wired tracker burns its error
        budget faster than it earns it."""
        return (self.slo_tracker is not None
                and self.slo_tracker.burn_rate() > 1.0)

    def _maybe_preempt(self, target: _Live, already: int) -> bool:
        """[holds: _lock] Free capacity for ``target`` by suspending one
        live decode of strictly lower priority whose preemption budget is
        not spent: the lowest class first, the least progressed within
        it. One a pass (``already`` so far) unless the SLO is burning,
        then up to the whole batch. False when preemption is off, no
        victim qualifies or the ``scheduler.preempt`` point vetoed it."""
        cfg = self.engine.cfg
        if not cfg.preemption:
            return False
        if already >= (len(self._live) if self._slo_burning() else 1):
            return False
        rank = _PRIORITY_RANK[target.req.priority]
        victim = None
        for slot, live in self._live.items():
            if _PRIORITY_RANK[live.req.priority] <= rank:
                continue
            if live.preempt_count >= cfg.preemption_budget:
                continue
            key = (-_PRIORITY_RANK[live.req.priority], len(live.tokens), slot)
            if victim is None or key < victim[0]:
                victim = (key, slot, live)
        if victim is None:
            return False
        return self._preempt(victim[1], victim[2])

    def _preempt(self, slot: int, live: _Live) -> bool:
        """[holds: _lock] Suspend one live decode: on the paged layout
        with the prefix cache and LRU eviction, index its blocks (prompt
        and every emitted token) in the trie, where admission pressure may
        evict them; free the slot (and the draft pool's, through the
        mirror); park the request for resume. Elsewhere nothing is
        indexed and the resume re-prefills cold (trie references under
        ``kv_eviction="none"`` would pin blocks for good). An injected
        ``scheduler.preempt`` error leaves the victim decoding: -> False."""
        try:
            faults.point("scheduler.preempt")
        except Exception:
            return False
        pool = self.engine.pool
        with obs.span("serve.preempt_s", request_id=live.request_id,
                      priority=live.req.priority, tokens=len(live.tokens)):
            if (self.engine.paged and pool.prefix_cache_enabled
                    and pool.eviction == "lru"):
                pool.register_prefix(slot,
                                     list(live.req.prompt) + live.tokens)
            del self._live[slot]
            pool.free(slot)
        live.preempt_count += 1
        self._preempted[live.request_id] = live
        self.preemptions += 1
        obs.counter("serve.preemptions_total").inc()
        obs.gauge("serve.preempted_live").set(len(self._preempted))
        return True

    def _resume_one(self, live: _Live) -> None:
        """[holds: _lock] Re-admit a suspended request: prefill its
        context (prompt and emitted tokens) into a fresh slot with the
        remaining budget. A greedy stream continues as an uninterrupted
        run would; a prefill failure retires the request."""
        pool = self.engine.pool
        self._pop_preempted(live.request_id)
        slot = pool.alloc()
        req = live.req
        context = list(req.prompt) + live.tokens
        try:
            with obs.trace_context(live.trace_id):
                with obs.span("serve.prefill", request_id=live.request_id,
                              prompt_len=len(context), resumed=True):
                    self.engine.prefill(
                        slot, context, seed=req.seed,
                        temperature=req.temperature, top_k=req.top_k,
                        top_p=req.top_p, eos_id=req.eos_id,
                        max_new_tokens=req.max_new_tokens - len(live.tokens))
        except Exception as e:
            pool.free(slot)
            obs.counter("serve.errors_total").inc()
            # Admitted once already: balance it with a retirement.
            obs.counter("serve.retired_total").inc()
            self._finish(live, FinishReason.ERROR,
                         error=f"resume prefill failed: "
                               f"{type(e).__name__}: {e}")
            return
        self.resumes += 1
        obs.counter("serve.resumes_total").inc()
        if live.trace_id is not None:
            live.decode_t0_wall = time.time()
        self._live[slot] = live

    def _admit(self) -> None:
        """[holds: _lock] One admission pass: grant free slots to the WFQ
        pick among queued requests and the suspended ones (a suspended
        request outranks a queued pick of equal or lower priority),
        preempting a lower-priority decode when the pick finds no slot or
        no blocks. On the paged layout a pick waits while its worst-case
        (no prefix hit) prefill exceeds the free plus reclaimable blocks;
        if nothing in flight will ever free one, it retires with a typed
        error instead of waiting forever."""
        pool = self.engine.pool
        preempts = 0
        while True:
            cand = self._peek_next()
            pre = self._peek_preempted()
            use_pre = pre is not None and (
                cand is None or _PRIORITY_RANK[pre.req.priority]
                <= _PRIORITY_RANK[cand.req.priority])
            target = pre if use_pre else cand
            if target is None:
                break
            if not pool.num_free:
                if not self._maybe_preempt(target, preempts):
                    break
                preempts += 1
                continue
            if self.engine.paged:
                ctx = len(target.req.prompt) + (len(target.tokens)
                                                if use_pre else 0)
                need = self.engine.prefill_blocks_needed(ctx)
                if pool.available_blocks() < need:
                    if self._maybe_preempt(target, preempts):
                        preempts += 1
                        continue
                    if not self._live:
                        if use_pre:
                            self._pop_preempted(target.request_id)
                            obs.counter("serve.retired_total").inc()
                        else:
                            self._pop_next()
                        obs.counter("serve.errors_total").inc()
                        self._finish(
                            target, FinishReason.ERROR,
                            error=f"kv blocks exhausted: need {need}, "
                                  f"{pool.available_blocks()} reclaimable")
                        continue
                    break
            if use_pre:
                self._resume_one(target)
            else:
                self._admit_one(self._pop_next())

    def _admit_one(self, live: _Live) -> None:
        """[holds: _lock]"""
        pool = self.engine.pool
        slot = pool.alloc()
        req = live.req
        if live.trace_id is not None:
            # Queue wait is known only now (submit -> this admission).
            obs.emit_span("serve.queue_wait", live.submit_wall, time.time(),
                          trace_id=live.trace_id,
                          request_id=live.request_id)
        try:
            # The trace context gives serve.prefill and the engine's
            # serve.prefill.chunk spans the request's trace id.
            with obs.trace_context(live.trace_id):
                with obs.span("serve.prefill", request_id=live.request_id,
                              prompt_len=len(req.prompt)):
                    self.engine.prefill(
                        slot, req.prompt, seed=req.seed,
                        temperature=req.temperature, top_k=req.top_k,
                        top_p=req.top_p, eos_id=req.eos_id,
                        max_new_tokens=req.max_new_tokens)
        except Exception as e:
            # One bad request must not kill the loop with others in
            # flight: free its slot, retire it, keep admitting.
            pool.free(slot)
            obs.counter("serve.errors_total").inc()
            self._finish(live, FinishReason.ERROR,
                         error=f"prefill failed: {type(e).__name__}: {e}")
            return
        obs.counter("serve.admitted_total").inc()
        if req.prefill_only:
            # Park the prefilled slot for the migration pull instead of
            # decoding. A duplicate id would orphan the first park's slot.
            if live.request_id in self._parked:
                pool.free(slot)
                obs.counter("serve.errors_total").inc()
                self._finish(live, FinishReason.ERROR,
                             error=f"request {live.request_id!r} "
                                   f"already parked")
                return
            if live.trace_id is not None:
                live.park_wall = time.time()
            self._parked[live.request_id] = (
                slot, live, time.monotonic() + self.parked_ttl_s)
            self._finish(live, FinishReason.PREFILLED)
            return
        if live.trace_id is not None:
            live.decode_t0_wall = time.time()
        self._live[slot] = live

    def _dispatch(self, active: np.ndarray):
        """[holds: _lock] ``engine.step`` with block exhaustion as
        backpressure: retire the row that could not grow, free its blocks,
        re-dispatch the rest. None when that retired every row."""
        while True:
            try:
                return self.engine.step(active)
            except KVBlocksExhausted as e:
                slot = e.slot
                if slot is None or slot not in self._live:
                    raise
                victim = self._live.pop(slot)
                self.engine.pool.free(slot)
                active[slot] = False
                obs.counter("serve.errors_total").inc()
                obs.counter("serve.retired_total").inc()
                self._finish(victim, FinishReason.ERROR,
                             error=f"kv blocks exhausted: {e}")
                if not self._live:
                    return None

    def _decode(self) -> int:
        """[holds: _lock]"""
        horizon = self.engine.cfg.decode_horizon
        speculative = self.engine.spec is not None
        active = np.zeros((self.engine.cfg.max_batch_size,), bool)
        for slot in self._live:
            active[slot] = True
        obs.histogram("metric.batch_occupancy").observe(
            len(self._live) / self.engine.cfg.max_batch_size)
        # The wall clock is read only when a traced request is in the
        # batch: its decode_window span and first-token milestone.
        traced_batch = obs.enabled() and any(
            live.trace_id is not None for live in self._live.values())
        t0_wall = time.time() if traced_batch else None
        t0 = time.monotonic()
        if self._host_gap_t is not None:
            obs.histogram("serve.host_gap_s").observe(t0 - self._host_gap_t)
        with obs.span("serve.decode_attention", rows=len(self._live)):
            try:
                out = self._dispatch(active)
            except Exception:
                # One bounded retry: a transient step failure must not
                # retire every request; a second failure surfaces.
                obs.counter("serve.step_retries_total").inc()
                time.sleep(self.step_retry_backoff_s)
                out = self._dispatch(active)
        if out is None:
            self._host_gap_t = None
            return 0
        tokens, block_emitted = out
        now = time.monotonic()
        dt = now - t0
        now_wall = time.time() if traced_batch else None
        self._host_gap_t = now
        obs.histogram("serve.decode.horizon").observe(
            self.engine.tokens_per_dispatch)
        ok = self.engine.step_ok
        emitted = 0
        for slot in list(self._live):
            live = self._live[slot]
            e = int(block_emitted[slot])
            if live.trace_id is not None and t0_wall is not None and e:
                obs.emit_span("serve.decode_window", t0_wall, now_wall,
                              trace_id=live.trace_id,
                              request_id=live.request_id, tokens=e)
            reason = None
            for i in range(e):
                tok = int(tokens[slot, i])
                live.tokens.append(tok)
                emitted += 1
                if live.ttft_s is None:
                    # The first token lands at its place within the block:
                    # its step of the horizon, or, speculative, its place
                    # among the row's emitted tokens.
                    denom = e if speculative else horizon
                    live.ttft_s = (t0 - live.submit_t) + dt * (i + 1) / denom
                    if live.trace_id is not None and t0_wall is not None:
                        live.first_token_wall = (t0_wall
                                                 + dt * (i + 1) / denom)
                    obs.histogram("serve.ttft_s").observe(live.ttft_s)
                    obs.histogram(
                        f"serve.ttft_s.{live.req.priority}").observe(
                            live.ttft_s)
                    if (self.slo_tracker is not None
                            and live.req.priority == "interactive"):
                        self._feed_slo(live.ttft_s)
                # The block's time split over the tokens it emitted the
                # row, one sample a token.
                self.tpot_s.append(dt / e)
                obs.histogram("serve.tpot_s").observe(dt / e)
                if self.on_token is not None:
                    self.on_token(live.request_id, tok)
                if live.req.eos_id is not None and tok == live.req.eos_id:
                    reason = FinishReason.EOS
                elif len(live.tokens) >= live.req.max_new_tokens:
                    reason = FinishReason.LENGTH
                elif live.deadline_t is not None and now >= live.deadline_t:
                    reason = FinishReason.DEADLINE
                if reason is not None:
                    break
            error = None
            if reason is None and ok is not None and not ok[slot]:
                reason, error = FinishReason.ERROR, "non-finite logits"
            if reason is not None:
                del self._live[slot]
                self.engine.pool.free(slot)
                if reason == FinishReason.ERROR:
                    obs.counter("serve.errors_total").inc()
                elif reason == FinishReason.DEADLINE:
                    obs.counter("serve.expired_total").inc()
                obs.counter("serve.retired_total").inc()
                self._finish(live, reason, error=error)
        obs.counter("serve.tokens_total").inc(emitted)
        if not self._live:
            # The next decode waits for new admissions: a gap measured
            # across that wait would be idle time.
            self._host_gap_t = None
        return emitted

    def _feed_slo(self, ttft_s: float) -> None:
        """[holds: _lock] One interactive first token into the wired TTFT
        tracker, judged against its spec's bound."""
        cfg = self.slo_tracker.cfg
        good = {"<": ttft_s < cfg.threshold, "<=": ttft_s <= cfg.threshold,
                ">": ttft_s > cfg.threshold,
                ">=": ttft_s >= cfg.threshold}[cfg.op]
        self.slo_tracker.observe(good)

    def _finish(self, live: _Live, reason: str,
                error: Optional[str] = None) -> None:
        """[holds: _lock]"""
        if live.trace_id is not None and live.decode_t0_wall is not None:
            # The retire fragment: the whole decode residency, with the
            # first-token milestone.
            attrs = {"request_id": live.request_id, "finish_reason": reason,
                     "tokens": len(live.tokens)}
            if live.ttft_s is not None:
                attrs["ttft_s"] = live.ttft_s
            if live.first_token_wall is not None:
                attrs["first_token"] = live.first_token_wall
            obs.emit_span("serve.decode", live.decode_t0_wall, time.time(),
                          trace_id=live.trace_id, **attrs)
        result = RequestResult(
            request_id=live.request_id, tokens=live.tokens,
            finish_reason=reason, ttft_s=live.ttft_s,
            latency_s=time.monotonic() - live.submit_t, error=error)
        self.results[live.request_id] = result
        if self.on_finish is not None:
            self.on_finish(result)

    def _emit_park_span(self, live: _Live, outcome: str) -> None:
        """[holds: _lock] One ``serve.park`` fragment per traced park, at
        its release (acked, resumed, expired or drained)."""
        if live.trace_id is None or live.park_wall is None:
            return
        obs.emit_span("serve.park", live.park_wall, time.time(),
                      trace_id=live.trace_id, request_id=live.request_id,
                      outcome=outcome)

    # ------------------------------------------------------- migration
    def _device(self):
        """The pool device as a context for the calling thread: handler
        threads run the wire's device ops on the engine's card."""
        dev = self.engine.device
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _paged_only(self, what: str, kind: str = "migration_failed"):
        if not self.engine.paged:
            raise MigrationError(
                f"kv_layout 'dense' {what} — migration requires the paged "
                f"pool", kind=kind)

    def export_parked(self, request_id: str) -> dict:
        """The source half of the migration pull (``/kv_export``): the
        parked request's full-block prompt prefix as the wire object
        (``serve/migrate.py``). Read-only: the parked references stay
        until :meth:`ack_parked` or the TTL. Raises ``KeyError`` for an
        unknown park and :class:`~nezha_tpu_torch.serve.migrate.
        MigrationError` on a dense engine. A speculative engine ships its
        target pool only (the destination prefills its own draft)."""
        faults.point("replica.kv_export")
        with self._lock, self._device():
            if request_id not in self._parked:
                raise KeyError(request_id)
            slot, live, _ = self._parked[request_id]
            # The export fragment carries the parked request's trace.
            with obs.trace_context(live.trace_id):
                with obs.traced_span("serve.kv_export",
                                     request_id=request_id) as sp:
                    self._paged_only("has no blocks to export")
                    pool = self.engine.pool
                    tokens = [int(t) for t in live.req.prompt]
                    nfull = min(len(tokens) // pool.block_size,
                                int(pool._bound[slot]))
                    if nfull == 0:
                        # A sub-block prompt ships nothing: a legal empty
                        # wire.
                        return encode_wire([], [], pool.block_size)
                    layers, _ = pool.export_block_payload(slot, nfull)
                    wire = encode_wire(tokens[:nfull * pool.block_size],
                                       layers, pool.block_size)
                    sp.set(blocks=nfull, bytes=wire["nbytes"])
                    return wire

    def ack_parked(self, request_id: str) -> bool:
        """The commit of the two-phase handoff (``/kv_ack``): free the
        parked slot and its blocks (and, speculative, the draft pool's
        slot through the mirror). -> False, idempotently, for an unknown
        park (acked already, expired or drained)."""
        with self._lock:
            parked = self._parked.pop(request_id, None)
            if parked is None:
                return False
            slot, live, _ = parked
            self.engine.pool.free(slot)
            self._emit_park_span(live, "acked")
            obs.counter("serve.retired_total").inc()
            return True

    def resume_parked(self, request_id: str) -> bool:
        """Decode a parked request HERE (the local fallback): its prompt
        K/V is already in this pool. -> False for an unknown park."""
        with self._lock:
            parked = self._parked.pop(request_id, None)
            if parked is None:
                return False
            slot, live, _ = parked
            self._emit_park_span(live, "resumed")
            if live.trace_id is not None:
                live.decode_t0_wall = time.time()
            # The "prefilled" result was the park's receipt, not the
            # request's answer.
            self.results.pop(request_id, None)
            self._live[slot] = live
            return True

    def install_migrated(self, tokens: Sequence[int], layers: list,
                         nbytes: int) -> int:
        """The destination half of the pull: install a decoded wire
        payload into this pool's prefix cache (fresh blocks at ref 1); a
        request submitted afterwards binds them as a prefix hit. Counts
        committed installs (blocks newly cached) in ``migrations`` and
        ``migration_bytes`` (and ``serve.kv.migrations_total``,
        ``serve.kv.migration_bytes``). -> blocks installed."""
        faults.point("replica.kv_install")
        with self._lock, self._device():
            self._paged_only("cannot install migrated blocks")
            installed = self.engine.pool.install_block_payload(tokens,
                                                               layers)
            if installed > 0:
                self.migrations += 1
                self.migration_bytes += int(nbytes)
                obs.counter("serve.kv.migrations_total").inc()
                obs.counter("serve.kv.migration_bytes").inc(nbytes)
            return installed

    # ----------------------------------------------------- fleet cache
    def fleet_digest(self, interval_s: float = 2.0,
                     max_entries: int = 256) -> dict:
        """The ``/healthz`` digest payload: a bounded prefix-hash summary
        of what this pool holds, rebuilt at most once per ``interval_s``
        (``serve/fleetcache``). A dense pool reports ``digest_size`` 0 and
        no ``fleet_digest``."""
        with self._lock:
            if not self.engine.paged:
                return {"digest_size": 0, "digest_age_s": 0.0}
            dc = self._digest_cache
            if (dc is None or dc.interval_s != float(interval_s)
                    or dc.max_entries != int(max_entries)):
                dc = fleetcache.DigestCache(interval_s, max_entries)
                self._digest_cache = dc
            return dc.payload(self.engine.pool)

    def export_prefix(self, tokens: Sequence[int]) -> dict:
        """The source half of a PEER pull (``/kv_export`` tokens mode):
        the longest cached full-block prefix of ``tokens`` (device trie
        and host tier) as the wire object; no park, no ACK, read-only. No
        coverage is a legal empty wire."""
        with self._lock, self._device():
            self._paged_only("has no blocks to export", "kv_pull_failed")
            pool = self.engine.pool
            covered, layers, _ = pool.export_prefix_payload(tokens)
            return encode_wire(covered, layers, pool.block_size)

    def install_pulled(self, tokens: Sequence[int], layers: list,
                       nbytes: int) -> int:
        """The destination half of a peer pull: install with the blocks
        tagged ``origin="peer"``, the wire bytes counted in
        ``pull_bytes`` (not the migration counters). -> blocks
        installed."""
        with self._lock, self._device():
            self._paged_only("cannot install pulled blocks",
                             "kv_pull_failed")
            installed = self.engine.pool.install_block_payload(
                tokens, layers, origin="peer")
            if installed > 0:
                self.pull_bytes += int(nbytes)
                obs.counter("serve.kv.pull_bytes").inc(nbytes)
            return installed

    # ----------------------------------------------------------- drain
    def cancel_remaining(self, reason: str = FinishReason.DEADLINE,
                         error: Optional[str] = None) -> int:
        """Retire everything queued, live or suspended with ``reason`` and
        the tokens it has, free every slot, and release every park (whose
        "prefilled" answer was delivered already; a drained source is no
        longer pullable). -> requests cancelled (parks not counted)."""
        def count():
            if reason == FinishReason.DEADLINE:
                obs.counter("serve.expired_total").inc()
            elif reason == FinishReason.ERROR:
                obs.counter("serve.errors_total").inc()

        with self._lock:
            n = 0
            while self._queued_n:
                live = self._pop_next()
                count()
                self._finish(live, reason, error=error)
                n += 1
            for slot in list(self._live):
                live = self._live.pop(slot)
                self.engine.pool.free(slot)
                obs.counter("serve.retired_total").inc()
                count()
                self._finish(live, reason, error=error)
                n += 1
            for rid in list(self._preempted):
                live = self._preempted.pop(rid)
                obs.counter("serve.retired_total").inc()
                count()
                self._finish(live, reason, error=error)
                n += 1
            obs.gauge("serve.preempted_live").set(0)
            for rid in list(self._parked):
                slot, parked_live, _ = self._parked.pop(rid)
                self.engine.pool.free(slot)
                self._emit_park_span(parked_live, "drained")
                obs.counter("serve.retired_total").inc()
            pool = self.engine.pool
            obs.gauge("serve.queue_depth").set(0)
            obs.gauge("serve.batch_occupancy").set(pool.occupancy)
            obs.gauge("serve.kv.blocks_used").set(pool.blocks_used)
            return n
