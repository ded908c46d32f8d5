"""Process-wide telemetry registry: counters, gauges, histograms, spans.

The observability layer the metrics of record hang off (tokens/s,
time to first token, queue depth, the KV pool's occupancy): call sites
across serve/ stay permanently instrumented, and the whole layer
collapses to near-zero cost when no run is active. The fast-path
contract is explicit: with telemetry disabled, ``counter().inc()`` /
``gauge().set()`` / ``histogram().observe()`` are a single attribute
check and ``span()`` returns one shared no-op singleton — no per-call
host allocation, no I/O.

Instruments are process-wide and keyed by name (get-or-create), so
independent subsystems accumulate into one snapshot without plumbing a
registry handle through every constructor. A run-scoped sink
(``obs.sink.start_run``) enables the registry and streams spans/metrics to
a ``--run-dir``; ``snapshot()`` renders everything into the
``summary.json`` schema (the telemetry schema checker).
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

# One mutable cell shared by every instrument: ``enabled`` is THE fast-path
# check. Instruments cache a reference to this object, so toggling it flips
# every existing counter/gauge/span site at once. ``windows`` is the
# optional rolling-window tap (obs/timeseries.WindowStore): it lives
# INSIDE the enabled branch, so the disabled fast path stays a single
# attribute check whether or not windows were ever installed.


class _State:
    __slots__ = ("enabled", "windows")

    def __init__(self):
        self.enabled = False
        self.windows = None


_state = _State()


def enabled() -> bool:
    return _state.enabled


# --------------------------------------------------------- trace context
# Distributed request tracing: a request admitted anywhere in the fleet
# carries one ``trace_id`` across processes (router -> prefill replica ->
# migration -> decode replica), and every span recorded while the ambient
# trace context is set adopts it, so per-replica spans.jsonl fragments can
# be stitched back into one per-request timeline (obs/report.py). The
# context is a contextvar — it follows the handler thread that owns the
# request, never leaks across threads, and costs nothing while telemetry
# is disabled (``Registry.span`` short-circuits to NULL_SPAN before ever
# reading it).
_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "nezha_trace", default=None)          # (trace_id, parent_span_id)

# Sampling knob for load (the serve CLI's ``--trace-sample P``): minting
# rolls a seeded RNG once per request; a sampled-out request gets NO trace id,
# so none of its per-request spans are emitted — tracing cost scales with
# P, not with traffic.
_trace_lock = threading.Lock()
_trace_sample = 1.0
_trace_rng = random.Random(0x7ace)


def set_trace_sample(p: float) -> None:
    """Set the fraction of minted traces kept (0.0 disables minting
    entirely, 1.0 traces every request)."""
    global _trace_sample
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"trace sample must be in [0, 1], got {p}")
    with _trace_lock:
        _trace_sample = p


def trace_sample() -> float:
    return _trace_sample


def mint_trace_id() -> Optional[str]:
    """A fresh trace id for one request — or ``None`` when telemetry is
    disabled (the branch-only no-op contract: no run, no tracing) or the
    request lost the ``set_trace_sample`` coin flip. The minting site is
    the fleet's admission edge (the router; a router-less scheduler mints
    for itself at submit)."""
    if not _state.enabled:
        return None
    with _trace_lock:
        if _trace_sample <= 0.0:
            return None
        if _trace_sample < 1.0 and _trace_rng.random() >= _trace_sample:
            return None
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


#: The HTTP twin of the ``trace_id`` payload field — every serving
#: front end (replica, thread worker, router) honors the same pair.
TRACE_HEADER = "X-Nezha-Trace"


def adopt_trace_header(headers, payload) -> None:
    """Merge a ``TRACE_HEADER`` value into ``payload["trace_id"]`` —
    THE header-adoption rule, shared by every HTTP front end so the
    header/field precedence can never diverge between them. The header
    fills ``trace_id`` only when the payload doesn't already carry a
    non-empty one (the router sends both; either carries the trace).
    Non-dict payloads are left for the caller's validation to reject.
    """
    if not isinstance(payload, dict):
        return
    hdr = headers.get(TRACE_HEADER)
    if hdr and not payload.get("trace_id"):
        payload["trace_id"] = hdr


def current_trace() -> Tuple[Optional[str], Optional[str]]:
    """-> ``(trace_id, parent_span_id)`` of the ambient trace context
    (``(None, None)`` outside any)."""
    cur = _TRACE.get()
    return cur if cur is not None else (None, None)


@contextlib.contextmanager
def trace_context(trace_id: Optional[str],
                  parent_id: Optional[str] = None):
    """Run the enclosed block under ``trace_id``: every span opened (or
    ``emit_span``-recorded) inside adopts it. ``trace_id=None`` is a
    cheap no-op, so call sites can pass an unconditionally-threaded
    (possibly absent) id without branching."""
    if not trace_id:
        yield
        return
    token = _TRACE.set((trace_id, parent_id))
    try:
        yield
    finally:
        _TRACE.reset(token)


def percentile_of(sorted_values: List[float], q: float) -> float:
    """Index percentile over an ascending list (0.0 when empty) — the one
    percentile convention every telemetry surface shares (Histogram
    summaries, the report renderer, recomputed-stream summaries)."""
    if not sorted_values:
        return 0.0
    idx = min(int(q / 100.0 * len(sorted_values)), len(sorted_values) - 1)
    return sorted_values[idx]


def values_summary(values: List[float]) -> dict:
    """``Histogram.summary()``-shaped dict computed exactly from a full
    list of values (the recomputed-from-stream path, where no reservoir
    decimation is involved)."""
    s = sorted(values)
    total = sum(s)
    return {"count": len(s), "sum": total,
            "min": s[0] if s else 0.0, "max": s[-1] if s else 0.0,
            "mean": total / len(s) if s else 0.0,
            "p50": percentile_of(s, 50), "p90": percentile_of(s, 90),
            "p99": percentile_of(s, 99)}


class Counter:
    """Monotonic counter. ``inc`` is a no-op while telemetry is disabled."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if _state.enabled:
            self.value += n
            w = _state.windows
            if w is not None:
                w.record_counter(self.name, n)


class Gauge:
    """Last-value-wins instrument (queue depths, cache sizes)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        if _state.enabled:
            self.value = float(v)
            w = _state.windows
            if w is not None:
                w.record_gauge(self.name, self.value)


class Histogram:
    """Value distribution with streaming min/max/sum and a bounded sample
    RESERVOIR for percentiles (Vitter's Algorithm R): once the reservoir
    is full, observation ``n`` replaces a random slot with probability
    ``cap/n``, so at any point the samples are a uniform draw over the
    WHOLE stream so far — long-run percentiles are unbiased, unlike the
    old stride decimation whose kept set was anchored to the startup
    prefix of the stream. The replacement RNG is seeded from the
    instrument name, so a given observation stream always yields the same
    summary (reproducible captures)."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples",
                 "_rng", "_cap", "_lock")

    # observe() is a multi-field read-modify-write hit from concurrent
    # recorder threads (the reservoir RNG's stream advance included) —
    # declared for the lock-discipline lint.
    _LOCK_GUARDED = {"count": "_lock", "total": "_lock", "min": "_lock",
                     "max": "_lock", "_samples": "_lock",
                     "_rng": "_lock"}

    def __init__(self, name: str, cap: int = 4096):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []
        # crc32, not hash(): hash() is salted per process, and the
        # reservoir must decimate identically across runs of the same
        # stream for captures to be reproducible.
        self._rng = random.Random(zlib.crc32(name.encode("utf-8")))
        self._cap = cap
        # Per-instrument lock: observe() is a multi-field read-modify-write
        # (count/total/reservoir replacement) that concurrent recorders
        # (e.g. two Executor threads timing compiles) would corrupt.
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        if not _state.enabled:
            return
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._samples) < self._cap:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._samples[j] = v
        # Window tap outside the reservoir lock: the store has its own
        # lock, and nesting them would couple every histogram's hot path
        # to the rotation critical section.
        w = _state.windows
        if w is not None:
            w.record_histogram(self.name, v)

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            s = sorted(self._samples)
        return percentile_of(s, q) if s else None

    def summary(self) -> dict:
        # count/sum/min/max are exact streaming stats; only the percentiles
        # come from the (possibly decimated) reservoir.
        with self._lock:
            count, total = self.count, self.total
            mn, mx = self.min, self.max
            s = sorted(self._samples)
        return {
            "count": count,
            "sum": total,
            "min": mn if mn is not None else 0.0,
            "max": mx if mx is not None else 0.0,
            "mean": total / count if count else 0.0,
            "p50": percentile_of(s, 50),
            "p90": percentile_of(s, 90),
            "p99": percentile_of(s, 99),
        }


class _NullSpan:
    """The disabled-mode span: one shared instance, every method a no-op —
    ``with obs.span("x"):`` costs a dict-free call and two no-op methods."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()

# Bookkeeping fields whose distributions mean nothing (the step counter,
# the logger's wall-clock stamp): streamed to metrics.jsonl as-is but never
# folded into metric.<key> histograms. Shared with the recomputed-stream
# path (obs/report.py summarize_streams).
UNFOLDED_METRIC_KEYS = frozenset({"step", "ts"})


class Span:
    """Live wall-clock span; records itself into the registry on exit.

    A span opened inside a ``trace_context`` adopts the ambient trace:
    it carries ``trace_id`` / a fresh ``span_id`` / the ambient
    ``parent_id``, and while entered it IS the ambient parent, so nested
    spans chain. The trace fields ride in the span record only when a
    trace is present — untraced captures are byte-identical to the
    pre-tracing schema."""

    __slots__ = ("name", "attrs", "t0", "t1", "_registry",
                 "trace_id", "span_id", "parent_id", "_token")

    def __init__(self, name: str, registry: "Registry", attrs: dict,
                 trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None):
        self.name = name
        self.attrs = attrs
        self.t0 = time.time()
        self.t1: Optional[float] = None
        self._registry = registry
        self.trace_id = trace_id
        self.span_id = new_span_id() if trace_id else None
        self.parent_id = parent_id
        self._token = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        if self.trace_id:
            self._token = _TRACE.set((self.trace_id, self.span_id))
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if self._token is not None:
            _TRACE.reset(self._token)
            self._token = None
        self.t1 = time.time()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._registry.record_span(self.to_record())
        return False

    def to_record(self) -> dict:
        t1 = self.t1 if self.t1 is not None else time.time()
        rec = {"name": self.name, "t0": self.t0, "t1": t1,
               "dur_s": t1 - self.t0, "attrs": self.attrs}
        if self.trace_id:
            rec["trace_id"] = self.trace_id
            rec["span_id"] = self.span_id
            if self.parent_id:
                rec["parent_id"] = self.parent_id
        return rec


class Registry:
    """Named-instrument store + bounded span log. Thread-safe for
    get-or-create (instrument mutation itself is GIL-atomic enough for
    counters/gauges; histograms carry their own lock, spans take the
    registry's)."""

    # Get-or-create maps and the span/event logs, shared by every
    # recording thread — declared for the lock-discipline lint.
    _LOCK_GUARDED = {"_counters": "_lock", "_gauges": "_lock",
                     "_histograms": "_lock", "spans": "_lock",
                     "events": "_lock"}

    def __init__(self, max_spans: int = 10000, max_events: int = 1000):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.spans: List[dict] = []
        self.events: List[dict] = []
        self._max_spans = max_spans
        self._max_events = max_events
        self._sink = None  # RunSink streaming spans/metrics, when attached
        # Stable identity for fleet roll-up dedupe: thread-backend
        # replicas all answer /stats from THIS one process-wide
        # registry, and the router must sum each distinct registry once
        # — not once per member — for thread and process backends to
        # report the same fleet totals.
        self.registry_id = uuid.uuid4().hex[:16]

    # -------------------------------------------------- instrument access
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def span(self, name: str, **attrs):
        if not _state.enabled:
            return NULL_SPAN
        tid, parent = current_trace()
        return Span(name, self, attrs, trace_id=tid, parent_id=parent)

    def traced_span(self, name: str, **attrs):
        """A span recorded ONLY inside an ambient trace context — the
        per-request instrumentation form: a sampled-out (or untraced)
        request pays a single contextvar read and records nothing, so
        trace volume scales with the sample rate, not with traffic."""
        if not _state.enabled:
            return NULL_SPAN
        tid, parent = current_trace()
        if tid is None:
            return NULL_SPAN
        return Span(name, self, attrs, trace_id=tid, parent_id=parent)

    def emit_span(self, name: str, t0: float, t1: float,
                  trace_id: Optional[str] = None,
                  parent_id: Optional[str] = None, **attrs) -> None:
        """Record an already-measured interval as a span — the
        retroactive form lifecycle call sites use when the boundary
        times are only known after the fact (queue wait is measured at
        admission, a park's span at its release). No-op while telemetry
        is disabled."""
        if not _state.enabled:
            return
        rec = {"name": name, "t0": float(t0), "t1": float(t1),
               "dur_s": float(t1) - float(t0), "attrs": attrs}
        if trace_id:
            rec["trace_id"] = trace_id
            rec["span_id"] = new_span_id()
            if parent_id:
                rec["parent_id"] = parent_id
        self.record_span(rec)

    def record_span(self, rec: dict) -> None:
        if not _state.enabled:
            return
        with self._lock:
            if len(self.spans) < self._max_spans:
                self.spans.append(rec)
            sink = self._sink
        if sink is not None:
            sink.write_span(rec)

    def record_event(self, kind: str, severity: str = "info",
                     source: str = "watchdog", **detail) -> Optional[dict]:
        """Record a typed telemetry event (the watchdog/SLO stream):
        kept in a bounded in-process log and streamed to the run dir's
        ``events.jsonl`` when a sink is attached. Event kinds under the
        ``watchdog.``/``slo.`` namespaces are pinned by
        the telemetry schema (EVENT_KINDS). No-op while
        telemetry is disabled."""
        if not _state.enabled:
            return None
        rec = {"event_schema_version": 1, "ts": time.time(),
               "kind": kind, "severity": severity, "source": source,
               "detail": detail}
        with self._lock:
            if len(self.events) < self._max_events:
                self.events.append(rec)
            sink = self._sink
        if sink is not None:
            sink.write_event(rec)
        return rec

    def windows(self, duration_s: float, skip: int = 0) -> dict:
        """The rolled-up window view over the trailing ``duration_s``
        seconds (obs/timeseries.WindowStore.view shape). With no window
        store installed the empty view renders — zero buckets, no
        instruments — so exposition callers never branch on None.
        ``skip`` drops that many newest buckets (trailing baselines)."""
        w = _state.windows
        if w is None:
            from nezha_tpu_torch.obs.timeseries import empty_view
            return empty_view(duration_s)
        return w.view(duration_s, skip=skip)

    # --------------------------------------------------------- aggregates
    def record_metrics(self, step: int, metrics: Dict[str, Any]) -> None:
        """Route a per-step metrics dict to the attached sink and fold
        every numeric value into a ``metric.<key>`` histogram, so the
        summary carries percentiles (step-rate p50/p90/...) for free."""
        if not _state.enabled:
            return
        for k, v in metrics.items():
            if (k not in UNFOLDED_METRIC_KEYS
                    and isinstance(v, (int, float))
                    and not isinstance(v, bool)):
                self.histogram(f"metric.{k}").observe(v)
        sink = self._sink
        if sink is not None:
            sink.write_metrics(step, metrics)

    def record_collective(self, op: str, payload_bytes: int,
                          seconds: Optional[float] = None,
                          bus_bytes: Optional[float] = None) -> None:
        """Per-collective accounting (EQuARX's first-class metric): call
        count + payload bytes always; achieved bus bandwidth when the
        caller timed the op (benchmarks). Call sites inside a step count
        the payload the step moves per execution."""
        if not _state.enabled:
            return
        self.counter(f"collective.{op}.calls").inc()
        self.counter(f"collective.{op}.payload_bytes").inc(
            int(payload_bytes))
        if seconds is not None and seconds > 0 and bus_bytes is not None:
            self.histogram(f"collective.{op}.bus_gbps").observe(
                bus_bytes / seconds / 1e9)

    def snapshot(self) -> dict:
        """Everything, in the frozen summary.json shape (schema v1)."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = {k: h.summary() for k, h in self._histograms.items()}
            spans = list(self.spans)
        collectives: Dict[str, dict] = {}
        for name, value in counters.items():
            if not name.startswith("collective."):
                continue
            _, op, field = name.split(".", 2)
            collectives.setdefault(op, {})[field] = value
        for name, h in hists.items():
            if name.startswith("collective.") and name.endswith(".bus_gbps"):
                op = name.split(".", 2)[1]
                collectives.setdefault(op, {})["bus_gbps"] = h
        slowest = sorted(spans, key=lambda s: -s["dur_s"])[:10]
        return {
            "schema_version": 1,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "collectives": collectives,
            "compile_cache": {
                "hits": counters.get("compile_cache.hits", 0),
                "misses": counters.get("compile_cache.misses", 0),
                "compile_seconds": hists.get(
                    "compile_cache.compile_seconds",
                    {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                     "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}),
            },
            "num_spans": len(spans),
            "slowest_spans": slowest,
        }

    def stats(self) -> dict:
        """The live ``/stats`` payload (stats schema v1, pinned by
        the stats schema check): the registry's
        counters/gauges/histogram summaries RIGHT NOW, without touching
        (or requiring) a run dir — what a replica front end answers so
        an operator can curl the fleet mid-run. Spans are excluded: the
        live view is the aggregate state, traces are the run-dir
        artifact."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = list(self._histograms.values())
        return {"stats_schema_version": 1,
                "kind": "replica",
                "ts": time.time(),
                "enabled": _state.enabled,
                "registry_id": self.registry_id,
                "counters": counters,
                "gauges": gauges,
                "histograms": {h.name: h.summary() for h in hists}}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self.spans.clear()
            self.events.clear()


# The process-wide default registry and its module-level shorthands: the
# form instrumented call sites use (``obs.counter("x").inc()``).
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def span(name: str, **attrs):
    return REGISTRY.span(name, **attrs)


def traced_span(name: str, **attrs):
    return REGISTRY.traced_span(name, **attrs)


def emit_span(name: str, t0: float, t1: float,
              trace_id: Optional[str] = None,
              parent_id: Optional[str] = None, **attrs) -> None:
    REGISTRY.emit_span(name, t0, t1, trace_id=trace_id,
                       parent_id=parent_id, **attrs)


def stats_snapshot() -> dict:
    return REGISTRY.stats()


def record_metrics(step: int, metrics: Dict[str, Any]) -> None:
    REGISTRY.record_metrics(step, metrics)


def record_collective(op: str, payload_bytes: int,
                      seconds: Optional[float] = None,
                      bus_bytes: Optional[float] = None) -> None:
    REGISTRY.record_collective(op, payload_bytes, seconds, bus_bytes)


def record_event(kind: str, severity: str = "info",
                 source: str = "watchdog", **detail) -> Optional[dict]:
    return REGISTRY.record_event(kind, severity=severity, source=source,
                                 **detail)


def windows(duration_s: float, skip: int = 0) -> dict:
    return REGISTRY.windows(duration_s, skip=skip)


def enable() -> None:
    _state.enabled = True


def disable() -> None:
    _state.enabled = False
