"""Rolling time-series telemetry: window buckets, mergeable sketches,
and the Prometheus-style ``/metrics`` exposition.

The registry (obs/registry.py) answers "what happened since the run
started"; this module answers "what happened over the LAST 10/60/300
seconds" — the sensing layer SLO evaluation (obs/slo.py), the anomaly
watchdog (obs/watchdog.py), and fleet autoscaling consume. Design:

- **window buckets** — a :class:`WindowStore` holds a bounded ring of
  fixed-interval buckets (default 10s x 30 = 300s of history, O(buckets)
  memory regardless of traffic). Every instrument write while a store is
  installed also lands in the CURRENT bucket: counters accumulate a
  per-bucket delta (windows render them as RATES), gauges keep
  last/min/max, histogram observations stream into a per-bucket
  :class:`LogSketch`.
- **mergeable sketches** — histograms use log-spaced buckets (DDSketch
  style, arXiv:1908.10693): a value lands in bucket
  ``ceil(log_gamma(v))``, so merging two sketches is bucket-wise count
  addition and the merged quantile BOUNDS are byte-identical to one
  sketch fed the union stream. That is what makes both roll-ups exact:
  windows merge across TIME (10s buckets -> a 60s view) and replicas
  merge across SPACE (the router's fleet ``/metrics``) without the
  summed-percentile lie.
- **exposition** — :func:`render_prometheus` renders a registry's
  cumulative stats plus its window views in the Prometheus text format
  (names sanitized under the pinned ``nezha_`` prefix, window-labeled
  samples like ``nezha_serve_ttft_s{window="60s",quantile="p99"}``);
  :func:`parse_prometheus` reads it back (``nezha-top``, tests).

Install with :func:`~nezha_tpu_torch.obs.registry.install_windows` (done by
``start_run`` by default); ``Registry.windows(duration)`` returns the
rolled-up view. The disabled-telemetry fast path is untouched: window
taps sit INSIDE the ``_state.enabled`` branch, so a disabled process
still pays a single attribute check per instrument call.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from nezha_tpu_torch.obs import registry as _registry
# One percentile convention for every telemetry surface.
from nezha_tpu_torch.obs.registry import percentile_of  # noqa: F401

#: Relative-accuracy knob: bucket i covers (gamma^(i-1), gamma^i], so a
#: reported quantile bound is within a factor gamma of the true value
#: (~5% at the default). Sketches only merge at equal gamma.
DEFAULT_GAMMA = 1.05

#: The canonical roll-up durations (seconds) every exposition surface
#: labels its windows with — ``window="10s" | "60s" | "300s"``.
WINDOW_DURATIONS = (10, 60, 300)

_HIST_SUMMARY_ZERO = {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                      "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}


class LogSketch:
    """Mergeable log-bucket value sketch (count/sum/min/max exact).

    Not thread-safe on its own — the owning :class:`WindowStore`
    serializes writes under its lock."""

    __slots__ = ("gamma", "count", "total", "min", "max",
                 "zero", "buckets", "_ln_gamma")

    def __init__(self, gamma: float = DEFAULT_GAMMA):
        if gamma <= 1.0:
            raise ValueError(f"gamma must be > 1, got {gamma}")
        self.gamma = float(gamma)
        self._ln_gamma = math.log(self.gamma)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.zero = 0                      # count of values <= 0
        self.buckets: Dict[int, int] = {}  # log-bucket index -> count

    def _index(self, v: float) -> int:
        # Bucket i covers (gamma^(i-1), gamma^i]; the index depends only
        # on (v, gamma), so any split of one stream across sketches
        # lands every value in the same bucket — merge exactness.
        return math.ceil(math.log(v) / self._ln_gamma - 1e-12)

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if v <= 0.0:
            # Telemetry values are durations/sizes; <= 0 collapses into
            # one underflow bucket rather than a log() domain error.
            self.zero += 1
        else:
            i = self._index(v)
            self.buckets[i] = self.buckets.get(i, 0) + 1

    def merge(self, other: "LogSketch") -> None:
        """Fold ``other`` in: bucket-wise count addition — the merged
        sketch reports the same quantile bounds as one sketch fed the
        union stream (pinned by tests)."""
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with gamma {self.gamma} and "
                f"{other.gamma}")
        self.count += other.count
        self.total += other.total
        if other.min is not None and (self.min is None
                                      or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None
                                      or other.max > self.max):
            self.max = other.max
        self.zero += other.zero
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n

    def quantile(self, q: float) -> float:
        """Upper quantile BOUND at percentile ``q`` (index-percentile
        rank, the one convention every telemetry surface shares),
        clamped into the exact [min, max] envelope."""
        if self.count == 0:
            return 0.0
        rank = min(int(q / 100.0 * self.count), self.count - 1)
        out: Optional[float] = None
        seen = self.zero
        if rank < seen:
            out = min(self.min if self.min is not None else 0.0, 0.0)
        else:
            for i in sorted(self.buckets):
                seen += self.buckets[i]
                if rank < seen:
                    out = self.gamma ** i     # bucket upper bound
                    break
        if out is None:
            out = self.max if self.max is not None else 0.0
        # Clamp with the EXACT extrema: a bound can overshoot max by a
        # factor <= gamma, and clamping keeps merge exactness (merged
        # and union sketches share identical exact min/max).
        if self.max is not None:
            out = min(out, self.max)
        if self.min is not None:
            out = max(out, self.min)
        return out

    def summary(self) -> dict:
        """The ``Histogram.summary()`` shape (count/sum exact, min/max
        exact, percentiles = sketch bounds)."""
        if self.count == 0:
            return dict(_HIST_SUMMARY_ZERO)
        return {"count": self.count, "sum": self.total,
                "min": self.min if self.min is not None else 0.0,
                "max": self.max if self.max is not None else 0.0,
                "mean": self.total / self.count,
                "p50": self.quantile(50), "p90": self.quantile(90),
                "p99": self.quantile(99)}

    def to_dict(self) -> dict:
        return {"gamma": self.gamma, "count": self.count,
                "sum": self.total,
                "min": self.min, "max": self.max, "zero": self.zero,
                "buckets": {str(i): n for i, n in self.buckets.items()}}

    @classmethod
    def from_dict(cls, obj: dict) -> "LogSketch":
        sk = cls(gamma=float(obj.get("gamma", DEFAULT_GAMMA)))
        sk.count = int(obj.get("count", 0))
        sk.total = float(obj.get("sum", 0.0))
        sk.min = obj.get("min")
        sk.min = float(sk.min) if sk.min is not None else None
        sk.max = obj.get("max")
        sk.max = float(sk.max) if sk.max is not None else None
        sk.zero = int(obj.get("zero", 0))
        sk.buckets = {int(i): int(n)
                      for i, n in (obj.get("buckets") or {}).items()}
        return sk


class _Bucket:
    """One fixed-interval window: per-instrument counter deltas, gauge
    last/min/max triples, and histogram sketches."""

    __slots__ = ("index", "counters", "gauges", "sketches")

    def __init__(self, index: int):
        self.index = index
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, List[float]] = {}   # [last, min, max]
        self.sketches: Dict[str, LogSketch] = {}


class WindowStore:
    """Bounded ring of fixed-interval window buckets.

    One lock serializes the hot recording path AND bucket rotation, so
    a writer can never land an observation in a bucket the rotation is
    simultaneously dropping (pinned by the concurrent-writer test).
    Memory is O(num_buckets x live instruments) — independent of
    traffic volume."""

    # Every recorder thread mutates the ring and the per-bucket maps —
    # declared for the lock-discipline lint.
    _LOCK_GUARDED = {"_buckets": "_lock"}

    def __init__(self, interval_s: float = 10.0,
                 retention_s: float = 300.0,
                 clock: Callable[[], float] = time.time,
                 gamma: float = DEFAULT_GAMMA):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self.num_buckets = max(1, math.ceil(retention_s / interval_s))
        self.gamma = float(gamma)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: deque = deque(maxlen=self.num_buckets)

    def _bucket(self) -> _Bucket:
        """The CURRENT bucket, rotating the ring if the interval grid
        advanced. Caller holds ``_lock``.

        [holds: _lock]"""
        idx = int(self._clock() / self.interval_s)
        if self._buckets and self._buckets[-1].index >= idx:
            # Same interval — or a clock stumble backwards; recording
            # into the newest bucket keeps the ring monotone either way.
            return self._buckets[-1]
        b = _Bucket(idx)
        self._buckets.append(b)      # maxlen drops the oldest bucket
        return b

    # -------------------------------------------------- recording taps
    def record_counter(self, name: str, n: float) -> None:
        with self._lock:
            b = self._bucket()
            b.counters[name] = b.counters.get(name, 0) + n

    def record_gauge(self, name: str, v: float) -> None:
        with self._lock:
            b = self._bucket()
            cur = b.gauges.get(name)
            if cur is None:
                b.gauges[name] = [v, v, v]
            else:
                cur[0] = v
                if v < cur[1]:
                    cur[1] = v
                if v > cur[2]:
                    cur[2] = v

    def record_histogram(self, name: str, v: float) -> None:
        with self._lock:
            b = self._bucket()
            sk = b.sketches.get(name)
            if sk is None:
                sk = b.sketches[name] = LogSketch(gamma=self.gamma)
            sk.observe(v)

    # ----------------------------------------------------- rolled views
    def view(self, duration_s: float, skip: int = 0) -> dict:
        """Roll the last ``ceil(duration/interval)`` buckets up into one
        window view (the ``Registry.windows(duration)`` shape).
        ``skip`` drops that many NEWEST grid intervals first — the
        watchdog's trailing-baseline view excludes the window it
        compares against.
        """
        n = max(1, math.ceil(float(duration_s) / self.interval_s))
        with self._lock:
            ring = list(self._buckets)
        # Anchor the window to the CLOCK's interval grid, not to
        # whichever buckets happen to exist: on a sparse workload the
        # newest retained bucket can be far in the past, and "the last
        # 60s" must then be empty rather than resurrect it. ``skip``
        # therefore excludes the newest ``skip`` grid INTERVALS (not
        # buckets) — idle gaps count against the baseline too.
        hi = int(self._clock() / self.interval_s) - max(0, int(skip))
        lo = hi - n + 1
        picked = [b for b in ring if lo <= b.index <= hi]
        counters: Dict[str, float] = {}
        gauges: Dict[str, List[float]] = {}
        sketches: Dict[str, LogSketch] = {}
        for b in picked:
            for k, v in b.counters.items():
                counters[k] = counters.get(k, 0) + v
            for k, (last, mn, mx) in b.gauges.items():
                cur = gauges.get(k)
                if cur is None:
                    gauges[k] = [last, mn, mx]
                else:
                    cur[0] = last       # later bucket wins "last"
                    if mn < cur[1]:
                        cur[1] = mn
                    if mx > cur[2]:
                        cur[2] = mx
            for k, sk in b.sketches.items():
                merged = sketches.get(k)
                if merged is None:
                    merged = sketches[k] = LogSketch(gamma=self.gamma)
                merged.merge(sk)
        covered = min(max(len(picked), 1) * self.interval_s,
                      max(float(duration_s), self.interval_s))
        out_h = {}
        for k, sk in sketches.items():
            h = sk.summary()
            h["sketch"] = sk.to_dict()
            out_h[k] = h
        return {
            "window_schema_version": 1,
            "duration_s": float(duration_s),
            "interval_s": self.interval_s,
            "ts": self._clock(),
            "buckets": len(picked),
            "counters": {k: {"delta": v, "rate": v / covered}
                         for k, v in counters.items()},
            "gauges": {k: {"last": t[0], "min": t[1], "max": t[2]}
                       for k, t in gauges.items()},
            "histograms": out_h,
        }


def empty_view(duration_s: float) -> dict:
    """The ``view()`` shape with no window store installed — callers
    render zeros instead of branching on None."""
    return {"window_schema_version": 1, "duration_s": float(duration_s),
            "interval_s": 0.0, "ts": time.time(), "buckets": 0,
            "counters": {}, "gauges": {}, "histograms": {}}


# ------------------------------------------------------ fleet merging
def merge_window_payloads(payloads: Iterable[Optional[dict]]) -> dict:
    """Merge member ``windows_payload()`` dicts into one fleet view —
    sketches merge bucket-wise (exact), counter deltas/rates and gauge
    lasts sum, gauge min/max envelope. Members sharing a
    ``registry_id`` (the thread replica backend: N members, ONE process
    registry) are deduplicated — each distinct registry contributes
    once, so thread and process backends report the same fleet totals.
    """
    merged_windows: Dict[str, dict] = {}
    seen: set = set()
    members = deduped = 0
    for p in payloads:
        if not isinstance(p, dict):
            continue
        members += 1
        reg = p.get("registry_id")
        if isinstance(reg, str) and reg:
            if reg in seen:
                deduped += 1
                continue
            seen.add(reg)
        for label, view in (p.get("windows") or {}).items():
            if not isinstance(view, dict):
                continue
            tgt = merged_windows.get(label)
            if tgt is None:
                tgt = merged_windows[label] = {
                    "window_schema_version": 1,
                    "duration_s": view.get("duration_s", 0.0),
                    "interval_s": view.get("interval_s", 0.0),
                    "ts": view.get("ts", 0.0),
                    "buckets": view.get("buckets", 0),
                    "counters": {}, "gauges": {}, "_sketches": {}}
            tgt["buckets"] = max(tgt["buckets"], view.get("buckets", 0))
            tgt["ts"] = max(tgt["ts"], view.get("ts", 0.0))
            for k, row in (view.get("counters") or {}).items():
                cur = tgt["counters"].setdefault(
                    k, {"delta": 0.0, "rate": 0.0})
                cur["delta"] += row.get("delta", 0.0)
                cur["rate"] += row.get("rate", 0.0)
            for k, row in (view.get("gauges") or {}).items():
                cur = tgt["gauges"].get(k)
                if cur is None:
                    tgt["gauges"][k] = dict(row)
                else:
                    # Fleet gauge semantics: "last" SUMS (fleet queue
                    # depth = every member's), min/max envelope.
                    cur["last"] = cur.get("last", 0.0) + row.get(
                        "last", 0.0)
                    cur["min"] = min(cur.get("min", 0.0),
                                     row.get("min", 0.0))
                    cur["max"] = max(cur.get("max", 0.0),
                                     row.get("max", 0.0))
            for k, h in (view.get("histograms") or {}).items():
                sk_obj = h.get("sketch") if isinstance(h, dict) else None
                if not isinstance(sk_obj, dict):
                    continue
                sk = LogSketch.from_dict(sk_obj)
                cur = tgt["_sketches"].get(k)
                if cur is None:
                    tgt["_sketches"][k] = sk
                else:
                    cur.merge(sk)
    for view in merged_windows.values():
        hists = {}
        for k, sk in view.pop("_sketches").items():
            h = sk.summary()
            h["sketch"] = sk.to_dict()
            hists[k] = h
        view["histograms"] = hists
    return {"window_schema_version": 1, "ts": time.time(),
            "members": members, "deduped": deduped,
            "windows": merged_windows}


# ------------------------------------------- Prometheus-text exposition
#: Pinned exposition conventions (the telemetry schema
#: re-exports and validates them): every sample name carries the
#: prefix; windowed samples are labeled with one of WINDOW_LABELS.
EXPOSITION_PREFIX = "nezha_"
WINDOW_LABELS = tuple(f"{d}s" for d in WINDOW_DURATIONS)
QUANTILE_LABELS = ("p50", "p90", "p99")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(-?[0-9.eE+]+"
    r"|[+-]?Inf|NaN)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def prom_name(name: str) -> str:
    """Instrument name -> exposition sample name (``serve.ttft_s`` ->
    ``nezha_serve_ttft_s``)."""
    return EXPOSITION_PREFIX + _NAME_RE.sub("_", name)


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(stats: Optional[dict],
                      windows: Optional[dict] = None,
                      extra_labels: Optional[Dict[str, str]] = None
                      ) -> str:
    """Render one registry's cumulative stats (the ``/stats`` shape —
    or the router's deduped fleet section) plus its window views
    (``windows_payload()`` / a fleet merge) as Prometheus text.

    Cumulative counters/gauges render unlabeled; window views render
    window-labeled rates (``<name>_rate{window="60s"}``), gauge
    last/min/max, and sketch quantiles
    (``<name>{window="60s",quantile="p99"}``)."""
    base = dict(extra_labels or {})

    def labels(**kw) -> str:
        merged = {**base, **kw}
        if not merged:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
        return "{" + inner + "}"

    lines: List[str] = []
    if stats:
        ctr = stats.get("counters") or {}
        # Fleet KV reuse at-a-glance: a comment line — both
        # parse_prometheus and the schema validator skip '#' lines, so
        # this is scrape-invisible but human-greppable on /metrics.
        if "serve.kv.fleet_hits_total" in ctr:
            lines.append(
                "# fleet kv: "
                f"{_fmt(ctr['serve.kv.fleet_hits_total'])} hits "
                f"(device "
                f"{_fmt(ctr.get('serve.kv.fleet_hits_device_total', 0))}"
                f" / host "
                f"{_fmt(ctr.get('serve.kv.fleet_hits_host_total', 0))}"
                f" / peer "
                f"{_fmt(ctr.get('serve.kv.fleet_hits_peer_total', 0))}), "
                f"{_fmt(ctr.get('serve.kv.pull_bytes', 0))} bytes pulled")
        for k in sorted(stats.get("counters") or {}):
            n = prom_name(k)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n}{labels()} "
                         f"{_fmt(stats['counters'][k])}")
        for k in sorted(stats.get("gauges") or {}):
            n = prom_name(k)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n}{labels()} {_fmt(stats['gauges'][k])}")
    for label in sorted((windows or {}).get("windows") or {},
                        key=lambda s: (len(s), s)):
        view = windows["windows"][label]
        if not isinstance(view, dict):
            continue
        for k in sorted(view.get("counters") or {}):
            row = view["counters"][k]
            n = prom_name(k)
            lines.append(f"{n}_rate{labels(window=label)} "
                         f"{_fmt(row.get('rate', 0.0))}")
        for k in sorted(view.get("gauges") or {}):
            row = view["gauges"][k]
            n = prom_name(k)
            for stat in ("last", "min", "max"):
                lines.append(f"{n}_{stat}{labels(window=label)} "
                             f"{_fmt(row.get(stat, 0.0))}")
        for k in sorted(view.get("histograms") or {}):
            h = view["histograms"][k]
            n = prom_name(k)
            for q in QUANTILE_LABELS:
                lines.append(
                    f"{n}{labels(window=label, quantile=q)} "
                    f"{_fmt(h.get(q, 0.0))}")
            lines.append(f"{n}_count{labels(window=label)} "
                         f"{_fmt(h.get('count', 0))}")
            lines.append(f"{n}_sum{labels(window=label)} "
                         f"{_fmt(h.get('sum', 0.0))}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str
                     ) -> List[Tuple[str, Dict[str, str], float]]:
    """Prometheus text -> ``[(name, labels, value), ...]`` — the
    ``nezha-top`` / test-side reader (comments skipped, malformed lines
    dropped; the schema validator is the strict reader)."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, raw_labels, value = m.group(1), m.group(2), m.group(3)
        labels = dict(_LABEL_RE.findall(raw_labels)) if raw_labels else {}
        try:
            out.append((name, labels, float(value)))
        except ValueError:
            continue
    return out


def metric_value(samples: List[Tuple[str, Dict[str, str], float]],
                 name: str, **want: str) -> Optional[float]:
    """First sample matching ``name`` whose labels contain ``want``."""
    for n, labels, v in samples:
        if n == name and all(labels.get(k) == w for k, w in want.items()):
            return v
    return None


# ---------------------------------------------- process-wide installation
def install_windows(interval_s: float = 10.0,
                    retention_s: float = 300.0,
                    clock: Callable[[], float] = time.time,
                    gamma: float = DEFAULT_GAMMA) -> WindowStore:
    """Install a :class:`WindowStore` as the process-wide window tap:
    every instrument write while telemetry is enabled also records into
    the store's current bucket. ``start_run`` installs one by default;
    the capture-only baseline (bench) and tests pass knobs explicitly.
    Replaces any previously installed store."""
    store = WindowStore(interval_s=interval_s, retention_s=retention_s,
                        clock=clock, gamma=gamma)
    _registry._state.windows = store
    return store


def uninstall_windows() -> None:
    _registry._state.windows = None


def current_windows() -> Optional[WindowStore]:
    return _registry._state.windows


def windows_payload(registry: Optional["_registry.Registry"] = None,
                    durations: Iterable[float] = WINDOW_DURATIONS
                    ) -> dict:
    """The JSON window views a front end serves at ``GET /windows`` —
    the mergeable form (sketch bucket counts ride along) the router
    scrapes to build the fleet ``/metrics`` roll-up. ``registry_id``
    lets the fleet merge dedupe thread-backend members that share one
    process registry."""
    reg = registry if registry is not None else _registry.REGISTRY
    return {"window_schema_version": 1, "ts": time.time(),
            "registry_id": reg.registry_id,
            "windows": {f"{int(d)}s": reg.windows(d) for d in durations}}
