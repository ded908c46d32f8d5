"""Declarative SLOs over window views: compliance + error-budget burn.

An SLO is one sentence about a windowed statistic::

    serve.ttft_s p99 < 0.5 over 60s
    serve.queue_depth max < 8 over 10s objective 0.99
    serve.admitted_total rate > 0.5 over 60s

:func:`parse_slo` turns the sentence into an :class:`SLOConfig`;
:func:`evaluate_slo` checks one config against a
``Registry.windows(duration)`` view (histogram quantiles, gauge
last/min/max, counter rate/delta — the stat picks the instrument kind);
:class:`SLOTracker` accumulates per-window verdicts into compliance and
**error-budget burn rate**: with objective ``o`` the budget is ``1-o``
bad windows, and burn = observed bad fraction / budget — burn 1.0 spends
the budget exactly at the objective boundary, burn 2.0 exhausts it in
half the period (the classic multi-window burn-rate alert input,
consumed by obs/watchdog.py).

The serving CLI wires specs from its ``--slo`` flag (repeatable /
``;``-separated); every evaluation is also recorded as a typed
``slo.eval`` event so ``nezha-telemetry RUN_DIR --slo`` can render
compliance/burn offline from ``events.jsonl`` alone.
"""

from __future__ import annotations

import re
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

#: Window stats an SLO may reference, and the instrument section each
#: resolves against (histograms win on name collision — percentiles are
#: the common case).
_HIST_STATS = ("p50", "p90", "p99", "mean", "count")
_GAUGE_STATS = ("last", "min", "max")
_COUNTER_STATS = ("rate", "delta")
VALID_STATS = _HIST_STATS + _GAUGE_STATS + _COUNTER_STATS

_OPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

_SPEC_RE = re.compile(
    r"^\s*(?P<metric>[A-Za-z0-9_.\-]+)\s+(?P<stat>[a-z0-9_]+)\s+"
    r"(?P<op><=|>=|<|>)\s+(?P<threshold>[0-9.eE+\-]+)\s+"
    r"over\s+(?P<window>[0-9.]+)\s*s"
    r"(?:\s+objective\s+(?P<objective>[0-9.]+))?\s*$")


@dataclass(frozen=True)
class SLOConfig:
    """One service-level objective over a rolling window."""

    metric: str          # instrument name, e.g. "serve.ttft_s"
    stat: str            # p99 / max / rate / ... (VALID_STATS)
    op: str              # "<" | "<=" | ">" | ">="
    threshold: float
    window_s: float      # evaluation window duration
    objective: float = 0.999   # target fraction of compliant windows

    @property
    def name(self) -> str:
        """Stable display/grouping key: ``serve.ttft_s:p99<0.5/60s``."""
        w = int(self.window_s) if float(self.window_s).is_integer() \
            else self.window_s
        return f"{self.metric}:{self.stat}{self.op}{self.threshold}/{w}s"

    def spec(self) -> str:
        """Round-trippable spec string (``parse_slo(cfg.spec())``)."""
        out = (f"{self.metric} {self.stat} {self.op} {self.threshold} "
               f"over {self.window_s}s")
        if self.objective != 0.999:
            out += f" objective {self.objective}"
        return out


def parse_slo(spec: str) -> SLOConfig:
    """``"serve.ttft_s p99 < 0.5 over 60s [objective 0.99]"`` ->
    :class:`SLOConfig`. Raises ``ValueError`` with the offending spec on
    any grammar violation (the CLI surfaces it as an argument error)."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(
            f"bad SLO spec {spec!r} (want: '<metric> <stat> <op> "
            f"<threshold> over <N>s [objective <frac>]')")
    stat = m.group("stat")
    if stat not in VALID_STATS:
        raise ValueError(
            f"bad SLO stat {stat!r} in {spec!r} (one of "
            f"{', '.join(VALID_STATS)})")
    objective = float(m.group("objective") or 0.999)
    if not 0.0 < objective < 1.0:
        raise ValueError(
            f"SLO objective must be in (0, 1), got {objective} "
            f"in {spec!r}")
    window_s = float(m.group("window"))
    if window_s <= 0:
        raise ValueError(f"SLO window must be > 0s in {spec!r}")
    return SLOConfig(metric=m.group("metric"), stat=stat,
                     op=m.group("op"),
                     threshold=float(m.group("threshold")),
                     window_s=window_s, objective=objective)


def parse_slo_args(values) -> List[SLOConfig]:
    """CLI form: repeatable ``--slo`` flags, each possibly
    ``;``-separated. Empty segments are skipped."""
    out: List[SLOConfig] = []
    for value in values or []:
        for part in str(value).split(";"):
            part = part.strip()
            if part:
                out.append(parse_slo(part))
    return out


def window_stat(view: dict, metric: str, stat: str) -> Optional[float]:
    """Resolve ``metric``'s ``stat`` in a window view, or ``None`` when
    the window saw no such instrument (no data is NOT a violation)."""
    if stat in _HIST_STATS:
        h = (view.get("histograms") or {}).get(metric)
        if h is not None:
            return float(h.get(stat, 0.0))
        return None
    if stat in _GAUGE_STATS:
        g = (view.get("gauges") or {}).get(metric)
        if g is not None:
            return float(g.get(stat, 0.0))
        return None
    c = (view.get("counters") or {}).get(metric)
    if c is not None:
        return float(c.get(stat, 0.0))
    return None


def evaluate_slo(cfg: SLOConfig, view: dict) -> dict:
    """One windowed evaluation -> the ``slo.eval`` event detail shape:
    ``{"slo", "metric", "stat", "op", "threshold", "window_s",
    "value", "ok", "no_data"}``. A window with no observations
    evaluates ``ok`` (vacuous) with ``no_data`` set, and trackers skip
    it — an idle service doesn't burn budget."""
    value = window_stat(view, cfg.metric, cfg.stat)
    if value is None:
        ok, no_data = True, True
    else:
        ok, no_data = _OPS[cfg.op](value, cfg.threshold), False
    return {"slo": cfg.name, "metric": cfg.metric, "stat": cfg.stat,
            "op": cfg.op, "threshold": cfg.threshold,
            "window_s": cfg.window_s, "objective": cfg.objective,
            "value": value, "ok": ok, "no_data": no_data}


class SLOTracker:
    """Per-SLO budget accounting over a trailing run of evaluations.

    ``observe(ok)`` feeds one window verdict; ``compliance`` is the
    lifetime good fraction, ``burn_rate()`` the trailing bad fraction
    divided by the error budget ``1 - objective``. Pinned by a
    hand-computed-trace unit test (objective 0.9, 8 good + 2 bad ->
    compliance 0.8, burn 2.0). Single-consumer (the watchdog thread);
    not locked."""

    def __init__(self, cfg: SLOConfig, horizon: int = 100):
        self.cfg = cfg
        self.good = 0
        self.bad = 0
        self._recent: deque = deque(maxlen=max(1, horizon))

    def observe(self, ok: bool) -> None:
        if ok:
            self.good += 1
        else:
            self.bad += 1
        self._recent.append(bool(ok))

    @property
    def total(self) -> int:
        return self.good + self.bad

    @property
    def compliance(self) -> float:
        t = self.total
        return self.good / t if t else 1.0

    def bad_fraction(self) -> float:
        if not self._recent:
            return 0.0
        return sum(1 for ok in self._recent if not ok) / len(self._recent)

    def burn_rate(self) -> float:
        """Error-budget burn over the trailing horizon: 0.0 = no burn,
        1.0 = burning exactly the budget, >1 = on track to exhaust it
        early."""
        budget = 1.0 - self.cfg.objective
        return self.bad_fraction() / budget

    def status(self) -> dict:
        return {"slo": self.cfg.name, "objective": self.cfg.objective,
                "evaluations": self.total, "good": self.good,
                "bad": self.bad, "compliance": self.compliance,
                "burn_rate": self.burn_rate()}


def summarize_slo_events(events: List[dict]) -> Dict[str, dict]:
    """Rebuild per-SLO compliance/burn from a run dir's ``slo.eval``
    event records (the ``nezha-telemetry --slo`` offline path). Events
    with no matching data windows (``no_data``) are excluded, mirroring
    the live tracker."""
    rows: Dict[str, dict] = {}
    for rec in events:
        if rec.get("kind") != "slo.eval":
            continue
        d = rec.get("detail") or {}
        name = d.get("slo")
        if not isinstance(name, str) or d.get("no_data"):
            continue
        row = rows.setdefault(
            name, {"slo": name, "good": 0, "bad": 0,
                   "objective": float(d.get("objective", 0.999)),
                   "last_value": None, "threshold": d.get("threshold"),
                   "window_s": d.get("window_s")})
        if d.get("ok"):
            row["good"] += 1
        else:
            row["bad"] += 1
        row["last_value"] = d.get("value")
    for row in rows.values():
        total = row["good"] + row["bad"]
        row["evaluations"] = total
        row["compliance"] = row["good"] / total if total else 1.0
        budget = 1.0 - row["objective"]
        bad_frac = row["bad"] / total if total else 0.0
        row["burn_rate"] = bad_frac / budget if budget > 0 else 0.0
    return rows
