"""Run-scoped telemetry sink: ``--run-dir`` -> metrics.jsonl + spans.jsonl
+ summary.json.

``start_run(run_dir)`` enables the process-wide registry and attaches a
``RunSink`` that streams per-step metrics and completed spans as JSONL;
``end_run()`` (or ``sink.close()``) writes the final ``summary.json`` from
the registry snapshot and disables telemetry again. One run at a time per
process — the run IS the process-wide enable switch, which is what keeps
the disabled fast paths branch-only.

File contract (frozen; the telemetry schema checker validates it):

    metrics.jsonl   one object per line: {"step": int, "ts": float, ...}
    spans.jsonl     one object per line: {"name", "t0", "t1", "dur_s",
                    "attrs"}
    events.jsonl    one object per line: {"event_schema_version", "ts",
                    "kind", "severity", "source", "detail"} — the typed
                    watchdog/SLO event stream (validated by the
                    schema checker when present, so captures without
                    it stay valid)
    summary.json    the Registry.snapshot() shape (schema_version 1) plus
                    a "run" block of caller-provided metadata
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from nezha_tpu_torch.obs import registry as _registry
from nezha_tpu_torch.obs.metrics import MetricsLogger

METRICS_FILE = "metrics.jsonl"
SPANS_FILE = "spans.jsonl"
EVENTS_FILE = "events.jsonl"
SUMMARY_FILE = "summary.json"


class RunSink:
    """Writer for one run directory. Create via :func:`start_run`."""

    def __init__(self, run_dir: str,
                 registry: Optional[_registry.Registry] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.run_dir = run_dir
        self.registry = registry if registry is not None \
            else _registry.REGISTRY
        self.meta = dict(meta or {})
        os.makedirs(run_dir, exist_ok=True)
        # A run dir holds exactly ONE run: truncate the streams and drop any
        # stale summary, so retrying with the same --run-dir never mixes a
        # previous capture's records into this run's report.
        try:
            os.remove(os.path.join(run_dir, SUMMARY_FILE))
        except FileNotFoundError:
            pass
        self._metrics = MetricsLogger(os.path.join(run_dir, METRICS_FILE),
                                      mode="w")
        self._spans = open(os.path.join(run_dir, SPANS_FILE), "w")
        self._events = open(os.path.join(run_dir, EVENTS_FILE), "w")
        self._t_start = time.time()
        self._closed = False

    def write_metrics(self, step: int, metrics: Dict[str, Any]) -> None:
        if not self._closed:
            self._metrics.log(step, metrics)

    def write_span(self, rec: dict) -> None:
        if not self._closed:
            self._spans.write(json.dumps(rec) + "\n")
            self._spans.flush()

    def write_event(self, rec: dict) -> None:
        if not self._closed:
            self._events.write(json.dumps(rec) + "\n")
            self._events.flush()

    def summary(self) -> dict:
        out = self.registry.snapshot()
        out["run"] = {**self.meta,
                      "run_dir": os.path.abspath(self.run_dir),
                      "started_at": self._t_start,
                      "wall_seconds": time.time() - self._t_start}
        return out

    def close(self) -> None:
        """Flush streams and write ``summary.json``. Idempotent."""
        if self._closed:
            return
        summary = self.summary()
        self._closed = True
        self._metrics.close()
        self._spans.close()
        self._events.close()
        path = os.path.join(self.run_dir, SUMMARY_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
        os.replace(tmp, path)  # readers never see a torn summary

    def __enter__(self) -> "RunSink":
        return self

    def __exit__(self, *exc) -> None:
        end_run()


_current: Optional[RunSink] = None


def current_sink() -> Optional[RunSink]:
    return _current


def start_run(run_dir: str, meta: Optional[Dict[str, Any]] = None,
              reset: bool = True, windows: bool = True,
              window_interval_s: float = 10.0,
              window_retention_s: float = 300.0) -> RunSink:
    """Open a telemetry run: enable the registry, attach the sink.

    ``reset`` clears instruments accumulated before the run started so the
    summary is genuinely run-scoped (pass False to keep process history).
    ``windows`` installs the rolling-window tap (obs/timeseries) so
    ``Registry.windows(duration)`` and the ``/metrics`` exposition carry
    live 10s/60s/300s views; pass False for a capture-only run (the
    bench scrape-overhead baseline measures exactly this delta).
    Starting a new run closes any previous one first.
    """
    global _current
    if _current is not None:
        end_run()
    if reset:
        _registry.REGISTRY.reset()
    # Pre-register the standard collective rows so every summary carries
    # the per-collective payload table — a single-device run reports
    # zeros rather than omitting the section (stable schema for readers).
    for op in ("all_reduce", "reduce_scatter", "all_gather"):
        _registry.REGISTRY.counter(f"collective.{op}.calls")
        _registry.REGISTRY.counter(f"collective.{op}.payload_bytes")
    if windows:
        from nezha_tpu_torch.obs.timeseries import install_windows
        install_windows(interval_s=window_interval_s,
                        retention_s=window_retention_s)
    sink = RunSink(run_dir, meta=meta)
    _current = sink
    _registry.REGISTRY._sink = sink
    _registry.enable()
    return sink


def end_run() -> None:
    """Write summary.json, detach the sink and the window store,
    disable telemetry."""
    global _current
    sink = _current
    _current = None
    _registry.REGISTRY._sink = None
    if sink is not None:
        sink.close()
    _registry._state.windows = None
    _registry.disable()
