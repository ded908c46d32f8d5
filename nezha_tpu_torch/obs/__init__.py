"""Telemetry (counterpart of ``nezha_tpu/obs``): the process-wide
registry and run-scoped sinks, the rolling windows with their Prometheus
exposition, SLOs and the watchdog, the JSONL metrics sink and the device
trace window. The reports (``obs/report.py``) are not ported yet.

- ``registry``: counters / gauges / histograms / wall-clock spans with
  branch-only no-op fast paths while disabled, and request trace ids.
- ``sink``: ``start_run(run_dir)`` streams ``metrics.jsonl``,
  ``spans.jsonl`` and ``events.jsonl`` and writes a final
  ``summary.json``.
- ``timeseries`` / ``slo`` / ``watchdog``: fixed-interval bucket rings
  with mergeable log-bucket sketches, declarative SLOs with error-budget
  burn rate, and the anomaly watchdog streaming typed events.
- ``metrics`` / ``trace``: the JSONL logger and the torch.profiler
  trace window.
"""

from nezha_tpu_torch.obs.metrics import MetricsLogger, read_metrics
from nezha_tpu_torch.obs.registry import (
    NULL_SPAN,
    Counter,
    Gauge,
    Histogram,
    REGISTRY,
    Registry,
    Span,
    TRACE_HEADER,
    adopt_trace_header,
    counter,
    current_trace,
    disable,
    emit_span,
    enable,
    enabled,
    gauge,
    histogram,
    mint_trace_id,
    new_span_id,
    record_collective,
    record_event,
    record_metrics,
    set_trace_sample,
    span,
    stats_snapshot,
    trace_context,
    trace_sample,
    traced_span,
    windows,
)
from nezha_tpu_torch.obs.sink import (
    EVENTS_FILE,
    METRICS_FILE,
    SPANS_FILE,
    SUMMARY_FILE,
    RunSink,
    current_sink,
    end_run,
    start_run,
)
from nezha_tpu_torch.obs.slo import (
    SLOConfig,
    SLOTracker,
    evaluate_slo,
    parse_slo,
    parse_slo_args,
    summarize_slo_events,
)
from nezha_tpu_torch.obs.timeseries import (
    LogSketch,
    WINDOW_DURATIONS,
    WindowStore,
    current_windows,
    install_windows,
    merge_window_payloads,
    parse_prometheus,
    render_prometheus,
    uninstall_windows,
    windows_payload,
)
from nezha_tpu_torch.obs.trace import Tracer, profile_trace
from nezha_tpu_torch.obs.watchdog import (Watchdog, WatchdogConfig,
                                          WatchdogThread)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Span", "REGISTRY",
    "NULL_SPAN", "counter", "gauge", "histogram", "span", "enabled",
    "enable", "disable", "record_metrics", "record_collective",
    "trace_context", "current_trace", "mint_trace_id", "new_span_id",
    "set_trace_sample", "trace_sample", "traced_span", "emit_span",
    "stats_snapshot", "TRACE_HEADER", "adopt_trace_header",
    "RunSink", "start_run", "end_run", "current_sink",
    "METRICS_FILE", "SPANS_FILE", "EVENTS_FILE", "SUMMARY_FILE",
    "MetricsLogger", "read_metrics",
    "Tracer", "profile_trace",
    "record_event", "windows",
    "LogSketch", "WindowStore", "WINDOW_DURATIONS",
    "install_windows", "uninstall_windows", "current_windows",
    "windows_payload", "merge_window_payloads",
    "render_prometheus", "parse_prometheus",
    "SLOConfig", "SLOTracker", "parse_slo", "parse_slo_args",
    "evaluate_slo", "summarize_slo_events",
    "Watchdog", "WatchdogConfig", "WatchdogThread",
]
