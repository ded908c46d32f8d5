"""Telemetry (counterpart of ``nezha_tpu/obs``): the JSONL metrics sink
and the device trace window. The registry, run sinks, reports and
request tracing are not ported yet."""

from nezha_tpu_torch.obs.metrics import MetricsLogger, read_metrics
from nezha_tpu_torch.obs.trace import Tracer, profile_trace

__all__ = ["MetricsLogger", "Tracer", "profile_trace",
           "read_metrics"]
