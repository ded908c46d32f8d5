from nezha_tpu_torch.utils.metrics import MetricsLogger, read_metrics
from nezha_tpu_torch.utils.profiling import Tracer, profile_trace

__all__ = ["MetricsLogger", "Tracer", "profile_trace",
           "read_metrics"]
