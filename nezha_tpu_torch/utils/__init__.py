from nezha_tpu_torch.utils.logging import get_logger, set_rank
from nezha_tpu_torch.utils.metrics import (MetricsLogger, StepTimer,
                                           read_metrics)
from nezha_tpu_torch.utils.profiling import Tracer, annotate, profile_trace

__all__ = ["MetricsLogger", "StepTimer", "Tracer", "annotate", "get_logger",
           "profile_trace", "read_metrics", "set_rank"]
