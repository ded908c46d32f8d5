"""Thin re-export: the metrics sink lives in ``nezha_tpu_torch.obs.
metrics``, as in the JAX package."""

from nezha_tpu_torch.obs.metrics import MetricsLogger, read_metrics

__all__ = ["MetricsLogger", "read_metrics"]
