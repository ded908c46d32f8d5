"""Thin re-export: the metrics sink and step timer live in
``nezha_tpu_torch.obs.metrics``, as in the JAX package."""

from nezha_tpu_torch.obs.metrics import MetricsLogger, StepTimer, read_metrics

__all__ = ["MetricsLogger", "StepTimer", "read_metrics"]
