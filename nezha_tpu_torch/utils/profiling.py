"""Thin re-export: the trace window lives in ``nezha_tpu_torch.obs.
trace``, as in the JAX package."""

from nezha_tpu_torch.obs.trace import Tracer, annotate, profile_trace

__all__ = ["Tracer", "annotate", "profile_trace"]
