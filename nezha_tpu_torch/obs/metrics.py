"""Metrics recording: the JSONL sink (counterpart of
``nezha_tpu/obs/metrics.py``'s ``MetricsLogger`` and ``read_metrics``;
the run sinks in ``obs/sink.py`` stream through it)."""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics: one object per line with an int
    ``step`` and a wall-clock ``ts``. Cheap enough to call every logged
    step; usable as the Trainer's ``metric_logger``."""

    def __init__(self, path: str, flush_every: int = 1, mode: str = "a"):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f: Optional[IO[str]] = open(path, mode)
        self._flush_every = max(flush_every, 1)
        self._since_flush = 0
        self.path = path

    def __call__(self, step: int, metrics: Dict[str, Any]) -> None:
        self.log(step, metrics)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._f is None:
            raise ValueError("logger is closed")
        rec = {"step": int(step), "ts": time.time()}
        for k, v in metrics.items():
            # Ints stay ints (a metrics dict's "step" must not demote the
            # int field to a float); tensor and numpy scalars coerce.
            if isinstance(v, (bool, int)):
                rec[k] = v
            else:
                rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")
        self._since_flush += 1
        if self._since_flush >= self._flush_every:
            self._f.flush()
            self._since_flush = 0

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(path: str) -> list:
    """Read a JSONL metrics file back as a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
