"""Metrics recording: the JSONL sink and windowed step timing
(counterpart of ``nezha_tpu/obs/metrics.py``; the run sinks in
``obs/sink.py`` stream through the JSONL reader).

CUDA launches are asynchronous, so a step returns before the card has
finished it, and per-step wall time measures the host. ``StepTimer``
times windows of steps instead and closes each with a host read of a
device scalar (``float()`` of the step's loss), which waits for every
step launched before it.
"""

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


class StepTimer:
    """Windowed steps/sec with one device barrier a window.

    Usage::

        timer = StepTimer(window=10)
        for batch in batches:
            metrics = step(batch)
            rate = timer.tick(metrics["loss"])   # None inside a window
            if rate is not None: ...             # steps/sec of the window

    ``tick`` reads the scalar on the host only at a window's edges, so
    the launch queue stays full in between. A loop that picks its own
    window edges (the Trainer logs on global-step multiples, which a
    resume can land between) uses the explicit form: ``start()`` once,
    then ``lap(scalar, n)`` at each edge to close a window of ``n``
    steps.
    """

    def __init__(self, window: int = 10):
        self.window = max(window, 1)
        self._count = 0
        self._t0: Optional[float] = None

    def tick(self, device_scalar) -> Optional[float]:
        if self._t0 is None:  # first call: sync, then open the window
            float(device_scalar)
            self._t0 = time.perf_counter()
            self._count = 0
            return None
        self._count += 1
        if self._count < self.window:
            return None
        float(device_scalar)  # barrier: the window's steps have finished
        now = time.perf_counter()
        rate = self._count / max(now - self._t0, 1e-9)
        self._t0 = now
        self._count = 0
        return rate

    # -- explicit windows ---------------------------------------------
    def start(self) -> None:
        """Open a window now (no barrier: the ``lap`` that closes it
        reads its scalar)."""
        self._t0 = time.perf_counter()
        self._count = 0

    def lap(self, device_scalar, steps: int) -> Optional[float]:
        """Close an explicit window of ``steps`` steps: read the scalar
        (the barrier), -> steps/sec since ``start()`` or the last lap.
        None when no window is open or it covered no step."""
        float(device_scalar)  # barrier: the window's steps have finished
        now = time.perf_counter()
        if self._t0 is None or steps <= 0:
            self._t0 = now
            return None
        rate = steps / max(now - self._t0, 1e-9)
        self._t0 = now
        return rate

    def exclude(self, seconds: float) -> None:
        """Leave ``seconds`` of host work (a checkpoint's save) out of
        the open window."""
        if self._t0 is not None:
            self._t0 += seconds

    def reset(self) -> None:
        """Forget the open window (after a stall, such as a rejoin's
        heal wait, that must not count against the next window)."""
        self._t0 = None
        self._count = 0
