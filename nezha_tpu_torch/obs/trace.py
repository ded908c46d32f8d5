"""Device tracing on ``torch.profiler`` (counterpart of the device half
of ``nezha_tpu/obs/trace.py``, which drives ``jax.profiler``; the
request trace ids live in ``obs/registry.py``).

:func:`annotate` names a region of the timeline (a
``torch.profiler.record_function`` range on the host row). A trace
window records the host's activity and, where CUDA is available, the
card's kernels and copies, and writes a Chrome trace (``.json``,
viewable in Perfetto or ``chrome://tracing``) into its directory.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


def _start_profiler() -> "torch.profiler.profile":
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


@contextlib.contextmanager
def profile_trace(log_dir: str, name: str = "trace") -> Iterator[None]:
    """Trace the enclosed block into ``log_dir/<name>_pid<P>.json``."""
    os.makedirs(log_dir, exist_ok=True)
    prof = _start_profiler()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"{name}_pid{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in a trace's timeline; costs a range push and pop
    when no profiler runs."""
    with torch.profiler.record_function(name):
        yield


class Tracer:
    """Start/stop trace control for long-running loops.

    A Trainer holds one and calls ``maybe_trace(step)`` after each step:
    the window opens at the first step at or after ``start_step`` (so a
    resumed run whose count starts past it still gets one whole window)
    and closes ``num_steps`` steps later, once per Tracer. The steps it
    covers are those after the one that opened it; :attr:`trace_path`
    names the file once it is written."""

    def __init__(self, log_dir: Optional[str] = None, start_step: int = 10,
                 num_steps: int = 3):
        self.log_dir = log_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self.stop_step = start_step + num_steps
        self.opened_at: Optional[int] = None
        self.trace_path: Optional[str] = None
        self._prof = None
        self._done = False

    @property
    def enabled(self) -> bool:
        return self.log_dir is not None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_trace(self, step: int) -> None:
        if not self.enabled:
            return
        if not self.active and not self._done and step >= self.start_step:
            self.stop_step = step + self.num_steps
            self.opened_at = step
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = _start_profiler()
        elif self.active and step >= self.stop_step:
            self.stop()

    def stop(self) -> None:
        """Close an open window and write its trace."""
        if not self.active:
            return
        prof, self._prof = self._prof, None
        self._done = True  # one window per Tracer
        prof.stop()
        self.trace_path = os.path.join(
            self.log_dir, f"trace_steps{self.opened_at + 1}-"
                          f"{self.stop_step}_pid{os.getpid()}.json")
        prof.export_chrome_trace(self.trace_path)
