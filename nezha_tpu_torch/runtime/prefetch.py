"""Host-side prefetching worker pool (counterpart of
``nezha_tpu/runtime/prefetch.py``).

N worker threads pull batches from the source iterator into a bounded
queue and stage them onto the device while the previous step runs. On
``cuda`` a worker copies each array into pinned host memory (under the
source's lock, so a source that refills its buffers may do so as soon as
the copy returns), issues the host-to-device copies on a side stream of
the target device, and records an event after them. The consumer makes
its current stream wait on that event and marks every tensor it hands out
as used by that stream (``record_stream``), so the caching allocator does
not reuse the memory while the step still reads it. On the CPU staging is
:func:`~nezha_tpu_torch.train.loop.batch_to_device`.

Either way a staged batch is what ``batch_to_device`` makes of the source
batch: the same keys, integers as int64, the same values bit for bit, so
the train step copies nothing a second time.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from nezha_tpu_torch import obs
from nezha_tpu_torch.train.loop import batch_to_device


def _pinned(x) -> torch.Tensor:
    """A pinned host copy of an array or tensor in ``batch_to_device``'s
    dtype (integers as int64). The block comes from the caching host
    allocator, which keeps it until the asynchronous copy from it ends."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    dtype = t.dtype if t.is_floating_point() else torch.int64
    out = torch.empty(t.shape, dtype=dtype, pin_memory=True)
    out.copy_(t)
    return out


class Prefetcher:
    """Bounded-depth background prefetcher; iterate to get device batches
    (dicts of tensors on ``device``).

    A depth of 0 behaves as 1. Every worker enqueues one exit sentinel, and
    the consumer stops after collecting all of them; a worker's error
    (from the source or from staging) is raised in the consumer. Reads
    that find the queue empty count in :attr:`stalls` and
    :attr:`stall_seconds`, the input-bound signal. While a telemetry run
    is active each read also sets the ``prefetch.queue_depth`` gauge,
    and each stall counts in ``prefetch.stalls`` and
    ``prefetch.stall_seconds`` (JAX's names)."""

    _DONE = object()

    def __init__(self, source: Iterator[Any], depth: int = 2,
                 device="cuda", num_workers: int = 1):
        self._source = source
        self.device = torch.device(device)
        self._stream = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
        # +num_workers slots so every worker can always enqueue its exit
        # sentinel without blocking, even with no consumer draining.
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(depth, 1) + max(num_workers, 1))
        self._src_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._done_seen = 0
        self.stalls = 0
        self.stall_seconds = 0.0
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"nezha-prefetch-{i}")
            for i in range(max(num_workers, 1))]
        for t in self._threads:
            t.start()

    def _next_staged(self):
        """The next batch, staged: (dict of tensors, the event after its
        copies or None on the CPU)."""
        if self._stream is None:
            with self._src_lock:
                batch = next(self._source)
            return batch_to_device(batch, self.device), None
        with self._src_lock:
            host = {k: _pinned(x) for k, x in next(self._source).items()}
        with torch.cuda.stream(self._stream):
            out = {k: h.to(self.device, non_blocking=True)
                   for k, h in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _work(self):
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                try:
                    item = self._next_staged()
                except StopIteration:
                    return
                except BaseException as e:  # surface in the consumer
                    self._error = e
                    return
                self._q.put(item)
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while True:
            recording = obs.enabled()
            if recording:
                obs.gauge("prefetch.queue_depth").set(self._q.qsize())
            if self._q.empty():
                t0 = time.perf_counter()
                item = self._q.get()
                # A wait that ends in a worker's exit is shutdown, not
                # input starvation.
                if item is not self._DONE:
                    waited = time.perf_counter() - t0
                    self.stalls += 1
                    self.stall_seconds += waited
                    if recording:
                        obs.counter("prefetch.stalls").inc()
                        obs.histogram("prefetch.stall_seconds").observe(
                            waited)
            else:
                item = self._q.get()
            if item is self._DONE:
                self._done_seen += 1
                if self._done_seen >= len(self._threads):
                    if self._error is not None:
                        raise self._error
                    raise StopIteration
                continue
            batch, done = item
            if done is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                for t in batch.values():
                    t.record_stream(current)
            return batch

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        # Keep draining until every worker has exited: a worker blocked in
        # put() needs space to wake up, see the stop flag, and enqueue its
        # sentinel.
        deadline = time.monotonic() + timeout
        while (any(t.is_alive() for t in self._threads)
               and time.monotonic() < deadline):
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=0.1)


def prefetch_to_device(source: Iterator[Any], depth: int = 2,
                       device="cuda") -> Prefetcher:
    return Prefetcher(source, depth=depth, device=device)
