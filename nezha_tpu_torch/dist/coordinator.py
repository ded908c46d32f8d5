"""The control plane over the native coordinator (counterpart of
``nezha_tpu/dist/coordinator.py``).

Processes :func:`join` a coordinator address and get a rank; the
:class:`ProcessGroup` then carries barriers, a key-value store (through
which :mod:`nezha_tpu_torch.dist.launch` hands out the address of
``torch.distributed``'s store), small broadcasts and all-gathers of host
blobs, and failure detection by heartbeat. Blocking native calls release
the GIL. Failed join attempts and newly dead ranks count in the
telemetry registry (``dist.join_retries_total``,
``dist.heartbeat_lost_total``); joins, barriers, failures and departures
are spans; each join attempt is the ``dist.join`` fault point.
"""

from __future__ import annotations

import ctypes
import random
import time
from typing import List, Optional

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.dist.native import load_library


class CoordinatorError(RuntimeError):
    pass


class JoinTimeout(CoordinatorError):
    """:func:`join` spent its retry budget without a rendezvous: the
    coordinator never came up (a CoordinatorError, so handlers of
    in-band failures catch it too)."""


class Coordinator:
    """The rendezvous server, one per job (on the rank-0 host). ``port``
    0 binds a free port; :attr:`port` is the one bound."""

    def __init__(self, world_size: int, port: int = 0,
                 heartbeat_timeout_s: float = 10.0):
        self._lib = load_library()
        self._h = self._lib.nz_coord_start(
            int(port), int(world_size), int(heartbeat_timeout_s * 1000))
        if not self._h:
            raise CoordinatorError(
                self._lib.nz_last_error().decode() or "coordinator start failed")
        self.world_size = world_size
        self.port = self._lib.nz_coord_port(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.nz_coord_stop(self._h)
            self._h = None

    def __enter__(self) -> "Coordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class ProcessGroup:
    """A joined member of the world: ``rank``, ``world_size`` and the
    control-plane calls. Every collective call (barrier, broadcast,
    all_gather) must be made by all ranks in the same order."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        self.rank = lib.nz_client_rank(handle)
        self.world_size = lib.nz_client_world(handle)
        self._last_failed: List[int] = []

    def _round(self, tag: str) -> int:
        """This rank's round of collective ``tag``: keys are never
        deleted, so each broadcast or all_gather writes fresh ones. The
        counter lives on the server, keyed by (tag, rank)."""
        return self.incr(f"__round/{tag}/{self.rank}")

    def incr(self, key: str) -> int:
        """Atomic fetch-and-increment on the server; -> the old value."""
        v = self._lib.nz_client_incr(self._h, key.encode())
        if v < 0:
            raise CoordinatorError(self._lib.nz_last_error().decode())
        return v

    def put(self, key: str, value: bytes) -> None:
        r = self._lib.nz_client_put(self._h, key.encode(), value, len(value))
        if r != 0:
            raise CoordinatorError(self._lib.nz_last_error().decode())

    def get(self, key: str, timeout_s: Optional[float] = None) -> bytes:
        """The value of ``key``, waiting until it is put (or timeout)."""
        timeout_ms = -1 if timeout_s is None else int(timeout_s * 1000)
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.nz_client_get(self._h, key.encode(), buf, cap,
                                        timeout_ms)
            if n < 0:
                raise CoordinatorError(self._lib.nz_last_error().decode())
            if n <= cap:
                return buf.raw[:n]
            cap = n  # larger than the buffer: ask again at its size

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        timeout_ms = -1 if timeout_s is None else int(timeout_s * 1000)
        with obs.span("dist.barrier", rank=self.rank):
            if self._lib.nz_client_barrier(self._h, timeout_ms) != 0:
                raise CoordinatorError(self._lib.nz_last_error().decode())

    def broadcast(self, value: Optional[bytes], root: int = 0,
                  timeout_s: Optional[float] = None,
                  tag: str = "bcast") -> bytes:
        """Root puts, every rank gets."""
        key = f"__{tag}/{self._round(tag)}/{root}"
        if self.rank == root:
            if value is None:
                raise ValueError("root must provide a value")
            self.put(key, value)
        return self.get(key, timeout_s)

    def all_gather(self, value: bytes, timeout_s: Optional[float] = None,
                   tag: str = "gather") -> List[bytes]:
        """Each rank's blob, in rank order."""
        rnd = self._round(tag)
        self.put(f"__{tag}/{rnd}/{self.rank}", value)
        return [self.get(f"__{tag}/{rnd}/{r}", timeout_s)
                for r in range(self.world_size)]

    def failed_ranks(self) -> List[int]:
        """Ranks the coordinator holds dead: they dropped their connection
        without leaving, or were silent past the heartbeat timeout. Each
        newly dead rank counts once in ``dist.heartbeat_lost_total``, and
        each change that brings one is a ``dist.failure`` span; the
        caller decides what a death means."""
        cap = max(self.world_size, 1)
        arr = (ctypes.c_int32 * cap)()
        n = self._lib.nz_client_failed(self._h, arr, cap)
        if n < 0:
            raise CoordinatorError(self._lib.nz_last_error().decode())
        failed = sorted(arr[i] for i in range(min(n, cap)))
        if failed != self._last_failed:
            newly = [r for r in failed if r not in self._last_failed]
            self._last_failed = failed
            if newly:
                obs.counter("dist.heartbeat_lost_total").inc(len(newly))
                with obs.span("dist.failure", rank=self.rank,
                              failed=failed):
                    pass
        return failed

    def leave(self) -> None:
        """Depart cleanly: peers do not count it as a failure."""
        if self._h:
            with obs.span("dist.leave", rank=self.rank):
                self._lib.nz_client_leave(self._h)
                self._lib.nz_client_close(self._h)
            self._h = None

    def close(self) -> None:
        """Drop the connection: peers see this rank as failed."""
        if self._h:
            self._lib.nz_client_close(self._h)
            self._h = None

    def __enter__(self) -> "ProcessGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.leave()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def join(host: str, port: int, rank_hint: int = -1,
         timeout_s: float = 60.0,
         heartbeat_interval_s: float = 2.0,
         attempt_timeout_s: float = 10.0,
         backoff_base_s: float = 0.25,
         backoff_max_s: float = 5.0,
         jitter: float = 0.5) -> ProcessGroup:
    """Join the coordinator at ``host:port``; -> a :class:`ProcessGroup`
    with its rank.

    Each native dial gets at most ``attempt_timeout_s`` (it rides out
    refused connections inside that window); a failed dial backs off
    exponentially from ``backoff_base_s`` up to ``backoff_max_s``, times
    1 ± ``jitter`` drawn from OS entropy (so a restarted world does not
    redial in lockstep), and once ``timeout_s`` is spent
    :class:`JoinTimeout` is raised. Each failed attempt counts in
    ``dist.join_retries_total``; that counter and
    ``dist.heartbeat_lost_total`` are registered here, so a joined run's
    summary carries both. The dial is the ``dist.join`` span, and each
    attempt passes the ``dist.join`` fault point (an injected fault is
    a failed attempt)."""
    lib = load_library()
    obs.counter("dist.join_retries_total")
    obs.counter("dist.heartbeat_lost_total")
    rng = random.SystemRandom()
    deadline = time.monotonic() + timeout_s
    attempt = 0
    last_err: Optional[BaseException] = None
    with obs.span("dist.join", host=host, port=port) as sp:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise JoinTimeout(
                    f"could not join coordinator at {host}:{port} within "
                    f"{timeout_s:.1f}s ({attempt} failed attempt(s)"
                    f"{f'; last: {last_err}' if last_err else ''})") \
                    from last_err
            try:
                faults.point("dist.join")
                h = lib.nz_client_connect(
                    host.encode(), int(port), int(rank_hint),
                    int(min(remaining, attempt_timeout_s) * 1000),
                    int(heartbeat_interval_s * 1000))
                if not h:
                    raise CoordinatorError(lib.nz_last_error().decode()
                                           or "join failed")
            except (CoordinatorError, faults.InjectedFault) as e:
                attempt += 1
                last_err = e
                obs.counter("dist.join_retries_total").inc()
                sp.set(retries=attempt)
                delay = min(backoff_max_s,
                            backoff_base_s * (2.0 ** (attempt - 1)))
                delay *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
                # Keep a last dial slice (up to 1 s) before the deadline,
                # so a coordinator that comes up late is still tried.
                reserve = min(attempt_timeout_s, 1.0)
                delay = min(delay, deadline - time.monotonic() - reserve)
                if delay > 0:
                    time.sleep(delay)
                continue
            group = ProcessGroup(h, lib)
            sp.set(rank=group.rank, world=group.world_size,
                   retries=attempt)
            return group
