"""From the coordinator's world to ``torch.distributed`` (counterpart of
``nezha_tpu/dist/launch.py``, which starts ``jax.distributed``).

Rank 0 opens a ``torch.distributed.TCPStore`` on a free port and puts its
``host:port`` into the coordinator's key-value store, as the JAX package
advertises ``__jax_coord_addr``; every rank reads it and enters
``init_process_group`` with that store, its coordinator-given rank and the
world size. The world comes from the coordinator, not from ``torchrun``'s
environment, and the backend is the caller's: ``nccl`` for ``cuda``,
``gloo`` for ``cpu`` (:func:`backend_for`), with no fallback when it
fails to start.
"""

from __future__ import annotations

import datetime
import socket
from typing import Optional

import torch
import torch.distributed as dist

from nezha_tpu_torch.dist.coordinator import ProcessGroup

STORE_KEY = "__torch_store_addr"
_LOOPBACK = ("", "localhost", "127.0.0.1", "::1")


def backend_for(device) -> str:
    """The process-group backend for a device: ``nccl`` on ``cuda``,
    ``gloo`` on ``cpu``."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {kind!r}")


def store_host(coordinator_host: str) -> str:
    """The host rank 0 advertises for the store: the loopback address
    when the coordinator is local (every rank is on this host), else
    this host's name."""
    return "127.0.0.1" if coordinator_host in _LOOPBACK \
        else socket.gethostname()


def init_torch_distributed(group: ProcessGroup, backend: str,
                           timeout_s: Optional[float] = 120.0,
                           host: str = "127.0.0.1") -> None:
    """Initialize ``torch.distributed``'s default group over ``group``'s
    processes: rank 0 opens the store on ``host`` at a free port and
    advertises it; every rank joins with ``backend``. Raises when the
    backend cannot start."""
    timeout = datetime.timedelta(seconds=timeout_s or 1800)
    if group.rank == 0:
        store = dist.TCPStore(host, 0, group.world_size, is_master=True,
                              wait_for_workers=False, timeout=timeout)
        group.put(STORE_KEY, f"{host}:{store.port}".encode())
    addr = group.get(STORE_KEY, timeout_s).decode()
    if group.rank != 0:
        h, _, port = addr.rpartition(":")
        store = dist.TCPStore(h, int(port), group.world_size,
                              is_master=False, timeout=timeout)
    dist.init_process_group(backend, store=store, rank=group.rank,
                            world_size=group.world_size, timeout=timeout)
