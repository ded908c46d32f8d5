"""Host<->device transfer and device-memory introspection (counterpart of
``nezha_tpu/tensor/memory.py``).

A tree is a tensor or array, or a dict, list or tuple of trees. The
card's memory is HBM3, so the metric names stay the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def to_device(tree: Any, device="cuda") -> Any:
    """Move a tree of host arrays or tensors onto ``device``."""
    return _tree_map(lambda x: (x if torch.is_tensor(x) else torch.as_tensor(
        np.asarray(x))).to(device), tree)


def to_host(tree: Any) -> Any:
    """Fetch a tree of tensors back to host numpy arrays (blocking)."""
    return _tree_map(lambda x: x.detach().cpu().numpy()
                     if torch.is_tensor(x) else np.asarray(x), tree)


def tree_bytes(tree: Any) -> int:
    """Total bytes of all tensor and array leaves of a tree."""
    total = 0
    for x in _leaves(tree):
        if torch.is_tensor(x):
            total += x.numel() * x.element_size()
        elif hasattr(x, "dtype") and hasattr(x, "size"):
            total += int(x.size) * np.dtype(x.dtype).itemsize
    return total


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_memory_stats(device=None) -> dict:
    """The caching allocator's statistics for a CUDA device
    (``torch.cuda.memory_stats``); empty for the CPU. ``device`` None: the
    current CUDA device when there is one, else the CPU."""
    dev = _device(device)
    if dev.type != "cuda":
        return {}
    return torch.cuda.memory_stats(dev)


def memory_metrics(device=None) -> dict:
    """The live and peak bytes worth logging every step, under stable
    metric names: ``hbm_bytes_in_use`` (``allocated_bytes.all.current``)
    and ``hbm_peak_bytes`` (``allocated_bytes.all.peak``); empty on the
    CPU."""
    stats = device_memory_stats(device)
    out = {}
    if "allocated_bytes.all.current" in stats:
        out["hbm_bytes_in_use"] = int(stats["allocated_bytes.all.current"])
    if "allocated_bytes.all.peak" in stats:
        out["hbm_peak_bytes"] = int(stats["allocated_bytes.all.peak"])
    return out
