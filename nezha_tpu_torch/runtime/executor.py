"""Executor: cached dispatch of graphs and functions (counterpart of
``nezha_tpu/runtime/executor.py``).

The executor's job is program lifetime: build once per (graph or
function, argument shapes), reuse on every call. A ``Graph`` builds into
a :class:`~nezha_tpu_torch.graph.lower.CompiledGraph` (its ``torch.fx``
program bound to the arguments' shapes, constants on their device); a
function is its own program. The telemetry is JAX's: the
``compile_cache.hits`` and ``compile_cache.misses`` counters, the
``compile_cache.compile_seconds`` histogram (the first call of a built
program) and the ``executor.compile`` span, which a ``--run-dir``
``summary.json`` reports under ``compile_cache``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, Dict, Hashable, Tuple

import numpy as np
import torch

from nezha_tpu_torch import obs
from nezha_tpu_torch.graph.graph import Graph
from nezha_tpu_torch.graph.lower import compile_graph


def _graph_fingerprint(graph: Graph) -> Hashable:
    """Structural identity of a graph: ops, edges, and attrs — so distinct
    graphs never share a built program even if same-named/sized."""

    def attr_val(v):
        if isinstance(v, np.ndarray):
            # repr() truncates big arrays; hash the actual bytes instead.
            h = hashlib.sha256()
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
            return ("ndarray", h.hexdigest())
        return repr(v)

    def attr_sig(attrs):
        return tuple(sorted((k, attr_val(v)) for k, v in attrs.items()))

    return (
        tuple((n.op, n.inputs, attr_sig(n.attrs)) for n in graph.nodes),
        tuple(graph.placeholders),
        tuple(graph.outputs),
    )


def _leaves(tree):
    """(structure, leaves) of a tree of dicts (sorted keys, as JAX
    flattens them), lists and tuples."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_leaves(tree[k]) for k in keys]
        return (("dict", tuple(keys), tuple(s for s, _ in subs)),
                [leaf for _, ls in subs for leaf in ls])
    if isinstance(tree, (list, tuple)):
        subs = [_leaves(x) for x in tree]
        return ((type(tree).__name__, tuple(s for s, _ in subs)),
                [leaf for _, ls in subs for leaf in ls])
    return "leaf", [tree]


def _signature(args: Tuple, kwargs: Dict) -> Hashable:
    def leaf_sig(x):
        if torch.is_tensor(x):
            return ("arr", tuple(x.shape), str(x.dtype), str(x.device))
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return ("arr", tuple(x.shape), str(x.dtype))
        return ("lit", x)

    treedef, leaves = _leaves((args, kwargs))
    return (treedef, tuple(leaf_sig(leaf) for leaf in leaves))


class CompileCache:
    """Thread-safe (signature -> built program) cache with stats.

    Hit/miss/build-time telemetry flows to the process-wide registry
    (``compile_cache.*``, the compiler-cache view in a ``--run-dir``
    summary) alongside the local attributes."""

    def __init__(self):
        self._cache: Dict[Hashable, Any] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        value, _ = self.get_or_build2(key, build)
        return value

    def get_or_build2(self, key: Hashable,
                      build: Callable[[], Any]) -> "Tuple[Any, bool]":
        """-> ``(value, built)`` where ``built`` says whether THIS call
        populated the entry — a per-call miss signal (the shared ``misses``
        counter can move concurrently under other keys)."""
        with self._lock:
            if key in self._cache:
                self.hits += 1
                obs.counter("compile_cache.hits").inc()
                return self._cache[key], False
        built = build()  # build outside the lock; duplicate builds are benign
        with self._lock:
            self.misses += 1
            obs.counter("compile_cache.misses").inc()
            return self._cache.setdefault(key, built), True

    def __len__(self):
        return len(self._cache)


class Executor:
    """Runs functions or Graph IR programs with build caching.

    ``run`` returns what the program returns; work launched on a card is
    asynchronous, as every torch call is (read a value or synchronize to
    wait). ``donate_argnums`` is accepted for JAX's signature and has no
    effect: torch has no buffer donation, and the graph programs return
    their new state rather than updating their inputs.
    """

    def __init__(self, donate_argnums: Tuple[int, ...] = ()):
        self.cache = CompileCache()
        self.donate_argnums = donate_argnums

    def run(self, fn_or_graph, *args, **kwargs):
        if isinstance(fn_or_graph, Graph):
            graph = fn_or_graph
            base_key = ("graph", _graph_fingerprint(graph))
            build = lambda: compile_graph(graph, args)
        else:
            # Key by the function object itself: hashable, and the cache
            # entry keeps it alive so ids can't be recycled.
            base_key = ("fn", fn_or_graph)
            build = lambda: fn_or_graph
        key = (base_key, _signature(args, kwargs))
        program, built = self.cache.get_or_build2(key, build)
        if built and obs.enabled():
            # The first call of a built program loads what it launches
            # (the kernels' builds included): its compile-time record.
            with obs.span("executor.compile", kind=base_key[0]):
                t0 = time.perf_counter()
                out = program(*args, **kwargs)
                obs.histogram("compile_cache.compile_seconds").observe(
                    time.perf_counter() - t0)
            return out
        return program(*args, **kwargs)

    def stats(self) -> dict:
        return {"entries": len(self.cache), "hits": self.cache.hits,
                "misses": self.cache.misses}
