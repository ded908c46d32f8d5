"""Rematerialization: keep a block's input, recompute its internals in
the backward (counterpart of the JAX package's ``jax.checkpoint`` around
a transformer block, a ResNet bottleneck or a pipeline stage).

:func:`checkpoint` is ``torch.utils.checkpoint.checkpoint`` with
``use_reentrant=False`` and two repairs for state JAX keeps functional:

- dropout masks: the port's ``Dropout`` draws from explicit
  ``torch.Generator`` objects, which ``preserve_rng_state`` does not save
  (it saves the default CPU and current-card generators). The forward
  records each given generator's state, and the recompute replays from
  it, so the recomputed masks are the forward's (JAX replays by keys);
  afterwards the generators are put back where the backward found them;
- running statistics: inside the recompute :func:`recomputing` is true,
  and ``BatchNorm`` then leaves its buffers alone, so a step updates them
  once, as JAX's functional state does.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Iterable

import torch
from torch.utils import checkpoint as _ckpt

_RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar(
    "nezha_torch_recomputing", default=False)


def recomputing() -> bool:
    """True while a :func:`checkpoint` region is being recomputed."""
    return _RECOMPUTING.get()


def _contexts(generators):
    saved = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in generators]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in generators]
        for g, s in zip(generators, saved):
            g.set_state(s)
        token = _RECOMPUTING.set(True)
        try:
            yield
        finally:
            _RECOMPUTING.reset(token)
            for g, s in zip(generators, now):
                g.set_state(s)

    return forward(), recompute()


def checkpoint(fn: Callable, *args,
               generators: Iterable[torch.Generator] = (), **kwargs) -> Any:
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward; ``generators`` are replayed in the recompute."""
    gens = list({id(g): g for g in generators}.values())
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=lambda: _contexts(gens), **kwargs)


def dropout_generators(module: torch.nn.Module):
    """The generators of ``module``'s active dropouts."""
    from nezha_tpu_torch.nn.layers import Dropout
    return [m.generator for m in module.modules()
            if isinstance(m, Dropout) and m.rate and m.generator is not None]


__all__ = ["checkpoint", "dropout_generators", "recomputing"]
