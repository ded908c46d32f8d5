"""The layer-stacked trunk (counterpart of the scan helpers of
``nezha_tpu/nn/module.py``: ``stack_prefixed_params``,
``unstack_prefixed_params``, ``scan_stack_init``, ``scan_stack_apply``).

JAX keeps a ``--scan-layers`` trunk as ONE parameter subtree whose every
leaf has a leading ``[L]`` layer dim (``h_scan`` for GPT-2,
``layers_scan`` for BERT) and runs it through ``lax.scan`` over one
traced block. Here the trunk is one block module whose parameters are
those stacked ``[L, ...]`` tensors (so its ``state_dict`` names are
``h_scan.attn.qkv.w`` and the checkpoint keys JAX's), applied layer by
layer: each layer runs the same module through
``torch.func.functional_call`` on views of its slices (one ``unbind`` a
forward, whose backward stacks the layers' gradients into the stacked
gradient).

The layers' dropout draws from the module's generators in layer order,
the derivation the unrolled trunk uses in the port (one stream through
``h0``, ``h1``, ...), so both layouts draw the same masks; ``remat``
recomputes each layer through ``nn/remat.py`` with those generators
replayed.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from nezha_tpu_torch.nn.remat import checkpoint, dropout_generators


def _stack(xs):
    if torch.is_tensor(xs[0]):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def stack_prefixed_params(params: dict, prefix: str, num_layers: int,
                          stacked_key: str) -> dict:
    """``{prefix}0 .. {prefix}{L-1}`` param subtrees (nested dicts of
    tensors or arrays) -> one ``stacked_key`` subtree with a leading [L]
    dim on every leaf. Non-matching entries pass through untouched."""
    names = {f"{prefix}{i}" for i in range(num_layers)}
    out = {k: v for k, v in params.items() if k not in names}
    layers = [params[f"{prefix}{i}"] for i in range(num_layers)]
    out[stacked_key] = _map(lambda *xs: _stack(xs), *layers)
    return out


def unstack_prefixed_params(params: dict, prefix: str, num_layers: int,
                            stacked_key: str) -> dict:
    """Inverse of :func:`stack_prefixed_params`."""
    out = {k: v for k, v in params.items() if k != stacked_key}
    for i in range(num_layers):
        out[f"{prefix}{i}"] = _map(lambda x, i=i: x[i], params[stacked_key])
    return out


def scan_source(key: str, prefix: str, stacked_key: str):
    """An unrolled leaf's place in a stacked trunk: ``a/{prefix}{i}/b`` ->
    (``a/{stacked_key}/b``, i); None for a key outside the trunk."""
    parts = key.split("/")
    for j, p in enumerate(parts):
        if p.startswith(prefix) and p[len(prefix):].isdigit():
            return ("/".join(parts[:j] + [stacked_key] + parts[j + 1:]),
                    int(p[len(prefix):]))
    return None


def stack_flat_keys(flat: Dict[str, np.ndarray], prefix: str,
                    num_layers: int, stacked_key: str
                    ) -> Dict[str, np.ndarray]:
    """The same over flat checkpoint keys: every ``.../{prefix}{i}/rest``
    key becomes ``.../{stacked_key}/rest`` holding the L layers'
    arrays stacked (a path may sit under ``variables/params/`` or an
    optimizer slot)."""
    out, groups = {}, {}
    for key, arr in flat.items():
        hit = scan_source(key, prefix, stacked_key)
        if hit is None or hit[1] >= num_layers:
            out[key] = arr
            continue
        groups.setdefault(hit[0], {})[hit[1]] = arr
    for key, layers in groups.items():
        out[key] = np.stack([np.asarray(layers[i])
                             for i in range(num_layers)])
    return out


def unstack_flat_keys(flat: Dict[str, np.ndarray], prefix: str,
                      num_layers: int, stacked_key: str
                      ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`stack_flat_keys`: each ``.../{stacked_key}/rest``
    key becomes the L keys ``.../{prefix}{i}/rest``."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if stacked_key not in parts:
            out[key] = arr
            continue
        j = parts.index(stacked_key)
        for i in range(num_layers):
            out["/".join(parts[:j] + [f"{prefix}{i}"] + parts[j + 1:])] = \
                np.asarray(arr)[i]
    return out


def scan_stack_init(layers: Sequence[nn.Module]) -> nn.Module:
    """One module holding ``layers`` (built in order, as the unrolled
    trunk builds them, so each draws the weights its unrolled twin does)
    with every parameter replaced by the ``[L, ...]`` stack of the
    layers'. Stateless layers only, as in JAX (a buffer would need a
    per-layer carry the layout does not model)."""
    template = layers[0]
    if any(True for _ in template.buffers()):
        raise ValueError("scan_layers requires stateless layers")
    stacked = {name: torch.stack([dict(l.named_parameters())[name].detach()
                                  for l in layers])
               for name, _ in template.named_parameters()}
    for name, value in stacked.items():
        owner, _, leaf = name.rpartition(".")
        mod = template.get_submodule(owner) if owner else template
        setattr(mod, leaf, nn.Parameter(value))
    return template


def layer_params(stack: nn.Module) -> List[Dict[str, torch.Tensor]]:
    """Each layer's parameters: views of the stacked tensors, from one
    ``unbind`` each (whose backward stacks the layers' gradients)."""
    names, slices = [], []
    for name, p in stack.named_parameters():
        names.append(name)
        slices.append(p.unbind(0))
    return [dict(zip(names, per)) for per in zip(*slices)]


def scan_stack_apply(stack: nn.Module, x, num_layers: int,
                     remat: bool = False, **layer_kwargs):
    """Apply a layer-stacked trunk: ``stack`` (its parameters ``[L,
    ...]``) run once a layer over the slices, the output of one the input
    of the next; ``layer_kwargs`` are layer-invariant inputs (masks,
    position offsets). ``remat=True`` recomputes each layer in the
    backward, its dropout masks replayed (``nn/remat.py``)."""
    gens = dropout_generators(stack) if remat else ()
    per_layer = layer_params(stack)
    if len(per_layer) != num_layers:
        raise ValueError(f"the stack holds {len(per_layer)} layers, not "
                         f"{num_layers}")

    def run(params, h):
        return torch.func.functional_call(stack, params, (h,), layer_kwargs)

    for params in per_layer:
        if remat:
            x = checkpoint(lambda h, params=params: run(params, h), x,
                           generators=gens)
        else:
            x = run(params, x)
    return x


def layer_slice(stack: nn.Module, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s parameters: views ``p[i]`` of the stacked tensors
    (the decode path's per-layer slice)."""
    return {name: p[i] for name, p in stack.named_parameters()}


__all__ = ["layer_params", "layer_slice", "scan_source",
           "scan_stack_apply", "scan_stack_init", "stack_flat_keys",
           "stack_prefixed_params", "unstack_flat_keys",
           "unstack_prefixed_params"]
