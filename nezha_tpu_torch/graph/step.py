"""The graph engine's train step for the port's ``Trainer``: one object
that owns the IR program's state, runs ``program(state, batch)`` on each
batch (after the config's host-side batch transform), and names its
checkpoint leaves as JAX's graph engine writes them.

JAX's graph engine checkpoints its state tree as it stands: the leaves
of ``{"params", "vel"}`` (momentum programs), ``{"params", "mu", "nu",
"step"}`` (AdamW) or ZeRO-1's ``{"flat", "vel"}``, keyed by their paths
(``params/h0/attn/qkv/w``, ``step``, ``flat``), without a ``variables/``
prefix or an ``rng`` leaf. :meth:`GraphTrainStep.state_leaves`,
:meth:`state_template` and :meth:`load_state_leaves` are those leaves,
so a graph checkpoint crosses between the packages in both directions.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from nezha_tpu_torch.graph.programs import (materialize_graph_zero1_params,
                                            tree_flatten_with_path,
                                            tree_unflatten, zero1_chunks,
                                            zero1_flat)


class GraphTrainStep:
    """``step(batch) -> {"loss"}`` over an IR program.

    ``program(state, batch) -> (state, metrics)`` is one of
    ``graph.programs``' steps, ``state`` its initial state, ``shard_fn``
    the config's host-side batch transform (``lm_shard_fn()``, ...).
    ``mesh`` is the one-process mesh of a dp or ZeRO-1 program (ZeRO-1's
    chunks are restored onto its shards); ``dims`` the MLP's widths,
    which ZeRO-1's params need to unflatten."""

    def __init__(self, program: Callable, state: dict, shard_fn: Callable,
                 mesh=None, dims=None):
        self.program = program
        self.state = state
        self.shard_fn = shard_fn
        self.mesh = mesh
        self.dims = dims
        self.device = self._device()

    def _device(self) -> torch.device:
        for _, leaf in tree_flatten_with_path(self.state)[0]:
            if isinstance(leaf, list):
                leaf = leaf[0]
            if torch.is_tensor(leaf):
                return leaf.device
        return torch.device("cpu")

    def __call__(self, batch: dict) -> Dict[str, torch.Tensor]:
        self.state, metrics = self.program(self.state, self.shard_fn(batch))
        return metrics

    def params(self) -> dict:
        """The JAX-layout parameter tree (for eval: ``load_param_tree``)."""
        if "flat" in self.state:
            return materialize_graph_zero1_params(self.dims, self.state)
        return self.state["params"]

    # -- checkpoint leaves --------------------------------------------------

    def state_leaves(self) -> Dict[str, np.ndarray]:
        """The state's leaves as host arrays under JAX's keys; ZeRO-1's
        chunks joined into the whole flat vector."""
        out = {}
        for path, leaf in tree_flatten_with_path(self.state)[0]:
            if isinstance(leaf, list):
                arr = zero1_flat(leaf)
            elif torch.is_tensor(leaf):
                arr = leaf.detach().cpu().numpy().copy()
            else:
                arr = np.asarray(leaf)
            out["/".join(path)] = arr
        return out

    def state_template(self) -> Dict[str, np.dtype]:
        """``{key: dtype}`` of :meth:`state_leaves`, without a copy."""
        out = {}
        for path, leaf in tree_flatten_with_path(self.state)[0]:
            if isinstance(leaf, list):
                leaf = leaf[0]
            dt = (str(leaf.dtype).replace("torch.", "")
                  if torch.is_tensor(leaf) else np.asarray(leaf).dtype)
            out["/".join(path)] = np.dtype(dt)
        return out

    def load_state_leaves(self, flat: Dict[str, np.ndarray]) -> None:
        """Install restored leaves: each on its leaf's device and dtype
        (ZeRO-1's flat vectors cut into the mesh's chunks)."""
        pairs, treedef = tree_flatten_with_path(self.state)
        new = []
        for path, leaf in pairs:
            arr = np.asarray(flat["/".join(path)])
            if isinstance(leaf, list):
                new.append(zero1_chunks(arr, self.mesh))
            elif torch.is_tensor(leaf):
                if arr.shape != tuple(leaf.shape):
                    raise ValueError(f"checkpoint leaf {'/'.join(path)} has "
                                     f"shape {arr.shape}, the state "
                                     f"{tuple(leaf.shape)}")
                new.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
                    device=leaf.device, dtype=leaf.dtype))
            else:
                new.append(np.asarray(arr, np.asarray(leaf).dtype))
        self.state = tree_unflatten(treedef, new)
