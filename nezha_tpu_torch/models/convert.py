"""Weight interchange with the JAX package's GPT-2 parameter tree.

The JAX package keys GPT-2 parameters by path — ``wte/embedding``,
``wpe/embedding``, ``h{i}/ln_1/{scale,bias}``, ``h{i}/attn/qkv/{w,b}``,
``h{i}/attn/proj/{w,b}``, ``h{i}/ln_2/...``, ``h{i}/mlp/fc|proj/{w,b}``
and ``ln_f/{scale,bias}`` — with the same layouts the port uses
(``Linear.w`` is ``[in, out]``). :func:`params_from_jax` maps such a flat
``{path: array}`` dict onto the port's ``state_dict`` names, which is how
both packages compute with the same weights.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_LAYER = re.compile(r"^h(\d+)/")


def _to_torch_name(path: str) -> str:
    return _LAYER.sub(r"h.\1/", path).replace("/", ".")


def _to_jax_path(name: str) -> str:
    return re.sub(r"^h\.(\d+)\.", r"h\1.", name).replace(".", "/")


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"h0/attn/qkv/w": array, ...}`` -> a ``state_dict`` for
    :class:`nezha_tpu_torch.models.gpt2.GPT2` (fp32 CPU tensors; the
    module's ``load_state_dict`` moves them to its device and dtype)."""
    return {_to_torch_name(path): torch.from_numpy(
                np.array(arr, dtype=np.float32, copy=True))
            for path, arr in flat.items()}


def params_to_jax(state_dict: Dict[str, torch.Tensor]
                  ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` -> flat
    ``{path: fp32 array}`` keyed like the JAX parameter tree."""
    return {_to_jax_path(name): t.detach().float().cpu().numpy()
            for name, t in state_dict.items()}
