"""Weight interchange with the JAX package's parameter and state trees.

The JAX package keys parameters by path. GPT-2's — ``wte/embedding``,
``wpe/embedding``, ``h{i}/ln_1/{scale,bias}``, ``h{i}/attn/qkv/{w,b}``,
``h{i}/attn/proj/{w,b}``, ``h{i}/ln_2/...``, ``h{i}/mlp/fc|proj/{w,b}``
and ``ln_f/{scale,bias}`` — and the MLP's — ``fc{i}/{w,b}``,
``head/{w,b}`` — have the layouts the port uses (``Linear.w`` is ``[in,
out]``): :func:`params_from_jax` maps such a flat ``{path: array}`` dict
onto the port's ``state_dict`` names, which is how both packages compute
with the same weights. BERT's (:func:`bert_from_jax`) are laid out the
same way: ``tok_emb``/``pos_emb``/``type_emb/embedding``,
``emb_ln/{scale,bias}``, ``layers{i}/{qkv,attn_out,fc,fc_out}/{w,b}``,
``layers{i}/{attn_ln,out_ln}/{scale,bias}``, ``mlm_dense/{w,b}``,
``mlm_ln/{scale,bias}`` and the top-level ``mlm_bias``. The ResNets' need more (:func:`resnet_from_jax`):
a conv's ``w`` is HWIO in JAX and ``weight`` OIHW in the port, and the
BatchNorm running statistics live in JAX's state tree and in the port's
buffers ``mean`` and ``var``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_LAYER = re.compile(r"^(h|blocks|layers)(\d+)/")
_BN_STATE = ("mean", "var")


def _to_torch_name(path: str) -> str:
    return _LAYER.sub(r"\1.\2/", path).replace("/", ".")


def _to_jax_path(name: str) -> str:
    return re.sub(r"^(h|blocks|layers)\.(\d+)\.", r"\1\2.", name).replace(
        ".", "/")


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def _array(t: torch.Tensor) -> np.ndarray:
    """An fp32 copy: a CPU fp32 tensor's ``numpy()`` would alias it."""
    return np.array(t.detach().float().cpu().numpy(), copy=True)


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"h0/attn/qkv/w": array, ...}`` -> a ``state_dict`` for
    :class:`nezha_tpu_torch.models.gpt2.GPT2` (fp32 CPU tensors; the
    module's ``load_state_dict`` moves them to its device and dtype)."""
    return {_to_torch_name(path): _tensor(arr)
            for path, arr in flat.items()}


def params_to_jax(state_dict: Dict[str, torch.Tensor]
                  ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` -> flat
    ``{path: fp32 array}`` keyed like the JAX parameter tree."""
    return {_to_jax_path(name): _array(t) for name, t in state_dict.items()}


def bert_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX BERT's flat params (``{"layers0/qkv/w": array, ...,
    "mlm_bias": array}``) -> a ``state_dict`` for
    :class:`nezha_tpu_torch.models.bert.Bert` (``layers.0.qkv.w``, ...,
    ``mlm_bias``; fp32 CPU tensors)."""
    return params_from_jax(flat)


def bert_to_jax(state_dict: Dict[str, torch.Tensor]
                ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`bert_from_jax`."""
    return params_to_jax(state_dict)


def resnet_from_jax(flat_params: Dict[str, np.ndarray],
                    flat_state: Optional[Dict[str, np.ndarray]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A JAX ResNet's flat params and state -> a ``state_dict`` for
    :class:`nezha_tpu_torch.models.resnet.ResNet`: ``blocks3/conv2/w``
    (HWIO) -> ``blocks.3.conv2.weight`` (OIHW), a conv's ``b`` ->
    ``bias``, ``blocks3/bn2/mean`` (state) -> the buffer
    ``blocks.3.bn2.mean``; other paths as :func:`params_from_jax`."""
    out = {}
    for path, arr in flat_params.items():
        prefix, leaf = path.rsplit("/", 1)
        conv = np.ndim(flat_params.get(prefix + "/w")) == 4
        name = _to_torch_name(prefix)
        if conv and leaf == "w":
            out[name + ".weight"] = _tensor(arr).permute(3, 2, 0, 1)
        elif conv and leaf == "b":
            out[name + ".bias"] = _tensor(arr)
        else:
            out[f"{name}.{leaf}"] = _tensor(arr)
    for path, arr in (flat_state or {}).items():
        out[_to_torch_name(path)] = _tensor(arr)
    return out


def resnet_to_jax(state_dict: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The inverse of :func:`resnet_from_jax`: a ``state_dict`` -> (flat
    params, flat state), fp32 arrays keyed like the JAX trees."""
    params, state = {}, {}
    for name, t in state_dict.items():
        arr = _array(t)
        prefix, leaf = name.rsplit(".", 1)
        path = _to_jax_path(prefix)
        if leaf in _BN_STATE:
            state[f"{path}/{leaf}"] = arr
        elif leaf == "weight":
            params[path + "/w"] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0))
        elif leaf == "bias" and prefix + ".weight" in state_dict:
            params[path + "/b"] = arr
        else:
            params[f"{path}/{leaf}"] = arr
    return params, state
