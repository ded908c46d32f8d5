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

The whole train state maps the same way (:func:`train_state_to_jax`,
:func:`load_train_state`): a module, its optimizer state and the run's
PRNG key become the flat keys of the JAX package's checkpoints, and
back.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nezha_tpu_torch.optim.optimizers import state_leaves

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


def jax_leaf_names(model: torch.nn.Module) -> Dict[str, Tuple[str, bool]]:
    """``state_dict`` name -> (the leaf's key under ``variables/``, conv):
    parameters under ``params/``, BatchNorm buffers under ``state/``; a
    conv's ``weight`` is ``w`` (HWIO in JAX, OIHW here) and its ``bias``
    ``b``. The same mapping as :func:`resnet_to_jax` and
    :func:`params_to_jax`, whatever the model."""
    sd = model.state_dict()
    buffers = {name for name, _ in model.named_buffers()}
    out = {}
    for name, t in sd.items():
        prefix, _, leaf = name.rpartition(".")
        path = _to_jax_path(prefix)
        conv = leaf == "weight" and t.dim() == 4
        if name in buffers and leaf in _BN_STATE:
            out[name] = (f"state/{path}/{leaf}", False)
        elif name in buffers:
            continue
        elif conv:
            out[name] = (f"params/{path}/w", True)
        elif leaf == "bias" and prefix + ".weight" in sd:
            out[name] = (f"params/{path}/b", False)
        else:
            out[name] = ("params/" + _to_jax_path(name), False)
    return out


def jax_variable_shapes(model: torch.nn.Module
                        ) -> Dict[str, Tuple[int, ...]]:
    """``variables/<key>`` -> the leaf's shape in JAX's layout (a conv
    kernel HWIO), for every leaf :func:`jax_leaf_names` maps."""
    sd = model.state_dict()
    out = {}
    for n, (key, conv) in jax_leaf_names(model).items():
        shape = tuple(sd[n].shape)
        out[f"variables/{key}"] = (shape[2], shape[3], shape[1],
                                   shape[0]) if conv else shape
    return out


def _to_jax_leaf(t: torch.Tensor, conv: bool) -> np.ndarray:
    arr = np.array(t.detach().cpu().numpy(), copy=True) \
        if t.dtype == torch.float32 else _array(t)
    return np.ascontiguousarray(arr.transpose(2, 3, 1, 0)) if conv else arr


def _from_jax_leaf(arr: np.ndarray, conv: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.permute(3, 2, 0, 1) if conv else t


def opt_state_key(path: Tuple[str, ...],
                  names: Dict[str, Tuple[str, bool]]) -> str:
    """The JAX checkpoint key of an optimizer-state leaf: its path under
    ``opt_state/``, each parameter name replaced by the parameter's JAX
    path (``opt_state/inner/mu/h0/attn/qkv/w``,
    ``opt_state/slots/blocks0/conv1/w/vr``, ``opt_state/count``)."""
    return "opt_state/" + "/".join(
        names[p][0][len("params/"):] if p in names else p for p in path)


def _param_shaped(path: Tuple[str, ...],
                  names: Dict[str, Tuple[str, bool]]) -> bool:
    """A leaf keyed directly by a conv parameter's name holds the
    parameter's shape in the port's OIHW (a moment, a velocity, an
    accumulator); Adafactor's factored leaves are already JAX's."""
    return path[-1] in names and names[path[-1]][1]


def train_state_template(model: torch.nn.Module, opt_state=None,
                         rng: bool = True) -> Dict[str, np.dtype]:
    """The keys and dtypes :func:`train_state_to_jax` writes, without
    copying a tensor (a template for ``checkpoint.try_restore``)."""
    names = jax_leaf_names(model)
    sd = model.state_dict()
    dt = {n: np.dtype(str(sd[n].dtype).replace("torch.", ""))
          for n in names}
    out = {f"variables/{key}": dt[n] for n, (key, _) in names.items()}
    for path, leaf in state_leaves(opt_state or {}):
        out[opt_state_key(path, names)] = (
            np.dtype(str(leaf.dtype).replace("torch.", ""))
            if torch.is_tensor(leaf) else np.dtype(np.int32))
    if rng:
        out["rng"] = np.dtype(np.uint32)
    return out


def train_state_to_jax(model: torch.nn.Module, opt_state=None,
                       rng=None) -> Dict[str, np.ndarray]:
    """(module, optimizer state, PRNG key) -> the flat leaves of the JAX
    train state: ``variables/params/<path>``, ``variables/state/<path>``
    (BatchNorm statistics), every optimizer-state leaf under its
    :func:`opt_state_key` (counters int32 and 0-d, a conv's per-parameter
    tensors in HWIO, as its weight) and ``rng`` (``uint32[2]``). Each
    leaf is a host copy."""
    names = jax_leaf_names(model)
    sd = model.state_dict()
    flat = {f"variables/{key}": _to_jax_leaf(sd[n], conv)
            for n, (key, conv) in names.items()}
    for path, leaf in state_leaves(opt_state or {}):
        flat[opt_state_key(path, names)] = (
            _to_jax_leaf(leaf, _param_shaped(path, names))
            if torch.is_tensor(leaf) else np.asarray(int(leaf), np.int32))
    if rng is not None:
        flat["rng"] = np.asarray(rng, np.uint32)
    return flat


@torch.no_grad()
def load_train_state(flat: Dict[str, np.ndarray], model: torch.nn.Module,
                     opt_state=None):
    """The inverse of :func:`train_state_to_jax`: copy the leaves into
    ``model``'s parameters and buffers (in place, cast to their dtypes
    on their device) and, given the optimizer state to fill, -> a new
    one of its structure on its tensors' devices (counters Python ints);
    else None.
    A leaf whose shape differs from the module's raises ValueError."""
    names = jax_leaf_names(model)
    sd = model.state_dict()

    def take(key: str, conv: bool, like: torch.Tensor) -> torch.Tensor:
        t = _from_jax_leaf(flat[key], conv)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key} has shape "
                             f"{tuple(flat[key].shape)}, the model "
                             f"{tuple(like.shape)} (another preset or "
                             f"--seq-len?)")
        return t.to(device=like.device, dtype=like.dtype)

    for n, (key, conv) in names.items():
        sd[n].copy_(take(f"variables/{key}", conv, sd[n]))
    if opt_state is None:
        return None

    def fill(node: dict, path: Tuple[str, ...]) -> dict:
        out = {}
        for k, like in node.items():
            at = path + (k,)
            if isinstance(like, dict):
                out[k] = fill(like, at)
            elif torch.is_tensor(like):
                out[k] = take(opt_state_key(at, names),
                              _param_shaped(at, names), like).clone()
            else:
                out[k] = int(flat[opt_state_key(at, names)])
        return out

    return fill(opt_state, ())
