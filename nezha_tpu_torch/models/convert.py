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
back. A MoE GPT-2's expert layers map by the same rule
(``h{i}/mlp/router/w``, ``h{i}/mlp/w_in``, ``h{i}/mlp/w_out``). The
pipeline's state (``parallel/pipeline.py``) keys the outer parameters
``pparams/outer/<path>`` and the stacked ``[L, ...]`` block leaves
``pparams/blocks/<path within a block>`` (:func:`pipeline_key`,
:func:`pipeline_params_to_jax`, :func:`pipeline_params_from_jax`).
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


def pipeline_key(name: str) -> str:
    """A pipeline leaf's name (an outer parameter's, or ``blocks.<name
    within a block>`` for a stacked block leaf) -> its path under
    ``pparams/`` in the JAX pipeline state."""
    if name.startswith("blocks."):
        return "blocks/" + _to_jax_path(name[len("blocks."):])
    return "outer/" + _to_jax_path(name)


def pipeline_params_to_jax(pparams: Dict[str, Dict[str, torch.Tensor]]
                           ) -> Dict[str, np.ndarray]:
    """``{"outer": {name: tensor}, "blocks": {name: [L, ...] tensor}}``
    -> flat ``{"pparams/...": fp32 array}``."""
    flat = {f"pparams/{pipeline_key(n)}": _array(t)
            for n, t in pparams["outer"].items()}
    flat.update({f"pparams/{pipeline_key('blocks.' + n)}": _array(t)
                 for n, t in pparams["blocks"].items()})
    return flat


def pipeline_params_from_jax(flat: Dict[str, np.ndarray]
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The inverse of :func:`pipeline_params_to_jax` (fp32 CPU tensors);
    keys outside ``pparams/`` are ignored."""
    out: Dict[str, Dict[str, torch.Tensor]] = {"outer": {}, "blocks": {}}
    for key, arr in flat.items():
        part, _, path = key.partition("/")[2].partition("/")
        if key.startswith("pparams/") and part in out:
            out[part][_to_torch_name(path)] = _tensor(arr)
    return out


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


# ------------------------------------------------- Hugging Face weights
# Counterparts of ``nezha_tpu/models/convert.py``'s Hugging Face half:
# the same key mapping, onto the port's parameter names (through the JAX
# paths, :func:`params_from_jax`). They take a state dict and a config
# object, so this module needs no ``transformers``; ``models/hf.py``
# loads the checkpoints.


def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def gpt2_config_from_hf(hf_config, **overrides):
    """A ``transformers.GPT2Config`` -> the port's ``GPT2Config``;
    settings the model cannot express raise ValueError (JAX's checks).
    ``overrides`` replace fields (``ln_impl``, ...)."""
    from nezha_tpu_torch.models.gpt2 import GPT2Config

    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported activation_function={act!r}; "
                         "the GPT-2 block uses tanh-approximate GELU")
    eps = getattr(hf_config, "layer_norm_epsilon", 1e-5)
    if abs(eps - 1e-5) > 1e-12:
        raise ValueError(f"unsupported layer_norm_epsilon={eps}; "
                         "GPT-2 layers use eps=1e-5")
    for flag in ("scale_attn_by_inverse_layer_idx",
                 "reorder_and_upcast_attn"):
        if getattr(hf_config, flag, False):
            raise ValueError(f"unsupported GPT2Config.{flag}=True")
    n_inner = getattr(hf_config, "n_inner", None)
    if n_inner is None:
        mlp_ratio = 4
    elif n_inner % hf_config.n_embd == 0:
        mlp_ratio = n_inner // hf_config.n_embd
    else:
        raise ValueError(
            f"n_inner={n_inner} is not a multiple of n_embd="
            f"{hf_config.n_embd}; GPT2Config.mlp_ratio cannot express it")
    return GPT2Config(vocab_size=hf_config.vocab_size,
                      max_positions=hf_config.n_positions,
                      num_layers=hf_config.n_layer,
                      num_heads=hf_config.n_head,
                      hidden_size=hf_config.n_embd, mlp_ratio=mlp_ratio,
                      dropout=0.0, **overrides)


def _gpt2_hf_paths(num_layers: int) -> Dict[str, str]:
    """JAX path -> HF key (without the ``transformer.`` prefix); HF's
    Conv1D stores ``[in, out]``, as ``Linear.w``."""
    out = {"wte/embedding": "wte.weight", "wpe/embedding": "wpe.weight",
           "ln_f/scale": "ln_f.weight", "ln_f/bias": "ln_f.bias"}
    for i in range(num_layers):
        h = f"h.{i}"
        for ours, theirs in (("ln_1/scale", "ln_1.weight"),
                             ("ln_1/bias", "ln_1.bias"),
                             ("attn/qkv/w", "attn.c_attn.weight"),
                             ("attn/qkv/b", "attn.c_attn.bias"),
                             ("attn/proj/w", "attn.c_proj.weight"),
                             ("attn/proj/b", "attn.c_proj.bias"),
                             ("ln_2/scale", "ln_2.weight"),
                             ("ln_2/bias", "ln_2.bias"),
                             ("mlp/fc/w", "mlp.c_fc.weight"),
                             ("mlp/fc/b", "mlp.c_fc.bias"),
                             ("mlp/proj/w", "mlp.c_proj.weight"),
                             ("mlp/proj/b", "mlp.c_proj.bias")):
            out[f"h{i}/{ours}"] = f"{h}.{theirs}"
    return out


def gpt2_params_from_hf(state_dict, num_layers: int
                        ) -> Dict[str, torch.Tensor]:
    """A ``GPT2LMHeadModel`` (or ``GPT2Model``) state dict -> a
    ``state_dict`` for :class:`~nezha_tpu_torch.models.gpt2.GPT2` (fp32
    CPU tensors); the keys may carry the ``transformer.`` prefix or not,
    and the tied ``lm_head.weight`` is not read."""
    sd = {k: _np(v) for k, v in state_dict.items()}

    def pre(k):
        return sd[k if k in sd else f"transformer.{k}"]

    return params_from_jax({path: pre(key) for path, key in
                            _gpt2_hf_paths(num_layers).items()})


def gpt2_from_hf(hf_model, device=None, **overrides):
    """The port's ``GPT2`` from a ``transformers.GPT2LMHeadModel``: its
    config, fp32 weights (the default policy, as JAX's), on ``device``
    (``cuda`` when None)."""
    from nezha_tpu_torch.models.gpt2 import GPT2

    cfg = gpt2_config_from_hf(hf_model.config, **overrides)
    model = GPT2(cfg, device=device)
    model.load_state_dict(gpt2_params_from_hf(hf_model.state_dict(),
                                              cfg.num_layers))
    return model


def gpt2_params_to_hf(state_dict, num_layers: int
                      ) -> Dict[str, np.ndarray]:
    """A GPT-2 ``state_dict`` -> the HF ``transformer.*`` key layout and
    the tied ``lm_head.weight`` (fp32 numpy)."""
    flat = params_to_jax(state_dict)
    out = {f"transformer.{key}": flat[path] for path, key in
           _gpt2_hf_paths(num_layers).items()}
    out["lm_head.weight"] = flat["wte/embedding"]
    return out


def bert_config_from_hf(hf_config, **overrides):
    """A ``transformers.BertConfig`` -> the port's ``BertConfig`` (JAX's
    checks)."""
    from nezha_tpu_torch.models.bert import BertConfig

    act = getattr(hf_config, "hidden_act", "gelu")
    if act != "gelu":
        raise ValueError(f"unsupported hidden_act={act!r}; "
                         "the BERT block uses erf GELU")
    if hf_config.intermediate_size % hf_config.hidden_size:
        raise ValueError(
            f"intermediate_size={hf_config.intermediate_size} is not a "
            f"multiple of hidden_size={hf_config.hidden_size}")
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        max_positions=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        hidden_size=hf_config.hidden_size,
        mlp_ratio=hf_config.intermediate_size // hf_config.hidden_size,
        dropout=0.0, ln_eps=hf_config.layer_norm_eps, **overrides)


_BERT_LINEARS = (("attn_out", "attention.output.dense"),
                 ("fc", "intermediate.dense"), ("fc_out", "output.dense"))
_BERT_NORMS = (("attn_ln", "attention.output.LayerNorm"),
               ("out_ln", "output.LayerNorm"))


def bert_params_from_hf(state_dict, num_layers: int
                        ) -> Dict[str, torch.Tensor]:
    """A ``BertForMaskedLM`` state dict -> a ``state_dict`` for
    :class:`~nezha_tpu_torch.models.bert.Bert` (fp32 CPU tensors): torch
    ``Linear`` weights (``[out, in]``) transposed, q/k/v concatenated
    into the fused qkv."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    flat = {}

    def lin(path, key):
        flat[f"{path}/w"] = sd[f"{key}.weight"].T
        flat[f"{path}/b"] = sd[f"{key}.bias"]

    def ln(path, key):
        flat[f"{path}/scale"] = sd[f"{key}.weight"]
        flat[f"{path}/bias"] = sd[f"{key}.bias"]

    emb = "bert.embeddings"
    flat["tok_emb/embedding"] = sd[f"{emb}.word_embeddings.weight"]
    flat["pos_emb/embedding"] = sd[f"{emb}.position_embeddings.weight"]
    flat["type_emb/embedding"] = sd[f"{emb}.token_type_embeddings.weight"]
    ln("emb_ln", f"{emb}.LayerNorm")
    lin("mlm_dense", "cls.predictions.transform.dense")
    ln("mlm_ln", "cls.predictions.transform.LayerNorm")
    flat["mlm_bias"] = sd["cls.predictions.bias"]
    for i in range(num_layers):
        L = f"bert.encoder.layer.{i}"
        q, k, v = (f"{L}.attention.self.{n}" for n in ("query", "key",
                                                       "value"))
        flat[f"layers{i}/qkv/w"] = np.concatenate(
            [sd[f"{n}.weight"].T for n in (q, k, v)], axis=1)
        flat[f"layers{i}/qkv/b"] = np.concatenate(
            [sd[f"{n}.bias"] for n in (q, k, v)])
        for ours, theirs in _BERT_LINEARS:
            lin(f"layers{i}/{ours}", f"{L}.{theirs}")
        for ours, theirs in _BERT_NORMS:
            ln(f"layers{i}/{ours}", f"{L}.{theirs}")
    return bert_from_jax(flat)


def bert_from_hf(hf_model, device=None, **overrides):
    """The port's ``Bert`` from a ``transformers.BertForMaskedLM`` (fp32
    weights, on ``device``)."""
    from nezha_tpu_torch.models.bert import Bert

    cfg = bert_config_from_hf(hf_model.config, **overrides)
    model = Bert(cfg, device=device)
    model.load_state_dict(bert_params_from_hf(hf_model.state_dict(),
                                              cfg.num_layers))
    return model


def bert_params_to_hf(state_dict, num_layers: int, hidden_size: int
                      ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`bert_params_from_hf`, in the
    ``BertForMaskedLM`` key layout (fp32 numpy), with the tied decoder's
    weight and bias written again under its own keys, as HF does."""
    flat = bert_to_jax(state_dict)
    out = {}

    def put_lin(key, path):
        out[f"{key}.weight"] = np.ascontiguousarray(flat[f"{path}/w"].T)
        out[f"{key}.bias"] = flat[f"{path}/b"]

    def put_ln(key, path):
        out[f"{key}.weight"] = flat[f"{path}/scale"]
        out[f"{key}.bias"] = flat[f"{path}/bias"]

    emb = "bert.embeddings"
    out[f"{emb}.word_embeddings.weight"] = flat["tok_emb/embedding"]
    out[f"{emb}.position_embeddings.weight"] = flat["pos_emb/embedding"]
    out[f"{emb}.token_type_embeddings.weight"] = flat["type_emb/embedding"]
    out["cls.predictions.bias"] = flat["mlm_bias"]
    out["cls.predictions.decoder.weight"] = flat["tok_emb/embedding"]
    out["cls.predictions.decoder.bias"] = flat["mlm_bias"]
    put_ln(f"{emb}.LayerNorm", "emb_ln")
    put_lin("cls.predictions.transform.dense", "mlm_dense")
    put_ln("cls.predictions.transform.LayerNorm", "mlm_ln")
    h = hidden_size
    for i in range(num_layers):
        L = f"bert.encoder.layer.{i}"
        w, b = flat[f"layers{i}/qkv/w"], flat[f"layers{i}/qkv/b"]
        for j, name in enumerate(("query", "key", "value")):
            out[f"{L}.attention.self.{name}.weight"] = \
                np.ascontiguousarray(w[:, j * h:(j + 1) * h].T)
            out[f"{L}.attention.self.{name}.bias"] = b[j * h:(j + 1) * h]
        for ours, theirs in _BERT_LINEARS:
            put_lin(f"{L}.{theirs}", f"layers{i}/{ours}")
        for ours, theirs in _BERT_NORMS:
            put_ln(f"{L}.{theirs}", f"layers{i}/{ours}")
    return out
