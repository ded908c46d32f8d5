"""Hugging Face checkpoints in and out: the one module of the port that
imports ``transformers`` (at call time, never at import).

The JAX package reads ``--hf-dir`` with
``transformers.GPT2LMHeadModel.from_pretrained`` (``nezha_tpu/cli/
common.py``); so does :func:`load_gpt2`, then maps the weights with
:func:`~nezha_tpu_torch.models.convert.gpt2_from_hf`, which takes a state
dict and needs no ``transformers``. :func:`random_hf_model` gives a
seeded random HF model, to write an HF directory from or to load an
export into (``load_state_dict(strict=True)``), with no download.

``from_pretrained`` may keep the dtype stored in the directory and tie or
drop ``lm_head.weight`` depending on the ``transformers`` version;
:func:`load_gpt2` reads the transformer's weights only, cast to fp32.
"""

from __future__ import annotations

import os

import torch


def _transformers():
    import transformers
    return transformers


def _hf_class(kind: str):
    """The HF model class of ``kind``: ``GPT2LMHeadModel`` or
    ``BertForMaskedLM``."""
    tf = _transformers()
    return {"gpt2": tf.GPT2LMHeadModel, "bert": tf.BertForMaskedLM}[kind]


def random_hf_model(kind: str, seed: int = 0, device="cpu", **config):
    """A randomly initialized HF model of ``kind`` (``config`` the
    fields of ``GPT2Config`` / ``BertConfig``, the library's defaults
    otherwise; dropout off), in fp32 eval mode, its weights drawn on
    ``device`` after ``torch.manual_seed(seed)``."""
    tf = _transformers()
    cfg_cls = {"gpt2": tf.GPT2Config, "bert": tf.BertConfig}[kind]
    drop = ({"resid_pdrop": 0.0, "embd_pdrop": 0.0, "attn_pdrop": 0.0}
            if kind == "gpt2" else {"hidden_dropout_prob": 0.0,
                                    "attention_probs_dropout_prob": 0.0})
    torch.manual_seed(seed)
    with torch.device(device):
        model = _hf_class(kind)(cfg_cls(**{**drop, **config}))
    return model.float().eval()


def load_gpt2(hf_dir: str, device=None, **overrides):
    """``--hf-dir``: the port's GPT-2 (fp32, on ``device``) from a
    ``GPT2LMHeadModel`` directory through ``from_pretrained``;
    ``overrides`` replace config fields. Only a local directory is read
    (never a hub name); a missing directory, or one ``from_pretrained``
    cannot read, exits naming it."""
    from nezha_tpu_torch.models.convert import gpt2_from_hf

    if not os.path.isdir(hf_dir):
        raise SystemExit(f"--hf-dir {hf_dir}: no such directory")
    try:
        hf_model = _hf_class("gpt2").from_pretrained(hf_dir,
                                                    local_files_only=True)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--hf-dir {hf_dir}: {e}")
    return gpt2_from_hf(hf_model.float(), device=device, **overrides)
