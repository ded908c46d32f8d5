"""Shared CLI helpers (counterpart of ``nezha_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from nezha_tpu_torch.data.tokenizer import default_eos_id, load_tokenizer
from nezha_tpu_torch.models.convert import (jax_variable_shapes,
                                            load_train_state,
                                            train_state_to_jax)
from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config
from nezha_tpu_torch.nn.scan import scan_source
from nezha_tpu_torch.tensor.policy import bf16_policy, f32_policy
from nezha_tpu_torch.train import checkpoint as ckpt
from nezha_tpu_torch.train import sharded_checkpoint as sck

# The tiny GPT-2 and BERT presets (nezha_tpu/cli/train.py TINY_GPT2_KW,
# TINY_BERT_KW), fp32.
TINY_GPT2_KW = dict(vocab_size=512, max_positions=96, num_layers=4,
                    num_heads=4, hidden_size=64)
TINY_BERT_KW = dict(vocab_size=512, max_positions=96, num_layers=2,
                    num_heads=4, hidden_size=64)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The weight source (``--random-init``, ``--ckpt-dir`` or
    ``--hf-dir``), preset, seed, device and ``--tokenizer`` flags."""
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--random-init", action="store_true",
                     help="seeded random weights at the preset's full "
                          "width")
    src.add_argument("--ckpt-dir",
                     help="checkpoint dir written by either package's "
                          "train CLI (the newest step that verifies, dense "
                          "or per-shard)")
    src.add_argument("--hf-dir",
                     help="a Hugging Face GPT2LMHeadModel directory "
                          "(from_pretrained; its config sets the model, "
                          "fp32); its tokenizer files serve as "
                          "--tokenizer's default")
    p.add_argument("--model-preset", choices=["full", "tiny"],
                   default="full",
                   help="full: GPT-2 124M, bf16 compute; tiny: the test "
                        "preset, fp32")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer dir (vocab.json+merges.txt or "
                        "vocab.txt) for text prompts and output; default: "
                        "--hf-dir's, else text is byte-level")
    p.add_argument("--seed", type=int, default=0,
                   help="weight seed, and the default request seed")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")


def gpt2_for_preset(preset: str, *, seed: int = 0, device="cuda",
                    **overrides) -> GPT2:
    """THE preset -> GPT2 mapping: ``full`` is GPT-2 124M with the bf16
    policy, ``tiny`` the test preset in fp32; ``overrides`` replace
    config fields. Weights are drawn from a generator on ``device``
    seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if preset == "full":
        return GPT2(GPT2Config(**overrides), policy=bf16_policy(),
                    generator=gen)
    if preset == "tiny":
        return GPT2(GPT2Config(**{**TINY_GPT2_KW, **overrides}),
                    policy=f32_policy(), generator=gen)
    raise ValueError(f"unknown model preset {preset!r}")


def resolve_eos_id(explicit: Optional[int], tokenizer, vocab: int,
                   flag: str = "--eos-id") -> Optional[int]:
    """The EOS policy of the inference CLIs: an explicit id at or past
    the vocabulary is a user error; else the tokenizer's own EOS
    (``default_eos_id``), dropped with a note when it lies outside the
    model's vocab; a negative id disables EOS stopping."""
    if explicit is not None and explicit >= vocab:
        raise SystemExit(f"{flag} {explicit} outside the model vocab "
                         f"[0, {vocab})")
    eos_id = explicit
    if eos_id is None and tokenizer is not None:
        eos_id = default_eos_id(tokenizer)
        if eos_id is not None and eos_id >= vocab:
            print(f"note: tokenizer EOS id {eos_id} is outside this "
                  f"model's vocab [0, {vocab}); EOS stopping disabled",
                  file=sys.stderr)
            eos_id = None
    if eos_id is not None and eos_id < 0:
        eos_id = None
    return eos_id


def load_tokenizer_arg(args):
    """The ``--tokenizer`` directory's tokenizer (a directory without
    tokenizer files exits with the reason); else the one shipped in
    ``--hf-dir`` when its files are complete (``vocab.json`` and
    ``merges.txt``, or ``vocab.txt``); else None."""
    if getattr(args, "tokenizer", None):
        try:
            return load_tokenizer(args.tokenizer)
        except FileNotFoundError as e:
            raise SystemExit(str(e))
    hf_dir = getattr(args, "hf_dir", None)
    if hf_dir:
        # A partial copy (BPE needs both files) falls back to byte-level.
        bpe = all(os.path.isfile(os.path.join(hf_dir, f))
                  for f in ("vocab.json", "merges.txt"))
        if bpe or os.path.isfile(os.path.join(hf_dir, "vocab.txt")):
            return load_tokenizer(hf_dir)
    return None


def _refuse_layouts(ckpt_dir: str, keys) -> None:
    """The layout the inference CLIs cannot read: a pipeline run's
    (stacked stage slabs under ``pparams/``, which JAX's inference CLIs
    do not read either)."""
    if any(k.startswith("pparams/") for k in keys):
        raise SystemExit(
            f"{ckpt_dir}: the newest checkpoint has the pipeline layout "
            f"(--parallel pp: pparams/ stacked stage slabs, no variables/ "
            f"leaves); the inference CLIs read a variables/ layout, as the "
            f"JAX package's do: train on with --parallel pp, or save from "
            f"another mode")


# (unrolled prefix, stacked key) of each --scan-layers trunk.
SCAN_TRUNKS = (("h", "h_scan"), ("layers", "layers_scan"))


def _read_plan(shapes, keys):
    """``{variables/<key>: shape}`` the model needs -> ``{its key:
    (stored key, layer or None)}``: the train state's layout as is; the
    graph engine's (JAX's ``_is_graph_layout``: no ``variables/`` leaves)
    params-only under ``params/<path>``; a ``--scan-layers`` trunk's
    layer ``i`` as slice ``i`` of the stacked leaf (JAX restores the scan
    layout and unstacks it once)."""
    graph = not any(k.startswith("variables/") for k in keys)
    plan = {}
    for key in shapes:
        src = key
        if graph:
            if not key.startswith("variables/params/"):
                continue   # the graph state has no BatchNorm statistics
            src = key[len("variables/"):]
        layer = None
        if src not in keys:
            for prefix, stacked in SCAN_TRUNKS:
                hit = scan_source(src, prefix, stacked)
                if hit is not None and hit[0] in keys:
                    src, layer = hit
                    break
        plan[key] = (src, layer)
    return plan


def _assemble(plan, got) -> dict:
    return {key: (got[src] if layer is None else np.asarray(got[src])[layer])
            for key, (src, layer) in plan.items()}


def restore_variables_any(ckpt_dir: str, model: torch.nn.Module) -> int:
    """Load the newest checkpoint in ``ckpt_dir`` into ``model`` (its
    ``variables``: weights and BatchNorm statistics; the optimizer state
    is not read); -> its step. Either layout a training run writes: the
    dense npz (the newest that verifies), else the per-shard layout
    (``step_*.sharded``, the newest complete save, each variable read
    whole); a graph-engine checkpoint params-only, and a
    ``--scan-layers`` trunk sliced into the model's unrolled layers
    (:func:`_read_plan`). No checkpoint at all exits."""
    shapes = jax_variable_shapes(model)
    current = train_state_to_jax(model)
    newest = ckpt.latest_step(ckpt_dir)
    if newest is None:
        step = sck.latest_step(ckpt_dir)
        if step is None:
            raise SystemExit(f"no checkpoint (npz or sharded) in "
                             f"{ckpt_dir}")
        keys = set(sck.checkpoint_keys(ckpt_dir, step))
        _refuse_layouts(ckpt_dir, keys)
        plan = _read_plan(shapes, keys)
        want = {src: ((tuple(shapes[key]) if layer is None
                       else (model.cfg.num_layers,) + tuple(shapes[key])),
                      None) for key, (src, layer) in plan.items()}
        got, step = sck.restore_sharded(ckpt_dir, want, step)
        load_train_state({**current, **_assemble(
            plan, {k: a for k, (a, _) in got.items()})}, model)
        print(f"restored step {step} (sharded) from {ckpt_dir}",
              file=sys.stderr)
        return step
    keys = set(ckpt.checkpoint_keys(ckpt_dir, newest))
    _refuse_layouts(ckpt_dir, keys)
    plan = _read_plan(shapes, keys)
    template = {src: np.dtype(current[key].dtype)
                for key, (src, _) in plan.items()}
    flat, step = ckpt.try_restore(ckpt_dir, template)
    if flat is None:
        raise SystemExit(f"no checkpoint in {ckpt_dir} passes "
                         f"verification")
    load_train_state({**current, **_assemble(plan, flat)}, model)
    print(f"restored step {step} from {ckpt_dir}", file=sys.stderr)
    return step


def load_gpt2_for_inference(args, **overrides) -> GPT2:
    """The inference CLIs' GPT-2 from ``--ckpt-dir`` or
    ``--random-init`` at ``--model-preset`` (full decodes in bf16, tiny in
    fp32, as JAX), or from ``--hf-dir`` (its config, fp32, as JAX's
    ``gpt2_from_hf``); ``overrides`` replace config fields. ``cuda``
    without a card exits."""
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    if getattr(args, "hf_dir", None):
        from nezha_tpu_torch.models.hf import load_gpt2
        return load_gpt2(args.hf_dir, device=args.device, **overrides)
    if args.ckpt_dir and "max_positions" not in overrides:
        rows = saved_positions(args.ckpt_dir)
        if rows is not None:
            overrides = dict(overrides, max_positions=rows)
    model = gpt2_for_preset(args.model_preset, seed=args.seed,
                            device=args.device, **overrides)
    if args.ckpt_dir:
        restore_variables_any(args.ckpt_dir, model)
    return model


def saved_positions(ckpt_dir: str) -> Optional[int]:
    """The rows of the position table in ``ckpt_dir``'s newest dense save
    (a ``--seq-len`` run trains another table than the preset's), None
    without one."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return None
    with np.load(ckpt.checkpoint_path(ckpt_dir, step)) as z:
        for key in ("variables/params/wpe/embedding",   # or the graph's
                    "params/wpe/embedding"):
            if key in z.files:
                return int(z[key].shape[0])
    return None
