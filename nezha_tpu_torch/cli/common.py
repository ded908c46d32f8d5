"""Shared CLI helpers (counterpart of ``nezha_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config
from nezha_tpu_torch.tensor.policy import bf16_policy, f32_policy

# The tiny GPT-2 and BERT presets (nezha_tpu/cli/train.py TINY_GPT2_KW,
# TINY_BERT_KW), fp32.
TINY_GPT2_KW = dict(vocab_size=512, max_positions=96, num_layers=4,
                    num_heads=4, hidden_size=64)
TINY_BERT_KW = dict(vocab_size=512, max_positions=96, num_layers=2,
                    num_heads=4, hidden_size=64)


def add_model_args(p: argparse.ArgumentParser,
                   refused_sources: Sequence[str] = ()) -> None:
    """The weight source, preset, seed and device flags. Each flag in
    ``refused_sources`` (e.g. ``--ckpt-dir``) joins ``--random-init`` as
    an alternative the parser accepts so that the command can refuse it
    typed (``NotPortedError``)."""
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--random-init", action="store_true",
                     help="seeded random weights at the preset's full "
                          "width (the only weight source of this port so "
                          "far)")
    for flag in refused_sources:
        src.add_argument(flag, help="not ported yet (refused)")
    p.add_argument("--model-preset", choices=["full", "tiny"],
                   default="full",
                   help="full: GPT-2 124M, bf16 compute; tiny: the test "
                        "preset, fp32")
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


def resolve_eos_id(explicit: Optional[int], vocab: int,
                   flag: str = "--eos-id") -> Optional[int]:
    """The EOS policy of the inference CLIs (JAX ``resolve_eos_id``
    without the tokenizer branch: the port loads no tokenizer): an
    explicit id at or past the vocabulary is a user error, a negative one
    disables EOS stopping, None keeps it off."""
    if explicit is not None and explicit >= vocab:
        raise SystemExit(f"{flag} {explicit} outside the model vocab "
                         f"[0, {vocab})")
    if explicit is not None and explicit < 0:
        return None
    return explicit
