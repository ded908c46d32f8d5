"""Shared CLI helpers (counterpart of ``nezha_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse

import torch

from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config
from nezha_tpu_torch.tensor.policy import bf16_policy, f32_policy

# The tiny GPT-2 preset (nezha_tpu/cli/train.py TINY_GPT2_KW), fp32.
TINY_GPT2_KW = dict(vocab_size=512, max_positions=96, num_layers=4,
                    num_heads=4, hidden_size=64)


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--random-init", action="store_true", required=True,
                   help="seeded random weights at the preset's full width "
                        "(the only weight source of this port so far)")
    p.add_argument("--model-preset", choices=["full", "tiny"],
                   default="full",
                   help="full: GPT-2 124M, bf16 compute; tiny: the test "
                        "preset, fp32")
    p.add_argument("--seed", type=int, default=0,
                   help="weight seed, and the default request seed")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")


def gpt2_for_preset(preset: str, *, seed: int = 0,
                    device="cuda") -> GPT2:
    """THE preset -> GPT2 mapping: ``full`` is GPT-2 124M with the bf16
    policy, ``tiny`` the test preset in fp32. Weights are drawn from a
    generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if preset == "full":
        return GPT2(GPT2Config(), policy=bf16_policy(), generator=gen)
    if preset == "tiny":
        return GPT2(GPT2Config(**TINY_GPT2_KW), policy=f32_policy(),
                    generator=gen)
    raise ValueError(f"unknown model preset {preset!r}")
