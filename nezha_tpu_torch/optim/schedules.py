"""Learning-rate schedules, functions of the int step (counterpart of
``nezha_tpu/optim/schedules.py``). The arithmetic runs in fp32, as in the
JAX package, and the result is returned as a Python float."""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant_schedule(value: float):
    return lambda step: float(_f32(value))


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    def sched(step: int) -> float:
        t = torch.clamp(_f32(step) / decay_steps, 0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t))
        return float(init_value * ((1 - alpha) * cosine + alpha))
    return sched


def linear_warmup_schedule(peak: float, warmup_steps: int):
    def sched(step: int) -> float:
        s = _f32(step)
        return float(peak * torch.clamp((s + 1.0) / max(warmup_steps, 1),
                                        max=1.0))
    return sched


def warmup_cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                           end_value: float = 0.0):
    """Linear warmup then cosine decay — the GPT-2/BERT standard."""
    def sched(step: int) -> float:
        s = _f32(step)
        warm = peak * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = end_value + (peak - end_value) * 0.5 * (
            1.0 + torch.cos(math.pi * t))
        return float(warm if step < warmup_steps else cos)
    return sched
