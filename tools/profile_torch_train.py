"""Where the time goes in the PyTorch port's training step, on one CUDA
card.

    python3 tools/profile_torch_train.py [--out train_profile.json] \
        [--ln-impl pallas] [--config resnet50_imagenet|bert_base_zero1]

``--config gpt2_124m`` (the default) is the step of ``chip_smoke.py``'s
train phase (GPT-2 124M, seeded random weights, bf16, B=8, S=1024,
``fused_loss_chunk=-1``, AdamW with weight decay 0.1,
``synthetic_token_batches`` seed 0; ``--ln-impl pallas`` for the fused
LayerNorm kernels). ``--config bert_base_zero1`` is its train_bert
phase's timed run: BERT-base as the config builds it (bf16, the fused
MLM head, flash attention non-causal), B=16, S=512 of
``synthetic_mlm_batches``, the config's AdamW. ``--config resnet50_imagenet`` is its train_image
phase's timed run: ResNet-50 with the s2d stem, bf16, batch 128 of
``synthetic_image_batches`` at 224 px, the config's momentum. Either runs
through ``Trainer.fit``: 2 warm-up steps, ``--steps`` timed steps without
the profiler, then ``--steps`` more under ``torch.profiler``. Reports ms
per step, tokens/s or images/s, the device's busy time and idle share,
the device time by kind of kernel, and the CUDA kernels and CPU ops that
took the most time; GPT-2 and BERT also the three flash kernels' device
time (B3 with the delta pre-pass). ResNet-50 adds two more profiled windows of
``--steps`` steps each, the forward and backward alone
(``TrainStep.loss_and_grads``, with the batch's host-to-device copy) and
the optimizer alone (``TrainStep.apply_gradients``), so the optimizer's
elementwise kernels are told apart from BatchNorm's. It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nezha_tpu_torch.cli.common import gpt2_for_preset  # noqa: E402
from nezha_tpu_torch.cli.train import build_config  # noqa: E402
from nezha_tpu_torch.data import synthetic_token_batches  # noqa: E402
from nezha_tpu_torch.models.gpt2 import lm_loss  # noqa: E402
from nezha_tpu_torch.optim import adamw  # noqa: E402
from nezha_tpu_torch.train import Trainer  # noqa: E402

B, S = 8, 1024
BERT_B, BERT_S = 16, 512
IMG_B, IMG_SIZE = 128, 224
# Each flash row's kernels: the Hopper (bf16) and first (fp32) bodies,
# and B3's delta pre-pass.
FLASH_SYMBOLS = {"flash_fwd": ("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
                 "flash_bwd_dq": ("flash_bwd_dq_kernel",
                                  "flash_bwd_dq_wgmma_kernel"),
                 "flash_bwd_dkv": ("flash_bwd_delta_kernel",
                                   "flash_bwd_dkv_kernel",
                                   "flash_bwd_dkv_wgmma_kernel")}
# Device kernels by kind, first match wins (names as the profiler shows
# them: the port's kernels, cuBLAS's nvjet and CUTLASS GEMMs, PyTorch's
# elementwise and reduction kernels).
CATEGORIES = (("decode attention", ("flash_decode_", "paged_decode_")),
              ("layer norm kernels", ("ln_fwd_kernel", "ln_bwd_")),
              ("flash attention", ("nezha::flash",)),
              ("matmul", ("gemm", "cutlass", "cublas", "xmma", "sm90_",
                          "nvjet")),
              ("reduction", ("reduce", "softmax", "norm")),
              ("elementwise", ("elementwise", "copy", "fill")))


# ResNet-50's kernels by kind: cuDNN's convolutions by pass (their names
# carry fprop, dgrad or wgrad), cuDNN's other kernels (layout and
# reorder), GEMMs (the 1x1 convolutions that run as cuBLAS and CUTLASS
# GEMMs, and the head), then reductions (BatchNorm's statistics and
# their backward) and elementwise kernels (BatchNorm's normalization and
# casts, the ReLUs and residual adds, and in the optimizer window the
# momentum update), and the copies.
IMAGE_CATEGORIES = (("conv forward", ("fprop",)),
                    ("conv backward data", ("dgrad",)),
                    ("conv backward weight", ("wgrad",)),
                    ("cudnn other", ("cudnn", "nchwtonhwc", "nhwctonchw",
                                     "conv")),
                    ("memcpy htod", ("memcpy htod",)),
                    ("matmul", ("gemm", "cutlass", "cublas", "xmma",
                                "sm90_", "nvjet")),
                    ("reduction", ("reduce", "welford", "norm", "softmax")),
                    ("elementwise", ("elementwise", "copy", "fill")))


def category(name: str, categories=CATEGORIES) -> str:
    low = name.lower()
    for cat, keys in categories:
        if any(k in low for k in keys):
            return cat
    return "other"


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profiled(fn, steps: int):
    """Run ``fn()`` under torch.profiler -> (its CUDA events, wall s)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    return events, [e for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA], wall


def by_kind(kernels, steps: int, categories) -> dict:
    out: dict = {}
    for e in kernels:
        c = category(e.key, categories)
        out[c] = out.get(c, 0.0) + dev_us(e) / 1e3 / steps
    return out


def image_windows(trainer, batches, steps: int) -> dict:
    """The forward and backward alone, then the optimizer alone, each over
    ``steps`` steps of the trainer's own step function."""
    step = trainer.step_fn
    grads = []

    def fwd_bwd():
        for _ in range(steps):
            grads.append(step.loss_and_grads(next(batches))[1])

    def optimizer():
        for g in grads:
            step.apply_gradients(g)

    out = {}
    for name, fn in (("forward_backward", fwd_bwd),
                     ("optimizer", optimizer)):
        _, kernels, wall = profiled(fn, steps)
        out[name] = {
            "wall_ms_per_step": 1e3 * wall / steps,
            "device_ms_per_step": sum(dev_us(e) for e in kernels)
            / 1e3 / steps,
            "launches_per_step": sum(e.count for e in kernels) / steps,
            "device_ms_per_step_by_kind": by_kind(kernels, steps,
                                                  IMAGE_CATEGORIES)}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="also write the full report as JSON here")
    p.add_argument("--config", choices=["gpt2_124m", "bert_base_zero1",
                                        "resnet50_imagenet"],
                   default="gpt2_124m")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--ln-impl", choices=["xla", "pallas"], default="xla")
    args = p.parse_args()
    if args.ln_impl != "xla" and args.config != "gpt2_124m":
        p.error("--ln-impl applies to gpt2_124m")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = torch.cuda.get_device_name(0)
    image = args.config == "resnet50_imagenet"
    if image:
        cfg = build_config(args.config, steps=2 + 3 * args.steps, seed=0,
                           device="cuda")
        trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn,
                          log_every=0)
        batches = cfg.batches(IMG_B)
        examples, categories = IMG_B, IMAGE_CATEGORIES
    elif args.config == "bert_base_zero1":
        cfg = build_config(args.config, steps=2 + 2 * args.steps, seed=0,
                           device="cuda")
        trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn,
                          log_every=0)
        batches = cfg.batches(BERT_B)
        examples, categories = BERT_B * BERT_S, CATEGORIES
    else:
        model = gpt2_for_preset("full", seed=0, device="cuda",
                                fused_loss_chunk=-1, ln_impl=args.ln_impl)
        trainer = Trainer(model, adamw(6e-4, weight_decay=0.1), lm_loss,
                          log_every=0)
        batches = synthetic_token_batches(B, seq_len=S, seed=0)
        examples, categories = B * S, CATEGORIES
    trainer.fit(batches, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(batches, args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events, kernels, prof_wall = profiled(
        lambda: trainer.fit(batches, args.steps), args.steps)
    busy_us = sum(dev_us(e) for e in kernels)
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:args.top]
    by_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:args.top]
    report = {
        "card": card,
        "config": args.config,
        "steps": args.steps,
        "ms_per_step": 1e3 * wall / args.steps,
        ("images_per_s" if image else "tokens_per_s"):
            examples * args.steps / wall,
        "profiled_ms_per_step": 1e3 * prof_wall / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share_profiled": 1.0 - busy_us / 1e6 / prof_wall,
        "device_idle_share_unprofiled_est": 1.0 - busy_us / 1e6 / wall,
        "device_ms_per_step_by_kind": by_kind(kernels, args.steps,
                                              categories),
        "kernels": [{"kind": category(e.key, categories),
                     "name": e.key[:160],
                     "device_ms_per_step": dev_us(e) / 1e3 / args.steps,
                     "calls_per_step": e.count / args.steps}
                    for e in sorted(kernels, key=dev_us, reverse=True)],
        "kernel_events": len(kernels),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "top_device": [{"name": e.key, "device_ms": dev_us(e) / 1e3,
                        "calls": e.count} for e in by_dev],
        "top_cpu_self": [{"name": e.key,
                          "cpu_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count} for e in by_cpu],
    }
    if image:
        report["windows"] = image_windows(trainer, batches, args.steps)
    else:
        report["ln_impl"] = args.ln_impl
        flash = {name: sum(dev_us(e) for e in kernels
                           if any(sym in e.key for sym in syms))
                 / 1e3 / args.steps for name, syms in FLASH_SYMBOLS.items()}
        flash["total"] = sum(flash.values())
        report["flash_ms_per_step"] = flash
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if not k.startswith("top_") and k != "kernels"}))
    for e in report["top_device"]:
        print(f"dev {e['device_ms']:9.3f} ms {e['calls']:6d}x {e['name']}")
    for e in report["top_cpu_self"]:
        print(f"cpu {e['cpu_ms']:9.3f} ms {e['calls']:6d}x {e['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
