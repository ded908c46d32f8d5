"""Train GPT-2 on synthetic tokens (counterpart of
``nezha_tpu/cli/train.py``, the ``gpt2_124m`` config).

    python -m nezha_tpu_torch.cli.train --config gpt2_124m --steps 20

The config is the JAX CLI's: GPT-2 124M with the fused-head loss
(``fused_loss_chunk=-1``) under the bf16 policy, AdamW with weight decay
0.1 on ``warmup_cosine_schedule(6e-4, 100, max(steps, 200))``, batch 8
of 1024 tokens from ``synthetic_token_batches`` (seed 0), on ``cuda``.
``--model-preset tiny`` is the fp32 test preset (vocab 512, 64 tokens).
Each log window prints a JSON metrics line on stderr; the last line on
stdout is ``{"final": {...}}``. Every other flag of the JAX CLI is
refused with an error that names it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional

import torch

from nezha_tpu_torch.cli.common import gpt2_for_preset
from nezha_tpu_torch.data import synthetic_token_batches
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.optim import (adamw, matrix_decay_mask,
                                   warmup_cosine_schedule, with_grad_clipping)
from nezha_tpu_torch.train import Trainer

CONFIGS = ("mlp_mnist", "resnet50_imagenet", "gpt2_124m", "bert_base_zero1",
           "wrn101_large_batch")
# Flags of the JAX train CLI this port does not take yet.
NOT_PORTED_FLAGS = frozenset((
    "--mesh", "--parallel", "--microbatches", "--sp-flash", "--attn-impl",
    "--moe-experts", "--optimizer", "--lr", "--grad-accum",
    "--label-smoothing", "--mlm-mask-token", "--remat", "--graph-bf16",
    "--scan-layers", "--grad-allreduce", "--platform", "--log-every",
    "--prefetch", "--ckpt-dir", "--ckpt-every", "--ckpt-keep",
    "--metrics-file", "--run-dir", "--trace-dir", "--data-dir", "--crop",
    "--failure-check-every", "--on-failure", "--rejoin-timeout",
    "--log-memory", "--profile-dir", "--profile-steps", "--coordinator",
    "--serve-coordinator", "--world-size", "--rank-hint",
    "--no-jax-distributed", "--engine", "--eval", "--eval-every",
    "--eval-batches"))
LOG_EVERY = 10


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nezha_tpu_torch.cli.train",
        description="Train GPT-2 on synthetic tokens (PyTorch/CUDA port).")
    p.add_argument("--config", required=True, choices=CONFIGS,
                   help="only gpt2_124m is ported")
    p.add_argument("--model-preset", choices=["full", "tiny"],
                   default="full",
                   help="full: GPT-2 124M, bf16 compute; tiny: the test "
                        "preset, fp32")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="default 8")
    p.add_argument("--seq-len", type=int, default=None,
                   help="tokens per row; also sizes the position table "
                        "(default 1024, tiny 64 with a 96-row table)")
    p.add_argument("--seed", type=int, default=0, help="weight seed")
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--clip-norm", type=float, default=None,
                   help="clip gradients to this global norm")
    p.add_argument("--wd-exclude-1d", action="store_true",
                   help="no weight decay on norm scales and biases")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            parser.error(f"{flag} is not ported to the PyTorch trainer "
                         f"yet (see ROADMAP.md)")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.config != "gpt2_124m":
        parser.error(f"--config {args.config} is not ported yet; only "
                     f"gpt2_124m trains in the PyTorch port")
    if args.steps < 1:
        parser.error(f"--steps must be >= 1, got {args.steps}")
    if args.dropout is not None and not 0.0 <= args.dropout < 1.0:
        parser.error(f"--dropout must be in [0, 1), got {args.dropout}")
    if args.clip_norm is not None and not args.clip_norm > 0:
        parser.error(f"--clip-norm must be > 0, got {args.clip_norm}")
    return args


def run(args: argparse.Namespace) -> Dict[str, float]:
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu to train on "
                         "the CPU")
    tiny = args.model_preset == "tiny"
    overrides = {} if tiny else {"fused_loss_chunk": -1}
    vocab = 512 if tiny else 50257
    seq_len = args.seq_len or (64 if tiny else 1024)
    if args.seq_len:
        overrides["max_positions"] = args.seq_len
    if args.dropout is not None:
        overrides["dropout"] = args.dropout
    model = gpt2_for_preset(args.model_preset, seed=args.seed,
                            device=args.device, **overrides)
    optimizer = adamw(warmup_cosine_schedule(6e-4, 100, max(args.steps, 200)),
                      weight_decay=0.1,
                      mask=matrix_decay_mask if args.wd_exclude_1d else None)
    if args.clip_norm is not None:
        optimizer = with_grad_clipping(optimizer, args.clip_norm)
    batch_size = args.batch_size or 8

    def log(step: int, metrics: Dict[str, float]) -> None:
        print(json.dumps(metrics), file=sys.stderr, flush=True)

    trainer = Trainer(model, optimizer, lm_loss, log_every=LOG_EVERY,
                      metric_logger=log, examples_per_step=batch_size)
    batches = synthetic_token_batches(batch_size, seq_len=seq_len,
                                      vocab_size=vocab)
    last = trainer.fit(batches, args.steps)
    if not math.isfinite(last.get("loss", math.nan)):
        raise SystemExit(f"training diverged: {last}")
    return last


def main(argv: Optional[List[str]] = None) -> int:
    last = run(parse_args(argv))
    print(json.dumps({"final": last}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
