"""Train a benchmark config on synthetic data (counterpart of
``nezha_tpu/cli/train.py``).

    python -m nezha_tpu_torch.cli.train --config gpt2_124m --steps 20
    python -m nezha_tpu_torch.cli.train --config bert_base_zero1 --eval
    python -m nezha_tpu_torch.cli.train --config resnet50_imagenet
    python -m nezha_tpu_torch.cli.train --config wrn101_large_batch \
        --batch-size 64
    python -m nezha_tpu_torch.cli.train --config mlp_mnist --steps 300

The configs are the JAX CLI's:

- ``gpt2_124m``: GPT-2 124M with the fused-head loss
  (``fused_loss_chunk=-1``) under the bf16 policy, AdamW with weight
  decay 0.1 on ``warmup_cosine_schedule(6e-4, 100, max(steps, 200))``,
  batch 8 of 1024 tokens from ``synthetic_token_batches`` (seed 0);
  ``--model-preset tiny`` is the fp32 test preset (vocab 512, 64 tokens);
  eval: 8 batches of seed 1 (tiny: 4), scored by ``lm_token_stats``;
- ``bert_base_zero1``: BERT-base with the fused MLM head under the bf16
  policy (flash attention, non-causal), ``mlm_loss``, AdamW with weight
  decay 0.01 on ``warmup_cosine_schedule(1e-4, 100, max(steps, 200))``,
  batch 16 of 512 tokens from ``synthetic_mlm_batches``; ``tiny`` is the
  fp32 test preset (vocab 512, 2 layers, width 64, 64 tokens, mask token
  1) with dense logits; eval: 8 batches of seed 1 (tiny: 4), scored by
  ``mlm_token_stats``;
- ``resnet50_imagenet``: ResNet-50 with the s2d stem under the bf16
  policy, momentum (beta 0.9, weight decay 1e-4) on
  ``warmup_cosine_schedule(0.4, 5 * 312, max(steps, 10))``, batch 256
  of ``synthetic_image_batches`` (224 px, 1000 classes); ``tiny`` is
  ``ResNet((1, 1), num_classes=100)`` on 32 px images; no eval split;
- ``wrn101_large_batch``: Wide-ResNet-101-2 with the s2d stem under the
  bf16 policy, momentum (beta 0.9, weight decay 1e-4) on
  ``warmup_cosine_schedule(1.6, 500, max(steps, 1000))``, batch 512 of
  ``synthetic_image_batches`` (one 80 GB card holds a batch of 256, not
  512); ``tiny`` is ``ResNet((1, 1), num_classes=100,
  width_factor=2)`` on 32 px images; no eval split;
- ``mlp_mnist``: the 784-256-256-10 MLP in fp32, ``momentum(0.1)``,
  batch 128 of ``mnist_batches`` (the synthetic set when no IDX files
  are on disk); ``tiny`` is the same; eval: the test split, one epoch,
  scored by ``accuracy``.

JAX runs ``gpt2_124m``, ``resnet50_imagenet`` and ``wrn101_large_batch``
data-parallel (``parallel_mode="dp"``) and ``bert_base_zero1`` with
ZeRO-1 (``"zero1"``); on one device JAX runs them single-device, with a
warning. The port trains every config on one card, and says so on
stderr (process groups are ROADMAP A3). ``--eval`` runs the config's
eval split after training, ``--eval-every N`` also every N steps (the
run trains in chunks that end on multiples of N), ``--eval-batches N``
caps each pass; a config without an eval split runs none. Training runs
on ``cuda`` unless ``--device`` says otherwise. Each log window prints a
JSON metrics line on stderr, each periodic eval a line with its
``eval_*`` metrics, the final eval ``{"eval": {...}}``; the last line on
stdout is ``{"final": {...}}``, with the final eval's ``eval_*`` keys.
Every other flag of the JAX CLI is refused with an error that names it.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import sys
from typing import Callable, Dict, Iterator, List, Optional

import torch

from nezha_tpu_torch.cli.common import TINY_BERT_KW, gpt2_for_preset
from nezha_tpu_torch.data import (mnist_batches, synthetic_image_batches,
                                  synthetic_mlm_batches,
                                  synthetic_token_batches)
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models.bert import Bert, BertConfig, bert_base, mlm_loss
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.models.mlp import MLP
from nezha_tpu_torch.models.resnet import ResNet, resnet50, wide_resnet101
from nezha_tpu_torch.ops.losses import \
    softmax_cross_entropy_with_integer_labels
from nezha_tpu_torch.optim import (Optimizer, adamw, matrix_decay_mask,
                                   momentum, warmup_cosine_schedule,
                                   with_grad_clipping)
from nezha_tpu_torch.tensor.policy import bf16_policy
from nezha_tpu_torch.train import (Trainer, accuracy, evaluate,
                                   lm_token_stats, mlm_token_stats)

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
    "--no-jax-distributed", "--engine"))
LOG_EVERY = 10


def image_ce(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """The image and MLP configs' loss: mean CE against ``label``."""
    return softmax_cross_entropy_with_integer_labels(logits, batch["label"])


@dataclasses.dataclass
class Config:
    """One config at one preset: its model (built), loss, batch stream
    (``batches(batch_size)``), optimizer, default batch size, the JAX
    CLI's parallel mode, and its eval split (``eval_batches(batch_size)``,
    a finite stream, scored by ``eval_stat``; None for none)."""
    model: torch.nn.Module
    loss_fn: Callable
    batches: Callable[[int], Iterator[dict]]
    optimizer: Optimizer
    default_batch: int
    parallel_mode: str = "single"
    eval_batches: Optional[Callable[[int], Iterator[dict]]] = None
    eval_stat: Optional[Callable] = None


def build_config(name: str, preset: str = "full", steps: int = 100,
                 seed: int = 0, device="cuda", seq_len: Optional[int] = None,
                 dropout: Optional[float] = None,
                 wd_exclude_1d: bool = False) -> Config:
    """THE config table: ``name`` at ``preset`` with weights seeded by
    ``seed`` on ``device``; ``steps`` sizes the learning-rate schedules;
    ``seq_len``, ``dropout`` and ``wd_exclude_1d`` apply to gpt2_124m."""
    tiny = preset == "tiny"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if name == "mlp_mnist":
        return Config(MLP(generator=gen), image_ce,
                      lambda bs: mnist_batches(bs), momentum(0.1), 128,
                      eval_batches=lambda bs: mnist_batches(
                          bs, split="test", epochs=1),
                      eval_stat=accuracy)
    if name in ("resnet50_imagenet", "wrn101_large_batch"):
        wide = name == "wrn101_large_batch"
        sched = (warmup_cosine_schedule(1.6, 500, max(steps, 1000)) if wide
                 else warmup_cosine_schedule(0.4, 5 * 312, max(steps, 10)))
        opt = momentum(sched, beta=0.9, weight_decay=1e-4)
        default_batch = 512 if wide else 256
        if tiny:
            model = ResNet((1, 1), num_classes=100,
                           width_factor=2 if wide else 1,
                           policy=bf16_policy(), generator=gen)
            return Config(model, image_ce, lambda bs: synthetic_image_batches(
                bs, image_size=32, num_classes=100), opt, default_batch,
                "dp")
        build = wide_resnet101 if wide else resnet50
        model = build(stem="s2d", policy=bf16_policy(), generator=gen)
        return Config(model, image_ce, synthetic_image_batches, opt,
                      default_batch, "dp")
    if name == "bert_base_zero1":
        opt = adamw(warmup_cosine_schedule(1e-4, 100, max(steps, 200)),
                    weight_decay=0.01)
        if tiny:
            model = Bert(BertConfig(**TINY_BERT_KW), generator=gen)
            mlm = dict(seq_len=64, vocab_size=512, mask_token=1)
            n_eval = 4
        else:
            model = bert_base(fused_loss_chunk=-1, generator=gen)
            mlm = dict(seq_len=512)
            n_eval = 8
        return Config(model, mlm_loss,
                      lambda bs: synthetic_mlm_batches(bs, **mlm), opt, 16,
                      "zero1", lambda bs: itertools.islice(
                          synthetic_mlm_batches(bs, seed=1, **mlm), n_eval),
                      mlm_token_stats)
    if name != "gpt2_124m":
        raise ValueError(f"unknown config {name!r}")
    overrides = {} if tiny else {"fused_loss_chunk": -1}
    if seq_len:
        overrides["max_positions"] = seq_len
    if dropout is not None:
        overrides["dropout"] = dropout
    model = gpt2_for_preset(preset, seed=seed, device=device, **overrides)
    vocab = 512 if tiny else 50257
    seq = seq_len or (64 if tiny else 1024)
    opt = adamw(warmup_cosine_schedule(6e-4, 100, max(steps, 200)),
                weight_decay=0.1,
                mask=matrix_decay_mask if wd_exclude_1d else None)

    def tokens(bs, seed=0):
        return synthetic_token_batches(bs, seq_len=seq, vocab_size=vocab,
                                       seed=seed)

    return Config(model, lm_loss, tokens, opt, 8, "dp",
                  lambda bs: itertools.islice(tokens(bs, seed=1),
                                              4 if tiny else 8),
                  lm_token_stats)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nezha_tpu_torch.cli.train",
        description="Train a benchmark config on synthetic data "
                    "(PyTorch/CUDA port).")
    p.add_argument("--config", required=True, choices=CONFIGS)
    p.add_argument("--model-preset", choices=["full", "tiny"],
                   default="full",
                   help="full: the config's model; tiny: its test preset "
                        "(GPT-2 and BERT in fp32, a two-block ResNet on "
                        "32 px)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the config's (gpt2 8, bert 16, mlp 128, "
                        "resnet 256, wrn 512)")
    p.add_argument("--seq-len", type=int, default=None,
                   help="gpt2_124m: tokens per row; also sizes the "
                        "position table (default 1024, tiny 64 with a "
                        "96-row table)")
    p.add_argument("--seed", type=int, default=0, help="weight seed")
    p.add_argument("--dropout", type=float, default=None,
                   help="gpt2_124m: the dropout rate")
    p.add_argument("--clip-norm", type=float, default=None,
                   help="clip gradients to this global norm")
    p.add_argument("--wd-exclude-1d", action="store_true",
                   help="gpt2_124m: no weight decay on norm scales and "
                        "biases")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--eval", action="store_true",
                   help="run the config's eval split after training")
    p.add_argument("--eval-every", type=int, default=None,
                   help="also run the eval split every N training steps "
                        "(implies the final --eval pass)")
    p.add_argument("--eval-batches", type=int, default=None,
                   help="cap each eval pass to N batches")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse and check the flags."""
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            parser.error(f"{flag} is not ported to the PyTorch trainer "
                         f"yet (see ROADMAP.md)")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    gpt2 = args.config == "gpt2_124m"
    for flag, value in (("--seq-len", args.seq_len),
                        ("--dropout", args.dropout),
                        ("--wd-exclude-1d", args.wd_exclude_1d or None)):
        if value is not None and not gpt2:
            parser.error(f"{flag} applies to gpt2_124m")
    if args.steps < 1:
        parser.error(f"--steps must be >= 1, got {args.steps}")
    if args.dropout is not None and not 0.0 <= args.dropout < 1.0:
        parser.error(f"--dropout must be in [0, 1), got {args.dropout}")
    if args.clip_norm is not None and not args.clip_norm > 0:
        parser.error(f"--clip-norm must be > 0, got {args.clip_norm}")
    if args.eval_every is not None and args.eval_every < 1:
        parser.error(f"--eval-every must be >= 1, got {args.eval_every}")
    if args.eval_batches is not None and args.eval_batches < 1:
        # An empty pass would raise mid-training under --eval-every.
        parser.error(f"--eval-batches must be >= 1, got "
                     f"{args.eval_batches}")
    return args


def run_eval(cfg: Config, batch_size: int,
             max_batches: Optional[int]) -> Optional[Dict[str, float]]:
    """One pass over the config's eval split with the current weights,
    or None when the config has none."""
    if cfg.eval_batches is None:
        return None
    return evaluate(cfg.model, cfg.eval_batches(batch_size), cfg.eval_stat,
                    max_batches=max_batches)


def run(args: argparse.Namespace) -> Dict[str, float]:
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu to train on "
                         "the CPU")
    cfg = build_config(args.config, args.model_preset, steps=args.steps,
                       seed=args.seed, device=args.device,
                       seq_len=args.seq_len, dropout=args.dropout,
                       wd_exclude_1d=args.wd_exclude_1d)
    if cfg.parallel_mode != "single":
        print(f"WARNING: config {args.config!r} requests parallel mode "
              f"{cfg.parallel_mode!r}; the port trains on one device "
              f"(process groups are ROADMAP A3): running single-device",
              file=sys.stderr, flush=True)
    optimizer, loss_fn = cfg.optimizer, cfg.loss_fn
    if args.clip_norm is not None:
        optimizer = with_grad_clipping(optimizer, args.clip_norm)
    batch_size = args.batch_size or cfg.default_batch

    def log(step: int, metrics: Dict[str, float]) -> None:
        print(json.dumps(metrics), file=sys.stderr, flush=True)

    trainer = Trainer(cfg.model, optimizer, loss_fn, log_every=LOG_EVERY,
                      metric_logger=log, examples_per_step=batch_size)
    batches = cfg.batches(batch_size)
    last: Dict[str, float] = {}
    if args.eval_every:
        # Train in chunks that end on multiples of --eval-every, an eval
        # pass between them; the final pass follows the last chunk.
        done = 0
        while done < args.steps:
            n = min(args.eval_every - trainer.global_step % args.eval_every,
                    args.steps - done)
            last = trainer.fit(batches, n)
            done += n
            if done < args.steps:
                results = run_eval(cfg, batch_size, args.eval_batches)
                if results is not None:
                    log(trainer.global_step, {
                        "step": trainer.global_step,
                        **{f"eval_{k}": v for k, v in results.items()}})
    else:
        last = trainer.fit(batches, args.steps)
    if not math.isfinite(last.get("loss", math.nan)):
        raise SystemExit(f"training diverged: {last}")
    if args.eval or args.eval_every:
        results = run_eval(cfg, batch_size, args.eval_batches)
        if results is not None:
            print(json.dumps({"eval": results}), file=sys.stderr,
                  flush=True)
            last.update({f"eval_{k}": v for k, v in results.items()})
    return last


def main(argv: Optional[List[str]] = None) -> int:
    try:
        last = run(parse_args(argv))
    except NotPortedError as e:
        raise SystemExit(f"nezha_tpu_torch.cli.train: {e}")
    print(json.dumps({"final": last}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
