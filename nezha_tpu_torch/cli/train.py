"""Train a benchmark config (counterpart of ``nezha_tpu/cli/train.py``).

    python -m nezha_tpu_torch.cli.train --config gpt2_124m --steps 20
    python -m nezha_tpu_torch.cli.train --config gpt2_124m --data-dir D \
        --ckpt-dir C --ckpt-every 10 --ckpt-keep 2 --eval
    python -m nezha_tpu_torch.cli.train --config bert_base_zero1 --eval
    python -m nezha_tpu_torch.cli.train --config resnet50_imagenet
    python -m nezha_tpu_torch.cli.train --config wrn101_large_batch \
        --batch-size 64
    python -m nezha_tpu_torch.cli.train --config mlp_mnist --steps 300
    python -m nezha_tpu_torch.cli.train --config gpt2_124m --parallel dp \
        --mesh dp=1 --grad-allreduce int8
    python -m nezha_tpu_torch.cli.train --config bert_base_zero1 \
        --model-preset tiny --device cpu --coordinator 127.0.0.1:0 \
        --serve-coordinator --world-size 2      # rank 0; it prints its
    python -m nezha_tpu_torch.cli.train --config bert_base_zero1 \
        --model-preset tiny --device cpu --coordinator 127.0.0.1:PORT

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

``gpt2_124m``, ``resnet50_imagenet`` and ``wrn101_large_batch`` run
data-parallel (``parallel_mode="dp"``), ``bert_base_zero1`` ZeRO-1
(``"zero1"``), ``mlp_mnist`` single-device; ``--parallel`` picks another
mode. One process drives one device. ``--coordinator HOST:PORT`` joins
the native coordinator (``--serve-coordinator`` also runs it, for
``--world-size`` processes; port 0 binds a free one, printed on stderr)
and, for dp and zero1 across more than one process, starts
``torch.distributed`` over that world (``nccl`` on ``cuda``, ``gloo`` on
``cpu``); ``--batch-size`` is then the global batch and each rank trains
on ``batch / world`` rows of it: its shard of ``--data-dir``'s loader,
or its rows of the synthetic stream. As in JAX, a dp or zero1 config on
a world of one process runs single-device with a warning, unless
``--mesh dp=1`` asks for the parallel path on the one device (a world-1
process group). ``--grad-allreduce int8`` puts the gradients on the int8
wire (``parallel/quantized.py``) and is refused outside dp and zero1.
``--parallel gspmd``
(gpt2_124m and bert_base_zero1) trains tensor-parallel in one process
(``parallel/gspmd.py``) on ``--mesh dp=D,tp=M`` (default ``dp=1,tp=-1``,
``tp=-1`` the visible cards): M shards of every split layer, the batch
split over the D groups, whose devices repeat group 0's;
``--shard-device D`` puts every shard on D (``cuda:0`` runs M shards on
one card, one after another), else the mesh takes one visible card a
shard (the CPU repeated on ``--device cpu``). On one visible card without
``--shard-device`` the mode degrades to single-device, as JAX's does on
one device. Its saves are per-shard (``step_<N>.sharded``, JAX's shards
and keys), its eval runs the tensor-parallel model inside
``auto_partitioner_scope``; gspmd across processes, and ``--optimizer
lars|lamb|adafactor`` (whose statistics span a whole tensor) under it,
are refused. ``--parallel pp`` (gpt2_124m; JAX's GPipe,
``parallel/pipeline.py``) trains on ``--mesh dp=D,pp=P`` (default
``dp=1,pp=-1``) with ``--microbatches M`` a step, the layers in P
contiguous stages, in one process (``--shard-device`` as for gspmd; one
visible card without it degrades to single-device); its saves are JAX's
pipeline layout (``pparams/``, the layer axis split P ways) and its eval
runs the merged weights; ``--wd-exclude-1d`` and pp across processes are
refused. ``--parallel sp`` (gpt2_124m; JAX's sequence parallelism,
``parallel/sequence_parallel.py``) trains on ``--mesh dp=D,sp=S``
(default ``dp=1,sp=-1``) in one process, each row's sequence cut into S
shards that attend across each other by ``--attn-impl ring`` (the
default) or ``ulysses``, through the flash kernels (``--sp-flash auto``
or ``on``) or composed (``off``), the head's loss fused (JAX's sp model,
``fused_loss_chunk=-1``); ``--shard-device`` and the one-card degrade as
for gspmd; its state is the single-device one (its saves the dense npz,
its eval the plain model on the same weights); sp across processes is
refused. ``--moe-experts E`` (gpt2_124m) makes every other block's MLP
a top-2 routed expert layer (``parallel/expert.py``) under single, dp,
zero1, sp (each shard routes its own tokens) or gspmd, whose mesh then
takes an ``ep`` axis (``dp=D,tp=M,ep=X``, default ``dp=1,tp=1,ep=-1``; X
must divide E); it cannot pipeline. ``--remat`` (gpt2_124m and the image
configs) recomputes each block in the backward (under pp each stage
application, under sp each layer across its shards). ``--attn-impl``
sets gpt2_124m's and bert_base_zero1's attention: auto, xla, flash, or
flash_shmap (gspmd only; auto and flash run the same per-shard kernels
there), and ring or ulysses (sp only). Every
``--failure-check-every`` steps each rank polls the coordinator for dead
peers and, on one, checkpoints and stops (``--on-failure stop``), or
with ``--on-failure rejoin`` checkpoints, waits up to
``--rejoin-timeout`` seconds for the dead rank's replacement (relaunched
with ``--rank-hint``; it resumes from the rescue checkpoint), reloads
that checkpoint and trains on. Rejoin needs ``--coordinator`` and
``--ckpt-dir``, and each process then trains alone (``--parallel
single``): a ``torch.distributed`` group cannot take a restarted
process, so dp and zero1 across processes recover by ``stop`` and a
relaunch. Log and ``{"save"}`` lines come from rank 0 (in single mode
from every process, each its own run).
``--eval`` runs the config's
eval split after training, ``--eval-every N`` also every N steps (the
run trains in chunks that end on multiples of N), ``--eval-batches N``
caps each pass; a config without an eval split runs none. Training runs
on ``cuda`` unless ``--device`` says otherwise. Each log window prints a
JSON metrics line on stderr, each periodic eval a line with its
``eval_*`` metrics, the final eval ``{"eval": {...}}``; the last line on
stdout is ``{"final": {...}}``, with the final eval's ``eval_*`` keys.

``--data-dir D`` trains from disk through the native loaders
(``data/native.py``), as the JAX CLI does: ``D/train.nzr`` image records
for the image configs (a random ``--crop`` and flip), random windows of
``D/train.tokens.u16`` (or ``.i32``) for ``gpt2_124m`` (ids at or past
the model's vocab are refused) and for ``bert_base_zero1`` under
dynamic MLM masking (``data/mlm.py``; the ``[MASK]`` id from
``--mlm-mask-token``, else the corpus's ``.meta.json`` sidecar or a
``vocab.txt`` beside it, else 103, refused on a byte-packed corpus), and
MNIST IDX files under ``D/mnist``; otherwise a note says the run uses
synthetic data. The eval then reads ``D/val.nzr`` (center crop, a batch
that divides the record count) or ``D/val.tokens.*`` (sequential
windows, one pass) when present.

``--ln-impl pallas`` (gpt2_124m) runs its LayerNorms through the fused
kernels (``ops/cuda/layer_norm.py``), forward and backward; the JAX CLI
has no such flag (its LayerNorms follow the model config).

``--ckpt-dir C`` resumes from C's newest checkpoint that verifies (``resumed
from step N`` on stderr), saves every ``--ckpt-every`` steps of the
global count and once at the end, keeping the newest ``--ckpt-keep``
(dense saves by rank 0; zero1 writes the per-shard layout,
``step_<N>.sharded``, each rank its own shards on a background thread);
``--eval-every`` points stay on multiples of the global step. The files
are the JAX package's (``train/checkpoint.py``), so either package
resumes the other's run; the port's dropout masks follow from (key,
step), not from JAX's key splits. ``--label-smoothing`` applies to the
image and MLP configs.

``--optimizer sgd|momentum|adamw|lars|lamb|adafactor`` with ``--lr``
swaps the config's optimizer for the JAX CLI's factory of that name on
``warmup_cosine_schedule(lr, min(100, max(1, steps // 10)), max(steps,
200))``. ``--grad-accum N`` applies the mean of N micro-steps' gradients
once (``optim.accumulate_gradients``, outside ``--clip-norm``), and sizes
the inner schedule to ``max(1, steps // N)`` updates; it composes with
single, dp and zero1. ``--prefetch N`` (default 2) stages the next N
batches onto the device while the step runs (``runtime.Prefetcher``:
pinned memory and a side stream on ``cuda``); the eval stream is not
prefetched. Every ``--log-every`` steps (default 10; 0: never) a metrics
line goes to stderr, and with ``--metrics-file F`` as a JSONL line into
F (rank 0's); ``--log-memory`` adds the card's ``hbm_bytes_in_use`` and
``hbm_peak_bytes`` (none on the CPU). ``--profile-dir D`` (or its alias
``--trace-dir``) writes a ``torch.profiler`` Chrome trace into D: of the
steps after step START for COUNT steps with ``--profile-steps
START:COUNT``, else of the whole run. Every other flag of the JAX CLI is
refused with an error that names it.

``--run-dir D`` runs the whole run inside a telemetry run scope
(``obs.start_run``): each log window streams into ``D/metrics.jsonl``,
the first step, every save and every rejoin into ``D/spans.jsonl``, and
``D/summary.json`` (counters such as ``train.steps``, the prefetcher's
stalls, the per-collective payload table, the rate percentiles) is
written on every exit path. Under ``--coordinator`` each process writes
into ``D/rank<K>`` (``--rank-hint K``) or ``D/pid<P>``. ``python -m
nezha_tpu_torch.cli.telemetry D [--check]`` renders it. A
``NEZHA_FAULT_PLAN`` in the environment arms the fault points
(``checkpoint.save``, ``dist.join``) for the run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import sys
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from nezha_tpu_torch import obs
from nezha_tpu_torch.cli.common import TINY_BERT_KW, gpt2_for_preset
from nezha_tpu_torch.data import (mnist_batches, synthetic_image_batches,
                                  synthetic_mlm_batches,
                                  synthetic_token_batches)
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models.bert import Bert, BertConfig, bert_base, mlm_loss
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.models.mlp import MLP
from nezha_tpu_torch.models.resnet import ResNet, resnet50, wide_resnet101
from nezha_tpu_torch.obs import MetricsLogger, Tracer, profile_trace
from nezha_tpu_torch.ops.losses import \
    softmax_cross_entropy_with_integer_labels
from nezha_tpu_torch.parallel.data_parallel import local_rows
from nezha_tpu_torch.runtime import Prefetcher
from nezha_tpu_torch.optim import (Optimizer, accumulate_gradients,
                                   adafactor, adamw, lamb, lars,
                                   matrix_decay_mask, momentum, sgd,
                                   warmup_cosine_schedule,
                                   with_grad_clipping)
from nezha_tpu_torch.tensor import bf16_policy, memory_metrics
from nezha_tpu_torch.train import (Trainer, accuracy, evaluate,
                                   lm_token_stats, mlm_token_stats)
from nezha_tpu_torch.train.loop import prng_key
from nezha_tpu_torch.utils.logging import get_logger, set_rank

CONFIGS = ("mlp_mnist", "resnet50_imagenet", "gpt2_124m", "bert_base_zero1",
           "wrn101_large_batch")
IMAGE_CONFIGS = ("resnet50_imagenet", "wrn101_large_batch")
# Flags of the JAX train CLI this port does not take yet.
NOT_PORTED_FLAGS = frozenset(("--platform",))
# --attn-impl's choices; the last two are --parallel sp's.
SP_ATTN_IMPLS = ("ring", "ulysses")
ATTN_IMPLS = ("auto", "xla", "flash", "flash_shmap") + SP_ATTN_IMPLS
# --sp-flash -> GPT2Config.sp_use_flash (JAX's table).
SP_FLASH = {"auto": None, "on": True, "off": False}
# Each config's parallel mode (the JAX CLI's).
CONFIG_MODES = {"mlp_mnist": "single", "resnet50_imagenet": "dp",
                "wrn101_large_batch": "dp", "gpt2_124m": "dp",
                "bert_base_zero1": "zero1"}
PARALLEL_MODES = ("config", "single", "dp", "zero1", "gspmd", "pp", "sp")
# The configs with a tensor-parallel rule table (JAX's tp_rules).
GSPMD_CONFIGS = ("gpt2_124m", "bert_base_zero1")
# --optimizer's factories, with the JAX CLI's weight decays; adamw and
# lamb take the decay mask of --wd-exclude-1d.
OPTIMIZERS = {
    "sgd": sgd,
    "momentum": lambda lr: momentum(lr, beta=0.9, weight_decay=1e-4),
    "adamw": lambda lr, **kw: adamw(lr, weight_decay=0.1, **kw),
    "lars": lambda lr: lars(lr, weight_decay=1e-4),
    "lamb": lambda lr, **kw: lamb(lr, weight_decay=0.01, **kw),
    "adafactor": adafactor,
}


# The AdamW configs' schedules (steps -> schedule), one factory each for
# both engines: the module's adamw and the graph engine's update programs.
GPT2_SCHEDULE = lambda steps: warmup_cosine_schedule(6e-4, 100,
                                                     max(steps, 200))
BERT_SCHEDULE = lambda steps: warmup_cosine_schedule(1e-4, 100,
                                                     max(steps, 200))
GRAPH_LR = 0.1          # the graph engine's momentum programs' rate
MLP_DIMS = [784, 256, 256, 10]


def image_ce(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """The image and MLP configs' loss: mean CE against ``label``."""
    return softmax_cross_entropy_with_integer_labels(logits, batch["label"])


@dataclasses.dataclass
class Config:
    """One config at one preset: its model (built), loss, batch stream
    (``batches(batch_size)``), optimizer (``build_optimizer(steps,
    **kw)``, its schedule sized to ``steps`` updates; the AdamW configs
    take ``mask``), default batch size, the JAX CLI's parallel mode, its
    eval split (``eval_batches(batch_size)``, a finite stream, scored by
    ``eval_stat``; None for none), and the step count ``build_config`` was
    given."""
    model: torch.nn.Module
    loss_fn: Callable
    batches: Callable[[int], Iterator[dict]]
    build_optimizer: Callable[..., Optimizer]
    default_batch: int
    parallel_mode: str = "single"
    eval_batches: Optional[Callable[[int], Iterator[dict]]] = None
    eval_stat: Optional[Callable] = None
    seq_len: Optional[int] = None   # gpt2_124m: tokens per row
    steps: int = 100
    # The AdamW configs' schedule factory (steps -> schedule) and weight
    # decay, shared by both engines (JAX's graph_opt).
    graph_opt: Optional[dict] = None

    @property
    def optimizer(self) -> Optimizer:
        """The config's optimizer over ``steps`` updates."""
        return self.build_optimizer(self.steps)


def build_config(name: str, preset: str = "full", steps: int = 100,
                 seed: int = 0, device="cuda", seq_len: Optional[int] = None,
                 dropout: Optional[float] = None,
                 ln_impl: Optional[str] = None,
                 attn_impl: Optional[str] = None,
                 moe_experts: Optional[int] = None,
                 remat: bool = False, scan_layers: bool = False) -> Config:
    """THE config table: ``name`` at ``preset`` with weights seeded by
    ``seed`` on ``device``; ``steps`` is the step count of
    ``Config.optimizer``; ``seq_len``, ``dropout``, ``ln_impl`` and
    ``moe_experts`` apply to gpt2_124m, ``attn_impl`` to gpt2_124m and
    bert_base_zero1, ``remat`` to gpt2_124m and the image configs,
    ``scan_layers`` (the layer-stacked trunk) to gpt2_124m and
    bert_base_zero1."""
    attn = {} if attn_impl is None else {"attn_impl": attn_impl}
    if scan_layers:
        attn["scan_layers"] = True
    tiny = preset == "tiny"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if name == "mlp_mnist":
        return Config(MLP(generator=gen), image_ce,
                      lambda bs: mnist_batches(bs),
                      lambda n: momentum(0.1), 128,
                      eval_batches=lambda bs: mnist_batches(
                          bs, split="test", epochs=1),
                      eval_stat=accuracy, steps=steps)
    if name in ("resnet50_imagenet", "wrn101_large_batch"):
        wide = name == "wrn101_large_batch"

        def opt(n):
            sched = (warmup_cosine_schedule(1.6, 500, max(n, 1000)) if wide
                     else warmup_cosine_schedule(0.4, 5 * 312, max(n, 10)))
            return momentum(sched, beta=0.9, weight_decay=1e-4)

        default_batch = 512 if wide else 256
        if tiny:
            model = ResNet((1, 1), num_classes=100,
                           width_factor=2 if wide else 1, remat=remat,
                           policy=bf16_policy(), generator=gen)
            return Config(model, image_ce, lambda bs: synthetic_image_batches(
                bs, image_size=32, num_classes=100), opt, default_batch,
                CONFIG_MODES[name], steps=steps)
        build = wide_resnet101 if wide else resnet50
        model = build(stem="s2d", remat=remat, policy=bf16_policy(),
                      generator=gen)
        return Config(model, image_ce, synthetic_image_batches, opt,
                      default_batch, CONFIG_MODES[name], steps=steps)
    if name == "bert_base_zero1":
        def opt(n, **kw):
            return adamw(BERT_SCHEDULE(n), weight_decay=0.01, **kw)

        if tiny:
            model = Bert(BertConfig(**{**TINY_BERT_KW, **attn}),
                         generator=gen)
            mlm = dict(seq_len=64, vocab_size=512, mask_token=1)
            n_eval = 4
        else:
            model = bert_base(fused_loss_chunk=-1, generator=gen, **attn)
            mlm = dict(seq_len=512)
            n_eval = 8
        return Config(model, mlm_loss,
                      lambda bs: synthetic_mlm_batches(bs, **mlm), opt, 16,
                      CONFIG_MODES[name], lambda bs: itertools.islice(
                          synthetic_mlm_batches(bs, seed=1, **mlm), n_eval),
                      mlm_token_stats, steps=steps,
                      graph_opt={"schedule": BERT_SCHEDULE,
                                 "weight_decay": 0.01})
    if name != "gpt2_124m":
        raise ValueError(f"unknown config {name!r}")
    overrides = dict(attn) if tiny else {"fused_loss_chunk": -1, **attn}
    if seq_len:
        overrides["max_positions"] = seq_len
    if dropout is not None:
        overrides["dropout"] = dropout
    if ln_impl is not None:
        overrides["ln_impl"] = ln_impl
    if moe_experts:
        overrides["moe_experts"] = moe_experts
    if remat:
        overrides["remat"] = True
    model = gpt2_for_preset(preset, seed=seed, device=device, **overrides)
    vocab = 512 if tiny else 50257
    seq = seq_len or (64 if tiny else 1024)

    def opt(n, **kw):
        return adamw(GPT2_SCHEDULE(n), weight_decay=0.1, **kw)

    def tokens(bs, seed=0):
        return synthetic_token_batches(bs, seq_len=seq, vocab_size=vocab,
                                       seed=seed)

    return Config(model, lm_loss, tokens, opt, 8, CONFIG_MODES[name],
                  lambda bs: itertools.islice(tokens(bs, seed=1),
                                              4 if tiny else 8),
                  lm_token_stats, seq, steps,
                  {"schedule": GPT2_SCHEDULE, "weight_decay": 0.1})


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
    p.add_argument("--engine", choices=["module", "graph"],
                   default="module",
                   help="module: the PyTorch modules and optimizers; graph: "
                        "the config's program authored in the graph IR "
                        "(forward, loss and optimizer update as IR graphs, "
                        "run by the runtime Executor; --parallel single, "
                        "dp or zero1 (mlp_mnist) on a one-process mesh)")
    p.add_argument("--graph-bf16", action="store_true",
                   help="--engine graph with gpt2_124m: the bf16 policy "
                        "authored in the IR (fp32 master params cast at "
                        "each use, the fused-head CE)")
    p.add_argument("--scan-layers", action="store_true",
                   help="gpt2_124m, bert_base_zero1: the layer-stacked "
                        "trunk (h_scan / layers_scan, a leading layer dim), "
                        "applied layer by layer through one block template")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the config's (gpt2 8, bert 16, mlp 128, "
                        "resnet 256, wrn 512)")
    p.add_argument("--seq-len", type=int, default=None,
                   help="gpt2_124m: tokens per row; also sizes the "
                        "position table (default 1024, tiny 64 with a "
                        "96-row table)")
    p.add_argument("--seed", type=int, default=0,
                   help="weight seed, the loaders' seed, and the run's "
                        "PRNG key (JAX's PRNGKey(seed))")
    p.add_argument("--dropout", type=float, default=None,
                   help="gpt2_124m: the dropout rate")
    p.add_argument("--ln-impl", choices=["xla", "pallas"], default=None,
                   help="gpt2_124m: LayerNorm by tensor ops (xla, the "
                        "default) or the fused LayerNorm kernels (pallas)")
    p.add_argument("--clip-norm", type=float, default=None,
                   help="clip gradients to this global norm")
    p.add_argument("--wd-exclude-1d", action="store_true",
                   help="the AdamW configs (gpt2_124m, bert_base_zero1) or "
                        "--optimizer adamw|lamb: no weight decay on norm "
                        "scales and biases (not under zero1)")
    p.add_argument("--optimizer", default=None, choices=sorted(OPTIMIZERS),
                   help="swap the config's optimizer (needs --lr; on a "
                        "warmup+cosine schedule over --steps)")
    p.add_argument("--lr", type=float, default=None,
                   help="peak learning rate of --optimizer's schedule")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="apply the mean gradient of N micro-steps once "
                        "(effective batch = batch size x N)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches staged onto the device ahead of the step "
                        "(pinned memory, a side stream; 0 behaves as 1)")
    p.add_argument("--log-every", type=int, default=10,
                   help="log a metrics line every N steps (0: never)")
    p.add_argument("--metrics-file", default=None,
                   help="append the logged metrics here as JSONL")
    p.add_argument("--log-memory", action="store_true",
                   help="add the card's live and peak allocated bytes "
                        "(hbm_bytes_in_use, hbm_peak_bytes) to each "
                        "logged line")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace here (the "
                        "whole run, or the --profile-steps window)")
    p.add_argument("--profile-steps", default=None, metavar="START:COUNT",
                   help="profile COUNT steps after step START (START, "
                        "COUNT >= 1; needs --profile-dir)")
    p.add_argument("--trace-dir", default=None,
                   help="alias of --profile-dir")
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
    p.add_argument("--data-dir", default=None,
                   help="train from disk: train.nzr (image configs), "
                        "train.tokens.u16|i32 (gpt2, bert), mnist/ (mlp); "
                        "val.nzr / val.tokens.* for the eval")
    p.add_argument("--crop", type=int, default=224,
                   help="image configs with --data-dir: crop size")
    p.add_argument("--mlm-mask-token", type=int, default=None,
                   help="bert --data-dir only: [MASK] id (default: the "
                        "corpus's tokenizer metadata, else 103)")
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="image and MLP configs: CE against (1 - eps) "
                        "one_hot + eps / V")
    p.add_argument("--ckpt-dir", default=None,
                   help="resume from and save checkpoints here (the JAX "
                        "package's npz format)")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="save every N global steps (0: only at the end)")
    p.add_argument("--ckpt-keep", type=int, default=None,
                   help="keep only the N newest checkpoints (default: all)")
    p.add_argument("--parallel", default="config", choices=PARALLEL_MODES,
                   help="config (the config's mode), single, dp (gradient "
                        "all-reduce), zero1 (sharded optimizer state), "
                        "gspmd (tensor-parallel, one process), pp (GPipe "
                        "pipeline, one process), sp (dp x sp ring/Ulysses "
                        "sequence parallel, one process)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches per step (--parallel pp)")
    p.add_argument("--mesh", default=None,
                   help='mesh axes, "dp=N" (N the world size, or -1); '
                        '"dp=1" runs dp/zero1 on one device; gspmd: '
                        '"dp=D,tp=M" (tp=-1: the visible cards), with '
                        '--moe-experts "dp=D,tp=M,ep=E"; pp: "dp=D,pp=P"; '
                        'sp: "dp=D,sp=S"')
    p.add_argument("--shard-device", default=None,
                   help="gspmd, pp and sp: every shard or stage on this "
                        "device (cuda:0 runs them on one card, one after "
                        "another); default: one visible card each on "
                        "cuda, the CPU repeated on cpu")
    p.add_argument("--sp-flash", default="auto", choices=sorted(SP_FLASH),
                   help="--parallel sp's attention kernels: auto and on "
                        "run the flash kernels per ring hop or head group "
                        "(their plain versions on the CPU); off the "
                        "composed attention (the escape hatch)")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="gpt2_124m: route every other block's MLP through "
                        "this many top-2 experts (mixture-of-experts; "
                        "lm_loss adds the load-balance aux); under gspmd "
                        "the experts shard over an ep mesh axis")
    p.add_argument("--remat", action="store_true",
                   help="gpt2_124m + image configs: rematerialize each "
                        "transformer block / ResNet bottleneck in the "
                        "backward (activation memory for recompute); "
                        "under pp each stage application")
    p.add_argument("--attn-impl", default=None, choices=ATTN_IMPLS,
                   help="gpt2_124m, bert_base_zero1: the attention (auto: "
                        "the flash kernels, per shard under gspmd; xla: "
                        "composed; flash_shmap: per shard, gspmd only); "
                        "gpt2_124m under --parallel sp: ring (its "
                        "default) or ulysses")
    p.add_argument("--grad-allreduce", default="fp32",
                   choices=["fp32", "int8"],
                   help="dp/zero1 gradient wire: exact fp32 or "
                        "block-scaled int8")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address for a multi-process launch")
    p.add_argument("--serve-coordinator", action="store_true",
                   help="also run the coordinator here (port 0: a free "
                        "one, printed on stderr)")
    p.add_argument("--world-size", type=int, default=1,
                   help="processes in the job (with --serve-coordinator)")
    p.add_argument("--rank-hint", type=int, default=-1,
                   help="preferred rank")
    p.add_argument("--failure-check-every", type=int, default=10,
                   help="poll the coordinator for dead peers every N "
                        "steps (multi-process runs)")
    p.add_argument("--on-failure", choices=["stop", "rejoin"],
                   default="stop",
                   help="on a dead peer: stop checkpoints, then raises "
                        "(relaunch the world: it resumes from --ckpt-dir); "
                        "rejoin also waits for the dead rank's relaunch "
                        "(--rank-hint), reloads the rescue checkpoint and "
                        "trains on (--parallel single)")
    p.add_argument("--rejoin-timeout", type=float, default=300.0,
                   help="seconds --on-failure rejoin waits for the "
                        "replacement rank before it gives up (then raises, "
                        "the checkpoint already committed)")
    p.add_argument("--run-dir", default=None,
                   help="write the run's telemetry here (metrics.jsonl, "
                        "spans.jsonl, events.jsonl, summary.json; under "
                        "--coordinator a rank<K> or pid<P> subdirectory "
                        "each); render with nezha_tpu_torch.cli.telemetry")
    p.add_argument("--no-jax-distributed", action="store_true",
                   help=argparse.SUPPRESS)
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse and check the flags."""
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            parser.error(f"{flag} is not ported to the PyTorch trainer "
                         f"yet (ROADMAP A7)")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.no_jax_distributed:
        parser.error("--no-jax-distributed skips the JAX package's "
                     "jax.distributed bootstrap; the port has no JAX "
                     "runtime to skip (its torch.distributed group starts "
                     "only for dp/zero1 across processes)")
    if args.world_size < 1:
        parser.error(f"--world-size must be >= 1, got {args.world_size}")
    if args.serve_coordinator and not args.coordinator:
        parser.error("--serve-coordinator needs --coordinator HOST:PORT")
    if args.failure_check_every < 0:
        parser.error(f"--failure-check-every must be >= 0, got "
                     f"{args.failure_check_every}")
    gpt2 = args.config == "gpt2_124m"
    for flag, value in (("--seq-len", args.seq_len),
                        ("--dropout", args.dropout),
                        ("--ln-impl", args.ln_impl)):
        if value is not None and not gpt2:
            parser.error(f"{flag} applies to gpt2_124m")
    if args.attn_impl is not None and args.config not in GSPMD_CONFIGS:
        parser.error("--attn-impl applies to gpt2_124m and bert_base_zero1")
    if args.attn_impl == "flash_shmap" and args.parallel != "gspmd":
        parser.error("--attn-impl flash_shmap runs the flash kernels per "
                     "shard of a tensor-parallel mesh: it needs --parallel "
                     "gspmd")
    if args.shard_device is not None and args.parallel not in (
            "gspmd", "pp", "sp") and not (args.engine == "graph"
                                          and args.parallel in ("dp",
                                                                "zero1")):
        parser.error("--shard-device places the shards of --parallel "
                     "gspmd and sp, the stages of --parallel pp and the "
                     "shards of --engine graph's dp and zero1")
    check_engine_flags(args)
    if args.attn_impl in SP_ATTN_IMPLS or args.parallel == "sp":
        check_sp_flags(args)
    check_model_flags(args)
    if args.trace_dir:
        if args.profile_dir and args.profile_dir != args.trace_dir:
            parser.error("--trace-dir is an alias for --profile-dir; pass "
                         "one of them")
        args.profile_dir = args.trace_dir
    if args.profile_steps:
        if not args.profile_dir:
            parser.error("--profile-steps needs --profile-dir for the "
                         "trace output")
        parse_profile_steps(args.profile_steps)
    if args.lr is not None and not args.optimizer:
        parser.error("--lr only applies with --optimizer (each config's "
                     "default optimizer bakes its own tuned schedule)")
    if args.optimizer:
        if args.lr is None:
            parser.error("--optimizer needs --lr (peak learning rate for "
                         "the warmup+cosine schedule)")
        if not args.lr > 0:  # also catches NaN
            parser.error(f"--lr must be > 0, got {args.lr}")
    if args.wd_exclude_1d:
        if args.optimizer and args.optimizer not in ("adamw", "lamb"):
            parser.error(f"--wd-exclude-1d needs a masked-decay optimizer "
                         f"(adamw/lamb), not {args.optimizer}")
        if not args.optimizer and args.config not in ("gpt2_124m",
                                                      "bert_base_zero1"):
            parser.error("--wd-exclude-1d applies to the AdamW configs "
                         "(gpt2_124m, bert_base_zero1) or with --optimizer "
                         "adamw/lamb")
    if args.grad_accum is not None and args.grad_accum < 1:
        parser.error(f"--grad-accum must be >= 1, got {args.grad_accum}")
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
    if args.ckpt_keep is not None and args.ckpt_keep <= 0:
        parser.error(f"--ckpt-keep must be >= 1 (got {args.ckpt_keep}); "
                     f"omit it to keep all checkpoints")
    if args.ckpt_every < 0:
        parser.error(f"--ckpt-every must be >= 0, got {args.ckpt_every}")
    if args.label_smoothing is not None:
        if args.config not in ("mlp_mnist",) + IMAGE_CONFIGS:
            parser.error("--label-smoothing applies to the integer-label "
                         "CE configs (mlp_mnist, "
                         + ", ".join(IMAGE_CONFIGS) + ")")
        if not 0.0 < args.label_smoothing < 1.0:
            parser.error(f"--label-smoothing must be in (0, 1), got "
                         f"{args.label_smoothing}")
    if args.mlm_mask_token is not None and (
            args.config != "bert_base_zero1" or not args.data_dir):
        parser.error("--mlm-mask-token applies to bert_base_zero1 with "
                     "--data-dir (the dynamic-MLM data path)")
    return args


def check_engine_flags(args) -> None:
    """The JAX CLI's checks of ``--engine graph``, ``--graph-bf16`` and
    ``--scan-layers`` against the other flags, with its messages."""
    graph = args.engine == "graph"
    if args.clip_norm is not None and graph and args.parallel in ("dp",
                                                                  "zero1"):
        raise SystemExit("--clip-norm with the graph engine's dp/zero1 "
                         "modes is unsupported: the clip must see the "
                         "REDUCED gradients, but their collectives live "
                         "inside the update graphs; use single-device "
                         "graph or the module engine")
    if args.optimizer and graph:
        raise SystemExit("the graph engine authors its optimizer update in "
                         "the IR (momentum/adamw programs); --optimizer "
                         "cannot swap it")
    if args.moe_experts and graph and args.config == "gpt2_124m":
        raise SystemExit("--moe-experts is not expressible in the graph "
                         "engine's GPT-2 program; drop --engine graph")
    if args.graph_bf16 and (not graph or args.config != "gpt2_124m"):
        raise SystemExit("--graph-bf16 applies to --engine graph with "
                         "gpt2_124m (the bf16 policy authored in the IR; "
                         "the module engine's presets carry their own "
                         "policies)")
    if args.wd_exclude_1d and graph:
        raise SystemExit("--wd-exclude-1d: the graph engine's IR-authored "
                         "update decays every leaf")
    if graph and args.grad_accum is not None and args.grad_accum > 1:
        raise SystemExit("--grad-accum is an optimizer wrapper the graph "
                         "engine's IR-authored update does not express; "
                         "drop --engine graph")
    if args.dropout is not None and graph and args.config == "gpt2_124m":
        raise SystemExit("the graph engine's GPT-2 program has no dropout "
                         "path; drop --engine graph")
    if (args.label_smoothing and graph
            and args.config in ("mlp_mnist",) + IMAGE_CONFIGS):
        raise SystemExit("the graph engine's programs author the plain "
                         "CE; drop --engine graph")
    if (args.remat and graph
            and args.config in ("gpt2_124m",) + IMAGE_CONFIGS):
        raise SystemExit("--remat is a jax.checkpoint knob; the graph "
                         "engine does not rematerialize")
    if args.scan_layers:
        if args.config not in ("gpt2_124m", "bert_base_zero1"):
            raise SystemExit("--scan-layers applies to gpt2_124m / "
                             "bert_base_zero1")
        if graph:
            raise SystemExit("--scan-layers is a module-engine knob; the "
                             "graph engine authors its own trunk IR")
        eff = (CONFIG_MODES[args.config] if args.parallel == "config"
               else args.parallel)
        if eff not in ("single", "dp", "zero1", "gspmd", "sp"):
            raise SystemExit("--scan-layers supports --parallel "
                             "single/dp/zero1/gspmd/sp (the pp builder "
                             "addresses unrolled h{i} names)")


def check_sp_flags(args) -> None:
    """``--parallel sp``'s model checks and its attention's (JAX's
    messages where JAX has the check)."""
    if args.config != "gpt2_124m":
        raise SystemExit(f"config {args.config!r} has no sequence-parallel "
                         f"model; --parallel sp supports: gpt2_124m")
    if args.parallel != "sp":
        raise SystemExit(f"--attn-impl {args.attn_impl} is the "
                         f"sequence-parallel attention: it needs --parallel "
                         f"sp")
    if args.attn_impl not in (None,) + SP_ATTN_IMPLS:
        raise SystemExit(f"--parallel sp attends across its shards by "
                         f"--attn-impl ring or ulysses, not "
                         f"{args.attn_impl}")


def check_model_flags(args) -> None:
    """The JAX CLI's checks of the model knobs, with its messages."""
    if args.moe_experts:
        if args.config != "gpt2_124m":
            raise SystemExit("--moe-experts applies to gpt2_124m")
        if args.parallel == "pp":
            raise SystemExit("--moe-experts cannot pipeline (MoE blocks "
                             "make the stage slabs heterogeneous); use "
                             "--parallel dp/zero1/sp, or gspmd with an ep "
                             "mesh axis (--mesh dp=X,tp=Y,ep=Z)")
    if args.remat and args.config not in ("gpt2_124m",) + IMAGE_CONFIGS:
        raise SystemExit("--remat applies to gpt2_124m and the image "
                         "configs")
    if args.microbatches < 1:
        raise SystemExit(f"--microbatches must be >= 1, got "
                         f"{args.microbatches}")


def parse_profile_steps(spec: str):
    """``START:COUNT`` -> (START, COUNT), both >= 1: the window opens
    after step START, so START 0 could not capture step 1."""
    m = re.match(r"^(\d+):(\d+)$", spec)
    if not m or int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise SystemExit(f"--profile-steps takes START:COUNT with START "
                         f">= 1 and COUNT >= 1 (e.g. 10:3), got {spec!r}")
    return int(m.group(1)), int(m.group(2))


def _token_file(data_dir: str, split: str):
    """(path, dtype) of ``<split>.tokens.u16`` or ``.i32`` in
    ``data_dir``, or None."""
    for name, dtype in ((f"{split}.tokens.u16", np.uint16),
                        (f"{split}.tokens.i32", np.int32)):
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            return path, dtype
    return None


def _mask_token_from_corpus_sidecar(tok_path: str) -> Optional[int]:
    """The packed corpus's own ``[MASK]`` id: the ``<tokens>.meta.json``
    sidecar the packer writes, else a ``vocab.txt`` beside the tokens;
    None when neither exists."""
    meta_path = tok_path + ".meta.json"
    if os.path.isfile(meta_path):
        try:
            with open(meta_path, encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, ValueError):
            meta = {}
        if meta.get("mask_token_id") is not None:
            return int(meta["mask_token_id"])
    vocab_txt = os.path.join(os.path.dirname(os.path.abspath(tok_path)),
                             "vocab.txt")
    if os.path.isfile(vocab_txt):
        with open(vocab_txt, encoding="utf-8") as f:
            for i, line in enumerate(f):
                if line.rstrip("\n") == "[MASK]":
                    return i
    return None


def resolve_mlm_mask_token(args, vocab_size: int, tok_path: str,
                           sample_ids) -> int:
    """The MLM ``[MASK]`` id for a packed corpus: ``--mlm-mask-token``;
    else the corpus's tokenizer metadata (refused when outside the
    model's vocab); else 103, refused when the corpus looks byte-packed
    (every sampled id < 256), where 103 is a real byte."""
    if args.mlm_mask_token is not None:
        return args.mlm_mask_token
    resolved = _mask_token_from_corpus_sidecar(tok_path)
    if resolved is not None:
        if resolved >= vocab_size:
            raise SystemExit(
                f"{tok_path}: the corpus tokenizer's [MASK] id {resolved} "
                f"is outside the model vocab ({vocab_size}); the corpus "
                f"and model vocabularies do not match")
        print(f"mlm: [MASK] id {resolved} resolved from the corpus "
              f"tokenizer metadata next to {tok_path}", file=sys.stderr)
        return resolved
    mask_token = min(103, vocab_size - 1)
    sample = np.asarray(sample_ids).ravel()
    if sample.size and int(sample.max()) < 256:
        raise SystemExit(
            f"{tok_path} looks byte-packed (sampled ids all < 256), so "
            f"the default mask_token {mask_token} is a real byte value; "
            f"pass an explicit --mlm-mask-token (>= 256 reserves an id "
            f"byte data cannot produce) or use a WordPiece-tokenized "
            f"corpus")
    return mask_token


def _slice_rows(it: Iterator[dict], rank: int, world: int
                ) -> Iterator[dict]:
    """This rank's rows of each batch of a stream every rank draws
    alike."""
    for b in it:
        yield local_rows(b, rank, world)


def data_source(args, cfg: Config, batch_size: int, rank: int = 0,
                world: int = 1):
    """Training batches: from ``--data-dir`` through the native loaders
    when it holds the config's files, else the config's synthetic
    stream. -> (iterator, closer or None). Token windows come from one
    loader worker, so the seed fixes their order (two workers' batches
    would interleave in arrival order). With ``world`` > 1,
    ``batch_size`` is the global batch and the stream yields this rank's
    ``batch_size // world`` rows: a loader reads shard ``rank`` of
    ``world`` (disjoint record batches, its own token windows), a
    synthetic stream is sliced (JAX's ``_data_source``)."""
    from nezha_tpu_torch.data.mlm import mlm_batches_from_tokens
    from nezha_tpu_torch.data.native import ImageRecordLoader, TokenLoader

    local = batch_size // world
    shard = {"shard_index": rank, "shard_count": world} if world > 1 else {}
    note = f" (shard {rank}/{world})" if shard else ""
    d = args.data_dir
    if d:
        if args.config in IMAGE_CONFIGS:
            rec = os.path.join(d, "train.nzr")
            if os.path.exists(rec):
                loader = ImageRecordLoader(rec, local, crop=args.crop,
                                           seed=args.seed,
                                           train_augment=True, **shard)
                print(f"data: {loader.num_examples} image records from "
                      f"{rec}{note}", file=sys.stderr)
                return iter(loader), loader.close
        elif args.config == "gpt2_124m" and _token_file(d, "train"):
            tok, dtype = _token_file(d, "train")
            vocab = cfg.model.cfg.vocab_size
            sample = np.fromfile(tok, dtype=dtype, count=65536)
            if sample.size and int(sample.max()) >= vocab:
                raise SystemExit(
                    f"{tok} holds token ids up to {int(sample.max())} but "
                    f"the model vocab is {vocab}; re-pack with a matching "
                    f"tokenizer (pack_text --tokenizer/--learn-bpe) or "
                    f"train the full-vocab preset")
            loader = TokenLoader(tok, seq_len=cfg.seq_len,
                                 batch_size=local, dtype=dtype,
                                 seed=args.seed, num_workers=1, **shard)
            print(f"data: {loader.num_tokens} tokens from {tok}{note}",
                  file=sys.stderr)
            return iter(loader), loader.close
        elif args.config == "bert_base_zero1" and _token_file(d, "train"):
            tok, dtype = _token_file(d, "train")
            mcfg = cfg.model.cfg
            mask_token = resolve_mlm_mask_token(
                args, mcfg.vocab_size, tok,
                np.fromfile(tok, dtype=dtype, count=32768))
            loader = TokenLoader(tok, seq_len=mcfg.max_positions,
                                 batch_size=local, dtype=dtype,
                                 seed=args.seed, num_workers=1, **shard)
            print(f"data: {loader.num_tokens} tokens from {tok} (dynamic "
                  f"MLM masking, mask_token={mask_token}){note}",
                  file=sys.stderr)
            return mlm_batches_from_tokens(
                iter(loader), vocab_size=mcfg.vocab_size,
                mask_token=mask_token, seed=args.seed,
                drop_last_column=True), loader.close
        elif args.config == "mlp_mnist":
            os.environ.setdefault("NEZHA_DATA_DIR", d)
            if os.path.isdir(os.path.join(d, "mnist")):
                print(f"data: MNIST IDX files from {d}/mnist",
                      file=sys.stderr)
                return _slice_rows(cfg.batches(batch_size), rank,
                                   world), None
        print(f"data: no records for {args.config} in {d}; using "
              f"synthetic data", file=sys.stderr)
    return _slice_rows(cfg.batches(batch_size), rank, world), None


def eval_source(args, cfg: Config, batch_size: int):
    """Eval batches: ``val.nzr`` (center crop) or ``val.tokens.*``
    (sequential windows over the whole file) in ``--data-dir`` when
    present, else the config's eval split. -> (iterator, closer, stat
    fn); the iterator is None when there is no eval."""
    from nezha_tpu_torch.data.mlm import mlm_batches_from_tokens
    from nezha_tpu_torch.data.native import ImageRecordLoader, nzr_count

    d = args.data_dir
    if d and args.config in IMAGE_CONFIGS:
        rec = os.path.join(d, "val.nzr")
        if os.path.exists(rec):
            # The largest batch <= the requested one that divides the
            # record count: the loader yields full batches only.
            n = nzr_count(rec)
            bs = max(k for k in range(1, min(batch_size, n) + 1)
                     if n % k == 0)
            if bs != batch_size:
                print(f"eval: batch {batch_size} -> {bs} to cover all "
                      f"{n} val records exactly", file=sys.stderr)
            loader = ImageRecordLoader(rec, bs, crop=args.crop,
                                       train_augment=False, epochs=1)
            print(f"eval: {n} val records from {rec}", file=sys.stderr)
            return iter(loader), loader.close, accuracy
    if d and args.config in ("gpt2_124m", "bert_base_zero1") and \
            _token_file(d, "val"):
        tok, dtype = _token_file(d, "val")
        mcfg = cfg.model.cfg
        seq = cfg.seq_len if args.config == "gpt2_124m" \
            else mcfg.max_positions
        ids = np.fromfile(tok, dtype=dtype).astype(np.int32)
        if ids.size and int(ids.max()) >= mcfg.vocab_size:
            raise SystemExit(
                f"{tok} holds token ids up to {int(ids.max())} but the "
                f"model vocab is {mcfg.vocab_size}; re-pack the val split "
                f"with the matching tokenizer")
        win = seq + 1
        n_win = ids.size // win
        if n_win < 1:
            raise SystemExit(f"{tok}: {ids.size} tokens is fewer than one "
                             f"{win}-token eval window")
        ids = ids[:n_win * win].reshape(n_win, win)
        bs = min(batch_size, n_win)

        def batches():
            # Full batches, then the rest as a smaller last batch.
            full = (n_win // bs) * bs
            for i in range(0, full, bs):
                yield {"tokens": ids[i:i + bs]}
            if full < n_win:
                yield {"tokens": ids[full:]}

        print(f"eval: {n_win} held-out windows from {tok}", file=sys.stderr)
        it = batches()
        if args.config == "bert_base_zero1":
            mask_token = resolve_mlm_mask_token(args, mcfg.vocab_size, tok,
                                                ids)
            it = mlm_batches_from_tokens(
                ({"tokens": b["tokens"][:, :-1]} for b in it),
                vocab_size=mcfg.vocab_size, mask_token=mask_token,
                seed=args.seed)
        return it, None, cfg.eval_stat
    if cfg.eval_batches is not None:
        return cfg.eval_batches(batch_size), None, cfg.eval_stat
    return None, None, None


def _split_rows(it: Iterator[dict], rank: int, world: int
                ) -> Iterator[dict]:
    """Rows ``[B * rank // world, B * (rank + 1) // world)`` of each
    batch: the ranks' shares of a stream every rank draws alike, a batch
    of fewer rows than ranks included (some shares are then empty)."""
    for b in it:
        n = len(next(iter(b.values())))
        lo, hi = n * rank // world, n * (rank + 1) // world
        yield {k: v[lo:hi] for k, v in b.items()}


def run_eval(args, cfg: Config, batch_size: int, rank: int = 0,
             world: int = 1, tp=None, pp=None,
             graph=None) -> Optional[Dict[str, float]]:
    """One pass over the eval split with the current weights, or None
    when there is none. With ``world`` > 1 (dp and ZeRO-1, whose ranks
    hold the same weights), each rank evaluates its rows of every global
    batch and the sums are added over the default group, so the work and
    the memory a rank takes are 1/world of the split's. ``tp`` (a gspmd
    step) evaluates its tensor-parallel model inside
    ``auto_partitioner_scope`` of its mesh; ``pp`` (a pipeline step)
    merges its stage slabs back into the model first; ``graph`` (a graph
    engine step) copies its IR state's params into the model first, as
    JAX evaluates the module on the graph state's params."""
    batches, close, stat = eval_source(args, cfg, batch_size)
    if batches is None:
        return None
    group = None
    if world > 1:
        import torch.distributed as dist

        batches, group = _split_rows(batches, rank, world), dist.group.WORLD
    model, scope = cfg.model, contextlib.nullcontext()
    if graph is not None:
        from nezha_tpu_torch.graph.programs import load_param_tree
        load_param_tree(model, graph.params())
    if pp is not None:
        model = pp.sync_model()
    if tp is not None:
        from nezha_tpu_torch.parallel.gspmd import auto_partitioner_scope
        model, scope = tp.tp_model, auto_partitioner_scope(tp.mesh)
    try:
        with scope:
            return evaluate(model, batches, stat,
                            max_batches=args.eval_batches, group=group)
    finally:
        if close is not None:
            close()


def parse_mesh(spec: Optional[str]) -> Optional[Dict[str, int]]:
    if not spec:
        return None
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    return axes


def join_world(args):
    """Dial the coordinator before touching a device (rank 0 may serve
    it); -> (group, coordinator), either None without
    ``--coordinator``."""
    if not args.coordinator:
        return None, None
    from nezha_tpu_torch import dist as nzdist

    host, _, port = args.coordinator.rpartition(":")
    host = host or "127.0.0.1"
    coord = None
    if args.serve_coordinator:
        coord = nzdist.Coordinator(world_size=args.world_size,
                                   port=int(port))
        port = coord.port
        print(f"coordinator: serving {host}:{port} for "
              f"{args.world_size} process(es)", file=sys.stderr, flush=True)
    group = nzdist.join(host, int(port), rank_hint=args.rank_hint)
    set_rank(group.rank)
    get_logger("nezha_tpu_torch.cli").info(
        "joined world: rank %d / %d", group.rank, group.world_size)
    return group, coord


def resolve_mode(args, cfg: Config, world: int) -> str:
    """The parallel mode after the JAX CLI's checks: its refusals, and
    its degrade of dp/zero1 to single-device on a one-device world
    unless ``--mesh`` asks for an all-ones mesh."""
    mode = cfg.parallel_mode if args.parallel == "config" else args.parallel
    if mode == "single" and args.mesh:
        raise SystemExit("--mesh has no effect in single-device mode; drop "
                         "it or pick a --parallel mode that consumes it")
    if mode in ("gspmd", "pp", "sp"):
        mode = resolve_sharded(args, mode)
        check_sp_flash(args, mode)
        return mode
    req = parse_mesh(args.mesh)
    req_size = 1
    for v in (req or {"": -1}).values():
        req_size *= v  # -1 ("all devices") counts as more than one
    if mode != "single" and world == 1 and req_size != 1:
        print(f"WARNING: config {args.config!r} requests parallel mode "
              f"{mode!r} but only 1 device is visible; running "
              f"single-device (check your mesh/launch if this is a "
              f"multi-chip job)", file=sys.stderr, flush=True)
        mode = "single"
    if args.grad_allreduce != "fp32" and mode not in ("dp", "zero1"):
        raise SystemExit("--grad-allreduce int8 is the dp/zero1 gradient "
                         f"wire format; mode {mode!r} does not consume it "
                         "(reject, don't ignore)")
    check_sp_flash(args, mode)
    if args.optimizer in ("lars", "lamb") and mode == "zero1":
        raise SystemExit(f"--optimizer {args.optimizer} computes layerwise "
                         f"trust ratios, which ZeRO-1's flat per-rank "
                         f"chunks cannot preserve; use --parallel dp (or "
                         f"adamw/momentum with zero1)")
    if args.wd_exclude_1d and mode == "zero1":
        raise SystemExit("--wd-exclude-1d: this mode's flat param layout "
                         "(zero1 chunks) erases the leaf shapes the "
                         "ndim-based decay mask keys on; use --parallel "
                         "dp/single")
    if mode != "single":
        axes = req or {"dp": -1}
        unusable = [a for a in axes if a != "dp"]
        if unusable:
            raise SystemExit(f"parallel mode {mode!r} cannot use mesh "
                             f"axis(es) {unusable} (it consumes ['dp']); "
                             f"pass --parallel to select the mode that "
                             f"uses them")
        if "dp" not in axes:
            raise SystemExit(f"parallel mode {mode!r} needs mesh axis(es) "
                             f"['dp'] (use size 1 to disable an axis); got "
                             f"{list(axes)}")
        if axes["dp"] not in (-1, world):
            raise SystemExit(f"--mesh dp={axes['dp']} does not match the "
                             f"world of {world} process(es), one device "
                             f"each")
    return mode


def check_sp_flash(args, mode: str) -> None:
    """JAX's refusal of ``--sp-flash`` outside sp, after the degrade."""
    if args.sp_flash != "auto" and mode != "sp":
        raise SystemExit(f"--sp-flash tunes the sequence-parallel attention "
                         f"kernels; mode {mode!r} does not consume it "
                         f"(reject, don't ignore)")


def mode_mesh(args, mode: str):
    """(the axes ``mode`` consumes, its default ``--mesh``): the JAX CLI's
    tables, with the MoE ``ep`` variant of gspmd."""
    if mode == "pp":
        return ("dp", "pp"), "dp=1,pp=-1"
    if mode == "sp":
        return ("dp", "sp"), "dp=1,sp=-1"
    if args.moe_experts:
        return ("dp", "tp", "ep"), "dp=1,tp=1,ep=-1"
    return ("dp", "tp"), "dp=1,tp=-1"


def sharded_axes(args, mode: str) -> Dict[str, int]:
    return parse_mesh(args.mesh) or parse_mesh(mode_mesh(args, mode)[1])


def resolve_sharded(args, mode: str) -> str:
    """``--parallel gspmd``'s, ``pp``'s and ``sp``'s checks (the JAX
    CLI's, and the port's own refusals), and their degrade to
    single-device on one visible card without ``--shard-device`` (JAX's
    on one device)."""
    if mode == "gspmd" and args.config not in GSPMD_CONFIGS:
        raise SystemExit(f"config {args.config!r} has no tensor-parallel "
                         f"rule table; --parallel gspmd supports: "
                         f"{', '.join(GSPMD_CONFIGS)}")
    if mode == "pp" and args.config != "gpt2_124m":
        raise SystemExit(f"config {args.config!r} has no pipeline spec; "
                         f"--parallel pp supports: gpt2_124m")
    if mode == "sp" and args.config != "gpt2_124m":
        raise SystemExit(f"config {args.config!r} has no sequence-parallel "
                         f"model; --parallel sp supports: gpt2_124m")
    if mode == "gspmd" and args.optimizer in ("lars", "lamb", "adafactor"):
        raise SystemExit(f"--optimizer {args.optimizer} computes statistics "
                         f"over whole tensors, which the tensor-parallel "
                         f"step's per-shard update cannot see; use adamw, "
                         f"momentum or sgd with --parallel gspmd")
    if mode == "pp" and args.wd_exclude_1d:
        raise SystemExit("--wd-exclude-1d: this mode's flat/stacked param "
                         "layout (zero1 chunks, pp stage slabs) erases the "
                         "leaf shapes the ndim-based decay mask keys on; "
                         "use --parallel dp/single/gspmd")
    if args.grad_allreduce != "fp32":
        raise SystemExit("--grad-allreduce int8 is the dp/zero1 gradient "
                         f"wire format; mode {mode!r} does not consume it "
                         "(reject, don't ignore)")
    consumed = mode_mesh(args, mode)[0]
    axes = sharded_axes(args, mode)
    unusable = [a for a in axes if a not in consumed]
    if unusable:
        raise SystemExit(f"parallel mode {mode!r} cannot use mesh axis(es) "
                         f"{unusable} (it consumes {list(consumed)}); pass "
                         f"--parallel to select the mode that uses them")
    missing = [a for a in consumed if a not in axes]
    if missing:
        raise SystemExit(f"parallel mode {mode!r} needs mesh axis(es) "
                         f"{missing} (use size 1 to disable an axis); got "
                         f"{list(axes)}")
    size = 1
    for v in axes.values():
        size *= v
    one_card = (torch.device(args.device).type == "cuda"
                and args.shard_device is None
                and torch.cuda.device_count() == 1)
    if one_card and size != 1:
        print(f"WARNING: config {args.config!r} requests parallel mode "
              f"{mode!r} but only 1 device is visible; running "
              f"single-device (check your mesh/launch if this is a "
              f"multi-chip job; --shard-device repeats one card)",
              file=sys.stderr, flush=True)
        return "single"
    return mode


def build_sharded_step(args, cfg: Config, optimizer: Optimizer, loss_fn,
                       mode: str, batch_size: int):
    """The tensor-parallel, pipeline or sequence-parallel step over
    ``--mesh`` (and ``--shard-device``)."""
    from nezha_tpu_torch.parallel.gspmd import (GSPMDTrainStep,
                                                make_gspmd_mesh)
    from nezha_tpu_torch.parallel.pipeline import (PipelineTrainStep,
                                                   gpt2_pipeline_spec,
                                                   make_pipeline_mesh)
    axes = sharded_axes(args, mode)
    devices = None
    if args.shard_device is not None:
        n = 1
        for v in axes.values():
            n *= v
        devices = [args.shard_device] * max(n, 1)
    device_type = torch.device(args.device).type
    try:
        if mode == "gspmd":
            mesh = make_gspmd_mesh(axes, devices, device_type)
            if mesh.ep and args.moe_experts % mesh.ep:
                raise SystemExit(
                    f"--moe-experts {args.moe_experts} is not divisible by "
                    f"mesh axis ep={mesh.ep}; expert stacks shard over ep "
                    f"(pass --mesh dp=X,tp=Y,ep=Z with Z dividing the "
                    f"expert count)")
            return GSPMDTrainStep(cfg.model, optimizer, loss_fn, mesh)
        if mode == "sp":
            from nezha_tpu_torch.models.gpt2 import with_overrides
            from nezha_tpu_torch.parallel.mesh import make_sp_mesh
            from nezha_tpu_torch.parallel.sequence_parallel import \
                SPTrainStep
            mesh = make_sp_mesh(axes, devices, device_type)
            if batch_size % mesh.dp:
                raise ValueError(f"batch of {batch_size} rows does not "
                                 f"split over dp={mesh.dp} groups")
            # JAX's sp model: the config's model over the same weights,
            # the shards' attention, the fused head; its loss is
            # lm_objective over each shard's targets.
            model = with_overrides(cfg.model,
                                   attn_impl=args.attn_impl or "ring",
                                   sp_use_flash=SP_FLASH[args.sp_flash],
                                   fused_loss_chunk=-1)
            return SPTrainStep(model, optimizer, mesh)
        mesh = make_pipeline_mesh(axes, devices, device_type)
        if batch_size % mesh.dp:
            raise ValueError(f"batch of {batch_size} rows does not split "
                             f"over dp={mesh.dp} groups")
        if batch_size // mesh.dp % args.microbatches:
            raise ValueError(f"local batch {batch_size // mesh.dp} not "
                             f"divisible by num_microbatches "
                             f"{args.microbatches}")
        spec = gpt2_pipeline_spec(cfg.model)
        # dropout_rng/remat follow the spec (the model config's), as JAX's
        # CLI resolves them.
        return PipelineTrainStep(cfg.model, spec, optimizer, loss_fn, mesh,
                                 args.microbatches,
                                 dropout_rng=bool(spec.dropout))
    except NotPortedError:
        raise
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh or mode_mesh(args, mode)[1]}: "
                         f"{e}")


def build_optimizer(args, cfg: Config, mode: str) -> Optimizer:
    """The run's optimizer, as the JAX CLI composes it: the config's, or
    ``--optimizer``'s factory on its warmup+cosine schedule; the decay
    mask of ``--wd-exclude-1d``; the ``--clip-norm`` clip (over the
    group under ZeRO-1, whose optimizer sees gradient chunks); then, on
    the outside, ``--grad-accum``, whose inner optimizer's schedule is
    sized to the updates it makes, ``max(1, steps // N)``."""
    build = cfg.build_optimizer
    if args.optimizer:
        factory, lr = OPTIMIZERS[args.optimizer], args.lr

        def build(steps, **kw):
            return factory(warmup_cosine_schedule(
                lr, min(100, max(1, steps // 10)), max(steps, 200)), **kw)
    kw = {"mask": matrix_decay_mask} if args.wd_exclude_1d else {}
    accum = args.grad_accum or 1
    opt = build(max(1, args.steps // accum), **kw)
    if args.clip_norm is not None:
        import torch.distributed as dist
        opt = with_grad_clipping(
            opt, args.clip_norm,
            group=dist.group.WORLD if mode == "zero1" else None)
    return accumulate_gradients(opt, accum)


def start_process_group(args, group, device: torch.device) -> None:
    """``torch.distributed``'s default group for dp/zero1: over the
    coordinator's world, or a world of one without a coordinator. The
    backend follows the device, with no fallback."""
    import torch.distributed as dist

    from nezha_tpu_torch.dist import backend_for
    from nezha_tpu_torch.dist.launch import (init_torch_distributed,
                                             store_host)
    backend = backend_for(device)
    if group is not None:
        init_torch_distributed(group, backend, host=store_host(
            args.coordinator.rpartition(":")[0]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def check_rejoin_args(args) -> None:
    """``--on-failure rejoin``'s argv checks (the JAX CLI's), and the
    port's counterpart of its ``--no-jax-distributed`` rule: a
    ``torch.distributed`` group cannot take a restarted process, so a
    mode that would start one across processes (dp or zero1, unless the
    world is known to be one process) is refused."""
    if not args.rejoin_timeout > 0:   # also catches NaN
        raise SystemExit(f"--rejoin-timeout must be > 0, got "
                         f"{args.rejoin_timeout}")
    if not args.coordinator:
        raise SystemExit("--on-failure rejoin needs --coordinator "
                         "(failure detection is the coordinator's "
                         "heartbeat)")
    if not args.ckpt_dir:
        raise SystemExit("--on-failure rejoin needs --ckpt-dir: recovery "
                         "reloads the rescue checkpoint")
    if args.engine == "graph":
        # JAX's refusal: the reload pairs with the module engine's
        # replicated-state modes.
        mode = "single" if args.parallel == "config" else args.parallel
        raise SystemExit(f"--on-failure rejoin supports the "
                         f"replicated-state module-engine modes "
                         f"(single/dp/sp); got mode {mode!r}, engine "
                         f"{args.engine!r} — use --on-failure stop with a "
                         f"supervisor relaunch")
    mode = (CONFIG_MODES[args.config] if args.parallel == "config"
            else args.parallel)
    one_process = args.serve_coordinator and args.world_size == 1
    if mode in ("dp", "zero1") and not one_process:
        raise SystemExit(f"--on-failure rejoin cannot run mode {mode!r} "
                         f"across processes: its torch.distributed group "
                         f"cannot absorb a restarted process mid-run; pass "
                         f"--parallel single (each process trains alone, "
                         f"heartbeat-coordinated), or use --on-failure "
                         f"stop and relaunch the world (training resumes "
                         f"from --ckpt-dir)")


def graph_mesh(args, mode: str, batch_size: int, device: torch.device):
    """The one-process dp mesh of the graph engine's dp and zero1: ``--mesh
    dp=M`` (default ``dp=-1``: the visible cards on cuda, one CPU device
    on cpu) of the CPU repeated, the visible cards, or ``--shard-device``
    repeated. One device degrades to single-device with JAX's warning
    (-> None)."""
    from nezha_tpu_torch.parallel.mesh import make_mesh
    axes = parse_mesh(args.mesh) or {"dp": -1}
    if list(axes) != ["dp"]:
        raise SystemExit(f"graph-engine {mode} consumes mesh axis 'dp' "
                         f"only; got {list(axes)}")
    m, devices = axes["dp"], None
    if args.shard_device is not None:
        if m < 1:
            raise SystemExit("--shard-device repeats one device: give "
                             "--mesh dp=M")
        devices = [args.shard_device] * m
    elif m == -1:
        m = (torch.cuda.device_count() if device.type == "cuda" else 1)
    if m == 1:
        print(f"WARNING: --engine graph --parallel {mode} with 1 visible "
              f"device; running single-device", file=sys.stderr, flush=True)
        return None
    try:
        mesh = make_mesh({"dp": m}, devices, device.type)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    if batch_size % m:
        raise SystemExit(f"--batch-size {batch_size} is not divisible by "
                         f"mesh axis dp={m} (it is the GLOBAL batch; shards "
                         f"must be equal)")
    return mesh


def build_graph_step(args, cfg: Config, batch_size: int,
                     device: torch.device):
    """``--engine graph``: the config's IR program (JAX's
    ``graph/programs.py`` step for the config and mode) over state
    initialized from the config's module, as a
    :class:`~nezha_tpu_torch.graph.step.GraphTrainStep`; -> (mode, step).
    The mode is JAX's: ``single`` unless ``--parallel`` says dp or zero1
    (mlp_mnist only), which run on :func:`graph_mesh`."""
    from nezha_tpu_torch.graph import programs
    from nezha_tpu_torch.graph.step import GraphTrainStep

    mode = "single" if args.parallel == "config" else args.parallel
    if mode not in ("single", "dp", "zero1"):
        raise SystemExit(f"--engine graph supports --parallel dp (IR "
                         f"all_reduce) or zero1 (IR reduce_scatter + "
                         f"all_gather) or single-device, not {mode!r}")
    if mode == "zero1" and args.config != "mlp_mnist":
        raise SystemExit("graph-engine zero1 is authored for mlp_mnist "
                         "(graph/programs.py zero1_update_graph); other "
                         "configs run the module engine's zero1")
    if mode == "single" and args.mesh:
        raise SystemExit("--mesh needs --parallel dp/zero1 with the graph "
                         "engine (single-device IR does not partition)")
    if args.grad_allreduce != "fp32":
        raise SystemExit("--grad-allreduce int8 is the module engine's "
                         "dp/zero1 wire; the graph engine's all-reduce is "
                         "an IR op (fp32 only)")
    if args.sp_flash != "auto":
        raise SystemExit("--sp-flash tunes the sequence-parallel attention "
                         "kernels; it needs --parallel sp (module engine)")
    mesh = None
    if mode in ("dp", "zero1"):
        mesh = graph_mesh(args, mode, batch_size, device)
        if mesh is None:
            mode = "single"
    model, dims = cfg.model, None
    if args.config == "mlp_mnist":
        dims = MLP_DIMS
        shard = programs.onehot_shard_fn(dims[-1])
        if mode == "zero1":
            state = programs.init_graph_mlp_zero1_state(dims, mesh,
                                                        model=model)
            program = programs.make_mlp_graph_zero1_train_step(
                dims, batch_size, lr=GRAPH_LR, mesh=mesh)
        elif mode == "dp":
            state = programs.init_graph_mlp_state(dims, model)
            program = programs.make_mlp_graph_dp_train_step(
                dims, batch_size, lr=GRAPH_LR, mesh=mesh)
        else:
            state = programs.init_graph_mlp_state(dims, model)
            program = programs.make_mlp_graph_train_step(
                dims, batch_size, lr=GRAPH_LR, clip_norm=args.clip_norm)
    elif args.config in IMAGE_CONFIGS:
        if args.eval or args.eval_every:
            raise SystemExit("graph-engine ResNet runs training-mode batch "
                             "stats only (no running BN stats); drop "
                             "--eval/--eval-every")
        state = programs.init_graph_resnet_state(model)
        shard = programs.image_shard_fn()
        if mode == "dp":
            program = programs.make_resnet_graph_dp_train_step(
                model, batch_size, lr=GRAPH_LR, mesh=mesh)
        else:
            program = programs.make_resnet_graph_train_step(
                model, lr=GRAPH_LR, clip_norm=args.clip_norm)
    else:
        sched = cfg.graph_opt["schedule"](args.steps)
        wd = cfg.graph_opt["weight_decay"]
        if args.config == "bert_base_zero1":
            state = programs.init_graph_bert_state(model)
            program = programs.make_bert_graph_train_step(
                model, sched, weight_decay=wd, clip_norm=args.clip_norm,
                mesh=mesh)
            shard = programs.bert_shard_fn()
        else:   # gpt2_124m: the transformer authored in the IR
            state = programs.init_graph_gpt2_state(model)
            program = programs.make_gpt2_graph_train_step(
                model, sched, weight_decay=wd, clip_norm=args.clip_norm,
                mesh=mesh, compute_dtype="bfloat16" if args.graph_bf16
                else "float32")
            shard = programs.lm_shard_fn()
    return mode, GraphTrainStep(program, state, shard, mesh, dims)


def run(args: argparse.Namespace) -> Dict[str, float]:
    """Run the parsed flags. A ``NEZHA_FAULT_PLAN`` arms the fault points
    for the run (the plan before it is restored on exit); with
    ``--run-dir`` the run goes on inside a telemetry run scope whose
    ``summary.json`` is written on every exit path."""
    from nezha_tpu_torch import faults
    prev_plan = faults.active()
    faults.install_from_env()
    try:
        if not args.run_dir:
            return _run_world(args)
        run_dir = args.run_dir
        if args.coordinator:
            # Each process captures into its own subdirectory (a sink
            # truncates its streams on open). The rank is given only at
            # the rendezvous, inside the scope: name it by the hint, else
            # the pid.
            run_dir = os.path.join(
                run_dir, f"rank{args.rank_hint}" if args.rank_hint >= 0
                else f"pid{os.getpid()}")
        obs.start_run(run_dir, meta={
            "config": args.config, "steps": args.steps,
            "engine": "graph" if args.engine == "graph" else "eager",
            "parallel": args.parallel, "model_preset": args.model_preset})
        try:
            return _run_world(args)
        finally:
            obs.end_run()
    finally:
        faults.install(prev_plan)


def _run_world(args: argparse.Namespace) -> Dict[str, float]:
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu to train on "
                         "the CPU")
    if args.parallel in ("gspmd", "pp", "sp") and args.coordinator:
        # Before the rendezvous, which would wait for peers.
        raise NotPortedError(f"--parallel {args.parallel} across processes "
                             f"is not ported (ROADMAP A7): the port's "
                             f"{args.parallel} is one process over its mesh")
    if (args.engine == "graph" and args.parallel in ("dp", "zero1")
            and args.coordinator):
        raise NotPortedError(f"--engine graph --parallel {args.parallel} "
                             f"across processes is not ported (ROADMAP "
                             f"A7): the port's graph {args.parallel} is one "
                             f"process over its mesh")
    if args.on_failure == "rejoin":
        check_rejoin_args(args)   # before the rendezvous can strand peers
    group, coord = join_world(args)
    # Rank 0 logs, as it prints.
    metrics_log = (MetricsLogger(args.metrics_file) if args.metrics_file
                   and (group is None or group.rank == 0) else None)
    try:
        return _run(args, group, metrics_log)
    finally:
        if metrics_log is not None:
            metrics_log.close()
        if group is not None:
            if sys.exc_info()[0] is None:
                try:
                    group.barrier(timeout_s=600)  # every rank finishes
                except Exception as e:
                    print(f"shutdown barrier skipped: {e}", file=sys.stderr)
            # Unwinding: leave at once, so peers see a clean departure.
            group.leave()
        if coord is not None:
            coord.stop()
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args: argparse.Namespace, group,
         metrics_log: Optional[MetricsLogger] = None) -> Dict[str, float]:
    world = group.world_size if group is not None else 1
    rank = group.rank if group is not None else 0
    device = torch.device(args.device)
    if device.type == "cuda":
        if device.index is None:   # one device a process: rank r's
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    cfg = build_config(args.config, args.model_preset, steps=args.steps,
                       seed=args.seed, device=device,
                       seq_len=args.seq_len, dropout=args.dropout,
                       ln_impl=args.ln_impl,
                       # ring/ulysses are the sp step's (its model shares
                       # this one's weights); the plain model evaluates.
                       attn_impl=(None if args.attn_impl in SP_ATTN_IMPLS
                                  else args.attn_impl),
                       moe_experts=args.moe_experts, remat=args.remat,
                       scan_layers=args.scan_layers)
    batch_size = args.batch_size or cfg.default_batch
    graph_step = None
    if args.engine == "graph":
        mode, graph_step = build_graph_step(args, cfg, batch_size, device)
    else:
        mode = resolve_mode(args, cfg, world)
    if args.scan_layers and mode in ("gspmd", "sp"):
        raise NotPortedError(f"--scan-layers under --parallel {mode} is not "
                             f"ported (ROADMAP A7): the port's {mode} step "
                             f"addresses the unrolled layers")
    if args.on_failure == "rejoin" and mode not in ("single", "dp"):
        # The reload goes through Trainer.initialize, which pairs with
        # the replicated-state modes; ZeRO-1's per-rank chunks recover by
        # a relaunch of the world.
        raise SystemExit(f"--on-failure rejoin supports the "
                         f"replicated-state modes (single/dp); got mode "
                         f"{mode!r} -- use --on-failure stop with a "
                         f"relaunch")
    # The module engine's dp and zero1 run a torch.distributed group; the
    # graph engine's run on its one-process mesh.
    parallel = mode in ("dp", "zero1") and graph_step is None
    if parallel:
        start_process_group(args, group, device)
    optimizer = (build_optimizer(args, cfg, mode) if graph_step is None
                 else None)
    loss_fn = cfg.loss_fn
    if args.label_smoothing:
        eps = args.label_smoothing

        def loss_fn(logits, batch):
            return softmax_cross_entropy_with_integer_labels(
                logits, batch["label"], label_smoothing=eps)
    # Single mode: each process trains alone on the whole batch.
    data_rank, data_world = (rank, world) if parallel else (0, 1)
    if batch_size % data_world:
        raise SystemExit(f"--batch-size {batch_size} must be divisible by "
                         f"the process world size {data_world} (it is the "
                         f"GLOBAL batch; each rank loads batch/world local "
                         f"rows)")

    # Rank 0 logs a parallel run; in single mode each process trains
    # alone and logs its own run.
    lead = rank == 0 or not parallel

    def log(step: int, metrics: Dict[str, float]) -> None:
        if not lead:
            return
        if args.log_memory:
            metrics = {**metrics, **memory_metrics(device)}
        print(json.dumps(metrics), file=sys.stderr, flush=True)
        if metrics_log is not None:
            metrics_log.log(step, metrics)

    step_fn = tp = pp = None
    if mode in ("gspmd", "pp", "sp"):
        step_fn = build_sharded_step(args, cfg, optimizer, loss_fn, mode,
                                     batch_size)
        tp = step_fn if mode == "gspmd" else None
        pp = step_fn if mode == "pp" else None
        extra = ({"microbatches": args.microbatches} if pp else
                 {"attn_impl": step_fn.model.cfg.attn_impl,
                  "sp_flash": args.sp_flash} if mode == "sp" else {})
        log(0, {"parallel": {"mode": mode, "mesh": step_fn.mesh.shape,
                             "devices": [str(d) for d in
                                         step_fn.mesh.devices],
                             **extra,
                             "opt_state_bytes": step_fn.opt_state_bytes()}})
    if parallel:
        from nezha_tpu_torch.parallel.data_parallel import (DPTrainStep,
                                                            replicate)
        from nezha_tpu_torch.parallel.zero1 import Zero1TrainStep
        replicate(cfg.model)
        build = Zero1TrainStep if mode == "zero1" else DPTrainStep
        step_fn = build(cfg.model, optimizer, loss_fn,
                        grad_reduce=args.grad_allreduce)
        import torch.distributed as dist
        log(0, {"parallel": {"mode": mode, "world": world,
                             "backend": dist.get_backend(),
                             "grad_allreduce": args.grad_allreduce,
                             "opt_state_bytes": step_fn.opt_state_bytes()}})
    if graph_step is not None:
        step_fn = graph_step
    tracer = None
    if args.profile_steps:
        start, count = parse_profile_steps(args.profile_steps)
        tracer = Tracer(args.profile_dir, start_step=start, num_steps=count)
    trainer = Trainer(cfg.model, optimizer, loss_fn, rng=prng_key(args.seed),
                      checkpoint_dir=args.ckpt_dir,
                      checkpoint_every=args.ckpt_every,
                      checkpoint_keep=args.ckpt_keep,
                      log_every=args.log_every, metric_logger=log,
                      examples_per_step=batch_size, step_fn=step_fn,
                      process_group=group,
                      failure_check_every=args.failure_check_every
                      if group is not None else 0,
                      failure_mode=args.on_failure,
                      rejoin_timeout_s=args.rejoin_timeout, tracer=tracer)
    start_step = trainer.initialize()
    if trainer.last_restore is not None:
        if lead:
            print(f"resumed from step {start_step}"
                  + (" (sharded)" if trainer.sharded else ""),
                  file=sys.stderr, flush=True)
        log(start_step, {"restore": trainer.last_restore})
    last: Dict[str, float] = {}
    with contextlib.ExitStack() as stack:
        # Closed in reverse: the trace, then the prefetcher, then the
        # source under it.
        source, close_source = data_source(args, cfg, batch_size, data_rank,
                                           data_world)
        if close_source is not None:
            stack.callback(close_source)
        # A resumed run goes on where the stream stood at its step (the
        # JAX CLI starts the stream over), so a cut run trains on the
        # batches an unbroken one would; the skipped batches are drawn
        # from the source, before the prefetcher, and never reach the
        # device.
        for _ in range(start_step):
            next(source)
        # The graph engine transforms each batch on the host first.
        batches = Prefetcher(source, depth=args.prefetch,
                             device=device if graph_step is None else "cpu")
        stack.callback(batches.close)
        if tracer is not None:
            stack.callback(tracer.stop)  # a window still open at the end
        elif args.profile_dir:
            stack.enter_context(profile_trace(args.profile_dir))
        if args.eval_every:
            # Train in chunks that end on global-step multiples of
            # --eval-every (so a resumed run's eval points are the
            # unbroken run's), an eval pass between them; the final pass
            # follows the last chunk.
            done = 0
            while done < args.steps:
                n = min(args.eval_every
                        - trainer.global_step % args.eval_every,
                        args.steps - done)
                last = trainer.fit(batches, n)
                done += n
                if done < args.steps:
                    results = run_eval(args, cfg, batch_size, data_rank,
                                       data_world, tp, pp, graph_step)
                    if results is not None:
                        log(trainer.global_step, {
                            "step": trainer.global_step,
                            **{f"eval_{k}": v for k, v in results.items()}})
        else:
            last = trainer.fit(batches, args.steps)
    if not math.isfinite(last.get("loss", math.nan)):
        raise SystemExit(f"training diverged: {last}")
    if args.ckpt_dir and not (trainer.saves and trainer.saves[-1]["step"]
                              == start_step + args.steps):
        # The final save (the JAX CLI's), unless --ckpt-every just wrote it.
        trainer.save(start_step + args.steps)
    trainer.wait_saves()
    for record in trainer.saves:
        log(record["step"], {"save": record})
    for record in trainer.rejoins:
        log(record["step"], {"rejoin": record})
    if args.eval or args.eval_every:
        results = run_eval(args, cfg, batch_size, data_rank, data_world,
                           tp, pp, graph_step)
        if results is not None:
            if lead:
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
