"""Serve GPT-2 over stdin JSONL or HTTP — the port's counterpart of
``nezha-serve``'s single-replica front ends.

    python -m nezha_tpu_torch.cli.serve --random-init --model-preset full
    python -m nezha_tpu_torch.cli.serve --ckpt-dir C --tokenizer D
    python -m nezha_tpu_torch.cli.serve --random-init --http 8000
    python -m nezha_tpu_torch.cli.serve --random-init --replicas 2 --http 0

Weights come from ``--ckpt-dir`` (the newest checkpoint of either
package's train CLI that verifies: a dense npz, else a per-shard
``step_*.sharded``), from a Hugging Face ``GPT2LMHeadModel`` directory
(``--hf-dir``, fp32; its tokenizer files the default ``--tokenizer``) or
are seeded random (``--random-init``).
Each stdin line is one request object, with ``prompt_tokens`` or a text
``prompt`` (encoded with ``--tokenizer``, else byte-level)::

    {"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 8,
     "temperature": 0.8, "top_k": 40, "top_p": 0.9, "seed": 1,
     "eos_id": 50256, "deadline_s": 30, "priority": "batch",
     "tenant_id": "acme"}
    {"id": "b", "prompt": "def main(", "max_new_tokens": 8}

and each request gets one stdout line when it finishes, its tokens
decoded into ``text`` the same way::

    {"id": "a", "event": "done", "tokens": [...], "text": "...",
     "finish_reason": "length", "ttft_s": ..., "latency_s": ...}

``eos_id`` defaults to ``--eos-id``, else the tokenizer's EOS.

``priority`` (``interactive``, the default, ``batch`` or
``background``) picks the request's admission lane (``--priority-weights``
sets the lanes' shares) and ``tenant_id`` (default ``default``) the
tenant it counts against; past ``--tenant-queue-cap`` queued requests of
one tenant, a request gets ``{"id": ..., "event": "error", "error": ...,
"error_type": "tenant_over_limit"}``. ``--preemption on`` lets a
higher-priority arrival suspend a lower-priority decode, which resumes
later where it stood.

``--kv-layout dense`` keeps one worst-case reservation a slot instead of
the block pool. ``--speculative`` decodes through a draft: the target's
first ``--draft-layers`` blocks (default: all of them), or a draft from
``--draft-ckpt-dir`` / ``--draft-hf-dir``, proposing ``--draft-k`` tokens
a verify window.

A malformed line gets ``{"id": ..., "event": "error", "error": ...}``.
The server exits once stdin closes and every request has finished.

``--http PORT`` serves HTTP on 127.0.0.1 instead (stdlib
``http.server``): ``POST /generate`` takes the same request object and
answers once it finishes (503 ``queue_full`` or ``tenant_over_limit``
under backpressure, 409 for an id already in flight), ``GET /healthz``
reports liveness, occupancy, parks, the host tier and the fleet digest
of the pool's cached prefixes (``--digest-interval``,
``--digest-max-entries``). ``GET /stats`` answers the live registry
snapshot (stats schema v1), ``/windows`` the rolling window views and
``/metrics`` their Prometheus text. ``--run-dir D`` writes the run's
``metrics.jsonl``, ``spans.jsonl``, ``events.jsonl`` and ``summary.json``
into D; ``--trace-sample`` is the share of requests that carry a trace
id; ``--slo SPEC`` and ``--watchdog-interval`` run the anomaly watchdog,
and the first ``serve.ttft_s`` SLO also drives preemption. A
``NEZHA_FAULT_PLAN`` in the environment installs a seeded fault plan.

KV migration: a request with ``"prefill_only": true`` is prefilled and
PARKED (it answers ``finish_reason`` ``"prefilled"``); another replica's
``POST /generate`` with ``"pull_from": {"port": P, "request_id": R}``
pulls its prompt blocks over ``/kv_export``, installs them, ACKs them
over ``/kv_ack`` and decodes (the answer carries a ``migration`` block;
a failed pull is 424 with its ``error_type``); ``{"resume": R}`` decodes
a park where it lies. ``"pull_from": {"port": P, "tokens": [...]}`` is a
peer pull of a cached prefix, which degrades to a cold prefill on
failure (``fleet_pull``). ``--role`` is the replica's tier as
``/healthz`` reports it. ``--kv-host-blocks N`` (int8 pools) keeps up
to N evicted prefix blocks in host memory and promotes them back for a
returning prompt. ``--prefill-impl xla`` prefills by the composed path
instead of the flash-prefill kernels.

SIGTERM or SIGINT starts a GRACEFUL DRAIN: admission closes (stdio
answers a line read afterwards with a ``"draining"`` error; HTTP answers
503 ``"draining"`` and ``/healthz`` turns 503), in-flight requests keep
decoding for up to ``--drain-timeout`` seconds, stragglers retire with
``finish_reason`` ``"deadline"``, and stdio ends with one
``{"event": "drain", "cancelled": N}`` line.

``--mesh M`` serves from a :class:`~nezha_tpu_torch.serve.ShardedEngine`
over M shards (the visible cards on ``cuda``; the CPU repeated on
``cpu``; ``--shard-device D`` puts every shard on D, e.g. M shards on
one card). With ``--ckpt-dir`` the training checkpoint is streamed onto
the mesh one leaf at a time (``reshard_checkpoint``: CRC-checked, never
gathered whole on one device); a corrupt or missing leaf is a refusal
to start. ``--prefill-mode sequence`` (with ``--mesh M``, M > 1) also
shards each prefill chunk's attention over the sequence, in the
``--seq-prefill-variant`` layout; ``--long-prefill-buckets`` adds chunk
widths above ``--max-prefill-len``. Under ``--mesh`` everything else runs
as on one device: ``--speculative`` (a self-draft shares the target's
shards; a ``--draft-ckpt-dir`` or ``--draft-hf-dir`` draft is split over
the same mesh), ``--kv-host-blocks`` (the host tier holds full-head
blocks gathered from the shards), ``--decode-impl``/``--prefill-impl
xla`` and the kernel switches (the composed attention on each shard),
and the block wire (``/kv_export`` gathers the shards' heads into the
one-device wire; an install scatters them).

FLEETS. ``--replicas N`` (N > 1, with ``--http``) turns this process into
a router and supervisor over N single-replica workers, each this same
stack on its own port: ``--replica-backend process`` (the default) spawns
``python -m nezha_tpu_torch.cli.serve`` processes with this command's
flags and ``--device``, ``thread`` hosts them in this process. With
process workers the front end builds no model and never touches the
card. ``--prefill-replicas P
--decode-replicas D`` serves disaggregated: requests prefill and park on
the prefill tier, and a decode replica pulls the blocks, installs them
and decodes. Unhealthy replicas are ejected after ``--probe-misses``
missed probes, crashed ones restarted with seeded capped backoff (a
circuit breaker after ``--max-restart-failures``), a request whose
replica died before answering is re-sent up to ``--route-retries`` times,
``--affinity-routing`` routes prompts to the replica caching their
prefix, and SIGTERM drains the replicas one at a time.
``--autoscale-min``/``--autoscale-max`` grow and shrink the fleet under
load.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import signal
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.cli.common import (add_model_args, gpt2_for_preset,
                                        load_gpt2_for_inference,
                                        load_tokenizer_arg, resolve_eos_id)
from nezha_tpu_torch.data.tokenizer import encode_plain
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.parallel.mesh import make_mesh
from nezha_tpu_torch.serve import (Engine, FinishReason, QueueFull, Request,
                                   Scheduler, ServeConfig, ShardedEngine,
                                   SpeculativeConfig, TenantOverLimit,
                                   migrate)
from nezha_tpu_torch.serve.sharded import ReshardError, reshard_checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nezha_tpu_torch.cli.serve",
                                description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--max-batch-size", type=int, default=4)
    p.add_argument("--max-len", type=int, default=96,
                   help="per-slot KV capacity (prompt + generated)")
    p.add_argument("--max-prefill-len", type=int, default=32,
                   help="widest single prefill chunk; longer prompts (up "
                        "to --max-len) prefill in successive chunks")
    p.add_argument("--prefill-buckets", default=None,
                   help="comma-separated prompt pad widths (the last must "
                        "equal --max-prefill-len); default: powers of two "
                        "up to --max-prefill-len")
    p.add_argument("--decode-impl", choices=["auto", "kernel", "xla"],
                   default=None,
                   help="decode attention: auto/kernel = the flash-decode "
                        "kernels, xla = the composed masked path; default: "
                        "the model config's choice (auto)")
    p.add_argument("--prefill-impl", choices=["auto", "kernel", "xla"],
                   default=None,
                   help="paged prefill attention: auto/kernel = the "
                        "flash-prefill kernels (int8 pools fuse the block "
                        "write into the kernel), xla = the composed masked "
                        "path with the write by tensor ops; default: the "
                        "model config's choice (auto)")
    p.add_argument("--long-prefill-buckets", default="",
                   help="comma-separated chunk widths above "
                        "--max-prefill-len (at most --max-len)")
    p.add_argument("--mesh", type=int, default=1,
                   help="tensor-parallel shards (>1: the sharded engine)")
    p.add_argument("--shard-device", default=None,
                   help="with --mesh: every shard on this device (M "
                        "shards on one card run one after another); "
                        "default: one visible card a shard on cuda, the "
                        "CPU on cpu")
    p.add_argument("--prefill-mode", choices=["replicated", "sequence"],
                   default="replicated",
                   help="sequence: shard each prefill chunk's attention "
                        "over the mesh too (needs --mesh M > 1)")
    p.add_argument("--seq-prefill-variant",
                   choices=["auto", "ulysses", "ring"], default="auto",
                   help="the sequence-sharded layout (auto: ulysses)")
    p.add_argument("--decode-horizon", type=int, default=1)
    p.add_argument("--kv-layout", choices=["paged", "dense"],
                   default="paged",
                   help="KV pool layout: paged = block-paged pool with "
                        "ref-counted blocks, lazy binding, and shared-"
                        "prefix prefill reuse (default); dense = the "
                        "classic worst-case per-slot reservation")
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--kv-num-blocks", type=int, default=None)
    p.add_argument("--prefix-cache", choices=["on", "off"], default="on")
    p.add_argument("--kv-eviction", choices=["lru", "none"], default="lru")
    p.add_argument("--kv-host-blocks", type=int, default=0,
                   help="host KV spill tier (requires --kv-dtype int8 "
                        "+ --kv-eviction lru): evicted prefix-cache "
                        "blocks demote their int8+scales payload into "
                        "a host-RAM LRU of up to N blocks instead of "
                        "being discarded, and a returning prefix hit "
                        "promotes them back with an async host-to-"
                        "device copy ahead of the prefill — turn-N+1 "
                        "chat traffic pays one tail chunk, not a cold "
                        "prefill; /healthz reports the tier's "
                        "occupancy. 0 = off")
    p.add_argument("--cache-dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--kv-dtype", choices=["bf16", "int8"], default="bf16",
                   help="KV block storage: bf16 keeps --cache-dtype; int8 "
                        "stores int8 blocks with one fp32 scale per "
                        "(block, head), about 2x the resident blocks")
    p.add_argument("--speculative", action="store_true",
                   help="speculative decoding: a cheap DRAFT model "
                        "proposes --draft-k tokens per window, one "
                        "batched target forward verifies them all, and "
                        "the longest agreeing prefix is emitted (greedy "
                        "outputs unchanged; sampled by lossless rejection "
                        "sampling)")
    p.add_argument("--draft-k", type=int, default=4,
                   help="speculative: draft tokens proposed per verify "
                        "window (a window emits 1..draft_k+1 tokens)")
    p.add_argument("--draft-layers", type=int, default=None,
                   help="speculative: SELF-DRAFT depth — the draft is "
                        "the target's first N layers sharing its "
                        "weights; default: full depth (identity draft, "
                        "accept-rate ~1). Ignored with "
                        "--draft-ckpt-dir/--draft-hf-dir")
    p.add_argument("--draft-ckpt-dir", default=None,
                   help="speculative: load a SEPARATE draft model from "
                        "this train checkpoint dir (same tokenizer/vocab "
                        "as the target)")
    p.add_argument("--draft-hf-dir", default=None,
                   help="speculative: load the draft model from a "
                        "Hugging Face GPT2LMHeadModel directory")
    p.add_argument("--k-max", type=int, default=64)
    p.add_argument("--queue-capacity", type=int, default=16)
    p.add_argument("--priority-weights", default=None, metavar="SPEC",
                   help="WFQ admission-grant weights per priority lane "
                        "as 'interactive=4,batch=2,background=1' (the "
                        "default split): per 7 grants under full "
                        "backlog, 4 go interactive, 2 batch, 1 "
                        "background — lower lanes slow, never starve. "
                        "All three classes required, integer weights "
                        ">= 1")
    p.add_argument("--tenant-queue-cap", type=int, default=None,
                   help="max queued requests any ONE tenant may hold; "
                        "past it the tenant gets a typed "
                        "tenant_over_limit error while others keep "
                        "admitting (default: no per-tenant cap — only "
                        "the global --queue-capacity)")
    p.add_argument("--preemption", choices=["on", "off"], default="off",
                   help="under slot/block pressure, SUSPEND the lowest-"
                        "priority running decode — its KV blocks move "
                        "to the prefix trie (LRU-evictable) — and resume "
                        "it when pressure clears")
    p.add_argument("--preemption-budget", type=int, default=2,
                   help="times one request may be preempted before it "
                        "becomes unpreemptable (the anti-thrash bound)")
    p.add_argument("--max-new-tokens", type=int, default=32,
                   help="default and per-request cap")
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="graceful-drain budget in seconds after SIGTERM/"
                        "SIGINT: admission closes at the signal, "
                        "in-flight requests may finish within this "
                        "window, stragglers retire with finish_reason "
                        "'deadline'")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve HTTP on PORT instead of stdio JSONL")
    p.add_argument("--role", choices=["prefill", "decode", "both"],
                   default="both",
                   help="this replica's serving tier (surfaced in "
                        "/healthz): 'prefill' members take admissions and "
                        "park prompt KV for migration, 'decode' members "
                        "pull migrated KV and stream tokens, 'both' "
                        "(default) does everything — the role is routing "
                        "metadata; every replica keeps the full engine")
    p.add_argument("--replicas", type=int, default=1,
                   help="N > 1 turns this process into a router/"
                        "supervisor front end over N engine workers "
                        "(requires --http; each worker is the single-"
                        "replica stack on its own port)")
    p.add_argument("--prefill-replicas", type=int, default=0,
                   help="with --decode-replicas: a DISAGGREGATED front "
                        "end of this many role=prefill workers plus the "
                        "decode tier (overrides --replicas; requires "
                        "--http)")
    p.add_argument("--decode-replicas", type=int, default=0,
                   help="role=decode workers of the disaggregated front "
                        "end (see --prefill-replicas)")
    p.add_argument("--replica-backend", choices=["process", "thread"],
                   default="process",
                   help="process: spawn worker processes (an OS failure "
                        "domain each); thread: host them in this process "
                        "(no spawn cost, no isolation)")
    p.add_argument("--probe-interval", type=float, default=0.5,
                   help="seconds between per-replica /healthz probes")
    p.add_argument("--probe-misses", type=int, default=3,
                   help="consecutive missed probes that eject a replica "
                        "from routing (one success readmits it)")
    p.add_argument("--route-retries", type=int, default=2,
                   help="times one request may be re-dispatched after its "
                        "replica died before answering (seeded backoff); "
                        "a begun response is never retried")
    p.add_argument("--restart-backoff", type=float, default=0.25,
                   help="base seconds of the capped exponential restart "
                        "backoff for crashed replicas")
    p.add_argument("--max-restart-failures", type=int, default=5,
                   help="consecutive startup failures after which a "
                        "replica's circuit breaker opens")
    p.add_argument("--affinity-routing", choices=["on", "off"],
                   default=None,
                   help="route token-id requests by prefix affinity from "
                        "the replicas' /healthz digests, with a peer "
                        "pull_from hint on a near miss (default: on when "
                        "the fleet has more than one replica)")
    p.add_argument("--digest-interval", type=float, default=2.0,
                   help="seconds between fleet-digest rebuilds on a "
                        "replica")
    p.add_argument("--digest-max-entries", type=int, default=256,
                   help="prefix-hash entries one replica advertises per "
                        "digest (recency first)")
    p.add_argument("--autoscale-min", type=int, default=None,
                   help="with --autoscale-max: the elastic lower bound on "
                        "the replica count (idle fleets drain down to "
                        "it, one replica at a time)")
    p.add_argument("--autoscale-max", type=int, default=None,
                   help="with --autoscale-min: the elastic upper bound "
                        "(sustained queue or prefill-wait pressure "
                        "spawns one replica at a time up to it)")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="share of requests that carry a trace id (their "
                        "lifecycle spans land in --run-dir)")
    p.add_argument("--run-dir", default=None,
                   help="write telemetry (metrics.jsonl, spans.jsonl, "
                        "events.jsonl, summary.json) here")
    p.add_argument("--slo", action="append", default=None, metavar="SPEC",
                   help="an SLO evaluated per window, e.g. "
                        "'serve.ttft_s p99 < 0.5 over 60s [objective "
                        "0.99]' (repeatable or ';'-separated); implies "
                        "the watchdog")
    p.add_argument("--watchdog-interval", type=float, default=0.0,
                   metavar="SECONDS",
                   help="run the anomaly watchdog every SECONDS, events "
                        "into events.jsonl; 0 disables (--slo implies "
                        "10 s)")
    return p


def _int_list(flag: str, value) -> tuple:
    try:
        return tuple(int(b) for b in str(value or "").split(",")
                     if b.strip())
    except ValueError:
        raise SystemExit(f"{flag} must be comma-separated ints, got "
                         f"{value!r}")


def _parse_priority_weights(spec):
    """'interactive=4,batch=2,background=1' -> dict (None passes through:
    ServeConfig then applies the default split)."""
    if spec is None:
        return None
    out = {}
    for part in str(spec).split(","):
        name, eq, val = part.partition("=")
        try:
            out[name.strip()] = int(val)
        except ValueError:
            raise SystemExit(f"--priority-weights must be 'class=int,...' "
                             f"pairs, got {part!r}")
        if not eq:
            raise SystemExit(f"--priority-weights must be 'class=int,...' "
                             f"pairs, got {part!r}")
    return out


def _draft_model(args):
    """``--speculative``'s explicit draft from ``--draft-ckpt-dir`` or
    ``--draft-hf-dir`` (None: the engine builds a self-draft), loaded as
    the target is."""
    if not (args.draft_ckpt_dir or args.draft_hf_dir):
        return None
    dargs = argparse.Namespace(**vars(args))
    dargs.ckpt_dir = args.draft_ckpt_dir
    dargs.hf_dir = args.draft_hf_dir
    dargs.random_init = False
    return load_gpt2_for_inference(dargs)


def build_scheduler(args) -> Scheduler:
    buckets = _int_list("--prefill-buckets", args.prefill_buckets)
    long_buckets = _int_list("--long-prefill-buckets",
                             args.long_prefill_buckets)
    if not args.speculative and (args.draft_ckpt_dir or args.draft_hf_dir):
        # A draft checkpoint without the knob would silently serve classic.
        raise SystemExit("--draft-ckpt-dir/--draft-hf-dir require "
                         "--speculative")
    if args.prefill_mode == "sequence" and args.mesh < 2:
        # Refused before any model is built: a 1-shard mesh has no
        # sequence axis to shard over.
        raise SystemExit("--prefill-mode sequence requires --mesh M with "
                         "M > 1 (the chunk is sharded over the mesh's "
                         "sequence axis)")
    devices = ([args.shard_device] * args.mesh if args.shard_device
               else None)
    mesh = None
    if args.mesh > 1:
        # Refused before the model is built on a card that may not exist.
        try:
            mesh = make_mesh({"tp": args.mesh}, devices,
                             torch.device(args.device).type)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: too few CUDA cards: {e}")
    shards = None
    if mesh is not None and args.ckpt_dir:
        shards, model = reshard_onto(args, mesh)
    else:
        model = load_gpt2_for_inference(args)
    spec = draft = None
    if args.speculative:
        spec = SpeculativeConfig(draft_k=args.draft_k,
                                 draft_layers=args.draft_layers)
        draft = _draft_model(args)
    try:
        cfg = ServeConfig(
            max_batch_size=args.max_batch_size,
            max_len=min(args.max_len, model.cfg.max_positions),
            max_prefill_len=args.max_prefill_len,
            prefill_buckets=buckets,
            long_prefill_buckets=long_buckets,
            prefill_mode=args.prefill_mode,
            seq_prefill_variant=args.seq_prefill_variant,
            decode_horizon=args.decode_horizon,
            decode_impl=args.decode_impl,
            prefill_impl=args.prefill_impl,
            kv_layout=args.kv_layout,
            kv_block_size=args.kv_block_size,
            kv_num_blocks=args.kv_num_blocks,
            prefix_cache=args.prefix_cache == "on",
            kv_eviction=args.kv_eviction,
            kv_host_blocks=args.kv_host_blocks,
            cache_dtype=(torch.float32 if args.cache_dtype == "f32"
                         else torch.bfloat16),
            kv_dtype=args.kv_dtype,
            k_max=args.k_max, queue_capacity=args.queue_capacity,
            speculative=spec,
            priority_weights=_parse_priority_weights(args.priority_weights),
            tenant_queue_cap=args.tenant_queue_cap,
            preemption=args.preemption == "on",
            preemption_budget=args.preemption_budget)
    except ValueError as e:
        raise SystemExit(f"serve config: {e}")
    if args.mesh > 1:
        try:
            engine = ShardedEngine(model, cfg, mesh_devices=args.mesh,
                                   devices=mesh.devices, shards=shards,
                                   draft_model=draft)
        except ValueError as e:
            # Topology constraints (heads % mesh, bucket divisibility,
            # too few cards, the dense layout) and the draft's checks as
            # the CLI's typed refusal.
            raise SystemExit(f"--mesh {args.mesh}: {e}")
    else:
        try:
            engine = Engine(model, cfg, draft_model=draft)
        except ValueError as e:
            # The draft's checks (vocabulary, positions, depth).
            raise SystemExit(f"--speculative: {e}")
    scheduler = Scheduler(engine)
    # The first serve.ttft_s SLO also widens the preemption quota while
    # its error budget burns (the watchdog keeps trackers of its own).
    for slo_cfg in _parse_slos(args):
        if slo_cfg.metric == "serve.ttft_s":
            scheduler.slo_tracker = obs.SLOTracker(slo_cfg)
            break
    return scheduler


def _parse_slos(args) -> list:
    try:
        return obs.parse_slo_args(getattr(args, "slo", None))
    except ValueError as e:
        raise SystemExit(f"--slo: {e}")


def _build_stack(args):
    """-> (scheduler, tokenizer, eos_id) for one replica."""
    try:
        scheduler = build_scheduler(args)
    except NotPortedError as e:
        raise SystemExit(f"nezha_tpu_torch.cli.serve: {e}")
    tokenizer = load_tokenizer_arg(args)
    eos_id = resolve_eos_id(args.eos_id, tokenizer, scheduler.engine.vocab)
    return scheduler, tokenizer, eos_id


def reshard_onto(args, mesh):
    """``--mesh M --ckpt-dir``: the preset's model (its structure) and
    the checkpoint streamed onto ``mesh``; the topology is checked before
    the load, and a reshard fault exits typed."""
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    m = mesh.size
    model = gpt2_for_preset(args.model_preset, seed=args.seed,
                            device=args.device)
    if model.cfg.num_heads % m:
        raise SystemExit(f"--mesh {m}: num_heads={model.cfg.num_heads} "
                         f"not divisible by the mesh -- K/V pools shard "
                         f"on the head axis")
    try:
        shards, step = reshard_checkpoint(args.ckpt_dir, model, mesh)
    except ReshardError as e:
        raise SystemExit(f"--mesh {m}: reshard refused: {e}")
    print(f"resharded step {step} from {args.ckpt_dir} onto a 1x{m} "
          f"serve mesh", file=sys.stderr, flush=True)
    return shards, model


def parse_request(obj, args, vocab: int, tokenizer=None,
                  eos_id=None) -> Request:
    """One wire object -> Request. Raises ValueError on bad input."""
    if not isinstance(obj, dict):
        raise ValueError("request must be a JSON object")
    if ("prompt_tokens" in obj) == ("prompt" in obj):
        raise ValueError("pass exactly one of prompt_tokens / prompt")
    if "prompt_tokens" in obj:
        prompt = [int(t) for t in obj["prompt_tokens"]]
    else:
        text = obj["prompt"]
        if not isinstance(text, str) or not text:
            raise ValueError("prompt must be a non-empty string")
        prompt = (encode_plain(tokenizer, text) if tokenizer is not None
                  else list(text.encode("utf-8")))
    if not prompt:
        raise ValueError("prompt encoded to zero tokens")
    if max(prompt) >= vocab or min(prompt) < 0:
        raise ValueError(f"prompt ids must be in [0, {vocab})")

    def num(key, cast, default=None):
        v = obj.get(key, default)
        if v is None:
            return None
        try:
            return cast(v)
        except (TypeError, ValueError):
            raise ValueError(f"{key} must be a number, got {v!r}")

    trace_id = obj.get("trace_id")
    if trace_id is not None and not isinstance(trace_id, str):
        raise ValueError(f"trace_id must be a string, got {trace_id!r}")
    priority = obj.get("priority", "interactive")
    if not isinstance(priority, str):
        raise ValueError(f"priority must be a string, got {priority!r}")
    tenant_id = obj.get("tenant_id", "default")
    if not isinstance(tenant_id, str):
        raise ValueError(f"tenant_id must be a string, got {tenant_id!r}")
    return Request(
        priority=priority, tenant_id=tenant_id,
        prompt=prompt,
        max_new_tokens=min(num("max_new_tokens", int, args.max_new_tokens),
                           args.max_new_tokens),
        temperature=num("temperature", float, 0.0),
        top_k=num("top_k", int), top_p=num("top_p", float),
        eos_id=num("eos_id", int, eos_id),
        seed=num("seed", int, args.seed),
        deadline_s=num("deadline_s", float),
        request_id=obj.get("id"),
        # Prefill and PARK for a migration instead of decoding here.
        prefill_only=bool(obj.get("prefill_only", False)),
        # "" is the router's sampled-out verdict; None lets the
        # scheduler mint.
        trace_id=trace_id)


def decode_text(tokens, tokenizer) -> str:
    """Tokens -> text: the tokenizer's decode, else byte-level (ids
    past 255 skipped)."""
    if tokenizer is not None:
        return tokenizer.decode(tokens)
    return bytes(t for t in tokens if t < 256).decode("utf-8",
                                                       errors="replace")


def _result_obj(res, tokenizer) -> dict:
    out = {"id": res.request_id, "event": "done", "tokens": res.tokens,
           "text": decode_text(res.tokens, tokenizer),
           "finish_reason": res.finish_reason, "ttft_s": res.ttft_s,
           "latency_s": res.latency_s}
    if res.error is not None:     # finish_reason "error": what broke
        out["error"] = res.error
    return out


def _drain(scheduler: Scheduler, budget_s: float, drive: bool,
           dead: Optional[threading.Event] = None,
           abort: Optional[threading.Event] = None) -> int:
    """The graceful drain both front ends share: keep decoding
    (``drive=True`` steps the scheduler here; ``drive=False`` trusts a
    live decode thread, whose death is ``dead``, and stops early on the
    server's ``abort``) until in-flight work finishes or ``budget_s``
    runs out, then cancel the stragglers with finish_reason "deadline",
    or "error" when the decode loop died (nothing can finish after
    that). -> requests cancelled. The window is one ``serve.drain``
    span."""
    reason, error = FinishReason.DEADLINE, None
    with obs.span("serve.drain", budget_s=budget_s) as sp:
        t_end = time.monotonic() + budget_s
        while scheduler.has_work() and time.monotonic() < t_end:
            if dead is not None and dead.is_set():
                reason = FinishReason.ERROR
                error = "decode loop died during drain"
                break
            if abort is not None and abort.is_set():
                break
            if drive:
                if not scheduler.step():
                    time.sleep(0.002)
            else:
                time.sleep(0.005)
        cancelled = scheduler.cancel_remaining(reason, error=error)
        sp.set(cancelled=cancelled, reason=reason)
    return cancelled


def run_stdio(scheduler: Scheduler, args, stdin=None, stdout=None,
              tokenizer=None, drain: Optional[threading.Event] = None
              ) -> int:
    """A reader thread feeds the queue as lines arrive (waiting for room:
    stdin is the backpressure channel); this thread drives decoding.
    Setting ``drain`` (the signal handlers do) closes admission, finishes
    in-flight work within ``--drain-timeout`` and writes one final
    ``{"event": "drain", "cancelled": N}`` line."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    drain = drain if drain is not None else threading.Event()
    out_lock = threading.Lock()

    def emit(obj):
        with out_lock:
            stdout.write(json.dumps(obj) + "\n")
            stdout.flush()

    def on_finish(res):
        emit(_result_obj(res, tokenizer))
        scheduler.results.pop(res.request_id, None)

    scheduler.on_finish = on_finish
    vocab = scheduler.engine.vocab
    eos_id = resolve_eos_id(args.eos_id, tokenizer, vocab)
    done_reading = threading.Event()

    def reader():
        try:
            for line in stdin:
                if drain.is_set():
                    # Admission closed with this line read: answer it, so
                    # the client is not left waiting; lines never read
                    # stay unanswered (the final drain line says so).
                    if line.strip():
                        try:
                            obj = json.loads(line)
                            rid = (obj.get("id") if isinstance(obj, dict)
                                   else None)
                        except ValueError:
                            rid = None
                        emit({"id": rid, "event": "error",
                              "error": "draining"})
                    break
                line = line.strip()
                if not line:
                    continue
                obj = None
                try:
                    obj = json.loads(line)
                    req = parse_request(obj, args, vocab, tokenizer,
                                        eos_id)
                except ValueError as e:
                    rid = obj.get("id") if isinstance(obj, dict) else None
                    emit({"id": rid, "event": "error", "error": str(e)})
                    continue
                while True:
                    if drain.is_set():
                        emit({"id": req.request_id, "event": "error",
                              "error": "draining"})
                        break
                    if scheduler.queue_depth >= scheduler.queue_capacity:
                        time.sleep(0.005)
                        continue
                    try:
                        scheduler.submit(req)
                        break
                    except TenantOverLimit as e:
                        # Typed, as the reference's HTTP front end answers
                        # it: this tenant is over ITS cap, the queue is not
                        # full.
                        emit({"id": req.request_id, "event": "error",
                              "error": str(e),
                              "error_type": "tenant_over_limit"})
                        break
                    except QueueFull:
                        time.sleep(0.005)
                    except ValueError as e:
                        emit({"id": req.request_id, "event": "error",
                              "error": str(e)})
                        break
        finally:
            done_reading.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    while ((not done_reading.is_set() or scheduler.has_work())
           and not drain.is_set()):
        if not scheduler.step():
            time.sleep(0.002)
    if drain.is_set():
        cancelled = _drain(scheduler, args.drain_timeout, drive=True)
        emit({"id": None, "event": "drain", "cancelled": cancelled})
    else:
        t.join(timeout=5.0)
    return 0


def send_metrics(handler) -> None:
    """Answer ``GET /metrics`` on ``handler`` (a BaseHTTPRequestHandler):
    the registry's totals and window views as Prometheus text."""
    body = obs.render_prometheus(obs.stats_snapshot(),
                                 obs.windows_payload()).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def run_http(scheduler: Scheduler, args, port: int, tokenizer=None,
             ready_cb=None, drain: Optional[threading.Event] = None) -> int:
    """The stdlib HTTP front end on 127.0.0.1:``port`` (0: any free port;
    ``ready_cb(server)`` gets the bound server): ``POST /generate``
    (answers once the request retires), ``/kv_export`` and ``/kv_ack``
    (the migration wire, allowed while draining), ``GET /healthz``,
    ``/stats``, ``/windows`` and ``/metrics`` (answered while draining
    too).
    Handlers run on server threads (not daemons: a cancelled request's
    answer is written before the process exits); one thread drives
    decoding. Setting ``drain`` closes admission (POST -> 503
    "draining", /healthz -> 503), lets in-flight requests finish within
    ``--drain-timeout``, then shuts the server down. -> 0."""
    drain = drain if drain is not None else threading.Event()
    vocab = scheduler.engine.vocab
    eos_id = resolve_eos_id(args.eos_id, tokenizer, vocab)
    role = getattr(args, "role", "both")
    events = {}
    events_lock = threading.Lock()

    def on_finish(res):
        with events_lock:
            ev = events.get(res.request_id)
        if ev is not None:
            ev.set()

    scheduler.on_finish = on_finish
    stop = threading.Event()          # the server is shutting down
    engine_dead = threading.Event()   # the decode loop crashed

    def release_waiters():
        with events_lock:
            for ev in events.values():
                ev.set()

    def loop():
        # A dead decode thread must release every waiter (500s), not
        # leave handlers parked while /healthz keeps answering.
        try:
            with scheduler._device():
                while not stop.is_set():
                    if not scheduler.step():
                        time.sleep(0.002)
        except Exception:
            import traceback
            traceback.print_exc()
            engine_dead.set()
            stop.set()
            release_waiters()

    threading.Thread(target=loop, daemon=True).start()

    class Handler(BaseHTTPRequestHandler):
        # Bounds a stalled connection, so joining handler threads at
        # shutdown cannot hang on it.
        timeout = 60

        def log_message(self, *a):
            pass

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))

        def do_GET(self):
            if self.path == "/stats":
                payload = obs.stats_snapshot()
                payload["role"] = role
                payload["tenants"] = scheduler.tenant_queue_depths()
                return self._send(200, payload)
            if self.path == "/windows":
                return self._send(200, obs.windows_payload())
            if self.path == "/metrics":
                return send_metrics(self)
            if self.path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            pool = scheduler.engine.pool
            if stop.is_set():
                status = "decode loop stopped"
            elif drain.is_set():
                status = "draining"
            else:
                status = "ok"
            payload = {
                "status": status, "active": pool.num_active,
                "capacity": pool.capacity, "queued": scheduler.queue_depth,
                "occupancy": pool.occupancy, "role": role,
                "parked": scheduler.parked_count,
                "tenants": scheduler.tenant_queue_depths(),
                "preempted": scheduler.preempted_count,
                "host_blocks": pool.host_blocks,
                "host_blocks_used": pool.host_blocks_used}
            if status == "ok":
                # The fleet digest rides the router's probe.
                payload.update(scheduler.fleet_digest(
                    getattr(args, "digest_interval", 2.0),
                    getattr(args, "digest_max_entries", 256)))
            self._send(200 if status == "ok" else 503, payload)

        def do_POST(self):
            if self.path in ("/kv_export", "/kv_ack"):
                return self._send(*migrate.dispatch_kv_endpoint(
                    scheduler, self.path, self._body()))
            if self.path != "/generate":
                return self._send(404, {"error": "unknown path"})
            if drain.is_set():
                return self._send(503, {"error": "draining"})
            try:
                obj = json.loads(self._body())
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            obs.adopt_trace_header(self.headers, obj)
            if isinstance(obj, dict) and obj.get("resume"):
                return self._resume(str(obj["resume"]))
            mig_meta = fleet_meta = None
            pull = obj.get("pull_from") if isinstance(obj, dict) else None
            if (isinstance(pull, dict) and "tokens" in pull
                    and "request_id" not in pull):
                # A peer pull: a failure degrades to a cold prefill.
                try:
                    fleet_meta = migrate.pull_prefix_into(scheduler, pull)
                except migrate.MigrationError as e:
                    fleet_meta = {"bytes": 0, "blocks": 0, "installed": 0,
                                  "degraded": str(e), "error_type": e.kind}
            elif pull is not None:
                # Pull, install and ACK before admission, so that the
                # submit below binds the installed blocks.
                try:
                    mig_meta = migrate.pull_into(scheduler, pull)
                except migrate.MigrationError as e:
                    return self._send(424, {"error": str(e),
                                            "error_type": e.kind})
            try:
                req = parse_request(obj, args, vocab, tokenizer, eos_id)
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            if stop.is_set():
                return self._send(503, {"error": "decode loop stopped"})
            # The event goes in BEFORE submit (a short request may retire
            # at once), and events_lock is never held across submit
            # (on_finish takes it under the scheduler's lock).
            rid = req.request_id or f"http-{uuid.uuid4().hex[:12]}"
            req.request_id = rid
            ev = threading.Event()
            with events_lock:
                if rid in events:
                    return self._send(409, {
                        "error": f"request id {rid!r} already in flight"})
                events[rid] = ev
            try:
                scheduler.submit(req)
            except QueueFull as e:
                with events_lock:
                    events.pop(rid, None)
                return self._send(503, {
                    "error": str(e),
                    "error_type": ("tenant_over_limit"
                                   if isinstance(e, TenantOverLimit)
                                   else "queue_full")})
            except ValueError as e:
                with events_lock:
                    events.pop(rid, None)
                return self._send(400, {"error": str(e)})
            extra = {}
            if mig_meta is not None:
                extra["migration"] = mig_meta
            if fleet_meta is not None:
                extra["fleet_pull"] = fleet_meta
            self._answer(rid, ev, extra)

        def _resume(self, rid: str):
            """Decode a parked request here (the local fallback)."""
            ev = threading.Event()
            with events_lock:
                if rid in events:
                    return self._send(409, {
                        "error": f"request id {rid!r} already in flight"})
                events[rid] = ev
            if not scheduler.resume_parked(rid):
                with events_lock:
                    events.pop(rid, None)
                return self._send(404, {
                    "error": f"request {rid!r} is not parked here",
                    "error_type": "migration_failed"})
            self._answer(rid, ev, {"resumed": True})

        def _answer(self, rid: str, ev: threading.Event, extra: dict):
            if stop.is_set():
                # The drain (or the decode loop's death) completed while
                # this request was being read: nobody will retire it.
                with events_lock:
                    events.pop(rid, None)
                return self._send(503, {"error": "draining"})
            ev.wait()
            with events_lock:
                events.pop(rid, None)
            res = scheduler.results.pop(rid, None)
            if res is None:   # the decode loop died before retiring it
                return self._send(500, {"error": "decode loop failed"})
            out = _result_obj(res, tokenizer)
            out.pop("event")
            out.update(extra)
            self._send(200, out)

    class Server(ThreadingHTTPServer):
        daemon_threads = False

    server = Server(("127.0.0.1", port), Handler)

    def cancel_stragglers():
        # A request whose upload straddled the drain may submit late: it
        # gets a result (deadline, or error on a dead engine) before the
        # waiters are released, never a spurious 500.
        if engine_dead.is_set():
            scheduler.cancel_remaining(FinishReason.ERROR,
                                       error="decode loop died")
        else:
            scheduler.cancel_remaining()

    def drain_watch():
        # The drain runs here, off the signal handler, which only sets
        # the event.
        drain.wait()
        if not stop.is_set():
            _drain(scheduler, args.drain_timeout, drive=False,
                   dead=engine_dead, abort=stop)
            stop.set()
        cancel_stragglers()
        release_waiters()
        server.shutdown()
        # Once more: a handler registering after the first sweep sees
        # stop set and answers 503 itself.
        cancel_stragglers()
        release_waiters()

    threading.Thread(target=drain_watch, daemon=True).start()
    if ready_cb is not None:
        ready_cb(server)
    print(f"nezha_tpu_torch.cli.serve listening on http://127.0.0.1:"
          f"{server.server_address[1]} (POST /generate, GET /healthz)",
          file=sys.stderr, flush=True)
    try:
        server.serve_forever(poll_interval=0.1)
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        drain.set()    # unblocks the watcher on exits without a signal
        server.server_close()
    return 0


def _start_watchdog(args):
    """Start the anomaly watchdog when ``--watchdog-interval`` or
    ``--slo`` asks for one (an SLO implies it, every 10 s by default).
    -> the started thread or None. A bad ``--slo`` exits with it."""
    slos = _parse_slos(args)
    interval = float(getattr(args, "watchdog_interval", 0.0) or 0.0)
    if interval <= 0 and not slos:
        return None
    if interval <= 0:
        interval = 10.0
    wd = obs.Watchdog(slos=slos,
                      config=obs.WatchdogConfig(interval_s=interval))
    return obs.WatchdogThread(wd).start()


def _set_trace_sample(args) -> None:
    try:
        obs.set_trace_sample(getattr(args, "trace_sample", 1.0))
    except ValueError as e:
        raise SystemExit(f"--trace-sample: {e}")


def run_worker(args, stdin=None, stdout=None, ready_cb=None,
               drain_event: Optional[threading.Event] = None) -> int:
    """The single-replica stack, run alone and as each spawned fleet
    worker: install ``NEZHA_FAULT_PLAN``'s plan (the previous one is
    restored on exit), hit ``replica.exec`` (the crash-at-startup drill),
    start the watchdog and the ``--run-dir`` sink, build the scheduler,
    install SIGTERM and SIGINT handlers that set the drain event (after
    the build, so a wedged start stays killable with Ctrl-C; skipped off
    the main thread, where ``drain_event`` triggers the same path), serve
    HTTP or stdio, and restore the old handlers on exit."""
    from nezha_tpu_torch.serve.supervisor import replica_exec_point
    prev_plan = faults.active()
    faults.install_from_env()
    try:
        replica_exec_point()
    except BaseException:
        faults.install(prev_plan)
        raise
    drain = drain_event if drain_event is not None else threading.Event()
    old_handlers = {}
    watchdog = sink = None
    try:
        _set_trace_sample(args)
        # The watchdog first: a bad --slo exits before a sink opens.
        watchdog = _start_watchdog(args)
        if args.run_dir:
            sink = obs.start_run(args.run_dir, meta={
                "kind": "serve",
                "mode": "http" if args.http is not None else "stdio"})
        scheduler, tokenizer, _ = _build_stack(args)
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(
                    sig, lambda signum, frame: drain.set())
            except ValueError:
                break   # not the main thread of the main interpreter
        if args.http is not None:
            return run_http(scheduler, args, args.http, tokenizer,
                            ready_cb=ready_cb, drain=drain)
        return run_stdio(scheduler, args, stdin=stdin, stdout=stdout,
                         tokenizer=tokenizer, drain=drain)
    finally:
        if watchdog is not None:
            watchdog.stop()
        if sink is not None:
            obs.end_run()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        faults.install(prev_plan)


# ------------------------------------------------------- multi-replica
def _worker_argv(args, rid: int, port: int, role: Optional[str] = None
                 ) -> list:
    """One spawned worker's argv: this command's flags minus the
    router's, plus the worker's port, its tier role and, with
    ``--run-dir``, a directory of its own. ``--device`` rides along: a
    worker runs on the card unless the front end was given ``--device
    cpu``."""
    argv = [sys.executable, "-m", "nezha_tpu_torch.cli.serve",
            "--role", role or getattr(args, "role", "both")]
    if args.random_init:
        argv.append("--random-init")
    elif args.ckpt_dir:
        argv += ["--ckpt-dir", args.ckpt_dir]
    elif args.hf_dir:
        argv += ["--hf-dir", args.hf_dir]
    argv += ["--model-preset", args.model_preset,
             "--device", args.device,
             "--max-batch-size", str(args.max_batch_size),
             "--max-len", str(args.max_len),
             "--max-prefill-len", str(args.max_prefill_len),
             "--k-max", str(args.k_max),
             "--queue-capacity", str(args.queue_capacity),
             "--max-new-tokens", str(args.max_new_tokens),
             "--cache-dtype", args.cache_dtype,
             "--decode-horizon", str(args.decode_horizon),
             "--kv-layout", args.kv_layout,
             "--kv-block-size", str(args.kv_block_size),
             "--kv-dtype", args.kv_dtype,
             "--prefix-cache", args.prefix_cache,
             "--kv-eviction", args.kv_eviction,
             "--kv-host-blocks", str(args.kv_host_blocks),
             "--preemption", args.preemption,
             "--preemption-budget", str(args.preemption_budget),
             "--digest-interval", str(args.digest_interval),
             "--digest-max-entries", str(args.digest_max_entries),
             "--drain-timeout", str(args.drain_timeout),
             "--trace-sample", str(args.trace_sample),
             "--watchdog-interval", str(args.watchdog_interval or 0.0),
             "--seed", str(args.seed),
             "--mesh", str(args.mesh or 1),
             "--prefill-mode", args.prefill_mode,
             "--seq-prefill-variant", args.seq_prefill_variant,
             "--http", str(port)]
    for spec in args.slo or []:
        argv += ["--slo", str(spec)]
    optional = (("--kv-num-blocks", args.kv_num_blocks),
                ("--priority-weights", args.priority_weights),
                ("--tenant-queue-cap", args.tenant_queue_cap),
                ("--tokenizer", args.tokenizer),
                ("--prefill-buckets", args.prefill_buckets),
                ("--long-prefill-buckets", args.long_prefill_buckets or None),
                ("--decode-impl", args.decode_impl),
                ("--prefill-impl", args.prefill_impl),
                ("--eos-id", args.eos_id),
                ("--shard-device", args.shard_device))
    for flag, value in optional:
        if value is not None:
            argv += [flag, str(value)]
    if args.speculative:
        argv += ["--speculative", "--draft-k", str(args.draft_k)]
        for flag, value in (("--draft-layers", args.draft_layers),
                            ("--draft-ckpt-dir", args.draft_ckpt_dir),
                            ("--draft-hf-dir", args.draft_hf_dir)):
            if value is not None:
                argv += [flag, str(value)]
    if args.run_dir:
        argv += ["--run-dir", os.path.join(args.run_dir, f"replica{rid}")]
    return argv


def run_multi(args, ready_cb=None, drain_event=None) -> int:
    """The fleet front end: the supervisor spawns the workers, the
    router serves HTTP over them, SIGTERM or SIGINT rolls the drain
    through them one at a time. With the process backend this process
    builds no model and touches no card (the workers own the engines);
    ``--replica-backend thread`` hosts the workers here instead."""
    from nezha_tpu_torch.serve.router import (Router,
                                              register_router_instruments,
                                              run_front_end)
    from nezha_tpu_torch.serve.supervisor import (ProcessBackend,
                                                  RouterConfig, Supervisor,
                                                  ThreadBackend)
    if args.http is None:
        raise SystemExit("--replicas N > 1 (or --prefill-replicas/"
                         "--decode-replicas) requires --http PORT (the "
                         "router is an HTTP front end)")
    roles: tuple = ()
    total = args.replicas
    if args.prefill_replicas or args.decode_replicas:
        if args.prefill_replicas < 1 or args.decode_replicas < 1:
            raise SystemExit("--prefill-replicas and --decode-replicas "
                             "must both be >= 1 for a disaggregated front "
                             "end")
        roles = (("prefill",) * args.prefill_replicas
                 + ("decode",) * args.decode_replicas)
        total = len(roles)
    affinity = args.affinity_routing or ("on" if total > 1 else "off")
    try:
        cfg = RouterConfig(
            replicas=total, roles=roles,
            probe_interval_s=args.probe_interval,
            probe_misses=args.probe_misses,
            route_retries=args.route_retries,
            restart_backoff_base_s=args.restart_backoff,
            max_restart_failures=args.max_restart_failures,
            drain_timeout_s=args.drain_timeout, seed=args.seed,
            affinity_routing=affinity == "on",
            digest_interval_s=args.digest_interval,
            digest_max_entries=args.digest_max_entries,
            autoscale_min=args.autoscale_min,
            autoscale_max=args.autoscale_max)
    except ValueError as e:
        raise SystemExit(f"fleet config: {e}")
    prev_plan = faults.active()
    faults.install_from_env()
    # The router is the trace-minting edge; the workers get the same
    # sample through their argv.
    _set_trace_sample(args)
    watchdog = sink = None
    drain = drain_event if drain_event is not None else threading.Event()
    old_handlers = {}
    sup = router = None
    try:
        watchdog = _start_watchdog(args)
        if args.run_dir:
            sink = obs.start_run(args.run_dir, meta={
                "kind": "serve_router", "replicas": total,
                "roles": ",".join(roles) if roles else "both",
                "backend": args.replica_backend})
            register_router_instruments()
        if args.replica_backend == "thread":
            wargs = copy.copy(args)
            wargs.replicas, wargs.http, wargs.run_dir = 1, None, None
            wargs.prefill_replicas = wargs.decode_replicas = 0
            backend = ThreadBackend(wargs, drain_timeout_s=args.drain_timeout,
                                    roles=roles)
        else:
            backend = ProcessBackend(
                lambda rid, port: _worker_argv(args, rid, port,
                                               cfg.role_of(rid)
                                               if roles else args.role),
                log_dir=(os.path.join(args.run_dir, "logs")
                         if args.run_dir else None))
        sup = Supervisor(backend, cfg)
        router = Router(sup, cfg)
        sup.start()
        router.start()
        # As in the worker: the handlers only set the event, installed
        # once the supervisor is up so a wedged spawn stays Ctrl-C-able.
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(
                    sig, lambda signum, frame: drain.set())
            except ValueError:
                break
        return run_front_end(router, sup, args.http, ready_cb=ready_cb,
                             drain=drain, drain_timeout_s=args.drain_timeout)
    finally:
        if router is not None:
            router.stop()
        if sup is not None:
            sup.shutdown()
        if watchdog is not None:
            watchdog.stop()
        if sink is not None:
            obs.end_run()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        faults.install(prev_plan)


def run(args, stdin=None, stdout=None, ready_cb=None,
        drain_event: Optional[threading.Event] = None) -> int:
    """The CLI's entry with parsed ``args``: a fleet front end when
    ``--replicas`` > 1, a tier split or autoscale bounds ask for one (an
    elastic fleet that starts at one replica still needs the router),
    else one replica."""
    if (args.replicas > 1 or args.autoscale_min is not None
            or args.autoscale_max is not None
            or args.prefill_replicas or args.decode_replicas):
        return run_multi(args, ready_cb=ready_cb, drain_event=drain_event)
    return run_worker(args, stdin=stdin, stdout=stdout, ready_cb=ready_cb,
                      drain_event=drain_event)


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
