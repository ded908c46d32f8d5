"""Where the time goes in the PyTorch port's serving path, on one CUDA card.

    python3 tools/profile_torch_serve.py [--kv-dtype int8] [--out f.json]
    python3 tools/profile_torch_serve.py --seq-prefill ring|ulysses

Serves the same eight greedy requests as ``chip_smoke.py``'s serve phase
(GPT-2 124M, seeded random weights, bf16, paged KV with 16-token blocks,
bf16 or int8 blocks) three times — warm-up, timed, profiled — and
reports what follows. ``--seq-prefill`` serves ``chip_smoke.py``'s
serve_seq cell instead: a ``ShardedEngine`` of four shards all on the
one card (they run one after another), sequence-sharded prefill in that
variant, long-prefill buckets 512 and 1024, and a 960-token request
added to the eight.

- wall time of a run without the profiler, split into prefill
  (admission) and decode-step time from the host clock around
  ``Engine.prefill`` and ``Engine.step``;
- from a second run under the profiler: device busy time (sum of CUDA
  kernel time) and the device's idle share of that run's wall time (and,
  as an estimate, of the unprofiled run's);
- the CUDA kernels and CPU ops that took the most time;
- the kernels one decode step launches with all eight rows live (from
  ten profiled steps).

It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nezha_tpu_torch.cli.common import gpt2_for_preset  # noqa: E402
from nezha_tpu_torch.serve import (Engine, Request, Scheduler,  # noqa: E402
                                   ServeConfig, ShardedEngine)


SEQ_MESH = 4
SEQ_DOCUMENT = 960


def requests(vocab: int, tag: str, document: bool = False):
    g = torch.Generator().manual_seed(1)

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    prefix = toks(128)
    prompts = [toks(5), toks(37), toks(200), toks(300), toks(600),
               toks(900), prefix + toks(20), prefix + toks(45)]
    if document:
        prompts.append(torch.randint(0, vocab, (SEQ_DOCUMENT,),
                                     generator=torch.Generator()
                                     .manual_seed(3)).tolist())
    return [Request(prompt=p, max_new_tokens=32, request_id=f"{tag}{i}")
            for i, p in enumerate(prompts)]


class Timed:
    """Host-clock totals around the engine's two entry points (each call
    ends in a device sync, so the host clock covers the device work)."""

    def __init__(self, engine):
        self.prefill_s = 0.0
        self.step_s = 0.0
        self.steps = 0
        prefill, step = engine.prefill, engine.step

        def timed_prefill(*a, **kw):
            t = time.perf_counter()
            prefill(*a, **kw)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t

        def timed_step(*a, **kw):
            t = time.perf_counter()
            out = step(*a, **kw)
            self.step_s += time.perf_counter() - t
            self.steps += 1
            return out

        engine.prefill = timed_prefill
        engine.step = timed_step
        self._engine = engine

    def remove(self) -> None:
        del self._engine.prefill, self._engine.step


def cuda_kernels(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def decode_step_launches(sched, vocab: int, steps: int = 10) -> float:
    """Kernel launches per decode step with all eight rows live: admit
    the eight requests (one scheduler step prefills them all and decodes
    once), then profile ``steps`` decode-only steps."""
    for r in requests(vocab, "k"):
        sched.submit(r)
    sched.step()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
    sched.run_until_idle()
    return sum(e.count for e in cuda_kernels(prof)) / steps


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="also write the full report as JSON here")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--kv-dtype", choices=["bf16", "int8"], default="bf16")
    p.add_argument("--seq-prefill", choices=["ring", "ulysses"],
                   default=None, help="serve the serve_seq cell instead")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = torch.cuda.get_device_name(0)
    model = gpt2_for_preset("full", seed=0, device="cuda")
    doc = args.seq_prefill is not None
    cfg = ServeConfig(max_batch_size=8, max_len=1024, max_prefill_len=256,
                      kv_block_size=16, kv_dtype=args.kv_dtype)
    if doc:
        cfg = dataclasses.replace(
            cfg, prefill_mode="sequence", long_prefill_buckets=(512, 1024),
            seq_prefill_variant=args.seq_prefill)
        engine = ShardedEngine(model, cfg, mesh_devices=SEQ_MESH,
                               devices=[torch.device("cuda", 0)] * SEQ_MESH)
    else:
        engine = Engine(model, cfg)
    sched = Scheduler(engine)
    for r in requests(model.cfg.vocab_size, "warm", doc):
        sched.submit(r)
    sched.run_until_idle()
    # Timed run without the profiler (its per-op cost would inflate the
    # host side), then the same traffic again under the profiler.
    sched.engine.pool.clear_prefix_cache()
    timed = Timed(sched.engine)
    t0 = time.perf_counter()
    for r in requests(model.cfg.vocab_size, "r", doc):
        sched.submit(r)
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed.remove()
    sched.engine.pool.clear_prefix_cache()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for r in requests(model.cfg.vocab_size, "p", doc):
            sched.submit(r)
        sched.run_until_idle()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Kernels are events of their own on the device; summing only those
    # counts each kernel once.
    kernels = cuda_kernels(prof)
    busy_us = sum(dev_us(e) for e in kernels)
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:args.top]
    by_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:args.top]
    tokens = sum(len(res.tokens) for rid, res in sched.results.items()
                 if rid.startswith("r"))
    step_launches = decode_step_launches(sched, model.cfg.vocab_size)
    report = {
        "card": card,
        "kv_dtype": args.kv_dtype,
        "seq_prefill": args.seq_prefill,
        "wall_s": wall,
        "prefill_s": timed.prefill_s,
        "decode_steps": timed.steps,
        "decode_s": timed.step_s,
        "decode_step_ms": 1e3 * timed.step_s / max(timed.steps, 1),
        "tokens": tokens,
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6,
        "kernel_events": len(kernels),
        "device_idle_share_profiled": 1.0 - busy_us / 1e6 / prof_wall,
        "device_idle_share_unprofiled_est": 1.0 - busy_us / 1e6 / wall,
        "decode_step_kernel_launches": step_launches,
        "top_device": [{"name": e.key, "device_ms": dev_us(e) / 1e3,
                        "calls": e.count} for e in by_dev],
        "top_cpu_self": [{"name": e.key,
                          "cpu_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count} for e in by_cpu],
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if not k.startswith("top_")}))
    for e in report["top_device"]:
        print(f"dev {e['device_ms']:9.3f} ms {e['calls']:6d}x {e['name']}")
    for e in report["top_cpu_self"]:
        print(f"cpu {e['cpu_ms']:9.3f} ms {e['calls']:6d}x {e['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
