"""Where the time goes in the PyTorch port's KV-cache generation, on one
CUDA card.

    python3 tools/profile_torch_generate.py [--out generate_profile.json]

The call of ``chip_smoke.py``'s generate phase (GPT-2 124M, seeded random
weights, bf16, ``ln_impl="pallas"``, eight random 512-token prompts, 256
new tokens greedy through ``models.generate``): a warm-up, then
five pairs of a run timed on the host clock and a prefill-only
run (``max_new_tokens=1``, the time to first token), then one run under
``torch.profiler``. Reports wall time, time to first token, decode ms per
step and tokens/s (the medians, and each pair's wall time and decode ms
per step, since the host's clock swings), the device's busy time
and idle share, device time by kind of kernel, and the CUDA kernels and
CPU ops that took the most time. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nezha_tpu_torch.cli.common import gpt2_for_preset  # noqa: E402
from nezha_tpu_torch.models import generate  # noqa: E402
from profile_torch_train import category, dev_us  # noqa: E402

B, PROMPT, NEW = 8, 512, 256
REPEATS = 5     # timed runs a call: the host's clock swings run to run


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="also write the full report as JSON here")
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = torch.cuda.get_device_name(0)
    model = gpt2_for_preset("full", seed=0, device="cuda", ln_impl="pallas")
    model.eval()
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, model.cfg.vocab_size, (B, PROMPT),
                           generator=g).cuda()

    def timed(n_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(model, prompt, n_new)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    timed(4)                                    # warm-up
    pairs = [(timed(NEW), timed(1)) for _ in range(REPEATS)]
    walls = [w for w, _ in pairs]
    steps = [1e3 * (w - f) / (NEW - 1) for w, f in pairs]
    wall = statistics.median(walls)
    ttft = statistics.median(f for _, f in pairs)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = timed(NEW)
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kernels)
    by_cat: dict = {}
    for e in kernels:
        c = category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + dev_us(e) / 1e3
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:args.top]
    by_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:args.top]
    report = {
        "card": card,
        "B": B, "prompt_len": PROMPT, "new_tokens": NEW,
        "ln_impl": "pallas",
        "wall_s": wall,
        "ttft_s": ttft,
        "decode_ms_per_step": statistics.median(steps),
        "wall_s_runs": walls,
        "decode_ms_per_step_runs": steps,
        "tokens_per_s": B * NEW / wall,
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share_profiled": 1.0 - busy_us / 1e6 / prof_wall,
        "device_idle_share_unprofiled_est": 1.0 - busy_us / 1e6 / wall,
        "device_ms_by_kind": by_cat,
        "kernel_launch_calls": launches,
        "kernel_events": len(kernels),
        "top_device": [{"name": e.key[:160], "device_ms": dev_us(e) / 1e3,
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
