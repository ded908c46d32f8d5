"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and ``nvidia-smi``'s name and power limit;
2. build: compiles every CUDA kernel from ``nezha_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and prints the build time;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes in bf16 (GPT-2 124M: H=12, D=64, pool blocks
   of 16, 64 blocks per row), with its time (CUDA events, L2 flushed
   before each launch), the plain version's time, the bound (bytes the
   call must move over 3.35 TB/s vs its flops over 989 TFLOP/s, from
   this run's lengths and starts) and, as a yardstick only,
   ``scaled_dot_product_attention`` on the same K/V gathered dense; each
   output element must lie within ``fold_error_bound`` of the plain one;
4. serve: GPT-2 124M at full width, seeded random weights, bf16, eight
   greedy requests through ``Scheduler`` (prompts of 5-900 tokens, some
   prefilled in chunks, two sharing a 128-token prefix); requires every
   request to finish, both kernels launched on the path, a clean
   ``leak_check()``, and agreement with the port's no-cache causal
   forward on the card (see SERVE_LOGIT_ATOL).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
# Kernel vs plain version, both on the card in bf16: they fold in
# different orders, so each rounds p to bf16 against other running maxima
# and rounds its own output; fold_error_bound (ops/cuda/common.py) bounds
# that per element by 2^-7 * (sum p|v| / l + |out|) + 1e-5, computed from
# the plain version run on |v|.
# Served logits vs the no-cache forward: both run GPT-2 in bf16 through
# 12 layers, but the reference rounds attention scores to bf16 and the
# kernels keep them fp32, so activations differ by bf16 rounding at every
# layer; logits of this random init have std ~0.5, and 0.125 (32 bf16
# ulps at 1.0) bounds that drift.
SERVE_LOGIT_ATOL = 0.125

H, D, BS, M = 12, 64, 16, 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def gpu_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around each call, with the L2
    cache flushed before every call (the serving path meets each layer's
    K/V cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def shuffled_tables(g, rows: int, n_blocks: int):
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    return perm[:rows * M].reshape(rows, M).to(torch.int32)


def within_bound(name: str, got, want, want_abs_v):
    """-> (max |kernel - plain|, its largest ratio to fold_error_bound);
    fails when any element exceeds the bound."""
    from nezha_tpu_torch.ops.cuda.common import fold_error_bound

    bound = fold_error_bound(want, want_abs_v, p_bf16=True)
    err = (got.float() - want.float()).abs()
    ratio = (err / bound).max().item()
    if not ratio <= 1.0:
        fail(f"{name}: |kernel - plain| exceeds fold_error_bound "
             f"(max ratio {ratio}, max error {err.max().item()})")
    return err.max().item(), ratio


def check_decode(g):
    from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                          paged_decode_attention_plain)
    import torch.nn.functional as F

    lengths_list = [0, 1, 15, 16, 17, 300, 777, M * BS]
    b = len(lengths_list)
    n = 1 + b * M
    bf = torch.bfloat16
    q = torch.randn(b, H, 1, D, generator=g).to("cuda", bf)
    kp = torch.randn(n, H, BS, D, generator=g).to("cuda", bf)
    vp = torch.randn(n, H, BS, D, generator=g).to("cuda", bf)
    tab = shuffled_tables(g, b, n).cuda()
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    args = (q, kp, vp, lengths, tab)
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    want = paged_decode_attention_plain(*args)
    abs_v = paged_decode_attention_plain(q, kp, vp.abs(), lengths, tab)
    err, ratio = within_bound("paged_decode", got, want, abs_v)
    if not torch.all(got[0] == 0):
        fail("paged_decode: the length-0 row is not exact zero")
    ms = gpu_time_ms(lambda: paged_decode_attention(*args), 100)
    plain_ms = gpu_time_ms(lambda: paged_decode_attention_plain(*args), 5)
    # Yardstick: SDPA over the rows' K/V gathered dense, masked by length.
    kd = kp[tab.long()].transpose(1, 2).reshape(b, H, M * BS, D)
    vd = vp[tab.long()].transpose(1, 2).reshape(b, H, M * BS, D)
    mask = (torch.arange(M * BS, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    library_ms = gpu_time_ms(
        lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask),
        100)
    total = sum(lengths_list)
    nbytes = (2 * b * H * D * 2                     # q in, out
              + 2 * total * H * D * 2               # K and V read once
              + sum(math.ceil(x / BS) for x in lengths_list) * 4 + b * 4)
    flops = 4 * total * H * D
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "paged_decode", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_decode.cu",
            "replaces": "nezha_tpu/ops/pallas/decode_attention.py:89",
            "max_abs_err": err, "err_over_tolerance": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"B={b} H={H} D={D} bs={BS} M={M} "
                     f"lengths={lengths_list}"}


def check_prefill(g):
    from nezha_tpu_torch.ops.cuda import (paged_prefill_attention,
                                          paged_prefill_attention_plain)
    import torch.nn.functional as F

    bf = torch.bfloat16
    n = 1 + M
    kp = torch.randn(n, H, BS, D, generator=g).to("cuda", bf)
    vp = torch.randn(n, H, BS, D, generator=g).to("cuda", bf)
    tab = shuffled_tables(g, 1, n).cuda()
    worst = worst_ratio = 0.0
    cases = []
    for s in (32, 256):
        q, kc, vc = (torch.randn(1, H, s, D, generator=g).to("cuda", bf)
                     for _ in range(3))
        for start in (0, 37, 256, 768):
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            args = (q, kc, vc, kp, vp, tab, starts)
            got = paged_prefill_attention(*args)
            torch.cuda.synchronize()
            want = paged_prefill_attention_plain(*args)
            abs_v = paged_prefill_attention_plain(q, kc, vc.abs(), kp,
                                                  vp.abs(), tab, starts)
            err, ratio = within_bound(f"paged_prefill S={s} start={start}",
                                      got, want, abs_v)
            worst = max(worst, err)
            worst_ratio = max(worst_ratio, ratio)
            ms = gpu_time_ms(lambda: paged_prefill_attention(*args), 50)
            plain_ms = gpu_time_ms(
                lambda: paged_prefill_attention_plain(*args), 3)
            # Yardstick: SDPA over [prefix gathered dense ; chunk].
            pk = kp[tab[0].long()].transpose(0, 1).reshape(1, H, M * BS, D)
            pv = vp[tab[0].long()].transpose(0, 1).reshape(1, H, M * BS, D)
            kd = torch.cat([pk[:, :, :start], kc], dim=2)
            vd = torch.cat([pv[:, :, :start], vc], dim=2)
            mask = (torch.arange(start + s, device="cuda")[None, :]
                    <= start + torch.arange(s, device="cuda")[:, None])
            library_ms = gpu_time_ms(
                lambda: F.scaled_dot_product_attention(q, kd, vd,
                                                       attn_mask=mask), 50)
            nbytes = (4 * s * H * D * 2                 # q, k, v in; out
                      + 2 * start * H * D * 2           # prefix K and V
                      + math.ceil(start / BS) * 4 + 4)
            flops = 4 * H * D * (s * start + s * (s + 1) // 2)
            bound_ms, bound_by = bound(nbytes, flops)
            cases.append({"S": s, "start": start, "max_abs_err": err,
                          "err_over_tolerance": ratio, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms})
    print(json.dumps({"paged_prefill_cases": cases}), flush=True)
    # The kernels line reports the widest chunk at the deepest start.
    rep = cases[-1]
    return {"name": "paged_prefill", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": "nezha_tpu/ops/pallas/prefill_attention.py:137",
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": f"B=1 H={H} D={D} bs={BS} M={M} S={rep['S']} "
                     f"start={rep['start']}"}


def serve(card: str):
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                          paged_prefill_attention)
    from nezha_tpu_torch.serve import (Engine, FinishReason, Request,
                                       Scheduler, ServeConfig)

    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    cfg = ServeConfig(max_batch_size=8, max_len=1024, max_prefill_len=256,
                      kv_block_size=16)
    engine = Engine(model, cfg)
    sched = Scheduler(engine)
    g = torch.Generator().manual_seed(1)
    vocab = model.cfg.vocab_size

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    prefix = toks(128)
    prompts = [toks(5), toks(37), toks(200), toks(300), toks(600),
               toks(900), prefix + toks(20), prefix + toks(45)]
    reqs = [Request(prompt=p, max_new_tokens=32, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    paged_decode_attention.launches = 0
    paged_prefill_attention.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle(max_iters=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = engine.kernel_launches()
    if sched.has_work():
        fail("scheduler did not drain")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    for r in reqs:
        res = sched.results[r.request_id]
        if res.finish_reason not in (FinishReason.LENGTH, FinishReason.EOS):
            fail(f"{r.request_id} finished {res.finish_reason}: "
                 f"{res.error}")
        dec = res.latency_s - res.ttft_s
        print(json.dumps({"request": r.request_id,
                          "prompt_len": len(r.prompt),
                          "new_tokens": len(res.tokens),
                          "ttft_s": res.ttft_s,
                          "decode_tok_s": (len(res.tokens) - 1) / dec
                          if dec > 0 else None,
                          "card": card}), flush=True)
    engine.pool.leak_check()
    if engine.pool.prefix_hits < 1:
        fail("the shared 128-token prefix did not hit the prefix cache")
    # Each decode launch serves every active row at once, so per request
    # is the run's count over the requests served.
    print(json.dumps({"serve_wall_s": wall, "launches": launches,
                      "launches_per_request": {
                          k: n / len(reqs) for k, n in launches.items()},
                      "prefix_hits": engine.pool.prefix_hits,
                      "cow_copies": engine.pool.cow_copies,
                      "step_calls": engine.step_calls,
                      "card": card}), flush=True)
    cross_check(model, sched, reqs)
    return launches


@torch.no_grad()
def cross_check(model, sched, reqs) -> None:
    """Every request against the no-cache causal forward over prompt +
    generated tokens (teacher-forced): the prompt's last-position logits
    from a fresh paged prefill must lie within SERVE_LOGIT_ATOL, and each
    generated token must be the reference argmax wherever the reference's
    top-2 margin exceeds that tolerance."""
    engine = sched.engine
    worst = 0.0
    checked = 0
    for r in reqs:
        res = sched.results[r.request_id]
        seq = list(r.prompt) + res.tokens[:-1]
        ref = model(torch.tensor([seq], device="cuda"))[0]     # [T, V]
        n = len(r.prompt)
        slot = engine.pool.alloc()
        try:
            engine.prefill(slot, r.prompt, max_new_tokens=1)
            got = engine.last_logits[slot].clone()
        finally:
            engine.pool.free(slot)
        err = (got - ref[n - 1]).abs().max().item()
        worst = max(worst, err)
        if not math.isfinite(err) or err > SERVE_LOGIT_ATOL:
            fail(f"{r.request_id}: last-position logits differ by {err} > "
                 f"{SERVE_LOGIT_ATOL}")
        steps = ref[n - 1:n - 1 + len(res.tokens)]
        top2 = steps.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        want = steps.argmax(dim=-1).tolist()
        for i, tok in enumerate(res.tokens):
            if margin[i].item() > SERVE_LOGIT_ATOL:
                checked += 1
                if tok != want[i]:
                    fail(f"{r.request_id} token {i}: served {tok}, "
                         f"reference {want[i]} (margin "
                         f"{margin[i].item():.4f})")
    engine.pool.leak_check()
    print(json.dumps({"cross_check_max_logit_err": worst,
                      "tokens_checked": checked}), flush=True)


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{card}, power limit unknown"
    print(f"card: {card}; nvidia-smi: {card_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    phase("build")
    from nezha_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    times = build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "per_kernel_s": times}), flush=True)

    phase("kernels")
    g = torch.Generator().manual_seed(0)
    kernels = [check_decode(g), check_prefill(g)]
    phase("serve")
    launches = serve(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
