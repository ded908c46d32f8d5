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
   The three flash-attention training kernels are held the same way in
   bf16 at GPT-2's training shape (B=8, H=12, S=1024, D=64, causal) and
   on a non-causal case, a ``kv_lengths`` case with a zero-length row
   and an odd S=100: the forward's output within ``fold_error_bound``
   and its lse within LSE_ATOL, dq/dk/dv within
   ``flash_bwd_error_bound``, padded keys' dk/dv exactly zero, and two
   backward runs bitwise equal. Yardstick: SDPA's forward, and its
   autograd backward with the forward subtracted.
   The dense flash-decode kernel at generate's shape (B=8, H=12, L=1024,
   D=64, bf16 cache; lengths 0-1024, and f32 queries over the bf16 cache)
   within ``fold_error_bound``, timed with every row at length 768;
   yardstick SDPA with a ``[B, 1, 1, L]`` length mask. The LayerNorm
   forward and backward kernels at the train step's rows (8192 x 768,
   bf16; also 8 and 37 rows) within ``layer_norm_error_bound``, the
   backward bitwise repeatable; yardsticks ``F.layer_norm`` and its
   autograd backward with the forward subtracted;
4. train: GPT-2 124M at full width, bf16, B=8, S=1024,
   ``fused_loss_chunk=-1``, AdamW (weight decay 0.1), batches from
   ``synthetic_token_batches`` (seed 0): (a) one step's loss, gradients
   and updated weights with flash attention against the same step with
   composed attention, from the same weights and batch (TRAIN_*
   tolerances); (b) the loss on one fixed batch at a constant lr falls
   by at least LOSS_DROP over 10 steps; (c) 10 steps through
   ``Trainer.fit`` after 2 warm-up steps: ms per step, tokens/s and MFU
   (the analytic step flops of ``bench.py``, over 989 TFLOP/s); (d) each
   flash kernel launched exactly 12 times per step in that run; (e) one
   step with ``ln_impl="pallas"`` against the same step with the xla
   LayerNorm, from the same weights and batch (TRAIN_* tolerances); (f)
   10 timed steps with ``ln_impl="pallas"``, each LayerNorm kernel
   launched exactly 25 times per step (2 per block + ``ln_f``);
5. serve: GPT-2 124M at full width, seeded random weights, bf16, eight
   greedy requests through ``Scheduler`` (prompts of 5-900 tokens, some
   prefilled in chunks, two sharing a 128-token prefix); requires every
   request to finish, both paged kernels launched on the path, a clean
   ``leak_check()``, and agreement with the port's no-cache causal
   forward with composed attention (``attn_impl="xla"``, independent of
   every kernel) on the card (see SERVE_LOGIT_ATOL);
6. generate: GPT-2 124M at full width, bf16, ``ln_impl="pallas"``, eight
   random 512-token prompts, 256 new tokens greedy through
   ``models.generate``: time to first token, decode ms per step and
   tokens/s; exact launch counts (flash forward 12 for the prefill, the
   flash-decode kernel 255 x 12, the LayerNorm forward 256 x 25); the
   prompt's last logits and every greedy token against the no-cache
   forward of a copy with ``attn_impl="xla"`` and ``ln_impl="xla"``
   (SERVE_LOGIT_ATOL, tokens where the reference's top-2 margin exceeds
   it); then one sampled call (temperature 0.8, top-k 40, top-p 0.95)
   whose every token lies in its step's top 40.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores
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
# The flash forward's lse against its plain version: both fp32, summing
# up to 1024 exponentials in other orders (64-key tiles against 512-key
# blocks) and scores whose fp32 dots differ in order; |lse| stays below
# ~10 here, and 1e-4 is ~100 fp32 ulps of that.
LSE_ATOL = 1e-4
# Train step, flash against composed attention, both bf16 on the card.
# The composed path rounds the attention scores to bf16 before the
# softmax, the kernels keep them fp32, so every layer's activations
# differ by bf16 rounding (2^-8 relative) and so do the gradients that
# flow back through them:
# - loss: a mean over 8192 positions of ~10.8 nats; 0.02 is ~2^-9 of it;
# - gradients: per tensor, ||g_flash - g_xla|| <= 0.05 ||g_xla|| (a few
#   bf16 roundings compounded over 12 layers);
# - weights after one AdamW step: the first update is lr * g / (|g| +
#   eps), ~lr * sign(g), so where |g| is near eps a rounding flips it;
#   |w_flash - w_xla| <= 2 * lr + 1e-6 bounds that.
TRAIN_LOSS_ATOL = 0.02
TRAIN_GRAD_RTOL = 0.05
# The fixed-batch loss after 10 AdamW steps at lr 6e-4 must sit at least
# this far below the first step's.
LOSS_DROP = 0.5
TRAIN_B, TRAIN_S, TRAIN_LR = 8, 1024, 6e-4
# The LayerNorm-kernel step against the xla-LayerNorm step is held to the
# same TRAIN_* tolerances: both paths compute the statistics in fp32 from
# the same bf16 input and round the output (and dx) to bf16 once, so they
# differ by fp32 summation order and rsqrt's last bits, which the bf16
# rounding of every activation turns into occasional one-ulp (2^-8) flips
# that compound through 12 layers and their backward — the mechanism,
# and at most the size, of the flash-vs-composed difference above.
GEN_B, GEN_PROMPT, GEN_NEW = 8, 512, 256
DEC_L = 1024                      # the dense decode check's cache length
LN_D = 768

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


def bound(nbytes: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def shuffled_tables(g, rows: int, n_blocks: int):
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    return perm[:rows * M].reshape(rows, M).to(torch.int32)


def within(name: str, got, want, bound):
    """-> (max |got - want|, its largest ratio to the elementwise bound);
    fails when any element exceeds the bound."""
    err = (got.float() - want.float()).abs()
    ratio = (err / bound).max().item()
    if not ratio <= 1.0:
        fail(f"{name}: |kernel - plain| exceeds its bound (max ratio "
             f"{ratio}, max error {err.max().item()})")
    return err.max().item(), ratio


def within_bound(name: str, got, want, want_abs_v):
    """``within`` against ``fold_error_bound`` of an attention output."""
    from nezha_tpu_torch.ops.cuda.common import fold_error_bound

    return within(name, got, want, fold_error_bound(want, want_abs_v, True))


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


def attended_pairs(s: int, causal: bool, lengths) -> int:
    """(query, key) pairs the masks leave, summed over rows."""
    pairs = 0
    for n in lengths:
        n = max(1, min(int(n), s))
        pairs += sum(min(i + 1, n) for i in range(s)) if causal else s * n
    return pairs


def flash_case(g, b, s, causal, lengths=None, timed=False):
    """Check the three flash kernels against their plain versions on one
    bf16 case; -> per-kernel errors, and times and bounds when timed."""
    from nezha_tpu_torch.ops.cuda.flash_attention import (
        _dkv_launch, _dq_launch, _lengths, flash_block_bwd,
        flash_block_bwd_plain, flash_block_fwd, flash_block_fwd_plain,
        flash_bwd_error_bound)
    import torch.nn.functional as F

    bf = torch.bfloat16
    tag = (f"flash B={b} S={s} causal={causal}"
           + ("" if lengths is None else f" lengths={lengths}"))
    q, k, v, do = (torch.randn(b, H, s, D, generator=g).to("cuda", bf)
                   for _ in range(4))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    out, lse = flash_block_fwd(q, k, v, causal, kv_lengths=lens)
    torch.cuda.synchronize()
    want, want_lse = flash_block_fwd_plain(q, k, v, causal, kv_lengths=lens)
    abs_v = flash_block_fwd_plain(q, k, v.abs(), causal,
                                  kv_lengths=lens)[0]
    res = {"flash_fwd": within_bound(f"{tag} out", out, want, abs_v)}
    lse_err = (lse - want_lse).abs().max().item()
    if not lse_err <= LSE_ATOL:
        fail(f"{tag}: lse differs by {lse_err} > {LSE_ATOL}")
    # The backward from the plain forward's out and lse, so both sides
    # differentiate the same values.
    bwd_args = (q, k, v, want, want_lse, do, causal)
    grads = flash_block_bwd(*bwd_args, kv_lengths=lens)
    torch.cuda.synchronize()
    plain = flash_block_bwd_plain(*bwd_args, kv_lengths=lens)
    bounds = flash_bwd_error_bound(*bwd_args, kv_lengths=lens)
    for name, got, w, bd in zip(("dq", "dk", "dv"), grads, plain, bounds):
        key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        err, ratio = within(f"{tag} {name}", got, w, bd)
        prev = res.get(key, (0.0, 0.0))
        res[key] = (max(prev[0], err), max(prev[1], ratio))
    if lengths is not None:
        for i, n in enumerate(lengths):
            n = max(1, n)
            if torch.any(grads[1][i, :, n:] != 0) or torch.any(
                    grads[2][i, :, n:] != 0):
                fail(f"{tag}: keys past length {n} of row {i} got a "
                     f"non-zero dk/dv")
    again = flash_block_bwd(*bwd_args, kv_lengths=lens)
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        fail(f"{tag}: two backward runs differ")
    res["lse_err"] = lse_err
    if not timed:
        return res
    lens_c = _lengths(lens, q, s)
    scale = 1.0 / D ** 0.5
    bwd = bwd_args[:6] + (lens_c, causal, scale)
    ms = {"flash_fwd": gpu_time_ms(
              lambda: flash_block_fwd(q, k, v, causal, kv_lengths=lens), 20),
          "flash_bwd_dq": gpu_time_ms(lambda: _dq_launch(*bwd), 20),
          "flash_bwd_dkv": gpu_time_ms(lambda: _dkv_launch(*bwd), 20)}
    plain_fwd_ms = gpu_time_ms(
        lambda: flash_block_fwd_plain(q, k, v, causal, kv_lengths=lens), 3)
    plain_bwd_ms = gpu_time_ms(
        lambda: flash_block_bwd_plain(*bwd_args, kv_lengths=lens), 3)
    # Yardstick: SDPA (causal, no lengths) forward, and its autograd
    # backward (forward + backward, forward subtracted).
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg,
                                                  is_causal=causal)
    sdpa_fwd = gpu_time_ms(sdpa, 20)
    sdpa_both = gpu_time_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg),
                                                        do), 20)
    pairs = attended_pairs(s, causal, lengths or [s] * b) * H
    x = b * H * s * D * 2                     # one [B, H, S, D] bf16 tensor
    lse_bytes = b * H * s * 4
    bounds = {"flash_fwd": bound(4 * x + lse_bytes, 4 * pairs * D),
              "flash_bwd_dq": bound(6 * x + lse_bytes, 6 * pairs * D),
              "flash_bwd_dkv": bound(7 * x + lse_bytes, 8 * pairs * D)}
    plain_ms = {"flash_fwd": plain_fwd_ms, "flash_bwd_dq": plain_bwd_ms,
                "flash_bwd_dkv": plain_bwd_ms}
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_both - sdpa_fwd,
               "flash_bwd_dkv": sdpa_both - sdpa_fwd}
    res["timing"] = {n: {"ms": ms[n], "plain_ms": plain_ms[n],
                         "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
                         "library_ms": library[n]} for n in ms}
    return res


FLASH_SOURCES = {
    "flash_fwd": ("nezha_tpu_torch/csrc/flash_fwd.cu",
                  "nezha_tpu/ops/pallas/flash_attention.py:91"),
    "flash_bwd_dq": ("nezha_tpu_torch/csrc/flash_bwd.cu",
                     "nezha_tpu/ops/pallas/flash_attention.py:228"),
    "flash_bwd_dkv": ("nezha_tpu_torch/csrc/flash_bwd.cu",
                      "nezha_tpu/ops/pallas/flash_attention.py:265"),
}


def check_flash(g):
    """The flash kernels on four cases; the kernels line reports the
    training shape's times and the worst error over all cases."""
    main = flash_case(g, TRAIN_B, TRAIN_S, True, timed=True)
    cases = [main,
             flash_case(g, 4, TRAIN_S, False),
             flash_case(g, 4, TRAIN_S, True, lengths=[0, 1, 517, TRAIN_S]),
             flash_case(g, TRAIN_B, 100, True)]
    print(json.dumps({"flash_cases": [
        {k: v for k, v in c.items() if k != "timing"} for c in cases]}),
        flush=True)
    out = []
    for name, (source, replaces) in FLASH_SOURCES.items():
        t = main["timing"][name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "max_abs_err": max(c[name][0] for c in cases),
                    "err_over_tolerance": max(c[name][1] for c in cases),
                    **t,
                    "shape": f"B={TRAIN_B} H={H} S={TRAIN_S} D={D} causal"})
        if name != "flash_fwd":
            out[-1]["plain_covers"] = "dq, dk and dv together"
            out[-1]["library_covers"] = "dq, dk and dv together"
    return out


def check_flash_decode(g):
    """The dense flash-decode kernel at generate's shape: bf16 queries
    and f32 queries over one bf16 cache, lengths from 0 to L."""
    from nezha_tpu_torch.ops.cuda import (flash_decode_attention,
                                          flash_decode_attention_plain)
    import torch.nn.functional as F

    lengths_list = [0, 1, 17, 300, 511, 768, 1000, DEC_L]
    b = len(lengths_list)
    bf = torch.bfloat16
    q32 = torch.randn(b, H, 1, D, generator=g).cuda()
    k = torch.randn(b, H, DEC_L, D, generator=g).to("cuda", bf)
    v = torch.randn(b, H, DEC_L, D, generator=g).to("cuda", bf)
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    worst = worst_ratio = 0.0
    for q in (q32.to(bf), q32):
        got = flash_decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        want = flash_decode_attention_plain(q, k, v, lengths)
        abs_v = flash_decode_attention_plain(q, k, v.abs(), lengths)
        err, ratio = within_bound(f"flash_decode q {q.dtype}", got, want,
                                  abs_v)
        if not torch.all(got[0] == 0):
            fail("flash_decode: the length-0 row is not exact zero")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    q = q32.to(bf)
    timed = torch.full((b,), 768, dtype=torch.int32, device="cuda")
    args = (q, k, v, timed)
    ms = gpu_time_ms(lambda: flash_decode_attention(*args), 100)
    plain_ms = gpu_time_ms(lambda: flash_decode_attention_plain(*args), 5)
    mask = (torch.arange(DEC_L, device="cuda")[None, :]
            < timed[:, None])[:, None, None, :]
    library_ms = gpu_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 100)
    total = 768 * b
    nbytes = (2 * b * H * D * 2                     # q in, out
              + 2 * total * H * D * 2               # K and V read once
              + b * 4)
    bound_ms, bound_by = bound(nbytes, 4 * total * H * D)
    return {"name": "flash_decode", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/flash_decode.cu",
            "replaces": "nezha_tpu/ops/pallas/decode_attention.py:63",
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"B={b} H={H} L={DEC_L} D={D} bf16 cache, timed at "
                     f"length 768; checked lengths={lengths_list}, bf16 "
                     f"and f32 q"}


def check_layer_norm(g):
    """The LayerNorm kernels at the train step's rows (B*S = 8192) and at
    8 and 37 rows, D=768, bf16 x; -> the kernels line's two entries."""
    from nezha_tpu_torch.ops.cuda.layer_norm import (
        layer_norm_bwd, layer_norm_bwd_plain, layer_norm_error_bound,
        layer_norm_fwd, layer_norm_fwd_plain)
    import torch.nn.functional as F

    d, eps, bf = LN_D, 1e-5, torch.bfloat16
    worst = {"layer_norm_fwd": (0.0, 0.0), "layer_norm_bwd": (0.0, 0.0)}
    timing = {}
    for rows in (TRAIN_B * TRAIN_S, 8, 37):
        x = (torch.randn(rows, d, generator=g) * 2
             + torch.randn(rows, 1, generator=g)).to("cuda", bf)
        dy = torch.randn(rows, d, generator=g).to("cuda", bf)
        scale = (1 + 0.3 * torch.randn(d, generator=g)).cuda()
        bias = (0.2 * torch.randn(d, generator=g)).cuda()
        y = layer_norm_fwd(x, scale, bias, eps)
        torch.cuda.synchronize()
        res = [within(f"layer_norm_fwd rows={rows}", y,
                      layer_norm_fwd_plain(x, scale, bias, eps),
                      layer_norm_error_bound(x, scale, bias, eps))]
        grads = layer_norm_bwd(x, scale, dy, eps)
        torch.cuda.synchronize()
        plain = layer_norm_bwd_plain(x, scale, dy, eps)
        bounds = layer_norm_error_bound(x, scale, bias, eps, dy=dy)
        bwd = []
        for name, got, want, bd in zip(
                ("dx", "dscale", "dbias"),
                (grads[0], grads[1].sum(0), grads[2].sum(0)),
                (plain[0], plain[1].sum(0), plain[2].sum(0)), bounds):
            bwd.append(within(f"layer_norm_bwd rows={rows} {name}", got,
                              want, bd))
        res.append((max(e for e, _ in bwd), max(r for _, r in bwd)))
        again = layer_norm_bwd(x, scale, dy, eps)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            fail(f"layer_norm_bwd rows={rows}: two runs differ")
        for name, (err, ratio) in zip(worst, res):
            worst[name] = (max(worst[name][0], err),
                           max(worst[name][1], ratio))
        if rows != TRAIN_B * TRAIN_S:
            continue
        # F.layer_norm on the card takes scale and bias in x's dtype.
        xg, sg, bg = (t.detach().to(bf).requires_grad_()
                      for t in (x, scale, bias))
        lib = lambda: F.layer_norm(xg, (d,), sg, bg, eps)
        lib_fwd = gpu_time_ms(lib, 50)
        lib_both = gpu_time_ms(
            lambda: torch.autograd.grad(lib(), (xg, sg, bg), dy), 50)
        elems = rows * d
        timing = {
            "layer_norm_fwd": {
                "ms": gpu_time_ms(
                    lambda: layer_norm_fwd(x, scale, bias, eps), 50),
                "plain_ms": gpu_time_ms(
                    lambda: layer_norm_fwd_plain(x, scale, bias, eps), 5),
                "library_ms": lib_fwd,
                # x in, y out (bf16), scale and bias in; ~8 fp32 ops each
                "bound": bound(2 * elems * 2 + 2 * d * 4, 8 * elems,
                               FP32_FLOPS_PER_S)},
            "layer_norm_bwd": {
                "ms": gpu_time_ms(
                    lambda: layer_norm_bwd(x, scale, dy, eps), 50),
                "plain_ms": gpu_time_ms(
                    lambda: layer_norm_bwd_plain(x, scale, dy, eps), 5),
                "library_ms": lib_both - lib_fwd,
                # x, dy in, dx out (bf16), scale in, dscale and dbias
                # out; ~19 fp32 ops each
                "bound": bound(3 * elems * 2 + 3 * d * 4, 19 * elems,
                               FP32_FLOPS_PER_S)}}
    out = []
    for name, line in (("layer_norm_fwd", 24), ("layer_norm_bwd", 33)):
        t = timing[name]
        out.append({"name": name, "route": "cuda",
                    "source": "nezha_tpu_torch/csrc/layer_norm.cu",
                    "replaces": f"nezha_tpu/ops/pallas/layer_norm.py:{line}",
                    "max_abs_err": worst[name][0],
                    "err_over_tolerance": worst[name][1], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                    "bound_by": t["bound"][1],
                    "library_ms": t["library_ms"],
                    "shape": f"rows={TRAIN_B * TRAIN_S} D={d} bf16 x, fp32 "
                             f"scale/bias; checked rows 8192, 8, 37"})
    out[1]["library_covers"] = "dx, dscale and dbias"
    return out


def compare_steps(what: str, model, ref, batch) -> dict:
    """One AdamW step of ``model`` against the same step of ``ref`` from
    the same weights and batch: the loss within TRAIN_LOSS_ATOL, each
    gradient within TRAIN_GRAD_RTOL of its norm, the weights after the
    step within 2 * lr. Both models are updated."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import make_train_step

    steps = [make_train_step(m, adamw(TRAIN_LR, weight_decay=0.1), lm_loss)
             for m in (model, ref)]
    loss, grads = steps[0].loss_and_grads(batch)
    loss_r, grads_r = steps[1].loss_and_grads(batch)
    loss_err = abs(loss.item() - loss_r.item())
    if not math.isfinite(loss.item()) or loss_err > TRAIN_LOSS_ATOL:
        fail(f"train {what}: loss {loss.item()} vs reference "
             f"{loss_r.item()} (tolerance {TRAIN_LOSS_ATOL})")
    worst_grad = 0.0
    for name, g in grads.items():
        gr = grads_r[name]
        rel = ((g - gr).norm() / gr.norm().clamp_min(1e-30)).item()
        worst_grad = max(worst_grad, rel)
        if not rel <= TRAIN_GRAD_RTOL:
            fail(f"train {what}: gradient of {name} differs by {rel} of its "
                 f"norm (tolerance {TRAIN_GRAD_RTOL})")
    del grads, grads_r
    for st in steps:
        st(batch)
    worst_w = max((pa - pb).abs().max().item() for pa, pb in zip(
        steps[0].params.values(), steps[1].params.values()))
    if not worst_w <= 2 * TRAIN_LR + 1e-6:
        fail(f"train {what}: weights after one step differ by {worst_w} > "
             f"2 * lr")
    return {"loss": loss.item(), "loss_reference": loss_r.item(),
            "loss_err": loss_err, "max_grad_rel_err": worst_grad,
            "max_weight_err_after_step": worst_w}


def timed_fit(model, batches, n_steps: int, counters, per_step, card: str):
    """2 warm-up steps, then ``n_steps`` through ``Trainer.fit`` on the
    host clock (ended by a device sync), every count in ``counters`` set
    to 0 just before; each kernel in ``per_step`` must launch exactly
    that many times per step. -> (stats, launches)."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import Trainer

    b, s = TRAIN_B, TRAIN_S
    trainer = Trainer(model, adamw(TRAIN_LR, weight_decay=0.1), lm_loss,
                      log_every=0)
    trainer.fit(batches, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        for name in c:
            c[name] = 0
    t0 = time.perf_counter()
    last = trainer.fit(batches, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: n for c in counters for name, n in c.items()}
    for name, want in per_step.items():
        if launches[name] != want * n_steps:
            fail(f"train: {name} launched {launches[name]} times in "
                 f"{n_steps} steps, not {want} per step")
    if not math.isfinite(last["loss"]):
        fail(f"train: loss {last['loss']}")
    n_params = sum(p.numel() for p in model.parameters())
    cfg = model.cfg
    step_flops = (6 * n_params + 6 * cfg.num_layers * cfg.hidden_size * s) \
        * b * s
    return {"B": b, "S": s, "ln_impl": cfg.ln_impl, "steps": n_steps,
            "ms_per_step": wall / n_steps * 1e3,
            "tokens_per_s": b * s * n_steps / wall,
            "mfu": step_flops * n_steps / wall / BF16_FLOPS_PER_S,
            "step_tflop": step_flops / 1e12, "params": n_params,
            "last_loss": last["loss"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches, "card": card}, launches


def train(card: str):
    """-> {"train": flash launches of the default run, "train_ln": flash
    and LayerNorm launches of the ln_impl="pallas" run}."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.data import synthetic_token_batches
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.ops.cuda.layer_norm import LAUNCHES as LN_LAUNCHES
    from nezha_tpu_torch.optim import adamw
    from nezha_tpu_torch.train import make_train_step

    b, s = TRAIN_B, TRAIN_S
    layers = 12
    batches = synthetic_token_batches(b, seq_len=s, seed=0)
    batch = next(batches)

    def fresh(**kw):
        return gpt2_for_preset("full", seed=0, device="cuda",
                               fused_loss_chunk=-1, **kw)

    # (a) one step, flash against composed attention, same weights.
    model = fresh()
    ref = fresh(attn_impl="xla")
    ref.load_state_dict(model.state_dict())
    print(json.dumps({"train_vs_composed": compare_steps(
        "flash vs composed attention", model, ref, batch)}), flush=True)
    del ref
    # (e) one step, the LayerNorm kernels against the xla LayerNorm.
    ln_model, ref = fresh(ln_impl="pallas"), fresh()
    ref.load_state_dict(ln_model.state_dict())
    print(json.dumps({"train_ln_vs_xla_ln": compare_steps(
        "ln_impl pallas vs xla", ln_model, ref, batch)}), flush=True)
    del ln_model, ref
    torch.cuda.empty_cache()

    # (b) the loss on one fixed batch falls at a constant lr.
    model = fresh()
    step = make_train_step(model, adamw(TRAIN_LR, weight_decay=0.1),
                           lm_loss)
    losses = [step(batch)["loss"].item() for _ in range(10)]
    if not (all(map(math.isfinite, losses))
            and losses[-1] <= losses[0] - LOSS_DROP):
        fail(f"train: fixed-batch loss did not fall by {LOSS_DROP}: "
             f"{losses}")
    print(json.dumps({"fixed_batch_losses": losses}), flush=True)
    del step

    # (c) + (d): the main path, Trainer.fit over the synthetic stream.
    stats, launches = timed_fit(model, batches, 10, [LAUNCHES],
                                {n: layers for n in LAUNCHES}, card)
    print(json.dumps({"train": stats}), flush=True)
    del model
    torch.cuda.empty_cache()
    # (f) the same run with the LayerNorm kernels.
    ln_stats, ln_launches = timed_fit(
        fresh(ln_impl="pallas"), batches, 10, [LAUNCHES, LN_LAUNCHES],
        {**{n: layers for n in LAUNCHES},
         **{n: 2 * layers + 1 for n in LN_LAUNCHES}}, card)
    print(json.dumps({"train_ln_pallas": ln_stats,
                      "default_ms_per_step": stats["ms_per_step"],
                      "ln_pallas_over_default": ln_stats["ms_per_step"]
                      / stats["ms_per_step"]}), flush=True)
    torch.cuda.empty_cache()
    return {"train": launches, "train_ln": ln_launches}


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
    """Every request against the no-cache causal forward with composed
    attention (a copy of the model with ``attn_impl="xla"``, so the
    reference runs no kernel) over prompt + generated tokens
    (teacher-forced): the prompt's last-position logits from a fresh
    paged prefill must lie within SERVE_LOGIT_ATOL, and each generated
    token must be the reference argmax wherever the reference's top-2
    margin exceeds that tolerance."""
    from nezha_tpu_torch.models.gpt2 import GPT2

    engine = sched.engine
    reference = GPT2(dataclasses.replace(model.cfg, attn_impl="xla"),
                     policy=model.policy, device="cuda")
    reference.load_state_dict(model.state_dict())
    reference.eval()
    worst = 0.0
    checked = 0
    for r in reqs:
        res = sched.results[r.request_id]
        seq = list(r.prompt) + res.tokens[:-1]
        ref = reference(torch.tensor([seq], device="cuda"))[0]  # [T, V]
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


@torch.no_grad()
def generate_phase(card: str):
    """KV-cache generation of GPT-2 124M with the LayerNorm kernels:
    greedy, timed, launch-counted and cross-checked, then one sampled
    call; -> the greedy run's launches."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.models import GPT2, generate, init_cache
    from nezha_tpu_torch.ops.cuda import flash_decode_attention
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.ops.cuda.layer_norm import LAUNCHES as LN_LAUNCHES

    model = gpt2_for_preset("full", seed=0, device="cuda", ln_impl="pallas")
    model.eval()
    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, vocab, (GEN_B, GEN_PROMPT), generator=g).cuda()
    generate(model, prompt[:, :16], 4)          # warm-up
    torch.cuda.synchronize()
    for c in (LAUNCHES, LN_LAUNCHES):
        for name in c:
            c[name] = 0
    flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = generate(model, prompt, GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**LAUNCHES, **LN_LAUNCHES,
                "flash_decode": flash_decode_attention.launches}
    want = {"flash_fwd": layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_decode": (GEN_NEW - 1) * layers,
            "layer_norm_fwd": GEN_NEW * (2 * layers + 1),
            "layer_norm_bwd": 0}
    if launches != want:
        fail(f"generate: launches {launches}, expected {want}")
    t0 = time.perf_counter()
    generate(model, prompt, 1)                  # prefill + first token
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    print(json.dumps({"generate": {
        "B": GEN_B, "prompt_len": GEN_PROMPT, "new_tokens": GEN_NEW,
        "ln_impl": "pallas", "wall_s": wall, "ttft_s": ttft,
        "decode_ms_per_step": (wall - ttft) / (GEN_NEW - 1) * 1e3,
        "tokens_per_s": GEN_B * GEN_NEW / wall, "launches": launches,
        "card": card}}), flush=True)

    # Cross-check, teacher-forced, against the no-cache forward of a copy
    # that runs no kernel.
    reference = GPT2(dataclasses.replace(model.cfg, attn_impl="xla",
                                         ln_impl="xla"),
                     policy=model.policy, device="cuda")
    reference.load_state_dict(model.state_dict())
    reference.eval()
    first = model(prompt, cache=init_cache(model, GEN_B, GEN_PROMPT),
                  pos=0, prefill=True)[:, -1]     # generate's own prefill
    ref = reference(out[:, :-1])[:, GEN_PROMPT - 1:]    # [B, N, V]
    err = (first - ref[:, 0]).abs().max().item()
    if not math.isfinite(err) or err > SERVE_LOGIT_ATOL:
        fail(f"generate: prompt's last logits differ by {err} > "
             f"{SERVE_LOGIT_ATOL}")
    top2 = ref.topk(2, dim=-1).values
    checked = (top2[..., 0] - top2[..., 1]) > SERVE_LOGIT_ATOL
    wrong = (out[:, GEN_PROMPT:] != ref.argmax(dim=-1)) & checked
    if wrong.any():
        b, i = map(int, wrong.nonzero()[0])
        fail(f"generate: row {b} token {i} is {int(out[b, GEN_PROMPT + i])}"
             f", reference {int(ref[b, i].argmax())}")
    del ref, top2

    # One sampled call: it finishes, and each token lies in its step's
    # top 40 by the same weights' teacher-forced logits (which differ
    # from the step's own by rounding only: SERVE_LOGIT_ATOL).
    gen = torch.Generator(device="cuda").manual_seed(0)
    sampled = generate(model, prompt, GEN_NEW, temperature=0.8, top_k=40,
                       top_p=0.95, generator=gen)
    own = model(sampled[:, :-1])[:, GEN_PROMPT - 1:]
    kth = own.topk(40, dim=-1).values[..., -1]
    picked = own.gather(-1, sampled[:, GEN_PROMPT:, None])[..., 0]
    outside = int((picked < kth - SERVE_LOGIT_ATOL).sum())
    if sampled.shape != out.shape or outside:
        fail(f"generate: sampled {tuple(sampled.shape)}, {outside} tokens "
             f"outside their step's top 40")
    print(json.dumps({"generate_cross_check": {
        "prompt_logit_err": err, "tokens_checked": int(checked.sum()),
        "tokens": GEN_B * GEN_NEW,
        "sampled_distinct_tokens": int(sampled[:, GEN_PROMPT:].unique()
                                       .numel())}}), flush=True)
    return launches


# The run whose launch count each kernel reports: the path it serves.
HOME_PATH = {"paged_decode": "serve", "paged_prefill": "serve",
             "flash_fwd": "train", "flash_bwd_dq": "train",
             "flash_bwd_dkv": "train", "flash_decode": "generate",
             "layer_norm_fwd": "generate", "layer_norm_bwd": "train_ln"}


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
    kernels = ([check_decode(g), check_prefill(g)] + check_flash(g)
               + [check_flash_decode(g)] + check_layer_norm(g))
    phase("train")
    paths = train(card)
    phase("serve")
    paths["serve"] = serve(card)
    phase("generate")
    paths["generate"] = generate_phase(card)
    for k in kernels:
        home = HOME_PATH[k["name"]]
        k["launches"] = paths[home][k["name"]]
        k["launches_path"] = home
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()
                                 if k["name"] in c}
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the {home} path")
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
