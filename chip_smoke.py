"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and ``nvidia-smi``'s name and power limit;
2. build: compiles every CUDA kernel from ``nezha_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and prints the build time;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes in bf16 (GPT-2 124M: H=12, D=64, pool blocks
   of 16, 64 blocks per row), with its time on the device (``device_time``:
   L2 flushed and the device held in a spin before each call, so no host
   gap is timed; three repeats; the profiler's per-kernel time beside
   it; the rig's zero point, an empty launch timed the same way, printed
   once and beside every row with the row's ms less it), the plain
   version's time, the bound (bytes the call must move
   over 3.35 TB/s vs its flops over 989 TFLOP/s, from this run's lengths
   and starts) and, as a yardstick only, ``scaled_dot_product_attention``
   on the same K/V gathered dense, pinned to a backend that it names;
   each output element must lie within ``fold_error_bound`` of the plain
   one; any host-late timed call fails the phase. The float paged decode
   kernel (B7), split over the KV length, on all four (q, pool) dtype
   pairs (lengths 0-1024 and on the first splits' boundaries), the
   length-0 row exact zero and two runs bitwise equal; timed on the
   serving rows at H=12 and at H=3 (a shard of the 4-way mesh), with its
   split size and the grid its library recorded at the launch;
   The three flash-attention training kernels are held the same way in
   bf16 at GPT-2's training shape (B=8, H=12, S=1024, D=64, causal) and
   on a non-causal case, a ``kv_lengths`` case with a zero-length row,
   an odd S=100, D=128 at S=1024 with lengths [0, 700], D=40 at S=200,
   and S=130 at B*H=6 (lse and delta rows at odd multiples of 4 bytes):
   the forward's output within ``fold_error_bound`` and its lse within
   LSE_ATOL, dq/dk/dv within ``flash_bwd_error_bound``, the delta
   pre-pass (which dq and dK/dV both read) within 2 D 2^-24 of each row's
   sum |dO * O| of its plain version, padded keys' dk/dv exactly zero,
   and two backward runs bitwise equal. B2 is timed alone on the
   pre-pass's delta, B3 with the pre-pass, and the whole backward beside
   SDPA's. Yardstick: SDPA's forward, and its backward alone
   (``torch.autograd.grad`` of a forward run outside the timer). Each
   flash row carries the SASS counts (``cuobjdump``) of ``HGMMA`` and
   ``UTMALDG`` in its kernels' instantiations; every instantiation of the
   Hopper bodies of B1-B3 must have both, and their first bodies must not
   be built for bf16.
   The dense flash-decode kernel, split over the KV length, on all four
   (q, cache) dtype pairs at L=1024, D=64 (lengths 0-1024 and on the
   first splits' boundaries) within ``fold_error_bound``, the length-0
   row exact zero and two runs bitwise equal; timed at generate's shape
   (B=8, H=12, bf16) with every row at length 768, with its split size
   and the grid its library recorded at the launch; yardstick SDPA with
   a ``[B, 1, 1, L]`` length mask. The LayerNorm
   forward and backward kernels at D=768, bf16, on 8, 37, 4096 and 8192
   rows within ``layer_norm_error_bound``, both bitwise repeatable; the
   forward timed at the rows each path gives it (8: a generate decode
   step; 4096: generate's prefill; 8192: a train step), each beside
   ``F.layer_norm`` on the same rows and its own bound; the backward (dx,
   and dscale and dbias, summed by its second kernel) at 8192 rows beside
   ``F.layer_norm``'s backward alone.
   The int8 paged decode kernel (B8), split over the KV length, at the
   serving shapes over int8 pools quantized with
   ``ops.quant.quantize_kv_block`` from random bf16 values (bf16 and f32
   queries; lengths 0-1024) within ``fold_error_bound``, the length-0 row
   exact zero and two runs bitwise equal, with its split size and the
   grid its library recorded at the launch; yardstick SDPA over the K/V
   dequantized and gathered dense (the dequant outside the timed
   region). The int8 prefill kernel with its fused block
   write (B10) at chunk width 256 from starts 0, 300 and 768 and width 37:
   the output within ``fold_error_bound``, every data block and scale
   after the call bitwise equal to the plain version's, untouched blocks
   unchanged, the error sample within 1e-6 relative, two runs bitwise
   equal; yardstick SDPA over the dequantized prefix and the chunk with
   the offset causal mask (it leaves out the write). The q-offset prefill
   kernel (B11) at the ring hop's shape on a 4-shard mesh (one row, H=3,
   and again H=12; a 256-row chunk from starts 0, 300 and 768; each of
   its four 64-query slices at ``q_offsets = starts + 64k``): within
   ``fold_error_bound`` of its plain version, each slice bitwise equal to
   B9's rows of the full chunk, and ``q_offsets = starts`` over the whole
   chunk bitwise equal to B9; yardstick SDPA over the prefix gathered
   dense and the chunk with the offset causal mask;
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
   10 timed steps with ``ln_impl="pallas"``, each LayerNorm kernel (the
   forward, the backward and its sums) launched exactly 25 times per step
   (2 per block + ``ln_f``);
5. serve: GPT-2 124M at full width, seeded random weights, bf16, eight
   greedy requests through ``Scheduler`` (prompts of 5-900 tokens, some
   prefilled in chunks, two sharing a 128-token prefix); requires every
   request to finish, both paged kernels launched on the path, a clean
   ``leak_check()``, and agreement with the port's no-cache causal
   forward with composed attention (``attn_impl="xla"``, independent of
   every kernel) on the card (see SERVE_LOGIT_ATOL); then the same eight
   requests on a second engine with ``kv_dtype="int8"``: every request
   finishes, the int8 kernels (B8, B10) launch and the float ones (B7,
   B9) do not, a clean ``leak_check()``, a prefix hit, and the same
   cross-check under INT8_SERVE_LOGIT_ATOL; it prints the largest
   per-chunk dequant error and both pools' bytes per block;
5b. serve_seq: the same weights on ``ShardedEngine(mesh_devices=4,
   devices=[cuda:0] * 4)`` (one card, its four shards run one after
   another) with ``prefill_mode="sequence"``, ``seq_prefill_variant=
   "ring"`` and ``long_prefill_buckets=(512, 1024)``: the serve phase's
   eight requests plus a 960-token one; every request finishes, B11
   launches 4 x 4 x 12 times per prefill chunk and B9/B10 never, B7 4 x
   12 times per decode step, a prefix hit, a clean ``leak_check()`` of
   every shard, the cross-check under SERVE_LOGIT_ATOL; then a ulysses
   engine on the same mesh (B9 per shard): identical tokens and, from a
   cold prefill of each prompt at its own bucket widths (the prefix cache
   emptied first; 512 and 1024 among them), bitwise-equal last-prompt
   logits; then a ulysses engine
   on int8 pools (B10, B8): the cross-check under INT8_SERVE_LOGIT_ATOL.
   Prints ``memory_report()``, the 960-token prompt's TTFT and the wall
   time;
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
import functools
import gc
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
# Served logits from an int8 pool vs the same no-cache forward: on top of
# the bf16 drift above, every cached K/V element carries a dequant error
# of at most amax/254 of its (block, head) — about one bf16 rounding
# (2^-9 relative) of the block's largest element — so the drift is of the
# same order as bf16's.
INT8_SERVE_LOGIT_ATOL = 0.125
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
# - gradients: per tensor, ||g_flash - g_xla|| <= 0.03 ||g_xla|| (a few
#   bf16 roundings compounded over 12 layers): twice the largest spread
#   tools/grad_spread.py measured on the H100 over six seeds (0.0149, an
#   LN scale or the position embedding; the median tensor ~0.010);
# - weights after one AdamW step: the first update is lr * g / (|g| +
#   eps), ~lr * sign(g), so where |g| is near eps a rounding flips it;
#   |w_flash - w_xla| <= 2 * lr + 1e-6 bounds that.
TRAIN_LOSS_ATOL = 0.02
TRAIN_GRAD_RTOL = 0.03
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
SEQ_MESH = 4                      # serve_seq's shards, all on one card

H, D, BS, M = 12, 64, 16, 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# The device timer. A kernel's time is taken on the device, not across
# its wrapper's host work: before each timed call the L2 cache is flushed
# (the serving path meets each layer's K/V cold) and the device is held in
# a spin (torch.cuda._sleep) long enough that the host enqueues the start
# event, the call and the end event while it still spins. A call whose
# start event had already completed when the host finished enqueueing was
# late: the gap before its launch is in its time. Every timed row counts
# such calls (host_late). A row with a late call is timed again from the
# start with twice the spin, up to TIMING_ATTEMPTS times (the late counts
# of the attempts set aside are kept in host_late_retried), and the
# kernels phase fails if its last attempt still had one. Each row is
# TIMED_REPEATS repeats of `iters` calls: ms is the mean of the repeats'
# means, ms_spread their min / median / max. A call over OUTLIER_FACTOR
# times its repeat's median call (a stall of the device, not the kernel's
# work) is left out of the mean and counted (outliers). Beside it,
# PROFILED_CALLS
# calls under torch.profiler give each launched kernel's device time
# (profiler_kernels) and their sum per call (profiler_us); a row whose
# event time and profiler time differ by more than DISAGREE_REL of the
# profiler time and more than DISAGREE_US is flagged (profiler_disagrees).
# The rig's zero point (empty_row): an empty launch, torch.cuda._sleep(0),
# timed the same way, EMPTY_ITERS calls a repeat; every row carries it
# (empty_ms) and its ms less it (ms_less_empty) beside its ms, which
# stays what the events read.
TIMED_REPEATS = 3
SLEEP_FLOOR_MS = 2.0      # the least device spin before a timed call
SLEEP_OVER_ENQUEUE = 8    # and at least this many times the host's enqueue
OUTLIER_FACTOR = 4.0
TIMING_ATTEMPTS = 3
PROFILED_CALLS = 5
PROFILE_ATTEMPTS = 3      # a profile that lost events is taken again
PROFILE_SETTLE_S = 0.01   # host pause before a profiling cycle closes
DISAGREE_REL, DISAGREE_US = 0.15, 5.0
EMPTY_ITERS = 200
FLUSH_BYTES = 64 << 20    # over the H100's 50 MB L2
# SDPA's backends in PyTorch's own order of preference; a yardstick runs
# pinned to the first that takes its inputs (library_backend).
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
TIMED_ROWS = []           # (label, ms, profiler_us, disagrees), in order


def repeat_mean(times):
    """The mean of one repeat's call times (ms) without its outliers ->
    (mean, outliers): a call over OUTLIER_FACTOR times the repeat's median
    call is an outlier."""
    v = sorted(times)
    median = spread(v)[1]
    kept = [t for t in v if t <= OUTLIER_FACTOR * median]
    return sum(kept) / len(kept), len(v) - len(kept)


def spread(values):
    """[min, median, max] of the repeats' means."""
    v = sorted(values)
    n = len(v)
    median = v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) / 2
    return [v[0], median, v[-1]]


def host_late_count(started) -> int:
    """Calls whose start event had completed by the time the host had
    enqueued the call and its end event."""
    return sum(1 for done in started if done)


def kernel_name(raw: str) -> str:
    """A profiler kernel name without return type, namespaces, template
    arguments or parameters: ``void ns::(anonymous namespace)::k<T>(T*)``
    -> ``k``."""
    name = raw.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    for stop in ("<", "("):
        if stop in name:
            name = name[:name.index(stop)]
    return name.split("::")[-1].strip()


def fold_profiler_events(events, calls: int, exclude=()):
    """Device events ``(raw name, us)`` of ``calls`` profiled calls ->
    ``{kernel: {"launches_per_call", "us_per_launch"}}``, leaving out the
    kernels named in ``exclude`` (the L2 flush's own)."""
    totals = {}
    for raw, us in events:
        name = kernel_name(raw)
        if name in exclude:
            continue
        n, t = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, t + us)
    return {name: {"launches_per_call": n / calls, "us_per_launch": t / n}
            for name, (n, t) in totals.items()}


def profiler_us(kernels) -> float:
    """Device microseconds per call summed over the call's kernels."""
    return sum(k["launches_per_call"] * k["us_per_launch"]
               for k in kernels.values())


def profiler_disagrees(event_ms: float, prof_us: float) -> bool:
    """The event time and the profiler time differ by more than
    DISAGREE_REL of the profiler time and by more than DISAGREE_US."""
    diff = abs(event_ms * 1e3 - prof_us)
    return diff > DISAGREE_REL * prof_us and diff > DISAGREE_US


def timing_fields(means, started, delay_ms, kernels, prefix="",
                  outliers=0, retried=(), empty_ms=None):
    """One timed row's fields from its repeats' means (ms), the start
    events' completion flags, the spin before each call, the profiled
    kernels, the calls left out as outliers, the late counts of attempts
    set aside and the rig's zero point (``empty_row``'s ms, None where
    it was not taken); ``prefix`` names a yardstick's fields
    (``library_``)."""
    ms = sum(means) / len(means)
    prof = profiler_us(kernels)
    return {f"{prefix}ms": ms, f"{prefix}empty_ms": empty_ms,
            f"{prefix}ms_less_empty": (None if empty_ms is None
                                       else ms - empty_ms),
            f"{prefix}ms_spread": spread(means),
            f"{prefix}outliers": outliers,
            f"{prefix}host_late": host_late_count(started),
            f"{prefix}host_late_retried": list(retried),
            f"{prefix}delay_ms": delay_ms, f"{prefix}profiler_us": prof,
            f"{prefix}profiler_kernels": kernels,
            f"{prefix}event_over_profiler": ms * 1e3 / prof if prof else None,
            f"{prefix}profiler_disagrees": profiler_disagrees(ms, prof)}


_FLUSH = []


def flush_l2() -> None:
    """Evict the L2 cache: a device-to-device copy of FLUSH_BYTES (a
    memcpy, not a kernel, so it never shares a name with a timed call's
    kernels)."""
    if not _FLUSH:
        _FLUSH.extend(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda") for _ in range(2))
    _FLUSH[0].copy_(_FLUSH[1])


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """The device spin's clock cycles per millisecond, measured."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    cycles = 10_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


@functools.lru_cache(maxsize=None)
def flush_kernel_names():
    """The device events the L2 flush itself shows under the profiler."""
    return frozenset(profiled_kernels(flush_l2, with_flush=False))


def profiled_kernels(fn, calls: int = PROFILED_CALLS,
                     with_flush: bool = True):
    """``calls`` calls of fn (each after an L2 flush) under torch.profiler
    -> fold_profiler_events of their device events. The profiler runs one
    warm-up cycle of the same calls before the recorded one (CUPTI drops
    events while it starts up), and each cycle closes PROFILE_SETTLE_S
    after the device is idle; a profile that still caught a fraction of a
    launch per call, or no device event, is taken again, up to
    PROFILE_ATTEMPTS times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    exclude = flush_kernel_names() if with_flush else ()
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    if with_flush:
                        flush_l2()
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_SETTLE_S)
                prof.step()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        kernels = fold_profiler_events(events, calls, exclude)
        if whole_launches(kernels):
            break
    return kernels


def whole_launches(kernels) -> bool:
    """Every kernel was caught a whole number of times a call (a call
    launches each of its kernels whole times), and at least one was."""
    return bool(kernels) and all(
        float(k["launches_per_call"]).is_integer() for k in kernels.values())


def timed_attempts(label: str, fn, iters: int, warmup: int = 3):
    """fn's timed repeats, retried with twice the spin while a call was
    host-late (see the timer's notes above) -> (means, started,
    outliers, delay_ms, retried); fails when the last attempt had a
    host-late call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    delay_ms = max(SLEEP_FLOOR_MS, SLEEP_OVER_ENQUEUE * enqueue_ms)
    retried = []
    for attempt in range(TIMING_ATTEMPTS):
        means, started, outliers = timed_repeats(fn, iters, delay_ms)
        late = host_late_count(started)
        if not late or attempt == TIMING_ATTEMPTS - 1:
            break
        retried.append(late)
        delay_ms *= 2
    if late:
        fail(f"{label}: {late} of {len(started)} timed calls were host-late "
             f"(the device finished a {delay_ms:.2f} ms spin before the "
             f"host had enqueued the call), after {retried} in earlier "
             f"attempts")
    return means, started, outliers, delay_ms, retried


def empty_call() -> None:
    """A launch that does no work: the timer's zero point."""
    torch.cuda._sleep(0)


@functools.lru_cache(maxsize=None)
def empty_row():
    """``empty_call`` on the rig every row is timed on -> its
    timing_fields (``ms`` is the zero point ``empty_ms`` of every other
    row), taken once a run."""
    means, started, outliers, delay_ms, retried = timed_attempts(
        "empty launch", empty_call, EMPTY_ITERS)
    return timing_fields(means, started, delay_ms,
                         profiled_kernels(empty_call), outliers=outliers,
                         retried=retried)


def device_time(label: str, fn, iters: int, warmup: int = 3,
                prefix: str = ""):
    """Time fn on the device (see the timer's notes above) -> its
    timing_fields, with the rig's zero point; fails when the last attempt
    had a host-late call."""
    zero = empty_row()["ms"]
    means, started, outliers, delay_ms, retried = timed_attempts(
        label, fn, iters, warmup)
    row = timing_fields(means, started, delay_ms, profiled_kernels(fn),
                        prefix, outliers, retried, zero)
    TIMED_ROWS.append((f"{label} {prefix}".strip(), row[f"{prefix}ms"],
                       row[f"{prefix}profiler_us"],
                       row[f"{prefix}profiler_disagrees"]))
    return row


def timed_repeats(fn, iters: int, delay_ms: float):
    """TIMED_REPEATS repeats of ``iters`` calls, each after an L2 flush
    and a ``delay_ms`` device spin -> (the repeats' means without their
    outliers, each call's start-event completion flag, outliers)."""
    cycles = int(delay_ms * sleep_cycles_per_ms())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means, started, outliers = [], [], 0
    gc.disable()
    try:
        for _ in range(TIMED_REPEATS):
            times = []
            for _ in range(iters):
                flush_l2()
                torch.cuda._sleep(cycles)
                start.record()
                fn()
                end.record()
                started.append(start.query())
                end.synchronize()
                times.append(start.elapsed_time(end))
            mean, dropped = repeat_mean(times)
            means.append(mean)
            outliers += dropped
    finally:
        gc.enable()
    return means, started, outliers


def library_time(label: str, fn, iters: int, backend: str):
    """A yardstick's device_time fields, prefixed ``library_``, with the
    backend it ran on."""
    return {**device_time(label, fn, iters, prefix="library_"),
            "library_backend": backend}


def plain_time_ms(fn, iters: int) -> float:
    """Mean ms of the plain PyTorch version from CUDA events around each
    call, the L2 flushed first. Its many small launches are host-bound,
    so this is host and device together; it is the plain version's cost,
    not a yardstick of the kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        flush_l2()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


TIMING_KEYS = ("ms", "empty_ms", "ms_less_empty", "ms_spread", "outliers",
               "host_late", "host_late_retried", "delay_ms", "profiler_us",
               "profiler_kernels", "event_over_profiler",
               "profiler_disagrees")


def reported(case):
    """The kernels line's timing fields of one timed case: the kernel's,
    its yardstick's, the plain version's time and the bound."""
    keys = (TIMING_KEYS + tuple(f"library_{k}" for k in TIMING_KEYS)
            + ("library_backend", "plain_ms", "bound_ms", "bound_by"))
    return {k: case[k] for k in keys}


def additive_mask(allowed, dtype):
    """A boolean attention mask as SDPA's kernels take it with no work of
    their own: 0 where allowed, -inf elsewhere, in the queries' dtype, a
    view whose rows start 16 elements apart. Made once, outside the timer,
    so a yardstick times the attention, not the mask's conversion."""
    n = allowed.shape[-1]
    buf = torch.full((*allowed.shape[:-1], -(-n // 16) * 16), float("-inf"),
                     dtype=dtype, device=allowed.device)
    mask = buf[..., :n]
    mask.masked_fill_(allowed, 0.0)
    return mask


def sdpa_yardstick(q, k, v, **kw):
    """``F.scaled_dot_product_attention(q, k, v, **kw)`` pinned to the
    first of SDPA_BACKENDS that takes these inputs -> (call, backend). A
    boolean ``attn_mask`` is passed in its additive form."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if kw.get("attn_mask") is not None and kw["attn_mask"].dtype == torch.bool:
        kw["attn_mask"] = additive_mask(kw["attn_mask"], q.dtype)

    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with sdpa_kernel(backend):
                    F.scaled_dot_product_attention(q, k, v, **kw)
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, **kw)
        return call, name
    fail(f"no SDPA backend takes q {tuple(q.shape)} {q.dtype}")


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


def fold_bound(want, want_abs_v, p_dtype=torch.bfloat16):
    """``fold_error_bound`` of an attention output whose p is rounded to
    ``p_dtype`` before P.V."""
    from nezha_tpu_torch.ops.cuda.common import fold_error_bound

    return fold_error_bound(want, want_abs_v, p_dtype == torch.bfloat16)


def within_bound(name: str, got, want, want_abs_v):
    """``within`` against ``fold_error_bound`` of an attention output."""
    return within(name, got, want, fold_bound(want, want_abs_v))


def worst_element(got, want, bound) -> dict:
    """The element with the largest ``|got - want| / bound``: both values,
    the error, the bound and, for a bf16 output, the error in units in the
    last place of ``want``."""
    err = (got.float() - want.float()).abs()
    i = int((err / bound).flatten().argmax())
    w, e = want.float().flatten()[i].item(), err.flatten()[i].item()
    row = {"want": w, "got": got.float().flatten()[i].item(), "err": e,
           "bound": bound.flatten()[i].item()}
    if want.dtype == torch.bfloat16 and w != 0.0:
        row["out_ulps"] = e / 2.0 ** (math.frexp(w)[1] - 8)
    return row


def check_paged_decode_case(tag: str, args, p_dtype) -> dict:
    """B7 on one case held against its plain version within
    ``fold_error_bound``, its length-0 rows exact zero and two runs
    bitwise equal -> max_abs_err, err_over_tolerance and the worst
    element."""
    from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                          paged_decode_attention_plain)

    q, kp, vp, lengths, tab = args
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    want = paged_decode_attention_plain(*args)
    abs_v = paged_decode_attention_plain(q, kp, vp.abs(), lengths, tab)
    bnd = fold_bound(want, abs_v, p_dtype)
    err, ratio = within(tag, got, want, bnd)
    if not torch.all(got[lengths == 0] == 0):
        fail(f"{tag}: a length-0 row is not exact zero")
    if not torch.equal(paged_decode_attention(*args), got):
        fail(f"{tag}: two runs differ")
    return {"max_abs_err": err, "err_over_tolerance": ratio,
            "worst": worst_element(got, want, bnd)}


def time_paged_decode(q, kp, vp, lengths, tab, label: str):
    """B7 on one bf16 case, checked first (``check_paged_decode_case``),
    with the device timer, beside SDPA over the rows' K/V gathered dense
    and masked by length, the plain version and the bound -> the row's
    fields."""
    from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                          paged_decode_attention_plain)

    b, h = q.shape[:2]
    args = (q, kp, vp, lengths, tab)
    checked = check_paged_decode_case(label, args, kp.dtype)
    timing = device_time(label, lambda: paged_decode_attention(*args), 100)
    timing["grid"] = launched_grid("paged_decode")
    if not math.prod(timing["grid"]):
        fail(f"{label}: no launch grid recorded ({timing['grid']})")
    timing["plain_ms"] = plain_time_ms(
        lambda: paged_decode_attention_plain(*args), 5)
    kd = kp[tab.long()].transpose(1, 2).reshape(b, h, M * BS, D)
    vd = vp[tab.long()].transpose(1, 2).reshape(b, h, M * BS, D)
    mask = (torch.arange(M * BS, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    sdpa, backend = sdpa_yardstick(q, kd, vd, attn_mask=mask)
    timing.update(library_time(label, sdpa, 100, backend))
    lens = lengths.tolist()
    total = sum(lens)
    nbytes = (2 * b * h * D * 2                     # q in, out
              + 2 * total * h * D * 2               # K and V read once
              + sum(math.ceil(x / BS) for x in lens) * 4 + b * 4)
    timing["bound_ms"], timing["bound_by"] = bound(nbytes, 4 * total * h * D)
    timing["timed_case"] = checked
    return timing


def check_decode(g):
    """B7, split over the KV length, at the serving shape's H=12 (the
    engine) and H=3 (a shard of the 4-way mesh): for each, all four (q,
    pool) dtype pairs over lengths 0-1024 and on the first splits'
    boundaries within ``fold_error_bound``, the length-0 row exact zero
    and two runs bitwise equal; then the serving rows of the same tensors
    in bf16, checked the same way and timed, with its split size and the
    grid its library recorded at the launch."""
    from nezha_tpu_torch.ops.cuda.decode_attention import split_size

    split = split_size("paged_decode")
    timed_lengths = [0, 1, 15, 16, 17, 300, 777, M * BS]
    lengths_list = timed_lengths + [split - 1, split, split + 1,
                                    2 * split + 1]
    b = len(lengths_list)
    n = 1 + b * M
    nb = len(timed_lengths)
    bf, f32 = torch.bfloat16, torch.float32
    tab = shuffled_tables(g, b, n).cuda()
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    worst = {"err_over_tolerance": -1.0}
    by_dtypes, timed = {}, {}
    h3 = H // SEQ_MESH
    for h in (h3, H):
        q32 = torch.randn(b, h, 1, D, generator=g).cuda()
        k32 = torch.randn(n, h, BS, D, generator=g).cuda()
        v32 = torch.randn(n, h, BS, D, generator=g).cuda()
        for q_dtype, pool_dtype in ((bf, bf), (f32, bf), (bf, f32),
                                    (f32, f32)):
            pair = f"H={h} q {q_dtype} pool {pool_dtype}"
            case = check_paged_decode_case(
                f"paged_decode {pair}",
                (q32.to(q_dtype), k32.to(pool_dtype), v32.to(pool_dtype),
                 lengths, tab), pool_dtype)
            by_dtypes[pair] = case["err_over_tolerance"]
            if case["err_over_tolerance"] > worst["err_over_tolerance"]:
                worst = {"pair": pair, **case}
        # Timed on the serving rows of the same tensors, in bf16.
        timed[h] = time_paged_decode(
            q32[:nb].to(bf), k32.to(bf), v32.to(bf), lengths[:nb], tab[:nb],
            "paged_decode" if h == H else f"paged_decode H={h}")
    timing = timed[H]
    return {"name": "paged_decode", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_decode.cu",
            "replaces": "nezha_tpu/ops/pallas/decode_attention.py:89",
            "max_abs_err": max(c["max_abs_err"] for c in (worst, *(
                t["timed_case"] for t in timed.values()))),
            "err_over_tolerance": max([*by_dtypes.values(), *(
                t["timed_case"]["err_over_tolerance"]
                for t in timed.values())]),
            "err_over_tolerance_by_dtypes": by_dtypes,
            "err_worst": {k: worst[k] for k in ("pair", "worst")},
            **timing, "split": split, "blocks": math.prod(timing["grid"]),
            "by_heads": {str(h3): timed[h3]},
            "shape": f"B={nb} H={H} D={D} bs={BS} M={M} bf16 q and pool, "
                     f"lengths={timed_lengths} (splits of {split} keys, "
                     f"grid {timing['grid']}); timed also at H={h3} "
                     f"(by_heads); checked B={b} lengths={lengths_list} at "
                     f"H={h3} and H={H}, all four (q, pool) dtype pairs, "
                     f"and each timed case"}


def check_prefill(g):
    from nezha_tpu_torch.ops.cuda import (paged_prefill_attention,
                                          paged_prefill_attention_plain)

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
            tag = f"paged_prefill S={s} start={start}"
            timing = device_time(tag, lambda: paged_prefill_attention(*args),
                                 50)
            plain_ms = plain_time_ms(
                lambda: paged_prefill_attention_plain(*args), 3)
            # Yardstick: SDPA over [prefix gathered dense ; chunk].
            pk = kp[tab[0].long()].transpose(0, 1).reshape(1, H, M * BS, D)
            pv = vp[tab[0].long()].transpose(0, 1).reshape(1, H, M * BS, D)
            kd = torch.cat([pk[:, :, :start], kc], dim=2)
            vd = torch.cat([pv[:, :, :start], vc], dim=2)
            mask = (torch.arange(start + s, device="cuda")[None, :]
                    <= start + torch.arange(s, device="cuda")[:, None])
            sdpa, backend = sdpa_yardstick(q, kd, vd, attn_mask=mask)
            timing.update(library_time(tag, sdpa, 50, backend))
            nbytes = (4 * s * H * D * 2                 # q, k, v in; out
                      + 2 * start * H * D * 2           # prefix K and V
                      + math.ceil(start / BS) * 4 + 4)
            flops = 4 * H * D * (s * start + s * (s + 1) // 2)
            bound_ms, bound_by = bound(nbytes, flops)
            cases.append({"S": s, "start": start, "max_abs_err": err,
                          "err_over_tolerance": ratio, **timing,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
    print(json.dumps({"paged_prefill_cases": cases}), flush=True)
    # The kernels line reports the widest chunk at the deepest start.
    rep = cases[-1]
    return {"name": "paged_prefill", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": "nezha_tpu/ops/pallas/prefill_attention.py:137",
            **reported(rep),
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            "shape": f"B=1 H={H} D={D} bs={BS} M={M} S={rep['S']} "
                     f"start={rep['start']}"}


def int8_pools(g, n: int):
    """int8 K/V pools [n, H, BS, D] and their [n, H] scales on the card,
    quantized from random bf16 values with the port's quantize_kv_block."""
    from nezha_tpu_torch.ops.quant import quantize_kv_block

    out = []
    for _ in range(2):
        x = torch.randn(n, H, BS, D, generator=g).to("cuda", torch.bfloat16)
        out += list(quantize_kv_block(x))
    return out            # kq, ks, vq, vs


def check_quant_decode(g):
    """B8 at the serving shapes, bf16 and f32 queries over int8 pools: the
    length-0 row exact zero, two runs bitwise equal; the split size and
    the grid its library recorded at the launch."""
    from nezha_tpu_torch.ops.cuda import (paged_quant_decode_attention,
                                          paged_quant_decode_attention_plain)
    from nezha_tpu_torch.ops.cuda.decode_attention import split_size
    from nezha_tpu_torch.ops.quant import dequantize_kv_block

    split = split_size("paged_quant_decode")
    lengths_list = [0, 1, 15, 16, 17, 300, 777, M * BS]
    b = len(lengths_list)
    n = 1 + b * M
    kq, ks, vq, vs = int8_pools(g, n)
    q32 = torch.randn(b, H, 1, D, generator=g).cuda()
    tab = shuffled_tables(g, b, n).cuda()
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    worst = worst_ratio = 0.0
    for q in (q32.to(torch.bfloat16), q32):
        args = (q, kq, vq, ks, vs, lengths, tab)
        got = paged_quant_decode_attention(*args)
        torch.cuda.synchronize()
        want = paged_quant_decode_attention_plain(*args)
        abs_v = paged_quant_decode_attention_plain(q, kq, vq.abs(), ks, vs,
                                                   lengths, tab)
        err, ratio = within(f"paged_quant_decode q {q.dtype}", got, want,
                            fold_bound(want, abs_v, q.dtype))
        if not torch.all(got[0] == 0):
            fail("paged_quant_decode: the length-0 row is not exact zero")
        if not torch.equal(paged_quant_decode_attention(*args), got):
            fail(f"paged_quant_decode q {q.dtype}: two runs differ")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    q = q32.to(torch.bfloat16)
    args = (q, kq, vq, ks, vs, lengths, tab)
    timing = device_time("paged_quant_decode",
                         lambda: paged_quant_decode_attention(*args), 100)
    grid = launched_grid("paged_quant_decode")
    if not math.prod(grid):
        fail(f"paged_quant_decode: no launch grid recorded ({grid})")
    plain_ms = plain_time_ms(
        lambda: paged_quant_decode_attention_plain(*args), 5)
    # Yardstick: SDPA over the rows' K/V dequantized (untimed) and
    # gathered dense, masked by length.
    kd, vd = (dequantize_kv_block(p[tab.long()], s[tab.long()], q.dtype)
              .transpose(1, 2).reshape(b, H, M * BS, D)
              for p, s in ((kq, ks), (vq, vs)))
    mask = (torch.arange(M * BS, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    sdpa, backend = sdpa_yardstick(q, kd, vd, attn_mask=mask)
    timing.update(library_time("paged_quant_decode", sdpa, 100, backend))
    total = sum(lengths_list)
    blocks = sum(math.ceil(x / BS) for x in lengths_list)
    nbytes = (2 * b * H * D * 2                     # q in, out (bf16)
              + 2 * total * H * D                   # int8 K and V read once
              + 2 * blocks * H * 4                  # their scales
              + blocks * 4 + b * 4)                 # table entries, lengths
    bound_ms, bound_by = bound(nbytes, 4 * total * H * D)
    return {"name": "paged_quant_decode", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_quant_decode.cu",
            "replaces": "nezha_tpu/ops/pallas/decode_attention.py:101",
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            **timing, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "split": split, "grid": grid,
            "blocks": math.prod(grid),
            "shape": f"B={b} H={H} D={D} bs={BS} M={M} int8 pools, bf16 q "
                     f"(also checked f32 q; splits of {split} keys, grid "
                     f"{grid}); lengths={lengths_list}"}


def check_quant_prefill(g):
    """B10: chunk width 256 from starts 0, 300 and 768, and width 37;
    the output within fold_error_bound, the write bitwise against the
    plain version's, two runs bitwise equal."""
    from nezha_tpu_torch.ops.cuda import (paged_quant_prefill_attention,
                                          paged_quant_prefill_attention_plain)
    from nezha_tpu_torch.ops.quant import dequantize_kv_block

    bf = torch.bfloat16
    n = 1 + M
    pools = int8_pools(g, n)
    tab = shuffled_tables(g, 1, n).cuda()
    worst = worst_ratio = 0.0
    cases = []
    for s, start in ((256, 0), (256, 300), (37, 100), (256, 768)):
        q, kc, vc = (torch.randn(1, H, s, D, generator=g).to("cuda", bf)
                     for _ in range(3))
        starts = torch.tensor([start], dtype=torch.int32, device="cuda")

        def run(fn, v_chunk=vc, v_abs=False):
            kq, ks, vq, vs = (t.clone() for t in pools)
            out, qerr = fn(q, kc, v_chunk, kq, vq.abs() if v_abs else vq,
                           ks, vs, tab, starts)
            return out, qerr, (kq, ks, vq, vs)

        tag = f"paged_quant_prefill S={s} start={start}"
        got, qerr, got_pools = run(paged_quant_prefill_attention)
        torch.cuda.synchronize()
        want, want_err, want_pools = run(paged_quant_prefill_attention_plain)
        abs_v = run(paged_quant_prefill_attention_plain, vc.abs(), True)[0]
        err, ratio = within_bound(tag, got, want, abs_v)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        for name, a, w in zip(("k", "k_scale", "v", "v_scale"), got_pools,
                              want_pools):
            if not torch.equal(a[1:], w[1:]):
                fail(f"{tag}: {name} after the write differs from the "
                     f"plain version's")
        touched = set(tab[0, start // BS:(start + s - 1) // BS + 1].tolist())
        untouched = [i for i in range(1, n) if i not in touched]
        for name, a, orig in zip(("k", "k_scale", "v", "v_scale"),
                                 got_pools, pools):
            if not torch.equal(a[untouched], orig[untouched]):
                fail(f"{tag}: an untouched {name} block changed")
        qerr_rel = abs(qerr.item() - want_err.item()) / want_err.item()
        if not qerr_rel <= 1e-6:
            fail(f"{tag}: qerr {qerr.item()} vs plain {want_err.item()}")
        again = run(paged_quant_prefill_attention)
        if not (torch.equal(again[0], got) and torch.equal(again[1], qerr)
                and all(torch.equal(a, b)
                        for a, b in zip(again[2], got_pools))):
            fail(f"{tag}: two runs differ")
        kq, ks, vq, vs = (t.clone() for t in pools)
        args = (q, kc, vc, kq, vq, ks, vs, tab, starts)
        timing = device_time(tag,
                             lambda: paged_quant_prefill_attention(*args), 50)
        plain_ms = plain_time_ms(
            lambda: paged_quant_prefill_attention_plain(*args), 3)
        # Yardstick: SDPA over [prefix dequantized (untimed) ; chunk],
        # offset-causal; it computes no block write.
        pk, pv = (dequantize_kv_block(p[tab[0].long()], sc[tab[0].long()],
                                      bf).transpose(0, 1)
                  .reshape(1, H, M * BS, D)
                  for p, sc in ((pools[0], pools[1]), (pools[2], pools[3])))
        kd = torch.cat([pk[:, :, :start], kc], dim=2)
        vd = torch.cat([pv[:, :, :start], vc], dim=2)
        mask = (torch.arange(start + s, device="cuda")[None, :]
                <= start + torch.arange(s, device="cuda")[:, None])
        sdpa, backend = sdpa_yardstick(q, kd, vd, attn_mask=mask)
        timing.update(library_time(tag, sdpa, 50, backend))
        n_touched = len(touched)
        nbytes = (4 * s * H * D * 2                 # q, k, v in; out (bf16)
                  + 2 * start * H * D               # int8 prefix K and V
                  + 2 * math.ceil(start / BS) * H * 4   # their scales
                  + 2 * 2 * n_touched * H * BS * D  # touched blocks r + w
                  + 2 * 2 * n_touched * H * 4       # their scales r + w
                  + math.ceil((start + s) / BS) * 4 + 4 + 4)
        flops = 4 * H * D * (s * start + s * (s + 1) // 2)
        bound_ms, bound_by = bound(nbytes, flops)
        cases.append({"S": s, "start": start, "max_abs_err": err,
                      "err_over_tolerance": ratio, "qerr": qerr.item(),
                      "qerr_rel_err": qerr_rel, **timing,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by})
    print(json.dumps({"paged_quant_prefill_cases": cases}), flush=True)
    rep = cases[-1]
    return {"name": "paged_quant_prefill", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/quant_prefill.cu",
            "replaces": "nezha_tpu/ops/pallas/prefill_attention.py:225",
            **reported(rep),
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            "library_covers": "the attention only, not the block write",
            "shape": f"B=1 H={H} D={D} bs={BS} M={M} int8 pools, bf16 q, "
                     f"S={rep['S']} start={rep['start']}; checked S=256 at "
                     f"0, 300, 768 and S=37 at 100"}


def check_prefill_qoff(g):
    """B11 at the ring hop's shapes: every 64-query slice of a 256-row
    chunk, H=3 (12 heads over 4 shards) and H=12, from starts 0, 300 and
    768; within fold_error_bound of the plain version and bitwise equal to
    B9's rows of the full chunk."""
    from nezha_tpu_torch.ops.cuda import (paged_prefill_attention,
                                          paged_prefill_qoff_attention,
                                          paged_prefill_qoff_attention_plain)

    bf = torch.bfloat16
    n = 1 + M
    s_kc = 256
    s_q = s_kc // SEQ_MESH
    worst = worst_ratio = 0.0
    cases = []
    for h in (H // SEQ_MESH, H):
        kp = torch.randn(n, h, BS, D, generator=g).to("cuda", bf)
        vp = torch.randn(n, h, BS, D, generator=g).to("cuda", bf)
        tab = shuffled_tables(g, 1, n).cuda()
        for start in (0, 300, 768):
            q, kc, vc = (torch.randn(1, h, s_kc, D, generator=g)
                         .to("cuda", bf) for _ in range(3))
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            full = paged_prefill_attention(q, kc, vc, kp, vp, tab, starts)
            tag = f"paged_prefill_qoff H={h} start={start}"
            if not torch.equal(paged_prefill_attention(
                    q, kc, vc, kp, vp, tab, starts, q_offsets=starts), full):
                fail(f"{tag}: q_offsets = starts differs from B9")
            for k in range(SEQ_MESH):
                rows = slice(k * s_q, (k + 1) * s_q)
                qs = q[:, :, rows].contiguous()
                qoff = starts + k * s_q
                args = (qs, kc, vc, kp, vp, tab, starts, qoff)
                got = paged_prefill_qoff_attention(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, full[:, :, rows]):
                    fail(f"{tag} slice {k}: not bitwise equal to B9's rows")
                want = paged_prefill_qoff_attention_plain(*args)
                abs_v = paged_prefill_qoff_attention_plain(
                    qs, kc, vc.abs(), kp, vp.abs(), tab, starts, qoff)
                err, ratio = within_bound(f"{tag} slice {k}", got, want,
                                          abs_v)
                worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
                if h != H // SEQ_MESH or start != 768:
                    continue
                # Timed: the ring hop's own shape, every slice.
                timing = device_time(
                    f"{tag} slice {k}",
                    lambda: paged_prefill_qoff_attention(*args), 50)
                plain_ms = plain_time_ms(
                    lambda: paged_prefill_qoff_attention_plain(*args), 3)
                # Yardstick: SDPA over [prefix gathered dense ; chunk],
                # the causal diagonal at the slice's offset.
                pk = kp[tab[0].long()].transpose(0, 1).reshape(1, h, M * BS,
                                                              D)
                pv = vp[tab[0].long()].transpose(0, 1).reshape(1, h, M * BS,
                                                              D)
                kd = torch.cat([pk[:, :, :start], kc], dim=2)
                vd = torch.cat([pv[:, :, :start], vc], dim=2)
                mask = (torch.arange(start + s_kc, device="cuda")[None, :]
                        <= start + k * s_q
                        + torch.arange(s_q, device="cuda")[:, None])
                sdpa, backend = sdpa_yardstick(qs, kd, vd, attn_mask=mask)
                timing.update(library_time(f"{tag} slice {k}", sdpa, 50,
                                           backend))
                keys = (k + 1) * s_q          # chunk rows the slice reaches
                nbytes = (2 * s_q * h * D * 2           # q in, out
                          + 2 * keys * h * D * 2        # chunk K and V
                          + 2 * start * h * D * 2       # prefix K and V
                          + math.ceil(start / BS) * 4 + 4 + 4)
                flops = 4 * h * D * (s_q * start + s_q * k * s_q
                                     + s_q * (s_q + 1) // 2)
                bound_ms, bound_by = bound(nbytes, flops)
                cases.append({"H": h, "start": start, "slice": k,
                              "S_q": s_q, "S_kc": s_kc, **timing,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by})
    print(json.dumps({"paged_prefill_qoff_cases": cases}), flush=True)
    rep = cases[-1]             # the last slice: the deepest diagonal
    return {"name": "paged_prefill_qoff", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": "nezha_tpu/ops/pallas/prefill_attention.py:167",
            **reported(rep),
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            "shape": f"B=1 H={rep['H']} D={D} bs={BS} M={M} S_q={s_q} "
                     f"S_kc={s_kc} start=768, slice {rep['slice']} "
                     f"(q_offset {768 + rep['slice'] * s_q}); checked H=3 "
                     f"and 12, starts 0, 300, 768, slices 0-3"}


def attended_pairs(s: int, causal: bool, lengths) -> int:
    """(query, key) pairs the masks leave, summed over rows."""
    pairs = 0
    for n in lengths:
        n = max(1, min(int(n), s))
        pairs += sum(min(i + 1, n) for i in range(s)) if causal else s * n
    return pairs


def flash_case(g, b, s, causal, lengths=None, timed=False, d=D, h=H):
    """Check the three flash kernels (and the dK/dV kernel's delta
    pre-pass) against their plain versions on one bf16 case; -> per-kernel
    errors, and times and bounds when timed."""
    from nezha_tpu_torch.ops.cuda.flash_attention import (
        _delta_launch, _dkv_launch, _dq_launch, _lengths, flash_block_bwd,
        flash_block_bwd_plain, flash_block_fwd, flash_block_fwd_plain,
        flash_bwd_delta_plain, flash_bwd_error_bound)

    bf = torch.bfloat16
    tag = (f"flash B={b} H={h} S={s} D={d} causal={causal}"
           + ("" if lengths is None else f" lengths={lengths}"))
    q, k, v, do = (torch.randn(b, h, s, d, generator=g).to("cuda", bf)
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
    # The pre-pass's delta against its plain version on the card: each
    # sums D fp32 products in its own order, off the exact sum by at most
    # D 2^-24 of the row's sum |dO * O|, so the two by twice that.
    delta = _delta_launch(want, do)
    torch.cuda.synchronize()
    row = (do.float() * want.float()).abs().sum(-1)
    delta_ratio = ((delta - flash_bwd_delta_plain(want, do)).abs()
                   / (2 * d * 2.0 ** -24 * row + 1e-30)).max().item()
    if not delta_ratio <= 1.0:
        fail(f"{tag}: delta off its plain version by {delta_ratio} of "
             f"its bound")
    res["lse_err"] = lse_err
    res["delta_err_over_tolerance"] = delta_ratio
    if not timed:
        return res
    lens_c = _lengths(lens, q, s)
    scale = 1.0 / d ** 0.5
    # B2 alone on the pre-pass's delta; B3 with the pre-pass, which its
    # row carries; then the whole backward (pre-pass, dq, dK/dV).
    timing = {
        "flash_fwd": device_time(
            "flash_fwd",
            lambda: flash_block_fwd(q, k, v, causal, kv_lengths=lens), 20),
        "flash_bwd_dq": device_time(
            "flash_bwd_dq", lambda: _dq_launch(q, k, v, want_lse, do, delta,
                                               lens_c, causal, scale), 20),
        "flash_bwd_dkv": device_time(
            "flash_bwd_dkv", lambda: _dkv_launch(
                q, k, v, want_lse, do, _delta_launch(want, do), lens_c,
                causal, scale), 20)}
    whole = device_time("flash_bwd",
                        lambda: flash_block_bwd(*bwd_args, kv_lengths=lens),
                        20)
    plain_fwd_ms = plain_time_ms(
        lambda: flash_block_fwd_plain(q, k, v, causal, kv_lengths=lens), 3)
    plain_bwd_ms = plain_time_ms(
        lambda: flash_block_bwd_plain(*bwd_args, kv_lengths=lens), 3)
    # Yardsticks: SDPA's forward (causal, no lengths), and its backward
    # alone: the forward runs once outside the timer on the same pinned
    # backend, then only torch.autograd.grad is timed.
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa, backend = sdpa_yardstick(qg, kg, vg, is_causal=causal)
    library = {"flash_fwd": library_time("flash_fwd", sdpa, 20, backend)}
    out_g = sdpa()
    sdpa_bwd = library_time(
        "flash_bwd", lambda: torch.autograd.grad(out_g, (qg, kg, vg), do,
                                                 retain_graph=True), 20,
        f"{backend} backward")
    library["flash_bwd_dq"] = library["flash_bwd_dkv"] = sdpa_bwd
    pairs = attended_pairs(s, causal, lengths or [s] * b) * h
    x = b * h * s * d * 2                     # one [B, H, S, D] bf16 tensor
    lse_bytes = b * h * s * 4                 # and one fp32 [B, H, S] row
    # dq reads q, k, v, dO, lse and delta and writes dq; dK/dV's row
    # carries the pre-pass, so it reads o too.
    bounds = {"flash_fwd": bound(4 * x + lse_bytes, 4 * pairs * d),
              "flash_bwd_dq": bound(5 * x + 2 * lse_bytes, 6 * pairs * d),
              "flash_bwd_dkv": bound(7 * x + lse_bytes, 8 * pairs * d)}
    plain_ms = {"flash_fwd": plain_fwd_ms, "flash_bwd_dq": plain_bwd_ms,
                "flash_bwd_dkv": plain_bwd_ms}
    res["timing"] = {n: {**timing[n], **library[n], "plain_ms": plain_ms[n],
                         "bound_ms": bounds[n][0], "bound_by": bounds[n][1]}
                     for n in timing}
    res["whole_backward"] = {
        "ms": whole["ms"], "ms_spread": whole["ms_spread"],
        "profiler_kernels": whole["profiler_kernels"],
        "sdpa_backward_ms": sdpa_bwd["library_ms"],
        "sdpa_backend": sdpa_bwd["library_backend"]}
    return res


FLASH_SOURCES = {
    "flash_fwd": ("nezha_tpu_torch/csrc/flash_fwd.cu",
                  "nezha_tpu/ops/pallas/flash_attention.py:91"),
    "flash_bwd_dq": ("nezha_tpu_torch/csrc/flash_bwd.cu",
                     "nezha_tpu/ops/pallas/flash_attention.py:228"),
    "flash_bwd_dkv": ("nezha_tpu_torch/csrc/flash_bwd.cu",
                      "nezha_tpu/ops/pallas/flash_attention.py:265"),
}


# Each flash row's kernels in the built libraries (SASS labels), and the
# Hopper bodies: every instantiation of these must issue wgmma (HGMMA)
# and TMA loads (UTMALDG).
FLASH_SASS = {"flash_fwd": ("flash_fwd_",),
              "flash_bwd_dq": ("flash_bwd_dq_",),
              "flash_bwd_dkv": ("flash_bwd_delta_", "flash_bwd_dkv_")}
HOPPER_BODIES = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel")
# The first bodies of B1-B3, built for fp32 only: bf16 runs the Hopper
# ones.
FIRST_BODIES = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel")


def sass_label(mangled: str) -> str:
    """A mangled flash kernel instantiation, readable: its dtype and
    integer template arguments, ``flash_bwd_dq_kernel<bf16, 8>``,
    ``flash_fwd_wgmma_kernel<64, 2, 128, 2>``."""
    import re

    m = re.search(r"(flash_[a-z_]+_kernel)I(.*?E)E*v", mangled)
    if not m:
        return mangled
    args = m.group(2)
    words = (["bf16"] if args.startswith("13__nv_bfloat16")
             else ["f32"] if args.startswith("f") else [])
    words += re.findall(r"Li(\d+)E", args)
    return f"{m.group(1)}<{', '.join(words)}>"


def flash_sass():
    """``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) counts of every kernel
    instantiation in the built flash libraries, from ``cuobjdump -sass``.
    Fails unless every instantiation of the three Hopper bodies (one or
    more each) issues both, or if a first body of B1-B3 was built for
    bf16."""
    import re
    from pathlib import Path

    from nezha_tpu_torch.ops.cuda import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([str(tool), "-sass",
                               str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        current = None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                current = sass_label(m.group(1))
                counts[current] = {"HGMMA": 0, "UTMALDG": 0}
            elif current:
                for op in counts[current]:
                    if re.search(rf"\b{op}\b", line):
                        counts[current][op] += 1
    for body in HOPPER_BODIES:
        inst = {k: c for k, c in counts.items() if k.startswith(body + "<")}
        if not inst or not all(c["HGMMA"] and c["UTMALDG"]
                               for c in inst.values()):
            fail(f"{body}: SASS instantiations {inst} lack HGMMA or UTMALDG")
    for body in FIRST_BODIES:
        if any(k.startswith(body + "<bf16") for k in counts):
            fail(f"{body} was built for bf16: {sorted(counts)}")
    return counts


def check_flash(g):
    """The flash kernels on seven cases; the kernels line reports the
    training shape's times, the worst error over all cases and each
    row's SASS counts."""
    main = flash_case(g, TRAIN_B, TRAIN_S, True, timed=True)
    cases = [main,
             flash_case(g, 4, TRAIN_S, False),
             flash_case(g, 4, TRAIN_S, True, lengths=[0, 1, 517, TRAIN_S]),
             flash_case(g, TRAIN_B, 100, True),
             flash_case(g, 2, TRAIN_S, True, lengths=[0, 700], d=128),
             flash_case(g, 2, 200, True, d=40),
             flash_case(g, 3, 130, True, lengths=[0, 77, 500], h=2)]
    print(json.dumps({"flash_cases": [
        {k: v for k, v in c.items() if k not in ("timing", "whole_backward")}
        for c in cases]}), flush=True)
    whole = main["whole_backward"]
    print(json.dumps({"flash_backward": {
        "shape": f"B={TRAIN_B} H={H} S={TRAIN_S} D={D} causal", **whole}}),
        flush=True)
    sass = flash_sass()
    out = []
    for name, (source, replaces) in FLASH_SOURCES.items():
        t = main["timing"][name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "max_abs_err": max(c[name][0] for c in cases),
                    "err_over_tolerance": max(c[name][1] for c in cases),
                    **t,
                    "shape": f"B={TRAIN_B} H={H} S={TRAIN_S} D={D} causal",
                    "sass": {k: c for k, c in sass.items()
                             if k.startswith(FLASH_SASS[name])}})
        if name != "flash_fwd":
            out[-1]["plain_covers"] = "dq, dk and dv together"
            out[-1]["library_covers"] = "dq, dk and dv together"
            out[-1]["whole_backward_ms"] = whole["ms"]
    return out


def launched_grid(kernel: str):
    """The grid (x, y, z) of a split decode kernel's last launch, as its
    library recorded it at the launch (``nezha_<kernel>_last_grid``)."""
    import ctypes
    from nezha_tpu_torch.ops.cuda import build

    xyz = (ctypes.c_int * 3)()
    build.bind(kernel, f"nezha_{kernel}_last_grid", (ctypes.c_void_p,))(xyz)
    return list(xyz)


def check_flash_decode(g):
    """The dense flash-decode kernel at generate's shape: all four (q,
    cache) dtype pairs, lengths from 0 to L and on the first splits'
    boundaries; the length-0 row exact zero, two runs bitwise equal."""
    from nezha_tpu_torch.ops.cuda import (flash_decode_attention,
                                          flash_decode_attention_plain)
    from nezha_tpu_torch.ops.cuda.decode_attention import split_size

    split = split_size("flash_decode")
    lengths_list = [0, 1, 17, 300, 511, 768, 1000, DEC_L,
                    split - 1, split, split + 1, 2 * split + 1]
    b = len(lengths_list)
    bf, f32 = torch.bfloat16, torch.float32
    q32 = torch.randn(b, H, 1, D, generator=g).cuda()
    k32 = torch.randn(b, H, DEC_L, D, generator=g).cuda()
    v32 = torch.randn(b, H, DEC_L, D, generator=g).cuda()
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    worst = worst_ratio = 0.0
    for q_dtype, cache_dtype in ((bf, bf), (f32, bf), (bf, f32), (f32, f32)):
        q, k, v = q32.to(q_dtype), k32.to(cache_dtype), v32.to(cache_dtype)
        tag = f"flash_decode q {q_dtype} cache {cache_dtype}"
        got = flash_decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        want = flash_decode_attention_plain(q, k, v, lengths)
        abs_v = flash_decode_attention_plain(q, k, v.abs(), lengths)
        err, ratio = within(tag, got, want,
                            fold_bound(want, abs_v, cache_dtype))
        if not torch.all(got[0] == 0):
            fail(f"{tag}: the length-0 row is not exact zero")
        if not torch.equal(flash_decode_attention(q, k, v, lengths), got):
            fail(f"{tag}: two runs differ")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    # Timed at generate's batch, every row at length 768.
    q, k, v = (x[:8].to(bf) for x in (q32, k32, v32))
    timed = torch.full((8,), 768, dtype=torch.int32, device="cuda")
    args = (q, k, v, timed)
    timing = device_time("flash_decode",
                         lambda: flash_decode_attention(*args), 100)
    grid = launched_grid("flash_decode")
    if not math.prod(grid):
        fail(f"flash_decode: no launch grid recorded ({grid})")
    plain_ms = plain_time_ms(lambda: flash_decode_attention_plain(*args), 5)
    mask = (torch.arange(DEC_L, device="cuda")[None, :]
            < timed[:, None])[:, None, None, :]
    sdpa, backend = sdpa_yardstick(q, k, v, attn_mask=mask)
    timing.update(library_time("flash_decode", sdpa, 100, backend))
    total = 768 * 8
    nbytes = (2 * 8 * H * D * 2                     # q in, out
              + 2 * total * H * D * 2               # K and V read once
              + 8 * 4)
    bound_ms, bound_by = bound(nbytes, 4 * total * H * D)
    return {"name": "flash_decode", "route": "cuda",
            "source": "nezha_tpu_torch/csrc/flash_decode.cu",
            "replaces": "nezha_tpu/ops/pallas/decode_attention.py:63",
            "max_abs_err": worst, "err_over_tolerance": worst_ratio,
            **timing, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "split": split, "grid": grid,
            "blocks": math.prod(grid),
            "shape": f"B=8 H={H} L={DEC_L} D={D} bf16, timed at length "
                     f"768 (splits of {split} keys, grid {grid}); checked "
                     f"B={b} lengths={lengths_list}, all four (q, cache) "
                     f"dtype pairs"}


# The rows B4's forward gets, by path: generate's decode steps (one token
# of GEN_B rows; GEN_NEW - 1 steps of 25 LayerNorms), its prefill (GEN_B x
# GEN_PROMPT rows, 25 launches a call) and a train step with
# ln_impl="pallas" (TRAIN_B x TRAIN_S rows, 25 a step, where B5 runs too).
LN_TIMED_ROWS = {"generate decode": GEN_B,
                 "generate prefill": GEN_B * GEN_PROMPT,
                 "train": TRAIN_B * TRAIN_S}


def layer_norm_case(g, rows: int, d: int):
    """x [rows, d] bf16 (rows with their own offsets), dy, fp32 scale and
    bias, on the card."""
    bf = torch.bfloat16
    x = (torch.randn(rows, d, generator=g) * 2
         + torch.randn(rows, 1, generator=g)).to("cuda", bf)
    dy = torch.randn(rows, d, generator=g).to("cuda", bf)
    scale = (1 + 0.3 * torch.randn(d, generator=g)).cuda()
    bias = (0.2 * torch.randn(d, generator=g)).cuda()
    return x, dy, scale, bias


def time_layer_norm_fwd(x, scale, bias, eps, fwd=None):
    """B4's forward (or ``fwd``, another build's) on x with the device
    timer, beside ``F.layer_norm`` on the same rows, the plain version and
    the bound -> the row's fields. ``F.layer_norm`` on the card takes scale
    and bias in x's dtype."""
    import torch.nn.functional as F
    from nezha_tpu_torch.ops.cuda.layer_norm import (layer_norm_fwd,
                                                     layer_norm_fwd_plain)

    fwd = fwd or layer_norm_fwd
    rows, d = x.shape
    label = f"layer_norm_fwd rows={rows}"
    sg, bg = scale.to(x.dtype), bias.to(x.dtype)
    elems = rows * d
    # x in, y out (bf16), scale and bias in; ~8 fp32 ops each
    bound_ms, bound_by = bound(2 * elems * x.element_size() + 2 * d * 4,
                               8 * elems, FP32_FLOPS_PER_S)
    return {"rows": rows,
            **device_time(label, lambda: fwd(x, scale, bias, eps), 50),
            **library_time(label,
                           lambda: F.layer_norm(x, (d,), sg, bg, eps), 50,
                           "F.layer_norm"),
            "plain_ms": plain_time_ms(
                lambda: layer_norm_fwd_plain(x, scale, bias, eps), 5),
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_layer_norm_bwd(x, dy, scale, bias, eps, bwd=None):
    """B5 (or ``bwd``, another build's backward returning dx, dscale and
    dbias) on x and dy with the device timer, beside ``F.layer_norm``'s
    backward alone (its forward runs once outside the timer, then only
    ``torch.autograd.grad``), the plain version and the bound -> the
    row's fields."""
    import torch.nn.functional as F
    from nezha_tpu_torch.ops.cuda.layer_norm import (layer_norm_bwd,
                                                     layer_norm_bwd_plain)

    bwd = bwd or layer_norm_bwd
    rows, d = x.shape
    xg, sg, bg = (t.detach().to(x.dtype).requires_grad_()
                  for t in (x, scale, bias))
    y_g = F.layer_norm(xg, (d,), sg, bg, eps)
    elems = rows * d
    # x, dy in, dx out (bf16), scale in, dscale and dbias out; ~19 fp32
    # ops each
    bound_ms, bound_by = bound(3 * elems * x.element_size() + 3 * d * 4,
                               19 * elems, FP32_FLOPS_PER_S)
    return {**device_time("layer_norm_bwd",
                          lambda: bwd(x, scale, dy, eps), 50),
            **library_time(
                "layer_norm_bwd",
                lambda: torch.autograd.grad(y_g, (xg, sg, bg), dy,
                                            retain_graph=True), 50,
                "F.layer_norm backward"),
            "plain_ms": plain_time_ms(
                lambda: layer_norm_bwd_plain(x, scale, dy, eps), 5),
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_layer_norm(g):
    """The LayerNorm kernels at D=768, bf16 x, on the rows of
    LN_TIMED_ROWS and 37 rows, each within ``layer_norm_error_bound`` (the
    backward's dx, dscale and dbias, which its second kernel sums) and
    both bitwise repeatable; the forward timed at each of LN_TIMED_ROWS's
    shapes, the backward at the train step's; -> the kernels line's two
    entries. The forward's entry carries generate's
    decode shape (almost all of its launches on its home path) and each
    timed shape under ``by_rows``."""
    from nezha_tpu_torch.ops.cuda.layer_norm import (
        launched_fwd_plan, layer_norm_bwd, layer_norm_bwd_plain,
        layer_norm_error_bound, layer_norm_fwd, layer_norm_fwd_plain)

    d, eps = LN_D, 1e-5
    worst = {"layer_norm_fwd": (0.0, 0.0), "layer_norm_bwd": (0.0, 0.0)}
    by_rows, bwd_timing = {}, {}
    for rows in sorted(set(LN_TIMED_ROWS.values()) | {37}):
        x, dy, scale, bias = layer_norm_case(g, rows, d)
        y = layer_norm_fwd(x, scale, bias, eps)
        torch.cuda.synchronize()
        res = [within(f"layer_norm_fwd rows={rows}", y,
                      layer_norm_fwd_plain(x, scale, bias, eps),
                      layer_norm_error_bound(x, scale, bias, eps))]
        if not torch.equal(layer_norm_fwd(x, scale, bias, eps), y):
            fail(f"layer_norm_fwd rows={rows}: two runs differ")
        grads = layer_norm_bwd(x, scale, dy, eps)
        torch.cuda.synchronize()
        plain = layer_norm_bwd_plain(x, scale, dy, eps)
        bounds = layer_norm_error_bound(x, scale, bias, eps, dy=dy)
        bwd = []
        for name, got, want, bd in zip(("dx", "dscale", "dbias"), grads,
                                       plain, bounds):
            bwd.append(within(f"layer_norm_bwd rows={rows} {name}", got,
                              want, bd))
        res.append((max(e for e, _ in bwd), max(r for _, r in bwd)))
        again = layer_norm_bwd(x, scale, dy, eps)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            fail(f"layer_norm_bwd rows={rows}: two runs differ")
        for name, (err, ratio) in zip(worst, res):
            worst[name] = (max(worst[name][0], err),
                           max(worst[name][1], ratio))
        if rows not in LN_TIMED_ROWS.values():
            continue
        timing = time_layer_norm_fwd(x, scale, bias, eps)
        by_rows[str(rows)] = {
            "path": [p for p, r in LN_TIMED_ROWS.items() if r == rows],
            "plan": dataclasses.asdict(launched_fwd_plan()), **timing}
        if rows != LN_TIMED_ROWS["train"]:
            continue
        bwd_timing = time_layer_norm_bwd(x, dy, scale, bias, eps)
    decode = dict(by_rows[str(LN_TIMED_ROWS["generate decode"])])
    decode.pop("rows")
    decode.pop("path")
    fwd = {"name": "layer_norm_fwd", "route": "cuda",
           "source": "nezha_tpu_torch/csrc/layer_norm.cu",
           "replaces": "nezha_tpu/ops/pallas/layer_norm.py:24",
           "max_abs_err": worst["layer_norm_fwd"][0],
           "err_over_tolerance": worst["layer_norm_fwd"][1], **decode,
           "by_rows": by_rows,
           "shape": f"rows={LN_TIMED_ROWS['generate decode']} D={d} bf16 x, "
                    f"fp32 scale/bias (generate's decode step); timed also "
                    f"at rows {LN_TIMED_ROWS['generate prefill']} and "
                    f"{LN_TIMED_ROWS['train']} (by_rows); checked rows "
                    f"{sorted(set(LN_TIMED_ROWS.values()) | {37})}"}
    bwd = {"name": "layer_norm_bwd", "route": "cuda",
           "source": "nezha_tpu_torch/csrc/layer_norm.cu",
           "replaces": "nezha_tpu/ops/pallas/layer_norm.py:33",
           "max_abs_err": worst["layer_norm_bwd"][0],
           "err_over_tolerance": worst["layer_norm_bwd"][1], **bwd_timing,
           "library_covers": "dx, dscale and dbias",
           "shape": f"rows={LN_TIMED_ROWS['train']} D={d} bf16 x, fp32 "
                    f"scale/bias; checked rows "
                    f"{sorted(set(LN_TIMED_ROWS.values()) | {37})}"}
    return [fwd, bwd]


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
    that many times per step, the LayerNorm forward on the step's rows.
    -> (stats, launches)."""
    from nezha_tpu_torch.models.gpt2 import lm_loss
    from nezha_tpu_torch.ops.cuda.layer_norm import FWD_LAUNCHES_BY_ROWS
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
    FWD_LAUNCHES_BY_ROWS.clear()
    t0 = time.perf_counter()
    last = trainer.fit(batches, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: n for c in counters for name, n in c.items()}
    for name, want in per_step.items():
        if launches[name] != want * n_steps:
            fail(f"train: {name} launched {launches[name]} times in "
                 f"{n_steps} steps, not {want} per step")
    ln_rows = dict(FWD_LAUNCHES_BY_ROWS)
    if ln_rows != ({b * s: launches["layer_norm_fwd"]}
                   if launches.get("layer_norm_fwd") else {}):
        fail(f"train: LayerNorm forward launches by rows {ln_rows}")
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
            "launches": launches, "layer_norm_fwd_by_rows": ln_rows,
            "card": card}, launches


def train(card: str):
    """-> ({"train": flash launches of the default run, "train_ln": flash
    and LayerNorm launches of the ln_impl="pallas" run}, {"train_ln": its
    LayerNorm forward launches by row count})."""
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
    return ({"train": launches, "train_ln": ln_launches},
            {"train_ln": ln_stats["layer_norm_fwd_by_rows"]})


def serve_prompts(vocab: int):
    """The serve phase's eight prompts: 5-900 tokens, two sharing a
    128-token prefix (seeded)."""
    g = torch.Generator().manual_seed(1)

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    prefix = toks(128)
    return [toks(5), toks(37), toks(200), toks(300), toks(600), toks(900),
            prefix + toks(20), prefix + toks(45)]


def serve(card: str, kv_dtype: str = "bf16"):
    """Eight greedy requests through Scheduler/Engine on a paged pool of
    ``kv_dtype``; -> the kernel launches of that run."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.serve import (Engine, FinishReason, Request,
                                       Scheduler, ServeConfig)

    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    cfg = ServeConfig(max_batch_size=8, max_len=1024, max_prefill_len=256,
                      kv_block_size=16, kv_dtype=kv_dtype)
    engine = Engine(model, cfg)
    sched = Scheduler(engine)
    reqs = [Request(prompt=p, max_new_tokens=32, request_id=f"r{i}")
            for i, p in enumerate(serve_prompts(model.cfg.vocab_size))]
    zero_serve_launches()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle(max_iters=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = engine.kernel_launches()
    if sched.has_work():
        fail("scheduler did not drain")
    int8 = kv_dtype == "int8"
    path = {"paged_quant_decode", "paged_quant_prefill"} if int8 else {
        "paged_decode", "paged_prefill"}
    for name, n in launches.items():
        if name in path and n <= 0:
            fail(f"kernel {name} was not launched on the {kv_dtype} "
                 f"serving path")
        if name not in path and n != 0:
            fail(f"kernel {name} launched {n} times on the {kv_dtype} "
                 f"serving path")
    for r in reqs:
        res = sched.results[r.request_id]
        if res.finish_reason not in (FinishReason.LENGTH, FinishReason.EOS):
            fail(f"{kv_dtype} {r.request_id} finished {res.finish_reason}: "
                 f"{res.error}")
        dec = res.latency_s - res.ttft_s
        print(json.dumps({"request": r.request_id, "kv_dtype": kv_dtype,
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
    stats = {"kv_dtype": kv_dtype, "serve_wall_s": wall,
             "launches": launches,
             "launches_per_request": {
                 k: n / len(reqs) for k, n in launches.items()},
             "prefix_hits": engine.pool.prefix_hits,
             "cow_copies": engine.pool.cow_copies,
             "step_calls": engine.step_calls,
             "bytes_per_block": engine.pool.bytes_per_block, "card": card}
    if int8:
        stats["max_quant_error"] = max(engine.quant_errors)
        stats["quant_error_samples"] = len(engine.quant_errors)
    print(json.dumps(stats), flush=True)
    cross_check(model, sched, reqs,
                INT8_SERVE_LOGIT_ATOL if int8 else SERVE_LOGIT_ATOL)
    return launches


def zero_serve_launches() -> None:
    from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                          paged_prefill_attention,
                                          paged_prefill_qoff_attention,
                                          paged_quant_decode_attention,
                                          paged_quant_prefill_attention)

    for wrapper in (paged_decode_attention, paged_prefill_attention,
                    paged_prefill_qoff_attention,
                    paged_quant_decode_attention,
                    paged_quant_prefill_attention):
        wrapper.launches = 0


def serve_seq(card: str):
    """Sequence-sharded serving on a 4-shard mesh of one card: a ring
    engine (B11), a ulysses engine (B9) and a ulysses engine on int8
    pools (B10); -> the launches of each run."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.serve import (FinishReason, Request, Scheduler,
                                       ServeConfig, ShardedEngine)

    model = gpt2_for_preset("full", seed=0, device="cuda")
    model.eval()
    layers, m = model.cfg.num_layers, SEQ_MESH
    g = torch.Generator().manual_seed(3)
    prompts = serve_prompts(model.cfg.vocab_size) + [
        torch.randint(0, model.cfg.vocab_size, (960,), generator=g).tolist()]
    label = f"one card, {m} shards run serially"
    runs, served, engines = {}, {}, {}
    for variant, kv_dtype in (("ring", "bf16"), ("ulysses", "bf16"),
                              ("ulysses", "int8")):
        tag = f"serve_seq {variant} {kv_dtype}"
        cfg = ServeConfig(max_batch_size=8, max_len=1024,
                          max_prefill_len=256,
                          long_prefill_buckets=(512, 1024),
                          kv_block_size=16, prefill_mode="sequence",
                          seq_prefill_variant=variant, kv_dtype=kv_dtype)
        engine = ShardedEngine(model, cfg, mesh_devices=m,
                               devices=[torch.device("cuda", 0)] * m)
        if engine._seq_variant != variant:
            fail(f"{tag}: the engine runs {engine._seq_variant}")
        sched = Scheduler(engine)
        reqs = [Request(prompt=p, max_new_tokens=32, request_id=f"r{i}")
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        zero_serve_launches()
        t0 = time.perf_counter()
        for r in reqs:
            sched.submit(r)
        sched.run_until_idle(max_iters=10_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = engine.kernel_launches()
        if sched.has_work():
            fail(f"{tag}: the scheduler did not drain")
        for r in reqs:
            res = sched.results[r.request_id]
            if res.finish_reason not in (FinishReason.LENGTH,
                                         FinishReason.EOS):
                fail(f"{tag} {r.request_id} finished {res.finish_reason}: "
                     f"{res.error}")
        per_layer = m * layers
        chunks, steps = engine.prefill_chunks, engine.step_calls
        int8 = kv_dtype == "int8"
        want = {"paged_decode": 0 if int8 else per_layer * steps,
                "paged_quant_decode": per_layer * steps if int8 else 0,
                "paged_prefill": (per_layer * chunks
                                  if variant == "ulysses" and not int8
                                  else 0),
                "paged_quant_prefill": per_layer * chunks if int8 else 0,
                "paged_prefill_qoff": (m * per_layer * chunks
                                       if variant == "ring" else 0)}
        if launches != want:
            fail(f"{tag}: launches {launches}, expected {want} for "
                 f"{chunks} chunks and {steps} decode steps")
        engine.pool.leak_check()
        if engine.pool.prefix_hits < 1:
            fail(f"{tag}: the shared 128-token prefix did not hit")
        doc = sched.results[reqs[-1].request_id]
        print(json.dumps({"serve_seq": {
            "variant": variant, "kv_dtype": kv_dtype, "mesh": label,
            "wall_s": wall, "ttft_960_s": doc.ttft_s,
            "prefill_chunks": chunks, "decode_steps": steps,
            "launches": launches, "prefix_hits": engine.pool.prefix_hits,
            "memory_report": engine.memory_report(),
            "max_quant_error": max(engine.quant_errors) if int8 else None,
            "card": card}}), flush=True)
        cross_check(model, sched, reqs,
                    INT8_SERVE_LOGIT_ATOL if int8 else SERVE_LOGIT_ATOL)
        runs[f"{variant}_{kv_dtype}"] = launches
        served[variant, kv_dtype] = {r.request_id: sched.results[
            r.request_id].tokens for r in reqs}
        engines[variant, kv_dtype] = engine
    if served["ring", "bf16"] != served["ulysses", "bf16"]:
        fail("serve_seq: ring and ulysses served different tokens")
    # Each prompt's last logits from a cold prefill, ring against
    # ulysses: the same bits. The prefix cache is emptied before every
    # prompt, so each prefills whole at its own bucket widths (up to the
    # 1024-wide long bucket), not as a short tail over cached blocks.
    widths = {}
    for i, p in enumerate(prompts):
        logits = []
        for key in (("ring", "bf16"), ("ulysses", "bf16")):
            engine = engines[key]
            engine.pool.clear_prefix_cache()
            plan = engine._plan_chunks(len(p))
            before = engine.prefill_chunks
            slot = engine.pool.alloc()
            try:
                engine.prefill(slot, p, max_new_tokens=1)
                logits.append(engine.last_logits[slot].clone())
            finally:
                engine.pool.free(slot)
            if engine.prefill_chunks - before != len(plan):
                fail(f"serve_seq r{i}: {engine.prefill_chunks - before} "
                     f"chunks dispatched, the cold plan has {len(plan)}")
            widths[f"r{i}"] = [w for _, _, w in plan]
        if not torch.equal(logits[0], logits[1]):
            fail(f"serve_seq r{i}: ring and ulysses last logits differ by "
                 f"{(logits[0] - logits[1]).abs().max().item()}")
    long_widths = {w for ws in widths.values() for w in ws} & {512, 1024}
    if long_widths != {512, 1024}:
        fail(f"serve_seq: the cold prefills used long buckets "
             f"{sorted(long_widths)}, expected 512 and 1024")
    for engine in engines.values():
        engine.pool.leak_check()
    print(json.dumps({"serve_seq_ring_vs_ulysses": {
        "tokens_identical": True, "last_logits_bitwise_equal": len(prompts),
        "requests": len(prompts), "cold_prefill_widths": widths}}),
        flush=True)
    return runs


@torch.no_grad()
def cross_check(model, sched, reqs, atol: float) -> None:
    """Every request against the no-cache causal forward with composed
    attention (a copy of the model with ``attn_impl="xla"``, so the
    reference runs no kernel) over prompt + generated tokens
    (teacher-forced): the prompt's last-position logits from a fresh
    paged prefill must lie within ``atol``, and each generated token must
    be the reference argmax wherever the reference's top-2 margin exceeds
    it."""
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
        if not math.isfinite(err) or err > atol:
            fail(f"{r.request_id}: last-position logits differ by {err} > "
                 f"{atol}")
        steps = ref[n - 1:n - 1 + len(res.tokens)]
        top2 = steps.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        want = steps.argmax(dim=-1).tolist()
        for i, tok in enumerate(res.tokens):
            if margin[i].item() > atol:
                checked += 1
                if tok != want[i]:
                    fail(f"{r.request_id} token {i}: served {tok}, "
                         f"reference {want[i]} (margin "
                         f"{margin[i].item():.4f})")
    engine.pool.leak_check()
    print(json.dumps({"kv_dtype": engine.cfg.kv_dtype,
                      "cross_check_max_logit_err": worst,
                      "tolerance": atol, "tokens_checked": checked}),
          flush=True)


@torch.no_grad()
def generate_phase(card: str):
    """KV-cache generation of GPT-2 124M with the LayerNorm kernels:
    greedy, timed, launch-counted and cross-checked, then one sampled
    call; -> the greedy run's launches, and its LayerNorm forward
    launches by row count (the prefill's GEN_B x GEN_PROMPT rows once,
    then GEN_B rows a decode step)."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.models import GPT2, generate, init_cache
    from nezha_tpu_torch.ops.cuda import flash_decode_attention
    from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
    from nezha_tpu_torch.ops.cuda.layer_norm import (FWD_LAUNCHES_BY_ROWS,
                                                     LAUNCHES as LN_LAUNCHES)

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
    FWD_LAUNCHES_BY_ROWS.clear()
    t0 = time.perf_counter()
    out = generate(model, prompt, GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**LAUNCHES, **LN_LAUNCHES,
                "flash_decode": flash_decode_attention.launches}
    want = {"flash_fwd": layers, "flash_bwd_dq": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkv": 0, "flash_decode": (GEN_NEW - 1) * layers,
            "layer_norm_fwd": GEN_NEW * (2 * layers + 1),
            "layer_norm_bwd": 0, "layer_norm_bwd_sums": 0}
    if launches != want:
        fail(f"generate: launches {launches}, expected {want}")
    ln_rows = dict(FWD_LAUNCHES_BY_ROWS)
    per_fwd = 2 * layers + 1
    if ln_rows != {GEN_B * GEN_PROMPT: per_fwd,
                   GEN_B: (GEN_NEW - 1) * per_fwd}:
        fail(f"generate: LayerNorm forward launches by rows {ln_rows}")
    t0 = time.perf_counter()
    generate(model, prompt, 1)                  # prefill + first token
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    print(json.dumps({"generate": {
        "B": GEN_B, "prompt_len": GEN_PROMPT, "new_tokens": GEN_NEW,
        "ln_impl": "pallas", "wall_s": wall, "ttft_s": ttft,
        "decode_ms_per_step": (wall - ttft) / (GEN_NEW - 1) * 1e3,
        "tokens_per_s": GEN_B * GEN_NEW / wall, "launches": launches,
        "layer_norm_fwd_by_rows": ln_rows, "card": card}}), flush=True)

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
    return launches, {"generate": ln_rows}


# The run whose launch count each kernel reports: the path it serves.
HOME_PATH = {"paged_decode": "serve", "paged_prefill": "serve",
             "paged_prefill_qoff": "serve_seq",
             "paged_quant_decode": "serve_int8",
             "paged_quant_prefill": "serve_int8",
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
    print(json.dumps({"timer_zero": {"call": "torch.cuda._sleep(0)",
                                     **empty_row()}}), flush=True)
    g = torch.Generator().manual_seed(0)
    kernels = ([check_decode(g), check_prefill(g)] + check_flash(g)
               + [check_flash_decode(g)] + check_layer_norm(g)
               + [check_quant_decode(g), check_quant_prefill(g),
                  check_prefill_qoff(g)])
    print(json.dumps({"timer": {
        "rows": len(TIMED_ROWS), "host_late": 0,
        "profiler_disagrees": [
            {"row": label, "ms": ms, "profiler_us": prof}
            for label, ms, prof, flag in TIMED_ROWS if flag]}}), flush=True)
    phase("train")
    paths, ln_rows = train(card)
    phase("serve")
    paths["serve"] = serve(card)
    paths["serve_int8"] = serve(card, "int8")
    phase("serve_seq")
    seq = serve_seq(card)
    paths["serve_seq"] = seq["ring_bf16"]
    paths["serve_seq_ulysses"] = seq["ulysses_bf16"]
    paths["serve_seq_int8"] = seq["ulysses_int8"]
    phase("generate")
    paths["generate"], gen_rows = generate_phase(card)
    ln_rows.update(gen_rows)
    for k in kernels:
        home = HOME_PATH[k["name"]]
        k["launches"] = paths[home][k["name"]]
        k["launches_path"] = home
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()
                                 if k["name"] in c}
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the {home} path")
        if k["name"] == "layer_norm_fwd":
            # By row count, as each path's wrapper counted them.
            k["launches_by_rows"] = ln_rows
        if k["name"] == "layer_norm_bwd":
            # B5's column sums run once after each of its launches.
            k["sums_launches"] = paths[home]["layer_norm_bwd_sums"]
            if k["sums_launches"] != k["launches"]:
                fail(f"layer_norm_bwd_sums launched {k['sums_launches']} "
                     f"times for {k['launches']} backward launches")
        if k["name"] == "flash_bwd_dkv":
            # B3's delta pre-pass runs before each dK/dV launch.
            k["pre_pass_launches"] = paths[home]["flash_bwd_delta"]
            if k["pre_pass_launches"] != k["launches"]:
                fail(f"flash_bwd_delta launched {k['pre_pass_launches']} "
                     f"times for {k['launches']} dK/dV launches")
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
