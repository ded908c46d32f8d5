"""Time geometries of the Hopper flash kernels (B1, B2, B3) at the
training shape.

    python3 tools/tune_flash_plans.py [--d 64 128] [--kernels fwd dq dkv]

``nezha_tpu_torch/csrc/flash_fwd.cu`` and ``flash_bwd.cu`` build their
bf16 bodies in one geometry a padded head dim (``FwdBuilds``,
``DqBuilds``, ``DkvBuilds``; ``FWD_BUILDS``, ``DQ_BUILDS`` and
``DKV_BUILDS`` in ``ops/cuda/flash_attention.py``): consumer warpgroups
of 64 rows, rows of a streamed tile, stages of the TMA ring. This copies
``nezha_tpu_torch/csrc`` into a temporary directory with the three lists
set to the CANDIDATES below, builds the two sources there, and for each
geometry at each padded D runs the kernel on GPT-2's training shape (B=8,
H=12, S=1024, causal, bf16; D=64, or D=128 for the 128-column builds),
checks it against the plain version (the forward within
``fold_error_bound``, dq, dK and dV within ``flash_bwd_error_bound``) and
times it with ``chip_smoke.py``'s device timer (dq on the delta
pre-pass's output, dK/dV with the pre-pass); the shipped forward and dq
also with the grid in plain order (not heaviest first); SDPA's forward
and its backward alone as yardsticks. Prints the card's name and power
limit, then one JSON line per row. Needs the card and ``nvcc``; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from csrc_variant import build_variant  # noqa: E402
from nezha_tpu_torch.ops.cuda.common import fold_error_bound  # noqa: E402
from nezha_tpu_torch.ops.cuda.flash_attention import (  # noqa: E402
    DKV_BUILDS, DQ_BUILDS, FWD_BUILDS, _delta_launch, _dkv_launch,
    _dq_launch, _fwd_launch, flash_block_bwd_plain, flash_block_fwd_plain,
    flash_bwd_error_bound, hopper_plan)

B, H, S = 8, 12, 1024
# (consumer warpgroups, rows of a streamed tile, stages) by padded D; each
# fits in shared memory, twice where one consumer runs two blocks an SM.
CANDIDATES = {
    "fwd": {64: [(2, 128, 3), (1, 128, 2), (1, 128, 3), (1, 64, 4)],
            128: [(2, 128, 2), (2, 128, 3)]},
    "dq": {64: [(1, 64, 2), (1, 64, 3), (1, 64, 4), (2, 64, 2), (2, 64, 3),
                (1, 128, 2)],
           128: [(1, 64, 2), (1, 64, 3), (2, 64, 2)]},
    "dkv": {64: [(2, 64, 2), (1, 64, 2)], 128: [(2, 64, 2), (1, 64, 2)]}}
STRUCTS = {"fwd": ("FwdBuilds", "Fwd", "flash_fwd.cu"),
           "dq": ("DqBuilds", "Dq", "flash_bwd.cu"),
           "dkv": ("DkvBuilds", "Dkv", "flash_bwd.cu")}


def build_candidates(tmp: Path):
    """Build the two flash sources from a copy whose build lists hold
    every candidate."""
    edits = []
    for kernel, (name, struct, source) in STRUCTS.items():
        # Dkv's template takes no tile: its query tiles are 64 rows.
        builds = ", ".join(
            f"{struct}<{d}, {c}, {t}, {st}>" if kernel != "dkv"
            else f"{struct}<{d}, {c}, {st}>"
            for d, geoms in CANDIDATES[kernel].items()
            for c, t, st in geoms)
        edits.append((source, rf"using {name} =[^;]*;",
                      f"using {name} = std::tuple<{builds}>;"))
    return build_variant(tmp / "candidates", ("flash_fwd", "flash_bwd"),
                         edits)


def tune_fwd(q, k, v, d, scale):
    """Each forward geometry at this D, then SDPA's forward."""
    want = flash_block_fwd_plain(q, k, v, True)[0]
    bound = fold_error_bound(
        want, flash_block_fwd_plain(q, k, v.abs(), True)[0], True)
    shipped = hopper_plan("fwd", d, *FWD_BUILDS[d])
    plans = [hopper_plan("fwd", d, *g) for g in CANDIDATES["fwd"][d]]
    plans.append(dataclasses.replace(shipped, heavy_first=False))
    for plan in plans:
        out = _fwd_launch(q, k, v, None, True, scale, plan)[0]
        torch.cuda.synchronize()
        ratio = ((out.float() - want.float()).abs() / bound).max().item()
        row = cs.device_time(f"fwd {plan}", lambda: _fwd_launch(
            q, k, v, None, True, scale, plan), 20)
        print(json.dumps({
            "d": d, "kernel": "fwd", "consumers": plan.rows // 64,
            "keys_a_tile": plan.tile, "stages": plan.stages,
            "heavy_first": plan.heavy_first, "shipped": plan == shipped,
            "smem_bytes": plan.smem_bytes, "err_over_bound": ratio,
            "ms": row["ms"], "ms_spread": row["ms_spread"],
            "profiler_us": row["profiler_us"]}), flush=True)
        if not ratio <= 1.0:
            cs.fail(f"{plan}: out exceeds fold_error_bound ({ratio})")
    sdpa, backend = cs.sdpa_yardstick(q, k, v, is_causal=True)
    row = cs.device_time("sdpa fwd", sdpa, 20)
    print(json.dumps({"d": d, "yardstick": f"SDPA {backend} forward",
                      "ms": row["ms"], "ms_spread": row["ms_spread"]}),
          flush=True)


def tune_dq(do, out, lse, q, k, v, d, scale):
    """Each dq geometry at this D (the shipped one also in plain order),
    on one delta from the pre-pass."""
    want = flash_block_bwd_plain(q, k, v, out, lse, do, True)[0]
    bound = flash_bwd_error_bound(q, k, v, out, lse, do, True)[0]
    delta = _delta_launch(out, do)
    shipped = hopper_plan("dq", d, *DQ_BUILDS[d])
    plans = [hopper_plan("dq", d, *g) for g in CANDIDATES["dq"][d]]
    plans.append(dataclasses.replace(shipped, heavy_first=False))
    for plan in plans:
        args = (q, k, v, lse, do, delta, None, True, scale, plan)
        got = _dq_launch(*args)
        torch.cuda.synchronize()
        ratio = ((got.float() - want.float()).abs() / bound).max().item()
        row = cs.device_time(f"dq {plan}", lambda: _dq_launch(*args), 20)
        print(json.dumps({
            "d": d, "kernel": "dq", "consumers": plan.rows // 64,
            "keys_a_tile": plan.tile, "stages": plan.stages,
            "heavy_first": plan.heavy_first, "shipped": plan == shipped,
            "smem_bytes": plan.smem_bytes, "err_over_bound": ratio,
            "ms": row["ms"], "ms_spread": row["ms_spread"],
            "profiler_us": row["profiler_us"]}), flush=True)
        if not ratio <= 1.0:
            cs.fail(f"{plan}: dq exceeds flash_bwd_error_bound ({ratio})")


def tune_dkv(do, out, lse, q, k, v, d, scale):
    """Each dK/dV geometry at this D, with the delta pre-pass."""
    want = flash_block_bwd_plain(q, k, v, out, lse, do, True)[1:]
    bounds = flash_bwd_error_bound(q, k, v, out, lse, do, True)[1:]
    shipped = hopper_plan("dkv", d, *DKV_BUILDS[d])
    for geometry in CANDIDATES["dkv"][d]:
        plan = hopper_plan("dkv", d, *geometry)

        def call():
            return _dkv_launch(q, k, v, lse, do, _delta_launch(out, do),
                               None, True, scale, plan)

        got = call()
        torch.cuda.synchronize()
        ratio = max(((x.float() - w.float()).abs() / bd).max().item()
                    for x, w, bd in zip(got, want, bounds))
        row = cs.device_time(f"dkv {plan}", call, 20)
        print(json.dumps({
            "d": d, "kernel": "dkv", "consumers": plan.rows // 64,
            "stages": plan.stages, "shipped": plan == shipped,
            "smem_bytes": plan.smem_bytes, "err_over_bound": ratio,
            "ms": row["ms"], "ms_spread": row["ms_spread"],
            "profiler_kernels": row["profiler_kernels"]}), flush=True)
        if not ratio <= 1.0:
            cs.fail(f"{plan}: dk/dv exceed flash_bwd_error_bound ({ratio})")


def sdpa_backward(do, q, k, v, d):
    """SDPA's backward alone, the yardstick of dq and dK/dV."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa, backend = cs.sdpa_yardstick(qg, kg, vg, is_causal=True)
    out_g = sdpa()
    row = cs.device_time("sdpa bwd", lambda: torch.autograd.grad(
        out_g, (qg, kg, vg), do, retain_graph=True), 20)
    print(json.dumps({"d": d, "yardstick": f"SDPA {backend} backward",
                      "ms": row["ms"], "ms_spread": row["ms_spread"]}),
          flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--d", type=int, nargs="+", default=[64, 128])
    p.add_argument("--kernels", nargs="+", choices=sorted(CANDIDATES),
                   default=["fwd", "dq", "dkv"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps({"build_s": build_candidates(Path(tmp))}),
              flush=True)
        g = torch.Generator().manual_seed(0)
        for d in args.d:
            q, k, v = (torch.randn(B, H, S, d, generator=g).to(
                "cuda", torch.bfloat16) for _ in range(3))
            scale = 1.0 / d ** 0.5
            if "fwd" in args.kernels:
                tune_fwd(q, k, v, d, scale)
            do = torch.randn(q.shape, generator=g).to("cuda", torch.bfloat16)
            out, lse = flash_block_fwd_plain(q, k, v, True)
            bwd = (do, out, lse, q, k, v, d, scale)
            if "dq" in args.kernels:
                tune_dq(*bwd)
            if "dkv" in args.kernels:
                tune_dkv(*bwd)
            if {"dq", "dkv"} & set(args.kernels):
                sdpa_backward(do, q, k, v, d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
