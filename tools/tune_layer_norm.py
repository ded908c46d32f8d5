"""Time the LayerNorm forward kernel (B4) on the rows each path gives it,
on its plan and on other geometries, and the backward (B5) on a train
step's rows.

    python3 tools/tune_layer_norm.py [--rows 8 4096 8192] [--sweep]
        [--bwd-rows 8192] [--bwd-variants] [--root DIR]

At D=768, bf16 x, fp32 scale and bias (GPT-2 124M's LayerNorm) and each
``--rows`` count (8: a generate decode step; 4096: generate's prefill;
8192: a train step), this checks the forward against its plain version
(within ``layer_norm_error_bound``) and times it with ``chip_smoke.py``'s
device timer beside ``F.layer_norm`` on the same rows, the plain version
and the bound. With ``--sweep`` it times, beside the plan
``fwd_plan`` picks, other geometries (``FwdPlan``: warps a block, blocks;
a row a block, a row a warp, the persistent grid at 1-4 blocks an SM,
4-warp blocks), each checked first. The shipped entry point takes only
``fwd_plan``'s geometry, so the sweep builds the forward from a copy of
the sources whose plan check takes any block of 1-8 warps and grid of
at most a warp a row (``csrc_variant.py``; the kernel is the shipped
one) and launches it on each plan itself.

Then, at each ``--bwd-rows`` count, the whole backward (dx, dscale and
dbias) is checked against its plain version (within
``layer_norm_error_bound``) and timed with ``chip_smoke.py``'s device
timer beside ``F.layer_norm``'s backward, the plain version and the
bound. A package whose backward returns per-block partials (before the
sums moved into the port's kernels) is timed with its two column sums,
as its autograd function ran them. With ``--bwd-variants`` it also
builds and times, from copies of the sources, one 8-warp block an SM
instead of two (``LN_BWD_BLOCKS_PER_SM`` 1, ``BWD_BLOCKS_PER_SM`` with
it), and a warp's rows loaded as it reduces them or two ahead instead of
one (``LN_BWD_AHEAD_CPL`` 0, or the lookahead 2).

With ``--root DIR`` it times the kernels of the ``nezha_tpu_torch``
package under DIR instead (e.g. a parent commit unpacked into an ignored
directory; built there; not with ``--sweep`` or ``--bwd-variants``), so
two versions can be timed in one call. Prints the card's name and power
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

D, EPS = 768, 1e-5
# The sweep's edit of the plan check: any block of 1 to LN_FWD_WARPS
# warps and any grid of at most a warp a row, ahead of fwd_plan's rule.
ANY_PLAN = ("layer_norm.cu", r"  const int sms = sm_count\(\);\n",
            "  return warps >= 1 && warps <= LN_FWD_WARPS && blocks >= 1 &&\n"
            "         blocks <= (rows + warps - 1) / warps;\n"
            "  const int sms = sm_count();\n")


# The backward's variants: name -> (edits of the copy of the sources, the
# backward's blocks an SM in the plan).
BWD_VARIANTS = {
    "one_block_per_sm": ([("layer_norm.cu",
                           r"constexpr int LN_BWD_BLOCKS_PER_SM = 2;",
                           "constexpr int LN_BWD_BLOCKS_PER_SM = 1;")], 1),
    "no_row_ahead": ([("layer_norm.cu",
                       r"constexpr int LN_BWD_AHEAD_CPL = \d+;",
                       "constexpr int LN_BWD_AHEAD_CPL = 0;")], 2),
    "two_rows_ahead": ([("layer_norm.cu",
                         r"CPL <= LN_BWD_AHEAD_CPL \? 1 : 0",
                         "CPL <= LN_BWD_AHEAD_CPL ? 2 : 0")], 2),
}


def whole_backward(bwd):
    """-> a call returning (dx, dscale, dbias): ``bwd`` itself where it
    returns them, else ``bwd`` followed by the column sums of the
    per-block partials it returns, as a parent's autograd function ran
    them."""
    def call(x, scale, dy, eps):
        dx, ds, db = bwd(x, scale, dy, eps)
        if ds.dim() == 2:
            ds, db = ds.sum(dim=0), db.sum(dim=0)
        return dx, ds, db
    return call


def time_backward(ln, rows: int, tag, source: str, g) -> None:
    """Check the whole backward of ``ln`` (the module as built now) at
    ``rows`` rows of D bf16 against its plain version, time it and print
    its row."""
    x, dy, scale, bias = cs.layer_norm_case(g, rows, D)
    bwd = whole_backward(ln.layer_norm_bwd)
    want = whole_backward(ln.layer_norm_bwd_plain)(x, scale, dy, EPS)
    bounds = ln.layer_norm_error_bound(x, scale, bias, EPS, dy=dy)
    got = bwd(x, scale, dy, EPS)
    torch.cuda.synchronize()
    ratio = max(((a.float() - w.float()).abs() / b).max().item()
                for a, w, b in zip(got, want, bounds))
    if not ratio <= 1.0:
        cs.fail(f"backward rows {rows} {tag}: exceeds "
                f"layer_norm_error_bound ({ratio})")
    if not all(torch.equal(a, b)
               for a, b in zip(bwd(x, scale, dy, EPS), got)):
        cs.fail(f"backward rows {rows} {tag}: two runs differ")
    row = cs.time_layer_norm_bwd(x, dy, scale, bias, EPS, bwd)
    print(json.dumps({
        "package": source, "backward": True, "rows": rows, "variant": tag,
        "err_over_bound": ratio,
        **{k: row[k] for k in (
            "ms", "empty_ms", "ms_less_empty", "ms_spread", "profiler_us",
            "profiler_kernels", "library_ms", "library_profiler_us",
            "plain_ms", "bound_ms", "bound_by")}}), flush=True)


def sweep_plans(rows: int, sms: int):
    """Geometries beside the default for ``rows`` rows of D bf16."""
    from nezha_tpu_torch.ops.cuda.layer_norm import FwdPlan, fwd_plan

    cpl = fwd_plan(rows, D, torch.bfloat16, sms).cpl
    plans = [FwdPlan(cpl, 1, rows), FwdPlan(cpl, 8, -(-rows // 8))]
    if rows > sms:
        for warps in (8, 4):
            for per_sm in (1, 2, 3, 4):
                per_warp = -(-rows // (sms * per_sm * warps))
                plans.append(FwdPlan(cpl, warps,
                                     -(-rows // (per_warp * warps))))
    return list(dict.fromkeys(plans))


def launch_on(plan):
    """-> fwd(x, scale, bias, eps) launching the forward of the built
    library on ``plan`` (the variant's check takes it)."""
    from nezha_tpu_torch.ops.cuda import build
    from nezha_tpu_torch.ops.cuda import layer_norm as ln

    def fwd(x, scale, bias, eps):
        y = torch.empty_like(x)
        rc = build.bind("layer_norm", "nezha_layer_norm_fwd",
                        ln._FWD_ARGTYPES)(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], float(eps),
            build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream, plan.cpl, plan.warps,
            plan.blocks)
        build.check_launch(rc, "nezha_layer_norm_fwd")
        return y
    return fwd


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, nargs="+", default=[8, 4096, 8192])
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--bwd-rows", type=int, nargs="*", default=[8192])
    p.add_argument("--bwd-variants", action="store_true")
    p.add_argument("--root", type=Path, default=None,
                   help="time the kernels of the package under this root")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.root is not None:
        if args.sweep or args.bwd_variants:
            raise SystemExit("--sweep and --bwd-variants time this tree's "
                             "kernels only")
        sys.path.insert(0, str(args.root.resolve()))
    from nezha_tpu_torch.ops.cuda import layer_norm as ln
    tmp = tempfile.TemporaryDirectory()
    if args.sweep:
        sys.path.insert(0, str(REPO / "tools"))
        from csrc_variant import build_variant
        print(json.dumps({"build_s": build_variant(
            Path(tmp.name) / "any_plan", ("layer_norm",), [ANY_PLAN])}),
            flush=True)
    source = str(Path(ln.__file__).resolve().parents[3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"package: {source}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator().manual_seed(0)
    for rows in args.rows:
        x, _, scale, bias = cs.layer_norm_case(g, rows, D)
        want = ln.layer_norm_fwd_plain(x, scale, bias, EPS)
        bound = ln.layer_norm_error_bound(x, scale, bias, EPS)
        plans = [None] + (sweep_plans(rows, sms) if args.sweep else [])
        for plan in plans:
            if plan is None:
                fwd, tag = ln.layer_norm_fwd, "default"
            else:
                fwd, tag = launch_on(plan), dataclasses.asdict(plan)
            got = fwd(x, scale, bias, EPS)
            torch.cuda.synchronize()
            ratio = ((got.float() - want.float()).abs() / bound).max().item()
            if not ratio <= 1.0:
                cs.fail(f"rows {rows} plan {tag}: exceeds "
                        f"layer_norm_error_bound ({ratio})")
            row = cs.time_layer_norm_fwd(x, scale, bias, EPS, fwd)
            print(json.dumps({
                "package": source, "rows": rows, "plan": tag,
                "default_plan": (dataclasses.asdict(ln.fwd_plan(
                    rows, D, x.dtype, sms)) if hasattr(ln, "fwd_plan")
                    else None),
                "err_over_bound": ratio,
                **{k: row[k] for k in (
                    "ms", "empty_ms", "ms_less_empty", "ms_spread",
                    "profiler_us", "library_ms", "library_profiler_us",
                    "plain_ms", "bound_ms", "bound_by")}}), flush=True)
    for rows in args.bwd_rows:
        time_backward(ln, rows, "default", source, g)
    if args.bwd_variants:
        sys.path.insert(0, str(REPO / "tools"))
        from csrc_variant import build_variant
        shipped = ln.BWD_BLOCKS_PER_SM
        for tag, (edits, per_sm) in BWD_VARIANTS.items():
            print(json.dumps({"variant": tag, "build_s": build_variant(
                Path(tmp.name) / tag, ("layer_norm",), edits)}), flush=True)
            ln.BWD_BLOCKS_PER_SM = per_sm
            for rows in args.bwd_rows:
                time_backward(ln, rows, tag, source, g)
            ln.BWD_BLOCKS_PER_SM = shipped
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
