"""Time the paged-prefill kernels at each block shape of their fold.

    python3 tools/tune_prefill_rows.py [--shapes 8x4 8x2 8x1 16x4]

The prefill fold (``nezha_tpu_torch/csrc/prefill_fold.cuh``) gives each
thread block ``PF_WARPS`` warps that fold ``KEY_SPLITS`` key tiles at
once, so a block owns 16 * PF_WARPS / KEY_SPLITS query rows. For each
shape WARPSxSPLITS this copies ``nezha_tpu_torch/csrc`` into a temporary
directory with the two constants set to it, builds the two prefill
sources from there and times, with ``chip_smoke.py``'s device timer and
at its shapes (GPT-2 124M: D=64, pool blocks of 16, 64 blocks a row,
bf16):

- B9 (``paged_prefill``): H=12, S=256 and S=32 at start 768;
- B11 (``paged_prefill_qoff``): the ring hop, H=3, each 64-query slice
  of a 256-row chunk from start 768;
- B10 (``paged_quant_prefill``, attention and write): H=12, S=256 at
  start 768 over int8 pools.

Each shape's B9 output must lie within ``fold_error_bound`` of the plain
version and its B11 slices must equal its B9 rows bitwise. Prints the
card's name and power limit, then one JSON line per shape. Needs the
card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from nezha_tpu_torch.ops.cuda import (  # noqa: E402
    build, paged_prefill_attention, paged_prefill_attention_plain,
    paged_prefill_qoff_attention, paged_quant_prefill_attention)

def use_shape(warps: int, splits: int, tmp: Path):
    """Point the kernel build at a copy of the sources with PF_WARPS =
    ``warps`` and KEY_SPLITS = ``splits``, in a build directory of its
    own, and build the two prefill sources there -> each build's
    seconds."""
    csrc = tmp / f"{warps}x{splits}" / "csrc"
    shutil.copytree(build.CSRC, csrc)
    header = csrc / "prefill_fold.cuh"
    text = header.read_text()
    for name, value in (("PF_WARPS", warps), ("KEY_SPLITS", splits)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{header}: expected one {name} line, found {n}")
    header.write_text(text)
    build.CSRC = csrc
    build.BUILD_ROOT = tmp / f"{warps}x{splits}" / "build"
    build._load.cache_clear()
    build.bind.cache_clear()
    return build.build_all(("paged_prefill", "quant_prefill"))


def inputs(g):
    """The smoke's operands: bf16 pools and one shuffled table row."""
    bf = torch.bfloat16
    n = 1 + cs.M
    pools = {h: [torch.randn(n, h, cs.BS, cs.D, generator=g).to("cuda", bf)
                 for _ in range(2)] for h in (cs.H // cs.SEQ_MESH, cs.H)}
    tab = cs.shuffled_tables(g, 1, n).cuda()
    chunks = {(h, s): [torch.randn(1, h, s, cs.D, generator=g).to("cuda", bf)
                       for _ in range(3)]
              for h, s in ((cs.H, 256), (cs.H, 32), (cs.H // cs.SEQ_MESH,
                                                     256))}
    return pools, tab, chunks, cs.int8_pools(g, n)


def measure(warps, splits, pools, tab, chunks, q8) -> dict:
    start = 768
    starts = torch.tensor([start], dtype=torch.int32, device="cuda")
    row = {"warps": warps, "key_splits": splits,
           "rows_per_block": 16 * warps // splits}
    for s in (256, 32):
        args = (*chunks[cs.H, s], *pools[cs.H], tab, starts)
        got = paged_prefill_attention(*args)
        want = paged_prefill_attention_plain(*args)
        q, kc, vc = chunks[cs.H, s]
        abs_v = paged_prefill_attention_plain(q, kc, vc.abs(), pools[cs.H][0],
                                              pools[cs.H][1].abs(), tab,
                                              starts)
        row[f"b9_s{s}_err_over_bound"] = cs.within_bound(
            f"b9 S={s}", got, want, abs_v)[1]
        t = cs.device_time(f"b9 S={s} {warps}x{splits}",
                           lambda: paged_prefill_attention(*args), 50)
        row[f"b9_s{s}"] = {k: t[k] for k in ("ms", "ms_spread",
                                             "profiler_us")}
    h = cs.H // cs.SEQ_MESH
    q, kc, vc = chunks[h, 256]
    s_q = 256 // cs.SEQ_MESH
    full = paged_prefill_attention(q, kc, vc, *pools[h], tab, starts)
    row["b11"] = []
    for k in range(cs.SEQ_MESH):
        qs = q[:, :, k * s_q:(k + 1) * s_q].contiguous()
        args = (qs, kc, vc, *pools[h], tab, starts, starts + k * s_q)
        if not torch.equal(paged_prefill_qoff_attention(*args),
                           full[:, :, k * s_q:(k + 1) * s_q]):
            cs.fail(f"{warps}x{splits}: B11 slice {k} differs from B9's "
                    f"rows")
        t = cs.device_time(f"b11 slice {k} {warps}x{splits}",
                           lambda: paged_prefill_qoff_attention(*args), 50)
        row["b11"].append({x: t[x] for x in ("ms", "ms_spread",
                                             "profiler_us")})
    kq, ks, vq, vs = (t.clone() for t in q8)
    args = (*chunks[cs.H, 256], kq, vq, ks, vs, tab, starts)
    t = cs.device_time(f"b10 {warps}x{splits}",
                       lambda: paged_quant_prefill_attention(*args), 50)
    row["b10"] = {x: t[x] for x in ("ms", "ms_spread", "profiler_us",
                                    "profiler_kernels")}
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+", default=["8x4", "8x2", "8x1",
                                                   "16x4"],
                   help="block shapes WARPSxSPLITS")
    args = p.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the tuning runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator().manual_seed(0)
    operands = inputs(g)
    with tempfile.TemporaryDirectory() as tmp:
        for shape in args.shapes:
            warps, splits = map(int, shape.split("x"))
            build_s = use_shape(warps, splits, Path(tmp))
            print(json.dumps({**measure(warps, splits, *operands),
                              "build_s": build_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
