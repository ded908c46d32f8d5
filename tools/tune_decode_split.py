"""Time a split decode kernel at each split size: the dense flash-decode
(B6), the float paged decode (B7) or the int8 paged decode (B8).

    python3 tools/tune_decode_split.py [--kernel dense|paged|quant]
        [--splits 128 256] [--other FILE] [--root DIR]

``nezha_tpu_torch/csrc/flash_decode.cu`` (``--kernel dense``, the default),
``csrc/paged_decode.cu`` (``--kernel paged``) and
``csrc/paged_quant_decode.cu`` (``--kernel quant``) fold each row's KV
length in splits of ``SPLIT`` keys, a compile-time constant. For each size
this copies ``nezha_tpu_torch/csrc`` into a temporary directory with
``SPLIT`` set to it, builds the kernel there, checks it against its plain
version (within ``fold_error_bound``; bf16 q, lengths from 0 to the cache's
end and on the first splits' boundaries) and times it with
``chip_smoke.py``'s device timer:

- dense: generate's shape (B=8, H=12, L=1024, D=64, bf16 cache) with every
  row at length 512 and at 768, the span a generate call of 512-token
  prompts and 256 new tokens walks;
- paged and quant: ``chip_smoke.py``'s serving shape (B=8, D=64,
  16-position pool blocks, M=64, lengths [0, 1, 15, 16, 17, 300, 777,
  1024]; bf16 pools, or int8 pools) at H=12 (the engine) and H=3 (a
  shard of the 4-way mesh).

The sizes run in the order given, then again in reverse, so each is timed
twice. ``--other`` times another source of the kernel (the same C
interface, e.g. a variant saved into an ignored directory) the same way
beside it. ``--root DIR`` instead checks and times, on the same cases,
the kernel of the ``nezha_tpu_torch`` package under DIR as it is built
there (e.g. a parent commit unpacked into an ignored directory), so two
versions can be timed in one call. Prints the card's name and power
limit, then one JSON line per row. Needs the card and ``nvcc``; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

B, D = 8, 64
DENSE_H, DENSE_L = 12, 1024
POOL_BS, POOL_M = 16, 64
POOL_LENGTHS = [0, 1, 15, 16, 17, 300, 777, POOL_M * POOL_BS]
POOL_HEADS = (12, 3)


def dense_cases(g):
    """-> (the checked call and its plain version, each taking v; v;
    [(label, timed call)])."""
    from nezha_tpu_torch.ops.cuda.decode_attention import (
        flash_decode_attention, flash_decode_attention_plain)

    bf = torch.bfloat16
    q, k, v = (torch.randn(B, DENSE_H, n, D, generator=g).to("cuda", bf)
               for n in (1, DENSE_L, DENSE_L))
    checked = torch.tensor([0, 1, 127, 128, 129, 300, 768, DENSE_L],
                           dtype=torch.int32, device="cuda")
    timed = []
    for length in (512, 768):
        lens = torch.full((B,), length, dtype=torch.int32, device="cuda")
        timed.append((f"length {length}",
                      lambda lens=lens: flash_decode_attention(q, k, v,
                                                               lens)))
    return ((lambda vv=v: flash_decode_attention(q, k, vv, checked)),
            (lambda vv=v: flash_decode_attention_plain(q, k, vv, checked)),
            v, timed)


def pool_table(g):
    """The serving shape's lengths and shuffled tables on the card."""
    n = 1 + B * POOL_M
    lens = torch.tensor(POOL_LENGTHS, dtype=torch.int32, device="cuda")
    tab = (torch.randperm(n - 1, generator=g) + 1)[:B * POOL_M].reshape(
        B, POOL_M).to("cuda", torch.int32)
    return n, lens, tab


def paged_cases(g):
    """``chip_smoke.py``'s B7 timing shape over bf16 pools at H=12 and
    H=3."""
    from nezha_tpu_torch.ops.cuda.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    bf = torch.bfloat16
    n, lens, tab = pool_table(g)
    per_h = {}
    for h in POOL_HEADS:
        per_h[h] = tuple(torch.randn(*shape, generator=g).to("cuda", bf)
                         for shape in ((B, h, 1, D), (n, h, POOL_BS, D),
                                       (n, h, POOL_BS, D)))
    q, kp, vp = per_h[12]
    timed = [(f"H={h}",
              lambda a=a: paged_decode_attention(*a, lens, tab))
             for h, a in per_h.items()]
    return ((lambda vv=vp: paged_decode_attention(q, kp, vv, lens, tab)),
            (lambda vv=vp: paged_decode_attention_plain(q, kp, vv, lens,
                                                        tab)),
            vp, timed)


def quant_cases(g):
    """The int8 pools of ``chip_smoke.py``'s B8 check at H=12 and H=3."""
    from nezha_tpu_torch.ops.cuda.decode_attention import (
        paged_quant_decode_attention, paged_quant_decode_attention_plain)
    from nezha_tpu_torch.ops.quant import quantize_kv_block

    bf = torch.bfloat16
    n, lens, tab = pool_table(g)
    per_h = {}
    for h in POOL_HEADS:
        pools = [quantize_kv_block(torch.randn(
            n, h, POOL_BS, D, generator=g).to("cuda", bf)) for _ in "kv"]
        q = torch.randn(B, h, 1, D, generator=g).to("cuda", bf)
        per_h[h] = (q, pools[0][0], pools[1][0], pools[0][1], pools[1][1])
    q, kq, vq, ks, vs = per_h[12]
    timed = [(f"H={h}",
              lambda a=a: paged_quant_decode_attention(*a, lens, tab))
             for h, a in per_h.items()]
    return ((lambda vv=vq: paged_quant_decode_attention(q, kq, vv, ks, vs,
                                                        lens, tab)),
            (lambda vv=vq: paged_quant_decode_attention_plain(
                q, kq, vv, ks, vs, lens, tab)),
            vq, timed)


KERNELS = {"dense": ("flash_decode", dense_cases),
           "paged": ("paged_decode", paged_cases),
           "quant": ("paged_quant_decode", quant_cases)}


def check(cs, call, want, bound, tag: str) -> float:
    """The kernel's output on the checked case within its bound ->
    the largest ratio."""
    got = call()
    torch.cuda.synchronize()
    ratio = ((got.float() - want.float()).abs() / bound).max().item()
    if not ratio <= 1.0:
        cs.fail(f"{tag}: exceeds fold_error_bound ({ratio})")
    return ratio


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=sorted(KERNELS), default="dense")
    p.add_argument("--splits", type=int, nargs="+", default=[128, 256])
    p.add_argument("--other", type=Path, default=None,
                   help="another source of the kernel to time beside")
    p.add_argument("--root", type=Path, default=None,
                   help="time the kernel of the package under this root")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    # This tree's timer, then (--root) the other package ahead of this
    # tree's.
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    if args.root is not None:
        if args.other:
            raise SystemExit("--root times that package's kernel only")
        sys.path.insert(0, str(args.root.resolve()))
    from csrc_variant import PACKAGE_CSRC, build_variant
    from nezha_tpu_torch.ops.cuda.decode_attention import split_size

    name, cases = KERNELS[args.kernel]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"package: {PACKAGE_CSRC.parents[1]}", flush=True)
    call, plain, v, timed = cases(torch.Generator().manual_seed(0))
    want = plain()
    bound = cs.fold_bound(want, plain(v.abs()))
    if args.root is not None:
        ratio = check(cs, call, want, bound, f"{args.root}")
        for label, fn in timed:
            row = cs.device_time(f"{name} {args.root} {label}", fn, 100)
            print(json.dumps({
                "kernel": name, "source": str(args.root), "case": label,
                "err_over_bound": ratio,
                **{k: row[k] for k in ("ms", "empty_ms", "ms_less_empty",
                                       "ms_spread", "profiler_us")}}),
                flush=True)
        return 0
    sources = [("tree", PACKAGE_CSRC / f"{name}.cu")]
    if args.other:
        sources.append(("other", args.other.resolve()))
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(tag, src, split) for split in args.splits
                for tag, src in sources]
        for tag, source, split in runs + runs[::-1]:
            build_s = build_variant(
                Path(tmp) / f"{tag}_split{split}", (name,),
                [(f"{name}.cu", r"constexpr int SPLIT = \d+;",
                  f"constexpr int SPLIT = {split};")],
                {f"{name}.cu": source})[name]
            split_size.cache_clear()
            assert split_size(name) == split
            ratio = check(cs, call, want, bound, f"{tag} split {split}")
            for label, fn in timed:
                row = cs.device_time(f"{name} {tag} split {split} {label}",
                                     fn, 100)
                print(json.dumps({
                    "kernel": name, "source": tag, "split": split,
                    "case": label, "grid": cs.launched_grid(name),
                    "build_s": build_s, "err_over_bound": ratio,
                    **{k: row[k] for k in ("ms", "empty_ms",
                                           "ms_less_empty", "ms_spread",
                                           "profiler_us")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
