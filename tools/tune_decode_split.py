"""Time the dense flash-decode kernel (B6) at each split size.

    python3 tools/tune_decode_split.py [--splits 128 256] [--other FILE]

``nezha_tpu_torch/csrc/flash_decode.cu`` folds each row's KV length in
splits of ``SPLIT`` keys, a compile-time constant. For each size this
copies ``nezha_tpu_torch/csrc`` into a temporary directory with ``SPLIT``
set to it, builds the kernel there, checks it against its plain version
(within ``fold_error_bound``; lengths 0 to L, bf16) and times it with
``chip_smoke.py``'s device timer at generate's shape (B=8, H=12, L=1024,
D=64, bf16 cache) with every row at length 512 and at 768, the span a
generate call of 512-token prompts and 256 new tokens walks. The sizes
run in the order given, then again in reverse, so each is timed twice.
``--other`` times another ``flash_decode.cu`` (the same C interface, e.g.
a variant saved into an ignored directory) the same way beside it.
Prints the card's name and power limit, then one JSON line per row.
Needs the card and ``nvcc``; imports nothing of JAX.
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
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from csrc_variant import PACKAGE_CSRC, build_variant  # noqa: E402
from nezha_tpu_torch.ops.cuda.decode_attention import (  # noqa: E402
    decode_split, flash_decode_attention, flash_decode_attention_plain)

B, H, L, D = 8, 12, 1024, 64


def use_split(tmp: Path, split: int, source: Path, tag: str) -> float:
    """Build flash_decode from a copy of the sources with ``source`` as
    flash_decode.cu and SPLIT = ``split`` -> its build seconds."""
    seconds = build_variant(
        tmp / f"{tag}_split{split}", ("flash_decode",),
        [("flash_decode.cu", r"constexpr int SPLIT = \d+;",
          f"constexpr int SPLIT = {split};")],
        {"flash_decode.cu": source})["flash_decode"]
    decode_split.cache_clear()
    return seconds


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--splits", type=int, nargs="+", default=[128, 256])
    p.add_argument("--other", type=Path, default=None,
                   help="another flash_decode.cu to time beside")
    args = p.parse_args()
    sources = [("tree", PACKAGE_CSRC / "flash_decode.cu")]
    if args.other:
        sources.append(("other", args.other.resolve()))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, H, n, D, generator=g).to("cuda", bf)
               for n in (1, L, L))
    checked = torch.tensor([0, 1, 127, 128, 129, 300, 768, L],
                           dtype=torch.int32, device="cuda")
    want = flash_decode_attention_plain(q, k, v, checked)
    bound = cs.fold_bound(
        want, flash_decode_attention_plain(q, k, v.abs(), checked))
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(tag, src, split) for split in args.splits
                for tag, src in sources]
        for tag, source, split in runs + runs[::-1]:
            build_s = use_split(Path(tmp), split, source, tag)
            assert decode_split() == split
            got = flash_decode_attention(q, k, v, checked)
            torch.cuda.synchronize()
            ratio = ((got.float() - want.float()).abs() / bound).max().item()
            if not ratio <= 1.0:
                cs.fail(f"{tag} split {split}: exceeds fold_error_bound "
                        f"({ratio})")
            for length in (512, 768):
                lens = torch.full((B,), length, dtype=torch.int32,
                                  device="cuda")
                row = cs.device_time(
                    f"decode {tag} split {split} length {length}",
                    lambda: flash_decode_attention(q, k, v, lens), 100)
                print(json.dumps({
                    "source": tag, "split": split, "length": length,
                    "grid": cs.launched_decode_grid(), "build_s": build_s,
                    "err_over_bound": ratio, "ms": row["ms"],
                    "ms_spread": row["ms_spread"],
                    "profiler_us": row["profiler_us"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
