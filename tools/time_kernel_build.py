"""The kernel build's wall by source: every ``nezha_tpu_torch/csrc``
source's ``nvcc`` started at once, as ``ops/cuda/build.py``
``build_all`` starts them, each one's end read as it comes, into a
temporary directory (the checkout's build cache is neither read nor
written). Run once with the build's flags and once with them less
``--split-compile``, so the two can be set side by side on one host.

    python3 tools/time_kernel_build.py

Prints the host's CPU count, then one JSON line a run: seconds from the
start to each source's end, and the run's wall. Needs ``nvcc``; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nezha_tpu_torch.ops.cuda import build  # noqa: E402


def timed_build(flags, label: str) -> dict:
    nvcc = build.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [nvcc, *flags, "-I", str(build.CSRC), "-o",
             f"{tmp}/lib{name}.so", str(build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in build.KERNELS}
        t0 = time.perf_counter()
        ends = {}
        while len(ends) < len(procs):
            for name, proc in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
                    if proc.returncode:
                        raise SystemExit(f"{name}: nvcc exit "
                                         f"{proc.returncode}\n"
                                         f"{proc.stdout.read()[-3000:]}")
            time.sleep(0.1)
    return {"flags": label, "end_s": ends, "wall_s": max(ends.values())}


def main() -> int:
    print(json.dumps({"cpus": os.cpu_count()}), flush=True)
    plain = [f for f in build.NVCC_FLAGS if not f.startswith(
        "--split-compile")]
    for flags, label in ((build.NVCC_FLAGS, "build"),
                         (plain, "without --split-compile")):
        print(json.dumps(timed_build(flags, label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
