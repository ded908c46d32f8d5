"""Check that the float paged-prefill kernel (B9) compiles to the same
machine code as another version of ``csrc/paged_prefill.cu``.

    python3 tools/compare_prefill_sass.py OTHER/paged_prefill.cu

Compiles both sources for ``sm_90a`` with the build's flags and
``-Xptxas -v``, disassembles them with ``cuobjdump -sass`` and, for each
dtype instantiation of ``paged_prefill_kernel`` in the other source,
finds this source's float (non-q-offset) instantiation of the same
dtypes and prints both register counts and whether the instruction
streams are identical. Exits non-zero if any differs. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "nezha_tpu_torch" / "csrc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-I", str(CSRC)]


def compile_and_dump(nvcc: str, source: Path, out: Path):
    """-> ({kernel: [instructions]}, {kernel: registers})."""
    obj = out.with_suffix(".o")
    log = subprocess.run([nvcc, *FLAGS, "-o", str(obj), str(source)],
                         capture_output=True, text=True, check=True).stderr
    regs, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            regs[current] = int(m.group(1))
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass",
                           str(obj)], capture_output=True, text=True,
                          check=True).stdout
    funcs, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            funcs[current] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?);", line)
        if m and current:
            funcs[current].append(m.group(1).strip())
    return funcs, regs


def dtypes(name: str) -> str:
    """The template arguments of a mangled ``paged_prefill_kernel``,
    without the q-offset flag."""
    args = name.split("paged_prefill_kernel")[1].split("EEv")[0]
    return re.sub(r"Lb[01]E?$", "", args)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path,
                   help="the paged_prefill.cu to compare with")
    p.add_argument("--nvcc", default="/usr/local/cuda/bin/nvcc")
    args = p.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        other, other_regs = compile_and_dump(args.nvcc, args.other,
                                             Path(tmp) / "other")
        mine, my_regs = compile_and_dump(args.nvcc,
                                         CSRC / "paged_prefill.cu",
                                         Path(tmp) / "mine")
    rows, same = [], True
    for name, instrs in other.items():
        if "paged_prefill_kernel" not in name:
            continue
        match = [n for n in mine if "paged_prefill_kernel" in n
                 and "Lb1E" not in n and dtypes(n) == dtypes(name)]
        ok = len(match) == 1 and mine[match[0]] == instrs
        same &= ok
        rows.append({"dtypes": dtypes(name), "instructions": len(instrs),
                     "registers_other": other_regs.get(name),
                     "registers": my_regs.get(match[0]) if match else None,
                     "identical": ok})
    print(json.dumps({"b9_sass": rows, "identical": same}))
    return 0 if same and rows else 1


if __name__ == "__main__":
    sys.exit(main())
