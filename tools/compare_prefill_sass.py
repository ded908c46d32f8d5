"""The prefill kernels' machine code: tensor-core use, registers, and
B10's write grid against another version of ``csrc/quant_prefill.cu``.

    python3 tools/compare_prefill_sass.py [--other-quant OTHER/quant_prefill.cu]

Compiles ``csrc/paged_prefill.cu`` and ``csrc/quant_prefill.cu`` for
``sm_90a`` with the build's flags and ``-Xptxas -v``, disassembles them
with ``cuobjdump -sass`` and prints, for every instantiation of
``paged_prefill_kernel`` (B9, and B11 where its q-offset flag is set) and
``quant_prefill_attn_kernel`` (B10's attention grid), its registers,
instruction count and ``HMMA`` (tensor-core) instructions. With
``--other-quant`` it also compiles the other source and prints whether
each ``quant_prefill_write_kernel`` (B10's write grid) instantiation's
instruction stream is identical in both. Exits non-zero if an
instantiation with a bf16 operand has no ``HMMA`` or a write grid
differs. Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); imports
nothing of JAX.
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
FOLD_KERNELS = ("paged_prefill_kernel", "quant_prefill_attn_kernel")
WRITE_KERNEL = "quant_prefill_write_kernel"


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


def label(name: str) -> str:
    """A mangled instantiation's kernel and template arguments, readable:
    ``paged_prefill_kernel<bf16, bf16, plain, ND=8>``."""
    base = next(k for k in FOLD_KERNELS + (WRITE_KERNEL,) if k in name)
    rest = name.split(base, 1)[1]
    args = rest[1:rest.find("EEv")] if rest.startswith("I") else ""
    names = []
    while args:
        for pattern, word in ((r"13__nv_bfloat16", "bf16"), (r"f", "f32"),
                              (r"S\d*_", None), (r"Lb(\d)E", "flag"),
                              (r"Li(\d+)E", "nd")):
            m = re.match(pattern, args)
            if not m:
                continue
            if word is None:        # a repeated type: the one before
                word = names[-1] if names else "?"
            elif word == "flag":
                word = "qoff" if m.group(1) == "1" else "plain"
            elif word == "nd":
                word = f"ND={m.group(1)}"
            names.append(word)
            args = args[m.end():]
            break
        else:
            names.append(args)
            break
    return f"{base}<{', '.join(names)}>"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other-quant", type=Path,
                   help="a quant_prefill.cu whose write grid to compare")
    p.add_argument("--nvcc", default="/usr/local/cuda/bin/nvcc")
    args = p.parse_args()
    funcs, regs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("paged_prefill", "quant_prefill"):
            f, r = compile_and_dump(args.nvcc, CSRC / f"{name}.cu",
                                    Path(tmp) / name)
            funcs.update(f)
            regs.update(r)
        other = other_regs = None
        if args.other_quant:
            other, other_regs = compile_and_dump(args.nvcc, args.other_quant,
                                                 Path(tmp) / "other")
    ok = True
    rows = []
    for name, instrs in sorted(funcs.items()):
        if not any(k in name for k in FOLD_KERNELS):
            continue
        hmma = sum(1 for i in instrs if i.split()[0].startswith("HMMA"))
        bf16 = "__nv_bfloat16" in name
        ok &= hmma > 0 or not bf16
        rows.append({"kernel": label(name), "registers": regs.get(name),
                     "instructions": len(instrs), "hmma": hmma})
    report = {"fold_sass": rows}
    if other is not None:
        # An anonymous namespace's mangled name carries its file's name,
        # so the two sources' kernels are matched by kernel and template
        # arguments.
        theirs = {label(n): (i, other_regs.get(n)) for n, i in other.items()
                  if WRITE_KERNEL in n}
        writes = []
        for name, instrs in sorted(funcs.items()):
            if WRITE_KERNEL not in name:
                continue
            other_instrs, other_reg = theirs.get(label(name), (None, None))
            same = other_instrs == instrs
            ok &= same
            writes.append({"kernel": label(name), "instructions": len(instrs),
                           "registers": regs.get(name),
                           "registers_other": other_reg, "identical": same})
        ok &= bool(writes)
        report["write_sass"] = writes
    report["ok"] = ok
    print(json.dumps(report))
    return 0 if ok and rows else 1


if __name__ == "__main__":
    sys.exit(main())
