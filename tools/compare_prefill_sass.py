"""The prefill kernels' machine code: tensor-core use, registers, and
B10's write grid against another version of ``csrc/quant_prefill.cu``;
the registers and spills of the float paged decode (B7) and the
LayerNorm backward (B5); and kernels a change must leave as they were
against another copy of the sources.

    python3 tools/compare_prefill_sass.py [--other-quant OTHER/quant_prefill.cu]
        [--other-csrc OTHER_CSRC]

Compiles ``csrc/paged_prefill.cu`` and ``csrc/quant_prefill.cu`` for
``sm_90a`` with the build's flags and ``-Xptxas -v``, disassembles them
with ``cuobjdump -sass`` and prints, for every instantiation of
``paged_prefill_kernel`` (B9, and B11 where its q-offset flag is set) and
``quant_prefill_attn_kernel`` (B10's attention grid), its registers,
instruction count and ``HMMA`` (tensor-core) instructions. For
information it prints, for every instantiation in ``INFO``'s sources
whose name holds its prefix (B7's kernels in ``csrc/paged_decode.cu``,
B5's in ``csrc/layer_norm.cu``), the registers, the bytes of spill
stores and loads and the instruction count ``ptxas`` and ``cuobjdump``
report. With ``--other-quant`` it also compiles the other source and
prints whether each ``quant_prefill_write_kernel`` (B10's write grid)
instantiation's instruction stream is identical in both. Exits non-zero
if an instantiation with a bf16 operand has no ``HMMA`` or a write grid
differs. With ``--other-csrc`` (another ``nezha_tpu_torch/csrc``, e.g. a
parent commit's) it compiles ``UNCHANGED``'s sources from both copies,
each against its own headers, and prints whether every instantiation of
B6's ``flash_decode_split_kernel``, B8's
``paged_quant_decode_split_kernel`` and B4's ``ln_fwd_kernel`` has the
same instruction stream in both (exit non-zero if not). Needs ``nvcc``
and ``cuobjdump`` (the CUDA toolkit); imports nothing of JAX.
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
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]
FOLD_KERNELS = ("paged_prefill_kernel", "quant_prefill_attn_kernel")
WRITE_KERNEL = "quant_prefill_write_kernel"
# Kernels to hold against another copy of the sources: source -> (kernel,
# whether a difference fails the run).
UNCHANGED = {"flash_decode": ("flash_decode_split_kernel", True),
             "paged_quant_decode": ("paged_quant_decode_split_kernel", True),
             "layer_norm": ("ln_fwd_kernel", True)}
# Kernels whose registers and spills are printed: source -> the prefix of
# their names.
INFO = {"paged_decode": "paged_decode", "layer_norm": "ln_bwd"}


def compile_and_dump(nvcc: str, source: Path, out: Path, spills=None):
    """-> ({kernel: [instructions]}, {kernel: registers}); the source
    compiles against the headers beside it. ``spills``, a dict, gets
    {kernel: (spill store bytes, spill load bytes)}."""
    obj = out.with_suffix(".o")
    log = subprocess.run([nvcc, *FLAGS, "-I", str(source.parent), "-o",
                          str(obj), str(source)],
                         capture_output=True, text=True, check=True).stderr
    regs, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            regs[current] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current and spills is not None:
            spills[current] = (int(m.group(1)), int(m.group(2)))
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


def same_kernels(nvcc: str, other_csrc: Path, tmp: Path):
    """UNCHANGED's kernels compiled from this tree and from other_csrc ->
    ([one row per instantiation], whether every required one matched).
    Instantiations are matched by kernel name and what follows it in the
    mangled name (template arguments and parameters): an anonymous
    namespace's mangled name carries its file's name."""
    rows, ok = [], True
    for source, (kernel, required) in UNCHANGED.items():
        dumps = []
        for tag, csrc in (("tree", CSRC), ("other", other_csrc)):
            funcs, regs = compile_and_dump(nvcc, csrc / f"{source}.cu",
                                           tmp / f"{tag}_{source}")
            dumps.append({name.split(kernel, 1)[1]: (instrs, regs.get(name))
                          for name, instrs in funcs.items() if kernel in name})
        mine, theirs = dumps
        for key in sorted(set(mine) | set(theirs)):
            same = key in mine and key in theirs and mine[key][0] == theirs[
                key][0]
            ok &= same or not required
            rows.append({"kernel": kernel, "instantiation": key,
                         "instructions": len(mine.get(key, ((),))[0]),
                         "registers": mine.get(key, (None, None))[1],
                         "registers_other": theirs.get(key, (None, None))[1],
                         "identical": same, "required": required})
        ok &= bool(mine) or not required
    return rows, ok


def kernel_info(nvcc: str, tmp: Path):
    """INFO's kernels compiled from this tree -> one row per
    instantiation: registers, spills, instructions."""
    rows = []
    for source, prefix in INFO.items():
        spills = {}
        funcs, regs = compile_and_dump(nvcc, CSRC / f"{source}.cu",
                                       tmp / f"info_{source}", spills)
        for name, instrs in sorted(funcs.items()):
            # The kernel's own name follows its length in the mangled
            # name (the anonymous namespace before it holds the file's).
            m = re.search(rf"(?<=\d)({prefix}\w*?_kernel)(?=[IE])", name)
            if not m:
                continue
            store, load = spills.get(name, (None, None))
            rows.append({"kernel": m.group(0), "mangled": name,
                         "registers": regs.get(name),
                         "spill_store_bytes": store,
                         "spill_load_bytes": load,
                         "instructions": len(instrs)})
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other-quant", type=Path,
                   help="a quant_prefill.cu whose write grid to compare")
    p.add_argument("--other-csrc", type=Path,
                   help="another nezha_tpu_torch/csrc whose B6, B8 and "
                        "B4-forward kernels to compare")
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
        info = kernel_info(args.nvcc, Path(tmp))
        same = same_ok = None
        if args.other_csrc:
            same, same_ok = same_kernels(args.nvcc, args.other_csrc.resolve(),
                                         Path(tmp))
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
    report = {"fold_sass": rows, "info": info}
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
    if same is not None:
        ok &= same_ok
        report["unchanged_sass"] = same
    report["ok"] = ok
    print(json.dumps(report))
    return 0 if ok and rows else 1


if __name__ == "__main__":
    sys.exit(main())
