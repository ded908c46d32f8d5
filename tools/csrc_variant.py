"""Build the port's kernels from an edited copy of their sources: the
tuning tools' way of timing a geometry or a constant the shipped sources
do not build. Needs ``nvcc``; imports nothing of JAX."""

from __future__ import annotations

import re
import shutil
from pathlib import Path

from nezha_tpu_torch.ops.cuda import build

PACKAGE_CSRC = build.CSRC


def build_variant(root: Path, names, edits=(), files=None) -> dict:
    """Copy ``nezha_tpu_torch/csrc`` into ``root/csrc`` (once: a root that
    exists is reused as it is), put each ``files`` entry (name -> path)
    in place of the source of that name, apply ``edits`` (source name,
    pattern, replacement; each pattern must match exactly once), point
    the kernel build at the copy with a build directory of its own, and
    build the kernels ``names`` -> {name: build seconds}."""
    csrc = root / "csrc"
    if not root.exists():
        shutil.copytree(PACKAGE_CSRC, csrc)
        for name, path in (files or {}).items():
            shutil.copyfile(path, csrc / name)
        for name, pattern, repl in edits:
            path = csrc / name
            text, n = re.subn(pattern, repl, path.read_text())
            if n != 1:
                raise SystemExit(f"{path}: expected one match of "
                                 f"{pattern!r}, found {n}")
            path.write_text(text)
    build.CSRC = csrc
    build.BUILD_ROOT = root / "build"
    build._load.cache_clear()
    build.bind.cache_clear()
    return build.build_all(tuple(names))
