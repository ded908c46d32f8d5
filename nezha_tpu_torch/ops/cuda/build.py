"""Build and load the port's CUDA kernels.

Each ``nezha_tpu_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface, which the kernel's wrapper loads with
``ctypes`` (pointers and the stream cross as ``c_void_p``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC --split-compile=0 -I csrc -o lib<name>.so \\
         csrc/<name>.cu

The build runs at first use, into ``build/nezha_tpu_torch/`` at the root
of the checkout (listed in ``.gitignore``), in a directory keyed by a hash
of the sources, headers and flags — an edited source builds anew, an
unchanged one is reused. :func:`build_all` starts one ``nvcc`` per source
at once. Builds and loads hold one module lock, so threads of one process
(two replicas' engines, say) never run ``nvcc`` twice for one source, and
each compiler writes a temporary file named by process and thread. There
is no fallback: if ``nvcc`` is missing or a build fails,
this raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "nezha_tpu_torch"
# --split-compile=0 runs a source's device optimization passes on all the
# host's cores: the build waits on its slowest source (paged_prefill.cu's
# instantiations), and splitting it shortens that wait
# (tools/time_kernel_build.py times the build with and without it).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0")
KERNELS = ("paged_decode", "paged_prefill", "flash_fwd", "flash_bwd",
           "flash_decode", "layer_norm", "paged_quant_decode",
           "quant_prefill")
# dtype codes the C entry points take (csrc/online_softmax.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Held across a build and a load: a second thread waits, then finds the
# library built.
_BUILD_LOCK = threading.RLock()


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel source failed to compile."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "build only where the CUDA toolkit is installed")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / f"{name}-{_digest(name)}" / f"lib{name}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source; -> (process, tmp output, final path), or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = KERNELS,
              timeout_s: float = 900.0) -> Dict[str, float]:
    """Build every named kernel library, one nvcc per source, all started
    together. -> seconds each build took (0.0 when already built)."""
    with _BUILD_LOCK:
        return _build_all(tuple(names), timeout_s)


def _build_all(names: Sequence[str], timeout_s: float) -> Dict[str, float]:
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    started = {name: _start(name, nvcc) for name in names}
    times: Dict[str, float] = {}
    failures = []
    for name, job in started.items():
        if job is None:
            times[name] = 0.0
            continue
        proc, tmp, out = job
        try:
            log, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failures.append(f"{name}: nvcc timed out after {timeout_s}s")
            continue
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0 or not tmp.exists():
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _BUILD_LOCK:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel ``name`` with its argument
    types declared (every pointer and the stream as ``c_void_p``, so no
    64-bit address is cut to an int) and an ``int`` result: the
    ``cudaError_t`` of the launch."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_head_dim(d: int, multiple: int = 8) -> None:
    """The kernels stage K/V in 16-byte loads and keep D/32 accumulator
    slots per lane: D must be a multiple of 8 (16 over int8 pools: one
    load holds 16 values), at most 128."""
    if d % multiple or not 0 < d <= 128:
        raise ValueError(f"head dim {d} not supported (a multiple of "
                         f"{multiple}, at most 128)")


def check_operands(q: torch.Tensor, **named) -> None:
    """What a kernel's C entry point assumes of its tensors: q of f32 or
    bf16, and each ``name=(tensor, dtype)`` of that dtype on q's device;
    all contiguous."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, (t, dtype) in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_aligned(**tensors: torch.Tensor) -> None:
    """16-byte vector loads need 16-byte aligned storage."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def check_launch(rc: int, symbol: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launch: a refused launch
    never runs, and no later synchronize would report it."""
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with "
                           f"cudaError_t {rc}")
