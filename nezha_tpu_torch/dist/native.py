"""The native coordinator (``csrc/coordinator.cpp``), bound with
``ctypes``: the coordinator half of ``nezha_tpu/runtime/native.py``.

The library builds at first use from ``csrc/coordinator.cpp`` alone with
``csrc/Makefile``'s flags, into ``build/nezha_tpu_torch/coordinator-
<digest>/libnezha_coord.so`` (the loader's builder,
:func:`nezha_tpu_torch.data.native.build_library`: an ``flock`` and an
atomic rename). A failed build or a missing symbol raises
:class:`NativeBuildError`; there is no fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from nezha_tpu_torch.data.native import ROOT, build_library

SOURCE = ROOT / "csrc" / "coordinator.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The coordinator library did not build or load."""


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.nz_last_error.restype = c.c_char_p
    lib.nz_coord_start.restype = c.c_void_p
    lib.nz_coord_start.argtypes = [c.c_int, c.c_int, c.c_int]
    lib.nz_coord_port.restype = c.c_int
    lib.nz_coord_port.argtypes = [c.c_void_p]
    lib.nz_coord_stop.argtypes = [c.c_void_p]
    lib.nz_client_connect.restype = c.c_void_p
    lib.nz_client_connect.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int,
                                      c.c_int]
    lib.nz_client_rank.restype = c.c_int
    lib.nz_client_rank.argtypes = [c.c_void_p]
    lib.nz_client_world.restype = c.c_int
    lib.nz_client_world.argtypes = [c.c_void_p]
    lib.nz_client_put.restype = c.c_int
    lib.nz_client_put.argtypes = [c.c_void_p, c.c_char_p, c.c_void_p,
                                  c.c_long]
    lib.nz_client_get.restype = c.c_long
    lib.nz_client_get.argtypes = [c.c_void_p, c.c_char_p, c.c_void_p,
                                  c.c_long, c.c_long]
    lib.nz_client_incr.restype = c.c_long
    lib.nz_client_incr.argtypes = [c.c_void_p, c.c_char_p]
    lib.nz_client_barrier.restype = c.c_int
    lib.nz_client_barrier.argtypes = [c.c_void_p, c.c_long]
    lib.nz_client_failed.restype = c.c_long
    lib.nz_client_failed.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                     c.c_long]
    lib.nz_client_leave.argtypes = [c.c_void_p]
    lib.nz_client_close.argtypes = [c.c_void_p]
    return lib


def load_library() -> ctypes.CDLL:
    """Build (when its digest is new) and load the coordinator library."""
    global _lib
    with _lock:
        if _lib is None:
            out = build_library(SOURCE, "coordinator", "libnezha_coord.so",
                                NativeBuildError)
            try:
                _lib = _declare(ctypes.CDLL(str(out)))
            except (OSError, AttributeError) as e:
                raise NativeBuildError(f"coordinator library {out}: "
                                       f"{e}") from e
        return _lib
