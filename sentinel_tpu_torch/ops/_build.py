"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface: ``nvcc`` compiles them for Hopper
(``sm_90a``) into one shared library, which is loaded with ``ctypes``.
The build runs at first use, from the sources in the checkout, into
``build/kernels/`` at the repository root (a directory git ignores); the
library's file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing build.

Nothing here runs at import time: the CPU tests import every module, and
the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = [_PKG / "csrc" / "fused.cu"]
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
#: what the last build printed (ptxas register / shared-memory report) and
#: how long it took; empty when the library was loaded from a previous build
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in ("/usr/local/cuda/bin/nvcc",):
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsentinel_kernels_{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sentinel_scatter_many.argtypes = [vp, i32, i32, vp, i64, vp]
    lib.sentinel_scatter_many.restype = i32
    lib.sentinel_gather_many.argtypes = [vp, i32, i32, vp]
    lib.sentinel_gather_many.restype = i32
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _target()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                capture_output=True,
                text=True,
            )
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
