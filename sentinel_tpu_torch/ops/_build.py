"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface: ``nvcc`` compiles them for Hopper
(``sm_90a``) into one shared library, which is loaded with ``ctypes``.
The build runs at first use, from the sources in the checkout, into
``build/kernels/`` at the repository root (a directory git ignores); the
library's file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing build.  Each
source compiles in its own ``nvcc`` process, all started together, and
one more call links the objects.

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
SOURCES = [_PKG / "csrc" / name for name in ("fused.cu", "segscan.cu", "probes.cu")]
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    lib.sentinel_scatter_many.argtypes = [vp, i32, i32, vp, i64, vp, vp, i32, vp]
    lib.sentinel_gather_many.argtypes = [vp, i32, i32, i32, vp]
    lib.sentinel_seg_excl_cumsum.argtypes = [vp, vp, vp, i32, vp, vp, i32, vp, vp, i32, vp]
    lib.sentinel_seg_incl_min.argtypes = [vp, vp, vp, vp, vp, i32, vp]
    lib.sentinel_seg_build.argtypes = [ctypes.POINTER(vp), i32, vp, vp, vp, i32, ctypes.c_float,
                                       ctypes.POINTER(i32), ctypes.POINTER(i32), i32, i32, i32, *[vp] * 12]
    lib.sentinel_seg_scan_tile.argtypes = []
    for fn in (lib.sentinel_scatter_many, lib.sentinel_gather_many, lib.sentinel_seg_excl_cumsum,
               lib.sentinel_seg_incl_min, lib.sentinel_seg_build, lib.sentinel_seg_scan_tile):
        fn.restype = i32
    lib.sentinel_probe_copy.argtypes = [vp, vp, i64, i32, vp]
    plan = [i32] * 5  # cluster, clusters, rows_per_block, smem_bytes, threads
    lib.sentinel_probe_hist_count.argtypes = [vp, i64, i32, vp, i64, i32, *plan, vp]
    lib.sentinel_probe_hist_planes.argtypes = [vp, vp, i32, i64, i32, i32, vp, i64, i32, *plan, vp]
    lib.sentinel_probe_hist_stat5.argtypes = [vp, vp, vp, i64, i32, vp, i64, i32, *plan, vp]
    lib.sentinel_probe_hist_max_clusters.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.sentinel_probe_copy, lib.sentinel_probe_hist_count, lib.sentinel_probe_hist_planes,
               lib.sentinel_probe_hist_stat5, lib.sentinel_probe_hist_max_clusters):
        fn.restype = i32
    return lib


def _build(so: Path) -> None:
    """One nvcc per source, all at once, then one link into ``so``."""
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        p = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((src, obj, p))
    logs = [f"== {src.name}\n{p.communicate()[0]}" for src, _obj, p in procs]
    failed = [f"{src.name} ({p.returncode})" for src, _obj, p in procs if p.returncode != 0]
    if not failed:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [_nvcc(), *ARCH, "-shared", "-o", str(tmp), *(str(obj) for _s, obj, _p in procs)],
            capture_output=True, text=True,
        )
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    for _src, obj, _p in procs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = _target()
            if not os.path.exists(so):
                _build(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
