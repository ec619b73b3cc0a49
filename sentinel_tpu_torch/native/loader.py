"""Build + load the native host library (``sentinel_host.cpp``).

The port's copy of ``sentinel_tpu/native/loader.py``.  ``g++`` compiles the
source in the checkout at first use — never at import — into
``build/native/`` at the repository root (a directory git ignores), the
same place ``ops/_build.py`` puts the CUDA kernels.  The library's file
name carries a hash of the source, so a stale or foreign binary is never
loaded: only a ``.so`` built from the exact ``sentinel_host.cpp`` on disk.
It is compiled to a temporary name and renamed into place, so processes
that build at once (test workers) each see all of a library or none.
When no toolchain is available, ``load_native()`` returns None and the
callers use the reference's numpy and Python forms.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "sentinel_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_log = logging.getLogger(__name__)


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_sentinel_host-{digest}.so"


def _build(so: Path) -> bool:
    # compile to a temp name, rename into place: a g++ killed mid-write
    # must never leave a truncated artifact at the final (hash-named,
    # existence-is-freshness) path
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        r = subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            capture_output=True,
            text=True,
            timeout=120,
        )
        if r.returncode != 0:
            _log.warning("native build failed: %s", r.stderr[-2000:])
            return False
        os.replace(tmp, so)
        # reap binaries from superseded source revisions
        for old in BUILD_DIR.glob("_sentinel_host-*.so"):
            if old != so:
                old.unlink(missing_ok=True)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i32, i64, u32, u64, f32 = c.c_int32, c.c_int64, c.c_uint32, c.c_uint64, c.c_float
    p = c.c_void_p
    lib.sx_ring_new.restype = p
    lib.sx_ring_new.argtypes = [u64]
    lib.sx_ring_free.argtypes = [p]
    lib.sx_ring_push.restype = i32
    lib.sx_ring_push.argtypes = [
        p, i32, i32, i32, i32, i32, f32, i32, i32, i32, i32, i32, i32
    ]
    lib.sx_ring_drain.restype = i64
    lib.sx_ring_drain.argtypes = [p, i64] + [p] * 12
    lib.sx_ring_size.restype = i64
    lib.sx_ring_size.argtypes = [p]
    lib.sx_intern_new.restype = p
    lib.sx_intern_new.argtypes = [u64, i32, i32]
    lib.sx_intern_free.argtypes = [p]
    lib.sx_intern_get.restype = i32
    lib.sx_intern_get.argtypes = [p, c.c_char_p, u32]
    lib.sx_intern_count.restype = i32
    lib.sx_intern_count.argtypes = [p, i32]
    # native front door (epoll token-protocol server; bound, not started)
    lib.sx_front_new.restype = p
    lib.sx_front_new.argtypes = [i32, u64, u64, u64, i32]
    lib.sx_front_free.argtypes = [p]
    lib.sx_front_port.restype = i32
    lib.sx_front_port.argtypes = [p]
    lib.sx_front_start.restype = i32
    lib.sx_front_start.argtypes = [p]
    lib.sx_front_stop.argtypes = [p]
    lib.sx_front_map_flow.restype = i32
    lib.sx_front_map_flow.argtypes = [p, i64, i32]
    lib.sx_front_map_param.restype = i32
    lib.sx_front_map_param.argtypes = [p, i64, i32, i32]
    lib.sx_front_set_guard.argtypes = [p, i64]
    lib.sx_front_clear_flows.argtypes = [p]
    lib.sx_front_acq_backlog.restype = i64
    lib.sx_front_acq_backlog.argtypes = [p]
    lib.sx_front_drain_acquires.restype = i64
    lib.sx_front_drain_acquires.argtypes = [p, i64] + [p] * 4
    lib.sx_front_drain_acquires2.restype = i64
    lib.sx_front_drain_acquires2.argtypes = [p, i64] + [p] * 7
    lib.sx_front_respond.restype = i32
    lib.sx_front_respond.argtypes = [p, i64] + [p] * 3
    lib.sx_front_respond_ex.restype = i32
    lib.sx_front_respond_ex.argtypes = [p, i64] + [p] * 5
    # batch-build presort (stable multi-key argsort + inverse permutation)
    lib.sx_batch_sort5.restype = i64
    lib.sx_batch_sort5.argtypes = [i64] + [p] * 7
    lib.sx_batch_sort3.restype = i64
    lib.sx_batch_sort3.argtypes = [i64] + [p] * 5
    # protocol v2 BATCH framing (big-endian column entries <-> int columns)
    lib.sx_frame_pack_entries.restype = i64
    lib.sx_frame_pack_entries.argtypes = [i64] + [p] * 5
    lib.sx_frame_unpack_entries.restype = i64
    lib.sx_frame_unpack_entries.argtypes = [i64] + [p] * 5
    lib.sx_frame_pack_results.restype = i64
    lib.sx_frame_pack_results.argtypes = [i64] + [p] * 5
    lib.sx_frame_unpack_results.restype = i64
    lib.sx_frame_unpack_results.argtypes = [i64] + [p] * 5
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The bound CDLL, building it on first use; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _so_path()
        # the hash in the filename ties the binary to this exact source —
        # existence is sufficient freshness
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            _LIB = _bind(ctypes.CDLL(str(so)))
        except OSError:
            _LIB = None
        return _LIB


def native_available() -> bool:
    return load_native() is not None
