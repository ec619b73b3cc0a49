"""Python wrappers over the native ring/interner, with pure fallbacks.

The port's copy of ``sentinel_tpu/native/ring.py``.

EventRing drains straight into numpy arrays (the exact layout the engine's
AcquireBatch/CompleteBatch want), so the tick thread's batch assembly is a
single C call instead of a Python loop over event objects.
"""

from __future__ import annotations

import ctypes
import threading
from collections import deque
from typing import Optional, Tuple

import numpy as np

from sentinel_tpu_torch.native.loader import load_native

FLAG_INBOUND = 1
FLAG_PRIORITIZED = 2
FLAG_COMPLETION = 4


class EventRing:
    """Bounded MPMC event ring; native when possible, deque fallback."""

    def __init__(self, capacity_pow2: int = 1 << 16):
        assert capacity_pow2 & (capacity_pow2 - 1) == 0
        self.capacity = capacity_pow2
        self._lib = load_native()
        if self._lib is not None:
            self._ring = self._lib.sx_ring_new(capacity_pow2)
            if not self._ring:  # allocation failed → fallback
                self._lib = None
        if self._lib is None:
            self._dq: deque = deque()
            self._dq_lock = threading.Lock()

    @property
    def native(self) -> bool:
        return self._lib is not None

    def push(
        self,
        res: int,
        count: int = 1,
        origin_id: int = -1,
        param_hash: int = 0,
        flags: int = 0,
        rt_ms: float = 0.0,
        error: int = 0,
        user_tag: int = 0,
        aux0: int = 0,
        aux1: int = 0,
        aux2: int = 0,
        aux3: int = 0,
    ) -> bool:
        if self._lib is not None:
            return (
                self._lib.sx_ring_push(
                    self._ring, res, count, origin_id, param_hash, flags,
                    rt_ms, error, user_tag, aux0, aux1, aux2, aux3,
                )
                == 0
            )
        with self._dq_lock:
            if len(self._dq) >= self.capacity:
                return False
            self._dq.append((res, count, origin_id, param_hash, flags, rt_ms,
                             error, user_tag, aux0, aux1, aux2, aux3))
            return True

    def drain(self, max_n: int) -> Tuple[np.ndarray, ...]:
        """(res, count, origin_id, param_hash, flags, rt_ms, error,
        user_tag, aux0, aux1, aux2, aux3) arrays of length n <= max_n."""
        res = np.empty(max_n, np.int32)
        count = np.empty(max_n, np.int32)
        origin = np.empty(max_n, np.int32)
        ph = np.empty(max_n, np.int32)
        flags = np.empty(max_n, np.int32)
        rt = np.empty(max_n, np.float32)
        err = np.empty(max_n, np.int32)
        tag = np.empty(max_n, np.int32)
        aux0 = np.empty(max_n, np.int32)
        aux1 = np.empty(max_n, np.int32)
        aux2 = np.empty(max_n, np.int32)
        aux3 = np.empty(max_n, np.int32)
        if self._lib is not None:
            cp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
            n = self._lib.sx_ring_drain(
                self._ring, max_n, cp(res), cp(count), cp(origin), cp(ph),
                cp(flags), cp(rt), cp(err), cp(tag), cp(aux0), cp(aux1),
                cp(aux2), cp(aux3),
            )
        else:
            n = 0
            with self._dq_lock:
                while n < max_n and self._dq:
                    row = self._dq.popleft()
                    (res[n], count[n], origin[n], ph[n], flags[n], rt[n],
                     err[n], tag[n], aux0[n], aux1[n], aux2[n], aux3[n]) = row
                    n += 1
        return tuple(a[:n] for a in (res, count, origin, ph, flags, rt, err,
                                     tag, aux0, aux1, aux2, aux3))

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.sx_ring_size(self._ring))
        return len(self._dq)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_ring", None):
            lib.sx_ring_free(self._ring)
            self._ring = None


class NativeInterner:
    """String -> dense id with lock-free reads.

    Not wired into the Python Registry: crossing ctypes per lookup costs
    more than a dict hit, so from Python the dict wins.  This exists for
    native-side ingestion (a C command/RLS front door resolving resource
    names without entering Python — SURVEY §2.9's host boundary), where
    the same id space must be shared with the device engine."""

    def __init__(self, capacity_pow2: int = 1 << 20, first_id: int = 1, max_ids: int = 1 << 20):
        self._lib = load_native()
        self.first_id = first_id
        if self._lib is not None:
            self._tbl = self._lib.sx_intern_new(capacity_pow2, first_id, max_ids)
            if not self._tbl:
                self._lib = None
        if self._lib is None:
            self._py: dict = {}
            self._lock = threading.Lock()
            self._next = first_id
            self._max = max_ids

    @property
    def native(self) -> bool:
        return self._lib is not None

    def get(self, name: str) -> int:
        """Dense id for name; -1 when capacity is exhausted."""
        if self._lib is not None:
            b = name.encode("utf-8")
            return int(self._lib.sx_intern_get(self._tbl, b, len(b)))
        rid = self._py.get(name)
        if rid is not None:
            return rid
        with self._lock:
            rid = self._py.get(name)
            if rid is not None:
                return rid
            if self._next >= self._max:
                return -1
            rid = self._next
            self._next += 1
            self._py[name] = rid
            return rid

    def count(self) -> int:
        if self._lib is not None:
            return int(self._lib.sx_intern_count(self._tbl, self.first_id))
        return len(self._py)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_tbl", None):
            lib.sx_intern_free(self._tbl)
            self._tbl = None


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def batch_sort5(k0, k1, k2, k3, k4, want_inv: bool = True):
    """Stable argsort by (k0, k1, k2, k3, k4), k0 most significant.

    Equivalent to ``np.lexsort((k4, k3, k2, k1, k0))`` — both the native
    and the fallback path are stable sorts, so tie order is identical.
    Returns ``(order, inv)`` int32 arrays (``inv`` None when not wanted);
    ``inv[order] == arange(n)``.
    """
    k0, k1, k2, k3, k4 = map(_as_i32, (k0, k1, k2, k3, k4))
    n = k0.shape[0]
    lib = load_native()
    if lib is not None:
        order = np.empty(n, np.int32)
        inv = np.empty(n, np.int32) if want_inv else None
        cp = lambda a: a.ctypes.data_as(ctypes.c_void_p) if a is not None else None
        lib.sx_batch_sort5(n, cp(k0), cp(k1), cp(k2), cp(k3), cp(k4),
                           cp(order), cp(inv))
        return order, inv
    order = np.lexsort((k4, k3, k2, k1, k0)).astype(np.int32)
    inv = None
    if want_inv:
        inv = np.empty(n, np.int32)
        inv[order] = np.arange(n, dtype=np.int32)
    return order, inv


# ---------------------------------------------------------------------------
# protocol v2 BATCH framing (cluster/protocol.py)
# ---------------------------------------------------------------------------
#
# Fixed-width big-endian column entries; the native pack/unpack loop and
# the numpy structured-dtype fallback produce IDENTICAL bytes (pinned by
# tests/test_torch_native.py), so peers built with and without a
# toolchain interoperate bit-exactly.

BATCH_ENTRY_SIZE = 14  # [kind:u8][id:i64][count:i32][flags:u8]
BATCH_RESULT_SIZE = 17  # [status:i8][remaining:i32][wait:i32][token:i64]

_ENTRY_DT = np.dtype(
    [("kind", "u1"), ("id", ">i8"), ("count", ">i4"), ("flags", "u1")]
)
_RESULT_DT = np.dtype(
    [("status", "i1"), ("remaining", ">i4"), ("wait", ">i4"), ("token", ">i8")]
)
assert _ENTRY_DT.itemsize == BATCH_ENTRY_SIZE
assert _RESULT_DT.itemsize == BATCH_RESULT_SIZE

_cp = lambda a: a.ctypes.data_as(ctypes.c_void_p)


def pack_batch_entries(kinds, ids, counts, flags) -> bytes:
    """Request entry columns → packed wire bytes (n × 14 B)."""
    kinds = np.ascontiguousarray(kinds, np.uint8)
    ids = np.ascontiguousarray(ids, np.int64)
    counts = np.ascontiguousarray(counts, np.int32)
    flags = np.ascontiguousarray(flags, np.uint8)
    n = kinds.shape[0]
    lib = load_native()
    if lib is not None:
        out = np.empty(n * BATCH_ENTRY_SIZE, np.uint8)
        lib.sx_frame_pack_entries(n, _cp(kinds), _cp(ids), _cp(counts),
                                  _cp(flags), _cp(out))
        return out.tobytes()
    rec = np.empty(n, _ENTRY_DT)
    rec["kind"], rec["id"], rec["count"], rec["flags"] = kinds, ids, counts, flags
    return rec.tobytes()


def unpack_batch_entries(buf: bytes) -> Tuple[np.ndarray, ...]:
    """Packed wire bytes → ``(kinds, ids, counts, flags)`` native-endian
    columns; raises on a length that is not a whole number of entries."""
    n, rem = divmod(len(buf), BATCH_ENTRY_SIZE)
    if rem:
        raise ValueError(f"truncated batch entries ({len(buf)} bytes)")
    lib = load_native()
    if lib is not None:
        raw = np.frombuffer(buf, np.uint8)
        kinds = np.empty(n, np.uint8)
        ids = np.empty(n, np.int64)
        counts = np.empty(n, np.int32)
        flags = np.empty(n, np.uint8)
        lib.sx_frame_unpack_entries(n, _cp(raw), _cp(kinds), _cp(ids),
                                    _cp(counts), _cp(flags))
        return kinds, ids, counts, flags
    rec = np.frombuffer(buf, _ENTRY_DT)
    return (
        rec["kind"].astype(np.uint8),
        rec["id"].astype(np.int64),
        rec["count"].astype(np.int32),
        rec["flags"].astype(np.uint8),
    )


def pack_batch_results(statuses, remainings, waits, tokens) -> bytes:
    """Response entry columns → packed wire bytes (n × 17 B)."""
    statuses = np.ascontiguousarray(statuses, np.int8)
    remainings = np.ascontiguousarray(remainings, np.int32)
    waits = np.ascontiguousarray(waits, np.int32)
    tokens = np.ascontiguousarray(tokens, np.int64)
    n = statuses.shape[0]
    lib = load_native()
    if lib is not None:
        out = np.empty(n * BATCH_RESULT_SIZE, np.uint8)
        lib.sx_frame_pack_results(n, _cp(statuses), _cp(remainings),
                                  _cp(waits), _cp(tokens), _cp(out))
        return out.tobytes()
    rec = np.empty(n, _RESULT_DT)
    rec["status"], rec["remaining"] = statuses, remainings
    rec["wait"], rec["token"] = waits, tokens
    return rec.tobytes()


def unpack_batch_results(buf: bytes) -> Tuple[np.ndarray, ...]:
    """Packed wire bytes → ``(statuses, remainings, waits, tokens)``."""
    n, rem = divmod(len(buf), BATCH_RESULT_SIZE)
    if rem:
        raise ValueError(f"truncated batch results ({len(buf)} bytes)")
    lib = load_native()
    if lib is not None:
        raw = np.frombuffer(buf, np.uint8)
        statuses = np.empty(n, np.int8)
        remainings = np.empty(n, np.int32)
        waits = np.empty(n, np.int32)
        tokens = np.empty(n, np.int64)
        lib.sx_frame_unpack_results(n, _cp(raw), _cp(statuses),
                                    _cp(remainings), _cp(waits), _cp(tokens))
        return statuses, remainings, waits, tokens
    rec = np.frombuffer(buf, _RESULT_DT)
    return (
        rec["status"].astype(np.int8),
        rec["remaining"].astype(np.int32),
        rec["wait"].astype(np.int32),
        rec["token"].astype(np.int64),
    )


def batch_sort3(k0, k1, k2, want_inv: bool = False):
    """Stable argsort by (k0, k1, k2); see :func:`batch_sort5`."""
    k0, k1, k2 = map(_as_i32, (k0, k1, k2))
    n = k0.shape[0]
    lib = load_native()
    if lib is not None:
        order = np.empty(n, np.int32)
        inv = np.empty(n, np.int32) if want_inv else None
        cp = lambda a: a.ctypes.data_as(ctypes.c_void_p) if a is not None else None
        lib.sx_batch_sort3(n, cp(k0), cp(k1), cp(k2), cp(order), cp(inv))
        return order, inv
    order = np.lexsort((k2, k1, k0)).astype(np.int32)
    inv = None
    if want_inv:
        inv = np.empty(n, np.int32)
        inv[order] = np.arange(n, dtype=np.int32)
    return order, inv
