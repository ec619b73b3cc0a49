"""Every collective the sharded engine sends, and the ledger that records it.

In the reference, XLA's partitioner places the collectives of a sharded
tick; the port runs eagerly and places them by hand.  Each one goes
through this module:

* ``all_reduce`` (SUM, MIN, MAX) and ``all_gather`` (the list form)
  over the shard's process group.  Only these: the ``gloo`` backend
  takes them on CUDA tensors, where it may not take
  ``all_gather_into_tensor`` or ``reduce_scatter``;
* the shard context (``ShardCtx``: the rank, the world size, the group),
  which ``parallel/spmd.make_sharded_tick`` sets for the duration of a
  sharded call (``scope``) and the ops layer reads (``current``).  It is
  None on the single-device path, which then runs exactly as before;
* the ledger: while ``recording()`` is on, every call appends a
  ``Record`` (kind, dtype, per-rank result shape, bytes, and the caller's
  ``file:line`` in the repo).  The tier-4 analyzer (analysis/spmd) reads
  it in place of the reference's optimized-HLO text;
* ``stats()``: the count, the bytes and the time of the collectives sent
  while it is on (the host's clock, and CUDA events on the card, which
  add no host sync), for ``chip_smoke.py``'s phase 16.

Ids and ranges: an axis of global length ``n`` splits evenly over the
ranks; rank ``r`` holds ``[r * n / world, (r + 1) * n / world)``
(``ShardCtx.span``).  An indivisible length raises: nothing is padded in
silence.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

#: HLO-style dtype names, as the reference's ledger spells them
DTYPE_NAMES = {
    torch.bool: "pred",
    torch.int8: "s8",
    torch.uint8: "u8",
    torch.int16: "s16",
    torch.float16: "f16",
    torch.bfloat16: "bf16",
    torch.int32: "s32",
    torch.float32: "f32",
    torch.int64: "s64",
    torch.float64: "f64",
}

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_HERE = os.path.abspath(__file__)


class ShardCtx(NamedTuple):
    """One rank's place in the mesh: its rank, the world size and the
    process group (None: the default group)."""

    rank: int
    world: int
    group: object = None

    def span(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's part of an axis of global length ``n``."""
        if n % self.world:
            raise ValueError(f"an axis of {n} does not divide over {self.world} ranks")
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k

    def clip(self, n: int, total: int) -> int:
        """How many of the global ids ``[0, n)`` of an axis of length
        ``total`` this rank holds (its span's overlap with them)."""
        lo, hi = self.span(total)
        return max(0, min(n, hi) - lo)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("sentinel_shard", default=None)


def current() -> Optional[ShardCtx]:
    """The shard the calling code runs on, or None (the single device)."""
    return _CURRENT.get()


@contextlib.contextmanager
def scope(ctx: Optional[ShardCtx]):
    """Run the body on ``ctx``'s shard."""
    tok = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(tok)


# -- the ledger ---------------------------------------------------------------


class Record(NamedTuple):
    """One collective as the sharded path sent it."""

    kind: str  # "all-reduce" | "all-gather"
    dtype: str  # HLO-style, e.g. "s32"
    shape: Tuple[int, ...]  # per-rank RESULT shape
    nbytes: int
    source: Optional[str]  # repo-relative path of the caller
    line: int


_lock = threading.Lock()
_ledger: Optional[List[Record]] = None
_stats = None


@contextlib.contextmanager
def recording():
    """Record every collective sent in the body; yields the list."""
    global _ledger
    with _lock:
        prev, _ledger = _ledger, []
        out = _ledger
    try:
        yield out
    finally:
        with _lock:
            _ledger = prev


class Stats:
    """Collectives sent while ``stats()`` is on: their count and bytes, the
    host's wall time in the calls (``host_ms``), and on the card their
    device time between CUDA events around each call (``device_ms()``,
    read only then: it waits for the last event)."""

    def __init__(self):
        self.count = 0
        self.bytes = 0
        self.host_ms = 0.0
        self._events = []

    def device_ms(self) -> float:
        t = 0.0
        for a, b in self._events:
            b.synchronize()
            t += a.elapsed_time(b)
        return t


@contextlib.contextmanager
def stats():
    global _stats
    s = Stats()
    with _lock:
        prev, _stats = _stats, s
    try:
        yield s
    finally:
        with _lock:
            _stats = prev


def _caller() -> Tuple[Optional[str], int]:
    f = sys._getframe(2)
    while f is not None and os.path.abspath(f.f_code.co_filename) == _HERE:
        f = f.f_back
    if f is None:
        return None, 0
    rel = os.path.relpath(os.path.abspath(f.f_code.co_filename), _REPO).replace(os.sep, "/")
    return (None if rel.startswith("..") else rel), f.f_lineno


def _note(kind: str, t: torch.Tensor) -> None:
    if _ledger is None:
        return
    src, line = _caller()
    _ledger.append(
        Record(kind, DTYPE_NAMES.get(t.dtype, str(t.dtype)), tuple(int(d) for d in t.shape),
               t.numel() * t.element_size(), src, line)
    )


def _timed(t: torch.Tensor, run):
    s = _stats
    if s is None:
        return run()
    s.count += 1
    s.bytes += t.numel() * t.element_size()
    ev = None
    if t.is_cuda:
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
    t0 = time.perf_counter()
    out = run()
    s.host_ms += (time.perf_counter() - t0) * 1e3
    if ev is not None:
        ev[1].record()
        s._events.append(ev)
    return out


def _group():
    ctx = current()
    return None if ctx is None else ctx.group


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the shard's group (in place; returned)."""
    import torch.distributed as dist

    t = t.contiguous()
    _note("all-reduce", t)
    _timed(t, lambda: dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=_group()))
    return t


def all_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (the
    list form of all_gather)."""
    import torch.distributed as dist

    t = t.contiguous()
    g = _group()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
    out_shape = list(t.shape)
    out_shape[dim] *= len(parts)
    _note("all-gather", torch.empty(out_shape, dtype=t.dtype, device="meta"))
    _timed(t, lambda: dist.all_gather(parts, t, group=g))
    return torch.cat(parts, dim=dim)


# -- the sharded reads the ops layer shares -----------------------------------


def local_ids(ctx: ShardCtx, ids: torch.Tensor, total: int) -> torch.Tensor:
    """Global ids on an axis of length ``total`` rebased to this rank's
    span: ids it does not hold fall outside ``[0, span)`` (negative or
    past it), which every gather reads as 0 and every scatter drops."""
    lo, _hi = ctx.span(total)
    return ids - lo if lo else ids


def row_values(tables, row: int, total: int) -> list:
    """The values of one global ``row`` of row-sharded tables (each
    ``[local rows, ...]``) on every rank: the owner's, summed with the
    other ranks' zeros (one all-reduce per dtype)."""
    ctx = current()
    lo, hi = ctx.span(total)
    mine = lo <= row < hi
    by_dtype: dict = {}
    for i, t in enumerate(tables):
        v = t[row - lo] if mine else torch.zeros_like(t[0])
        by_dtype.setdefault(t.dtype, []).append((i, v))
    out = [None] * len(tables)
    for _dt, items in by_dtype.items():
        flat = torch.cat([v.reshape(-1) for _i, v in items])
        flat = all_reduce(flat)
        off = 0
        for i, v in items:
            out[i] = flat[off : off + v.numel()].reshape(v.shape)
            off += v.numel()
    return out
