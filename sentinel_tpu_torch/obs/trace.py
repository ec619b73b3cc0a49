"""Pipeline span tracer: a lock-light, fixed-capacity ring of spans.

The port's copy of ``sentinel_tpu/obs/trace.py``.  Its one difference:
the profiler passthrough enters ``torch.profiler.record_function``, so
host spans line up with the kernels in a ``torch.profiler`` capture.

The qualitative half of the observability plane (``obs/registry.py`` is
the quantitative half): every instrumented stage of a decision's journey
— batch assembly, presort, dispatch, device tick, readback, resolve,
cluster RPC round-trips, remote-shard chunks — records a (name, t0, dur,
thread, trace, attrs) span into a preallocated ring.  "Give Me Some
Slack" (arxiv 1703.01166) is the design brief: measurement that rides
the hot path must be O(1), allocation-light, and self-limiting — here a
wrapping ring whose writers never block each other.

Concurrency model: the slot index comes from ``itertools.count`` (its
``next`` is a single C call, atomic under the GIL), so concurrent
writers land on distinct slots and a write is one tuple store.  The ring
wraps — old spans are overwritten, never flushed synchronously.  Readers
(``snapshot``/``chrome_trace``) copy the list and sort by sequence; a
read racing a write sees either the old or the new complete tuple.

Disabled mode: hot call sites pay ONE flag check (``t0()`` returns 0)
and skip everything else — no formatting, no allocation, no clock read.

Timestamps are monotonic nanoseconds.  ``now_ns`` below is the tracer's
single raw-clock read point: span brackets at ~µs durations need the ns
clock directly, and keeping the read HERE (not scattered per call site)
keeps every other clock read in ``utils/time_source``.

Export: ``chrome_trace()`` emits Chrome Trace Event JSON (``ph: "X"``
complete events, µs timestamps) loadable in Perfetto / chrome://tracing;
with ``torch_annotations`` on, ``span()`` additionally enters
``torch.profiler.record_function`` so host spans line up with the
device's kernels inside a ``torch.profiler.profile()`` capture.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time as _time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple


def now_ns() -> int:
    """Monotonic nanoseconds — THE tracer's raw-clock read (everything
    else routes through ``utils/time_source``)."""
    return _time.monotonic_ns()


# -- distributed trace context ------------------------------------------------
#
# Wire-level trace ids are 64-bit and PROCESS-UNIQUE (pid + startup-clock
# salt in the high bits, a counter below), unlike the small per-tick
# correlation ids ``SpanTracer.next_trace_id`` hands out: a client's
# ``cluster.rpc`` span and the server's ``token.decision`` span live in
# different processes and may only collide if both ids are global.  The
# pair ``(trace_id, parent_span_id)`` rides the cluster protocol's
# optional trace tail (cluster/protocol.py) and the receiving side
# re-installs it as this thread-local ambient context, so spans begun
# while serving the request adopt the caller's trace id and record the
# caller's span id as ``parent`` — the joins ``--merge`` turns into
# Perfetto flow events.

_ID_SALT = ((os.getpid() & 0xFFFF) << 48) | ((now_ns() & 0xFFFFFF) << 24)
_trace_seq = itertools.count(1)
_span_seq = itertools.count(1)
_ctx = threading.local()


def new_trace_id() -> int:
    """Fresh 64-bit wire trace id, unique across processes (pid + clock
    salt + counter).  Never 0 — 0 means "no trace context" on the wire."""
    return _ID_SALT | (next(_trace_seq) & 0xFFFFFF)


def new_span_id() -> int:
    """Fresh 64-bit span id (same uniqueness construction as trace ids)."""
    return _ID_SALT | (next(_span_seq) & 0xFFFFFF)


def current_ctx() -> Tuple[int, int]:
    """Ambient ``(trace_id, span_id)`` for this thread; ``(0, 0)`` unset."""
    return getattr(_ctx, "trace", 0), getattr(_ctx, "span", 0)


@contextmanager
def trace_ctx(trace_id: int, span_id: int = 0):
    """Install an ambient trace context for the current thread.  Spans
    begun inside (``begin``/``span`` with ``trace=0``) adopt ``trace_id``
    and record ``span_id`` as their ``parent`` attr."""
    old = (getattr(_ctx, "trace", 0), getattr(_ctx, "span", 0))
    _ctx.trace, _ctx.span = trace_id, span_id
    try:
        yield
    finally:
        _ctx.trace, _ctx.span = old


def maybe_ctx(trace_id: int, span_id: int = 0):
    """``trace_ctx`` when a wire trace id arrived AND tracing is on,
    else a shared no-op — the receiving side's single-check adoption."""
    if trace_id and TRACER.enabled:
        return trace_ctx(trace_id, span_id)
    return _NOOP


def _adopt(trace: int, attrs: Optional[dict]) -> Tuple[int, Optional[dict]]:
    """Fold the ambient context into a span being created with no
    explicit trace id.  Called only on the tracing-ENABLED path."""
    if trace == 0:
        t = getattr(_ctx, "trace", 0)
        if t:
            trace = t
            parent = getattr(_ctx, "span", 0)
            if parent:
                attrs = dict(attrs) if attrs else {}
                attrs.setdefault("parent", parent)
    return trace, attrs


def _pow2_at_least(n: int) -> int:
    n = max(int(n), 2)
    return 1 << (n - 1).bit_length()


class SpanHandle:
    """An open span from the explicit begin/end API — may cross threads
    (begin on the tick thread, end on a resolver-pool thread)."""

    __slots__ = ("name", "t0_ns", "trace", "attrs")

    def __init__(self, name: str, t0_ns: int, trace: int, attrs: Optional[dict]):
        self.name = name
        self.t0_ns = t0_ns
        self.trace = trace
        self.attrs = attrs


class _Span:
    """Context-manager span (allocated only while tracing is enabled)."""

    __slots__ = ("_tr", "name", "trace", "attrs", "t0", "_ann")

    def __init__(self, tr: "SpanTracer", name: str, trace: int, attrs: Optional[dict]):
        self._tr = tr
        self.name = name
        self.trace = trace
        self.attrs = attrs
        self._ann = None

    def __enter__(self):
        ann_cls = self._tr._ann_cls
        if ann_cls is not None:
            self._ann = ann_cls(self.name)
            self._ann.__enter__()
        self.t0 = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = now_ns()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        self._tr.record(self.name, self.t0, t1 - self.t0, self.trace, self.attrs)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _NoopSpan()


class SpanTracer:
    """Fixed-capacity span ring.  See the module docstring for the
    concurrency and disabled-mode contracts."""

    def __init__(self, capacity: int = 8192, drop_counter=None):
        self.capacity = _pow2_at_least(capacity)
        self._mask = self.capacity - 1
        self.enabled = False
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._seq = itertools.count()
        self._trace_ids = itertools.count(1)
        self._ann_cls = None  # torch.profiler.record_function when requested
        self._lock = threading.Lock()  # guards enable/reset, not the hot path
        # optional obs Counter mirroring ring-overwrite loss (the global
        # tracer wires sentinel_trace_spans_dropped_total); synced on the
        # READ side so the one-store write path stays untouched
        self._drop_counter = drop_counter
        self._drops_synced = 0

    # -- lifecycle ----------------------------------------------------------

    def enable(self, torch_annotations: bool = False) -> None:
        with self._lock:
            if torch_annotations:
                from torch.profiler import record_function

                self._ann_cls = record_function
            else:
                self._ann_cls = None
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._ann_cls = None

    def reset(self) -> None:
        """Drop all recorded spans (sequence numbers keep counting)."""
        with self._lock:
            self._ring = [None] * self.capacity

    def next_trace_id(self) -> int:
        """Fresh correlation id (e.g. one per tick iteration)."""
        return next(self._trace_ids)

    # -- hot-path write ------------------------------------------------------

    def record(
        self,
        name: str,
        t0_ns: int,
        dur_ns: int,
        trace: int = 0,
        attrs: Optional[dict] = None,
    ) -> None:
        """Store one completed span.  One counter bump + one slot store;
        concurrent writers never contend on a lock."""
        i = next(self._seq)
        self._ring[i & self._mask] = (
            i,
            name,
            t0_ns,
            dur_ns,
            threading.get_ident(),
            trace,
            attrs,
        )

    def begin(self, name: str, trace: int = 0, **attrs) -> Optional[SpanHandle]:
        """Explicit-API open span; returns None when disabled (the caller's
        single flag check).  Pass the handle to ``end`` on ANY thread."""
        if not self.enabled:
            return None
        trace, a = _adopt(trace, attrs or None)
        return SpanHandle(name, now_ns(), trace, a)

    def end(self, handle: Optional[SpanHandle], **attrs) -> None:
        if handle is None:
            return
        if attrs:
            merged = dict(handle.attrs or {})
            merged.update(attrs)
            handle.attrs = merged
        self.record(
            handle.name, handle.t0_ns, now_ns() - handle.t0_ns, handle.trace, handle.attrs
        )

    def span(self, name: str, trace: int = 0, **attrs):
        """Context-manager span; a shared no-op when disabled."""
        if not self.enabled:
            return _NOOP
        trace, a = _adopt(trace, attrs or None)
        return _Span(self, name, trace, a)

    # -- read side -----------------------------------------------------------

    def spans_dropped_total(self) -> int:
        """Spans lost to ring overwrite so far: everything ever recorded
        beyond what one full ring can hold.  0 until the first wrap."""
        return max(0, self.recorded_total - self.capacity)

    def _sync_drop_counter(self) -> None:
        """Mirror overwrite loss into the registry counter (monotonic:
        only the delta since the last read is added).  Read-side only,
        so taking the tracer lock here costs the hot write path nothing
        — and concurrent snapshot() callers can't double-count a delta."""
        if self._drop_counter is None:
            return
        d = self.spans_dropped_total()
        with self._lock:
            delta = d - self._drops_synced
            if delta <= 0:
                return
            self._drops_synced = d
        self._drop_counter.inc(delta)

    def snapshot(self) -> List[dict]:
        """Spans currently in the ring, oldest first.  A wrapped ring has
        lost its oldest spans — that loss is surfaced (not silent) via
        ``spans_dropped_total`` / ``sentinel_trace_spans_dropped_total``."""
        self._sync_drop_counter()
        recs = [r for r in list(self._ring) if r is not None]
        recs.sort(key=lambda r: r[0])
        return [
            {
                "seq": seq,
                "name": name,
                "t0_ns": t0,
                "dur_ns": dur,
                "tid": tid,
                "trace": trace,
                "attrs": attrs or {},
            }
            for seq, name, t0, dur, tid, trace, attrs in recs
        ]

    @property
    def recorded_total(self) -> int:
        """Approximate number of spans ever recorded (ring wraps past
        ``capacity``): max live sequence + 1."""
        recs = [r for r in list(self._ring) if r is not None]
        return (max(r[0] for r in recs) + 1) if recs else 0

    def chrome_trace(self, spans: Optional[List[dict]] = None) -> dict:
        """Chrome Trace Event JSON (Perfetto-loadable 'X' complete events)."""
        spans = self.snapshot() if spans is None else spans
        pid = os.getpid()
        events = []
        for s in spans:
            args = dict(s.get("attrs") or {})
            if s.get("trace"):
                args["trace"] = s["trace"]
            events.append(
                {
                    "name": s["name"],
                    "ph": "X",
                    "ts": s["t0_ns"] / 1000.0,
                    "dur": s["dur_ns"] / 1000.0,
                    "pid": pid,
                    "tid": s["tid"],
                    "args": args,
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def _env_capacity(default: int = 8192) -> int:
    """SENTINEL_TRACE_CAPACITY, falling back on any malformed value — a
    tracing tuning knob must never stop the flow-control service from
    importing."""
    try:
        return int(os.environ.get("SENTINEL_TRACE_CAPACITY", default))
    except ValueError:
        return default


def _global_drop_counter():
    """Registry counter for the global tracer's ring-overwrite loss.
    Lazy import: registry never imports trace, so this is cycle-free."""
    from sentinel_tpu_torch.obs.registry import REGISTRY

    return REGISTRY.counter(
        "sentinel_trace_spans_dropped_total",
        "spans overwritten by trace-ring wraparound (snapshot() holds at "
        "most SENTINEL_TRACE_CAPACITY spans; older ones are lost)",
    )


#: process-global default tracer; enable with ``sentinel_tpu_torch.obs.enable()``
#: or SENTINEL_TRACE=1 in the environment
TRACER = SpanTracer(capacity=_env_capacity(), drop_counter=_global_drop_counter())
if os.environ.get("SENTINEL_TRACE", "") not in ("", "0"):
    TRACER.enable()


# -- hot-call-site helpers (module-level: one import, one flag check) --------


def t0() -> int:
    """Stage start marker: monotonic ns when tracing is enabled, else 0.
    The truthiness of the return value is the call site's single check."""
    return now_ns() if TRACER.enabled else 0


def stage(name: str, t0_ns: int, hist=None, trace: int = 0, attrs: Optional[dict] = None) -> None:
    """Record a completed stage: span into the ring, duration into an
    optional ms histogram.  Call only when ``t0_ns`` is truthy.  The
    trace id rides into the histogram as a bucket exemplar, so a bad
    exposition quantile links back to its Perfetto span."""
    dur = now_ns() - t0_ns
    TRACER.record(name, t0_ns, dur, trace, attrs)
    if hist is not None:
        hist.observe(dur / 1e6, exemplar=f"{trace:x}" if trace else None)


def stage_ns(
    name: str, t0_ns: int, dur_ns: int, hist=None, trace: int = 0, attrs: Optional[dict] = None
) -> None:
    """``stage`` with an explicit duration (accumulated or cross-thread)."""
    TRACER.record(name, t0_ns, dur_ns, trace, attrs)
    if hist is not None:
        hist.observe(dur_ns / 1e6, exemplar=f"{trace:x}" if trace else None)


def event(name: str, trace: int = 0, attrs: Optional[dict] = None) -> None:
    """Zero-duration marker span (degrade transitions, hot swaps)."""
    if TRACER.enabled:
        TRACER.record(name, now_ns(), 0, trace, attrs)


# -- summaries ---------------------------------------------------------------


def summarize(spans: Iterable[dict], prefix: Optional[str] = None) -> Dict[str, dict]:
    """Per-name duration stats over snapshot()/chrome-trace spans:
    ``{name: {count, p50_ms, p99_ms, mean_ms, total_ms}}``."""
    import numpy as np

    by_name: Dict[str, List[float]] = {}
    for s in spans:
        name = s["name"]
        if prefix is not None and not name.startswith(prefix):
            continue
        dur_ns = s["dur_ns"] if "dur_ns" in s else s.get("dur", 0.0) * 1000.0
        by_name.setdefault(name, []).append(dur_ns / 1e6)
    out: Dict[str, dict] = {}
    for name in sorted(by_name):
        a = np.asarray(by_name[name], np.float64)
        out[name] = {
            "count": int(a.size),
            "p50_ms": round(float(np.percentile(a, 50)), 4),
            "p99_ms": round(float(np.percentile(a, 99)), 4),
            "mean_ms": round(float(a.mean()), 4),
            "total_ms": round(float(a.sum()), 4),
        }
    return out


def load_spans(path: str) -> List[dict]:
    """Read spans back from a chrome-trace JSON file (or a raw snapshot
    list) — the CLI's input side."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "traceEvents" in data:
        return [
            {
                "name": e.get("name", "?"),
                "t0_ns": float(e.get("ts", 0.0)) * 1000.0,
                "dur_ns": float(e.get("dur", 0.0)) * 1000.0,
                "tid": e.get("tid", 0),
                "trace": (e.get("args") or {}).get("trace", 0),
                "attrs": e.get("args") or {},
            }
            for e in data["traceEvents"]
        ]
    if isinstance(data, list):
        return data
    raise ValueError(f"{path}: neither a chrome trace nor a span snapshot")
