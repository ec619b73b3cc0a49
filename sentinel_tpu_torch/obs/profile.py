"""sentinel_tpu_torch.obs.profile — the continuous profiling plane.

The port's copy of ``sentinel_tpu/obs/profile.py``, whole.  Four
always-on-cheap pillars on top of the span tracer / registry / flight
recorder triad:

* **Device memory ledger** (``LEDGER``): tagged device-buffer accounting
  per pool — rule tensors, window rings, SALSA sketch state, wire and
  staging buffers, token-service columns — registered at the allocation
  sites (``ops/engine.py``, ``ops/gsketch.py``, ``sketch/salsa.py``,
  ``runtime/client.py``, ``cluster/token_service.py``) and published as
  ``sentinel_hbm_bytes{pool}`` gauges.  ``reconcile()`` compares the
  ledger's claim against the CUDA caching allocator on demand
  (``torch.cuda.memory_allocated`` and the ``*bytes*`` fields of
  ``torch.cuda.memory_stats``); on the CPU, whose allocator keeps no
  statistics, both read ``None``.  An optional capacity (``set_capacity``
  / ``SENTINEL_HBM_CAPACITY_BYTES``) turns every ledger mutation into a
  capacity check feeding the ``hbm_capacity`` SLO
  (``sentinel_hbm_capacity_checks_total`` /
  ``sentinel_hbm_capacity_breaches_total``).

* **Retrace observatory** (``RETRACE``): PyTorch runs the tick eagerly, so
  a "retrace" here is a new tick binding — a miss of
  ``ops/engine.make_tick``'s cache, keyed by ``(cfg, features)`` as the
  reference's compiled-tick cache is.  Every miss is journaled WITH ITS
  CAUSE — a field-by-field diff of the new key against the previous one —
  and counted as ``sentinel_retraces_total{entry,expected}``.  The first
  build per entry is warmup (expected); deliberate rebinds (rule-feature
  changes, segment resizes, operating-point swaps) run under the
  ``expected_retrace(reason)`` context manager; anything else is a
  SURPRISE retrace and steady-state serving must show zero of them.
  ``sentinel_compile_ms{entry}`` times the client's warm-up ticks (on the
  card the first one includes building the CUDA kernels with ``nvcc``).

* **Deep-profile capture** (``capture_profile``): a bounded,
  rate-limited dense capture window — the span tracer is force-enabled
  (with its ``torch.profiler.record_function`` passthrough, so a running
  ``torch.profiler`` capture sees the same spans) for at most ``ms``
  milliseconds and the window's spans come back as a Chrome-trace dict.
  Served at ``GET /api/profile?ms=``.  Fails OPEN: a capture error
  (including the ``obs.profile.capture`` chaos failpoint) returns an
  error payload and touches nothing.

* **Online sketch-accuracy audit** (``SketchAudit``): a rotating
  per-tick shadow sampler re-folds K sampled sketched resources through
  an exact host-side window and compares the device sketch's windowed
  estimates against it — ``sentinel_sketch_audit_err`` histograms,
  ``sentinel_sketch_underestimates_total`` (the SALSA overestimate-only
  invariant: must stay 0) and ``sentinel_sketch_eps_violations_total``
  wired into ``default_slos()``.  Slack windows overestimate transiently
  BY DESIGN — lazy expiry keeps up to ``slack_buckets`` finished buckets
  in the running sums — so the eps check compares against the
  slack-adjusted exact bound, never the bare window.  The
  ``sketch.audit.shadow`` failpoint fails the audit OPEN
  (``sentinel_sketch_audit_failures_total``); admission decisions are
  never touched.

Disarmed cost contract: the ledger and observatory live on allocation /
binding paths (cold by construction); the audit's hot-path site in
``runtime/client._run_tick`` is one ``is None`` check when disarmed and a
``SketchAudit(k=0)`` observe() is a single flag check.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time as _time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY, MetricRegistry

# -- chaos failpoints --------------------------------------------------------

#: deep-profile capture session (raise ⇒ capture fails OPEN: an error
#: payload comes back, tracing state is restored, decisions untouched)
_FP_CAPTURE = FP.register(
    "obs.profile.capture", "deep-profile capture session", FP.HIT_ACTIONS
)
#: online audit shadow fold + estimate compare (raise ⇒ the audit tick
#: fails OPEN: sentinel_sketch_audit_failures_total counts it, the
#: serving tick proceeds untouched)
_FP_AUDIT = FP.register(
    "sketch.audit.shadow", "online sketch-accuracy audit shadow", FP.HIT_ACTIONS
)


# ---------------------------------------------------------------------------
# pillar 1: HBM memory ledger
# ---------------------------------------------------------------------------

#: thread-local allocation owner — SentinelClient brackets its engine
#: state / ruleset builds so per-client buffers can be dropped on stop()
_OWNER = threading.local()


@contextmanager
def ledger_owner(name: str):
    """Tag every ``LEDGER.set`` inside the block with ``name:`` so a
    later ``LEDGER.drop_owner(name)`` releases exactly those entries
    (client stop, token-service close)."""
    prev = getattr(_OWNER, "name", None)
    _OWNER.name = name
    try:
        yield
    finally:
        _OWNER.name = prev


def _owner() -> str:
    return getattr(_OWNER, "name", None) or "proc"


def tree_nbytes(tree: Any) -> int:
    """Total buffer bytes across a tree's array leaves: tensors
    (``numel() * element_size()``) and numpy arrays, reached through
    NamedTuples, tuples, lists, dicts and dataclasses — the allocation
    sites hand their freshly built state straight in.  Any other leaf
    (a Python scalar, None) holds no buffer and counts 0.  Tensors are
    recognised by their methods, so this module imports no torch: the
    cluster codec and the obs plane import without it."""
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return int(tree.numel()) * int(tree.element_size())
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_nbytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0


class MemoryLedger:
    """Tagged device-buffer accounting: ``(pool, owner:key) -> bytes``.

    ``set`` overwrites (re-allocation at the same site replaces the old
    claim), ``drop``/``drop_owner`` release, and every mutation
    republishes the per-pool ``sentinel_hbm_bytes{pool}`` gauge plus —
    when a capacity is configured — one capacity check.  All cold-path:
    entries change on allocation events (client construction, rule
    compiles, ring growth), never per tick."""

    #: the pools the plane accounts (free-form strings are accepted;
    #: these are the documented ones)
    POOLS = ("rules", "windows", "sketch", "wire", "tokens")

    def __init__(self, registry: MetricRegistry = REGISTRY):
        self._registry = registry
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], int] = {}
        self._gauges: Dict[str, Any] = {}
        try:
            self._capacity = int(
                os.environ.get("SENTINEL_HBM_CAPACITY_BYTES", "0") or 0
            )
        except ValueError:
            self._capacity = 0
        self._in_breach = False
        self._c_checks = registry.counter(
            "sentinel_hbm_capacity_checks_total",
            "memory-ledger capacity evaluations (one per ledger mutation "
            "while a capacity is configured)",
        )
        self._c_breaches = registry.counter(
            "sentinel_hbm_capacity_breaches_total",
            "ledger mutations that left total tracked HBM above the "
            "configured capacity",
        )

    # -- write side ---------------------------------------------------------

    def set(self, pool: str, key: str, nbytes: int) -> None:
        """Claim ``nbytes`` for ``(pool, key)`` under the current
        ledger owner; overwrites any previous claim at the same site."""
        with self._lock:
            self._entries[(pool, f"{_owner()}:{key}")] = max(0, int(nbytes))
        self._publish(pool)

    def track(self, pool: str, key: str, tree: Any) -> int:
        """``set`` from a pytree of array leaves; returns the bytes."""
        nb = tree_nbytes(tree)
        self.set(pool, key, nb)
        return nb

    def drop(self, pool: str, key: str) -> None:
        with self._lock:
            self._entries.pop((pool, f"{_owner()}:{key}"), None)
        self._publish(pool)

    def drop_owner(self, owner: str) -> None:
        """Release every entry the owner claimed (any pool)."""
        pref = owner + ":"
        with self._lock:
            doomed = [k for k in self._entries if k[1].startswith(pref)]
            for k in doomed:
                del self._entries[k]
        for pool in {p for p, _ in doomed}:
            self._publish(pool)

    def set_capacity(self, nbytes: int) -> None:
        self._capacity = max(0, int(nbytes))

    def reset(self) -> None:
        """Drop everything (tests)."""
        with self._lock:
            pools = {p for p, _ in self._entries}
            self._entries.clear()
        for pool in pools:
            self._publish(pool)

    # -- read side ----------------------------------------------------------

    def pool_bytes(self, pool: str) -> int:
        with self._lock:
            return sum(v for (p, _), v in self._entries.items() if p == pool)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._entries.values())

    def snapshot(self) -> dict:
        """Pools, per-entry breakdown, capacity posture — the flight
        bundle's ``memory`` provider section and ``api/memory``."""
        with self._lock:
            entries = dict(self._entries)
        pools: Dict[str, int] = {}
        for (pool, _), v in entries.items():
            pools[pool] = pools.get(pool, 0) + v
        total = sum(pools.values())
        return {
            "pools": pools,
            "entries": {f"{p}/{k}": v for (p, k), v in sorted(entries.items())},
            "total_bytes": total,
            "capacity_bytes": self._capacity,
            "in_breach": bool(self._capacity and total > self._capacity),
        }

    def reconcile(self, device=None) -> dict:
        """Ledger vs reality, on demand: the CUDA caching allocator's
        ``memory_allocated`` (``live_array_bytes``) and the ``*bytes*``
        fields of its ``memory_stats`` next to the ledger total.
        ``unaccounted_bytes`` is allocated bytes the ledger does not
        claim (batch columns, readback buffers, the allocator's own
        rounding).  ``device`` defaults to the current CUDA device where
        one exists; on the CPU, whose allocator keeps no statistics, both
        reads are ``None``."""
        import torch

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        snap = self.snapshot()
        live = stats = None
        if device.type == "cuda":
            live = int(torch.cuda.memory_allocated(device))
            stats = {
                k: int(v)
                for k, v in torch.cuda.memory_stats(device).items()
                if isinstance(v, (int, float)) and "bytes" in k
            }
        out = dict(snap)
        out["live_array_bytes"] = live
        out["device_memory_stats"] = stats
        out["unaccounted_bytes"] = (
            max(0, live - snap["total_bytes"]) if live is not None else None
        )
        return out

    def flight_section(self) -> dict:
        return self.snapshot()

    # -- internals ----------------------------------------------------------

    def _publish(self, pool: str) -> None:
        g = self._gauges.get(pool)
        if g is None:
            g = self._registry.gauge(
                "sentinel_hbm_bytes",
                "ledger-tracked device buffer bytes per pool (rules, "
                "windows, sketch, wire, tokens)",
                labels={"pool": pool},
            )
            self._gauges[pool] = g
        g.set(self.pool_bytes(pool))
        if self._capacity:
            self._c_checks.inc()
            total = self.total_bytes()
            breach = total > self._capacity
            if breach:
                self._c_breaches.inc()
            if breach and not self._in_breach:
                FL.FLIGHT.note(
                    "profile.hbm_breach",
                    total_bytes=total,
                    capacity_bytes=self._capacity,
                    pool=pool,
                )
            self._in_breach = breach


#: process-global ledger — the one ``sentinel_hbm_bytes`` publishes from
LEDGER = MemoryLedger()


# ---------------------------------------------------------------------------
# pillar 2: retrace observatory
# ---------------------------------------------------------------------------

_EXPECTED = threading.local()


@contextmanager
def expected_retrace(reason: str):
    """Mark compile-cache misses inside the block as DELIBERATE (rule
    feature change, segment resize, config migration, warmup): they
    count as ``sentinel_retraces_total{expected="true"}`` and journal
    with this reason attached."""
    prev = getattr(_EXPECTED, "reason", None)
    _EXPECTED.reason = str(reason)
    try:
        yield
    finally:
        _EXPECTED.reason = prev


def expected_reason() -> Optional[str]:
    return getattr(_EXPECTED, "reason", None)


def _diff_part(name: str, old: Any, new: Any) -> List[str]:
    """Named diff of one cache-key part: dataclass configs diff
    field-by-field, feature sets diff by membership, everything else by
    equality — the CAUSE string an operator triages from."""
    if old == new:
        return []
    if dataclasses.is_dataclass(new) and type(old) is type(new):
        out = []
        for f in dataclasses.fields(new):
            a, b = getattr(old, f.name), getattr(new, f.name)
            if a != b:
                out.append(f"{name}.{f.name}: {a!r}→{b!r}")
        return out or [f"{name}: changed"]
    if isinstance(new, frozenset) and isinstance(old, frozenset):
        added = ",".join(sorted(new - old))
        gone = ",".join(sorted(old - new))
        parts = ([f"+{added}"] if added else []) + ([f"-{gone}"] if gone else [])
        return [f"{name}: {' '.join(parts)}"]
    return [f"{name}: {old!r}→{new!r}"]


class RetraceObservatory:
    """Per-entry binding-cache-miss journal with cause attribution.

    ``observe(entry, **key_parts)`` is called from the MISS branch of an
    entry point's binding cache (zero cost on hits): the new key is
    diffed against the previous trace's key part-by-part, the miss is
    counted as ``sentinel_retraces_total{entry,expected}``, and the
    flight journal gets a ``profile.retrace`` record.  ``expected`` is
    true for the first build per entry (warmup) and for misses inside an
    ``expected_retrace(reason)`` block; everything else is a SURPRISE
    retrace (steady-state serving must show none)."""

    #: recent-retrace ring size (the flight provider section)
    RING = 64

    def __init__(self, registry: MetricRegistry = REGISTRY):
        self._registry = registry
        self._lock = threading.Lock()
        self._last_key: Dict[str, Dict[str, Any]] = {}
        self._counters: Dict[Tuple[str, str], Any] = {}
        self._recent: List[dict] = []

    def observe(self, entry: str, **key_parts) -> dict:
        with self._lock:
            prev = self._last_key.get(entry)
            self._last_key[entry] = dict(key_parts)
        reason = expected_reason()
        if prev is None:
            cause, expected = "warmup", True
        else:
            causes: List[str] = []
            for k, new in key_parts.items():
                causes.extend(_diff_part(k, prev.get(k), new))
            for k in prev:
                if k not in key_parts:
                    causes.append(f"{k}: removed")
            cause = "; ".join(causes) if causes else "recompile (key unchanged)"
            expected = reason is not None
        rec = {
            "entry": entry,
            "cause": cause,
            "expected": expected,
            "reason": reason if expected and prev is not None else
            ("warmup" if prev is None else None),
        }
        self._counter(entry, expected).inc()
        FL.FLIGHT.note(
            "profile.retrace",
            entry=entry,
            cause=cause,
            expected=expected,
            reason=rec["reason"],
        )
        with self._lock:
            self._recent.append(rec)
            del self._recent[: -self.RING]
        return rec

    def observe_compile_ms(self, entry: str, ms: float) -> None:
        """One measured warm-up latency (client warm sites)."""
        self._registry.histogram(
            "sentinel_compile_ms",
            "warm-up latency of a newly bound entry point: its first ticks at "
            "both batch shapes (on the card the first warm-up also builds the "
            "CUDA kernels with nvcc)",
            labels={"entry": entry},
        ).observe(float(ms))

    def recent(self) -> List[dict]:
        with self._lock:
            return list(self._recent)

    def surprise_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._recent if not r["expected"])

    def reset(self) -> None:
        """Forget per-entry history (tests); counters keep counting."""
        with self._lock:
            self._last_key.clear()
            self._recent.clear()

    def flight_section(self) -> dict:
        recent = self.recent()
        return {
            "recent": recent[-16:],
            "total_seen": len(recent),
            "surprises": sum(1 for r in recent if not r["expected"]),
            "entries": sorted(self._last_key),
        }

    def _counter(self, entry: str, expected: bool):
        key = (entry, "true" if expected else "false")
        c = self._counters.get(key)
        if c is None:
            c = self._registry.counter(
                "sentinel_retraces_total",
                "entry-point binding-cache misses (a new tick binding) by entry and "
                "whether the retrace was expected (warmup / deliberate "
                "recompile) — expected=\"false\" must stay 0 in steady "
                "state",
                labels={"entry": entry, "expected": key[1]},
            )
            self._counters[key] = c
        return c


#: process-global observatory — ops/engine.make_tick reports misses here
RETRACE = RetraceObservatory()


# ---------------------------------------------------------------------------
# pillar 3: deep-profile capture
# ---------------------------------------------------------------------------

_C_CAPTURES: Dict[str, Any] = {}
_CAPTURE_LOCK = threading.Lock()
_LAST_CAPTURE = [0.0]  # perf_counter() of the last successful capture

#: capture window bounds: at least one ms of signal, at most 10 s of a
#: command-plane thread blocked on a profile request
MIN_CAPTURE_MS = 1.0
MAX_CAPTURE_MS = 10_000.0
#: successful captures are at least this far apart (rate limiting the
#: dense-capture cost; operators retry after the window)
MIN_CAPTURE_INTERVAL_S = 2.0


def _capture_counter(result: str):
    c = _C_CAPTURES.get(result)
    if c is None:
        c = REGISTRY.counter(
            "sentinel_profile_captures_total",
            "deep-profile capture sessions by outcome (ok / rate_limited "
            "/ error)",
            labels={"result": result},
        )
        _C_CAPTURES[result] = c
    return c


def capture_profile(
    ms: float = 250.0,
    min_interval_s: float = MIN_CAPTURE_INTERVAL_S,
    sleep: Optional[Callable[[float], None]] = None,
) -> dict:
    """Grab one bounded dense-capture window and return it as a
    Chrome-trace payload.

    The span tracer is force-enabled for the window (with its
    ``torch.profiler.record_function`` passthrough, so a running
    ``torch.profiler`` capture sees the same spans), the calling thread
    sleeps out the window, and the spans whose start falls inside it come
    back as ``{"ms", "span_count", "chrome_trace"}``.  Rate-limited and fail-OPEN:
    a second capture inside ``min_interval_s`` returns
    ``{"error": "rate_limited"}``; any internal failure (including the
    ``obs.profile.capture`` failpoint) restores the tracer's prior state
    and returns ``{"error": ...}``.  Decisions are never touched."""
    try:
        ms = float(ms)
    except (TypeError, ValueError):
        ms = 250.0
    ms = min(max(ms, MIN_CAPTURE_MS), MAX_CAPTURE_MS)
    slp = sleep if sleep is not None else _time.sleep
    with _CAPTURE_LOCK:
        now = _time.perf_counter()
        if _LAST_CAPTURE[0] and now - _LAST_CAPTURE[0] < min_interval_s:
            _capture_counter("rate_limited").inc()
            return {
                "error": "rate_limited",
                "retry_after_s": round(
                    min_interval_s - (now - _LAST_CAPTURE[0]), 3
                ),
            }
        was_enabled = OT.TRACER.enabled
        try:
            FP.hit(_FP_CAPTURE)
            OT.TRACER.enable(torch_annotations=True)
            t0 = OT.now_ns()
            slp(ms / 1000.0)
            t1 = OT.now_ns()
            spans = [
                s for s in OT.TRACER.snapshot() if t0 <= s["t0_ns"] <= t1
            ]
            trace = OT.TRACER.chrome_trace(spans)
            _LAST_CAPTURE[0] = _time.perf_counter()
            _capture_counter("ok").inc()
            return {
                "ms": ms,
                "t0_ns": t0,
                "t1_ns": t1,
                "span_count": len(spans),
                "chrome_trace": trace,
            }
        except Exception as e:  # stlint: disable=fail-open — capture is diagnostic; the serving path must not see its failures
            _capture_counter("error").inc()
            return {"error": f"{type(e).__name__}: {e}"}
        finally:
            if not was_enabled:
                OT.TRACER.disable()


# ---------------------------------------------------------------------------
# pillar 4: online sketch-accuracy audit
# ---------------------------------------------------------------------------


class SketchAudit:
    """Rotating exact-shadow audit of the device sketch's windowed
    estimates.

    Per tick (``observe``): sketch-tail ids in the batch (``res >=
    node_rows``) fold their clamped counts into per-window-bucket host
    dicts — a global volume series plus per-resource series for up to
    ``k`` tracked resources (membership rotates so cold resources get
    audited too).  Every ``period`` ticks (``observe`` again): the
    tracked resources' device estimates (via the reader the client
    binds: attempts = PASS + BLOCK planes, the exact semantics the
    engine folds — ``acq.count`` units per valid entry) are compared
    against the shadow:

    * **underestimate** — ``est < exact(window)``: breaks the SALSA
      overestimate-only invariant; ``sentinel_sketch_underestimates_total``
      must stay 0.
    * **eps violation** — ``est > exact(window+slack) + e/width * V``:
      the CMS error bound, where the comparison base is the
      SLACK-ADJUSTED exact sum.  Lazy expiry keeps up to
      ``slack_buckets`` finished buckets in the running sums (plus one
      guard bucket for the tick-vs-audit clock lag), so a slack-only
      overestimate is BY DESIGN and must not count; ``V`` is the global
      folded volume over the same slack-extended span.

    The eps check only fires for resources whose shadow provably covers
    the whole slack window — tracked since before the window started, or
    admitted at their first-ever appearance on a fresh sketch — so a
    mid-stream admission can never fabricate a violation.  Audit
    failures (including the ``sketch.audit.shadow`` failpoint) fail OPEN
    via ``sentinel_sketch_audit_failures_total``; ``observe`` never
    raises into the tick.  Disabled (``k=0``) cost is one flag check."""

    #: cap on the first-appearance set that certifies fresh-sketch
    #: completeness; past it, only window-covering tenure certifies
    SEEN_CAP = 1 << 16

    def __init__(
        self,
        node_rows: int,
        window_ms: int,
        sample_count: int,
        slack_buckets: int,
        width: int,
        k: int = 8,
        period: int = 16,
        rotate_every: int = 64,
        fresh_state: bool = True,
        trash_row: Optional[int] = None,
        registry: MetricRegistry = REGISTRY,
    ):
        self.node_rows = int(node_rows)
        self.trash_row = None if trash_row is None else int(trash_row)
        self.window_ms = max(1, int(window_ms))
        self.sample_count = max(1, int(sample_count))
        # +1 guard bucket: estimates are read one tick behind the fold
        # clock, so one extra finished bucket may still be in the sums
        self.slack_buckets = max(0, int(slack_buckets)) + 1
        self.width = max(1, int(width))
        self.k = max(0, int(k))
        self.period = max(1, int(period))
        self.rotate_every = max(self.period, int(rotate_every))
        self.fresh = bool(fresh_state)
        self.enabled = self.k > 0
        self._ticks = 0
        self._vol: Dict[int, int] = {}
        self._tracked: Dict[int, Dict[int, int]] = {}
        self._first: Dict[int, int] = {}
        self._complete: Dict[int, bool] = {}
        self._admit_order: List[int] = []
        self._seen: set = set()
        self._last_audit: dict = {}
        self._c_checks = registry.counter(
            "sentinel_sketch_audit_checks_total",
            "per-resource online sketch-accuracy comparisons performed",
        )
        self._c_under = registry.counter(
            "sentinel_sketch_underestimates_total",
            "sketch estimates below the exact shadow window — breaks the "
            "overestimate-only invariant; must stay 0",
        )
        self._c_eps = registry.counter(
            "sentinel_sketch_eps_violations_total",
            "sketch estimates above the slack-adjusted exact bound plus "
            "the CMS eps budget (e/width * window volume)",
        )
        self._c_fail = registry.counter(
            "sentinel_sketch_audit_failures_total",
            "audit ticks that failed OPEN (shadow fold or estimate read "
            "raised; admission decisions untouched)",
        )
        self._h_err = registry.histogram(
            "sentinel_sketch_audit_err",
            "sketch estimate minus exact shadow window, per audited "
            "resource (overestimate magnitude; power-of-two buckets)",
            start=1.0,
            buckets=24,
        )

    # -- hot path -----------------------------------------------------------

    def observe(
        self,
        t_ms: int,
        res,  # np.ndarray int — batch resource column (may be None)
        cnt,  # np.ndarray int — clamped batch count column
        reader: Optional[Callable] = None,
    ) -> None:
        """One tick: audit first (the estimates lag this tick's fold by
        design — shadow and sketch then cover the same stream prefix),
        then fold this tick's sketch-id counts into the shadow."""
        if not self.enabled:
            return
        self._ticks += 1
        try:
            FP.hit(_FP_AUDIT)
            if (
                reader is not None
                and self._tracked
                and self._ticks % self.period == 0
            ):
                self._audit(int(t_ms), reader)
            if res is not None:
                self._fold(int(t_ms), res, cnt)
        except Exception:  # stlint: disable=fail-open — the audit is observational; a failed shadow must never fail the tick
            self._c_fail.inc()

    # -- internals ----------------------------------------------------------

    def _wid(self, t_ms: int) -> int:
        return (t_ms & 0xFFFFFFFF) // self.window_ms

    def _fold(self, t_ms: int, res, cnt) -> None:
        w = self._wid(t_ms)
        # the engine folds EVERY valid (non-trash) row's count into the
        # sketch — exact-tier rows included — so the eps budget's V must
        # cover them all, not just the tracked tail
        valid = (
            res != self.trash_row if self.trash_row is not None else res >= 0
        )
        total = int(np.asarray(cnt)[valid].sum())
        if total:
            self._vol[w] = self._vol.get(w, 0) + total
        mask = valid & (res >= self.node_rows)
        if not mask.any():
            return
        # group by distinct id before the Python loop: the hot-path cost
        # scales with DISTINCT sketch ids per tick, not batch rows
        u, inv = np.unique(np.asarray(res)[mask], return_inverse=True)
        sums = np.bincount(inv, weights=np.asarray(cnt)[mask])
        rids = u.tolist()
        cnts = sums.astype(np.int64).tolist()
        rotated = False
        for rid, c in zip(rids, cnts):
            d = self._tracked.get(rid)
            if d is None:
                first_sight = rid not in self._seen and len(self._seen) < self.SEEN_CAP
                if len(self._tracked) < self.k:
                    d = self._admit(rid, w, first_sight)
                elif (
                    not rotated
                    and self.rotate_every
                    and self._ticks % self.rotate_every == 0
                ):
                    # rotate: retire the longest-tracked resource so the
                    # sample keeps visiting fresh parts of the id space
                    rotated = True
                    old = self._admit_order.pop(0)
                    self._tracked.pop(old, None)
                    self._first.pop(old, None)
                    self._complete.pop(old, None)
                    d = self._admit(rid, w, first_sight)
            if d is not None:
                d[w] = d.get(w, 0) + int(c)
            if len(self._seen) < self.SEEN_CAP:
                self._seen.add(rid)
        # prune buckets that can no longer matter to any comparison
        floor = w - (self.sample_count + self.slack_buckets + 2)
        if any(b < floor for b in self._vol):
            self._vol = {b: v for b, v in self._vol.items() if b >= floor}
            for rid, d in self._tracked.items():
                self._tracked[rid] = {
                    b: v for b, v in d.items() if b >= floor
                }

    def _admit(self, rid: int, w: int, first_sight: bool) -> Dict[int, int]:
        d: Dict[int, int] = {}
        self._tracked[rid] = d
        self._first[rid] = w
        # a fresh sketch + a resource shadowed from its very first fold
        # ⇒ the shadow is complete even before window-covering tenure
        self._complete[rid] = self.fresh and first_sight
        self._admit_order.append(rid)
        return d

    def _audit(self, t_ms: int, reader: Callable) -> None:
        w = self._wid(t_ms)
        lo_min = w - self.sample_count  # window buckets: (lo_min, w]
        hi_min = lo_min - self.slack_buckets  # slack span: (hi_min, w]
        rids = sorted(self._tracked)
        est = np.asarray(reader(rids, t_ms), dtype=np.int64)
        vol = sum(v for b, v in self._vol.items() if hi_min < b <= w)
        eps_budget = math.e / self.width * vol
        under = viol = 0
        for rid, e in zip(rids, est.tolist()):
            d = self._tracked[rid]
            exact_lo = sum(v for b, v in d.items() if lo_min < b <= w)
            exact_hi = sum(v for b, v in d.items() if hi_min < b <= w)
            self._c_checks.inc()
            self._h_err.observe(max(float(e - exact_lo), 0.0))
            if e < exact_lo:
                under += 1
                self._c_under.inc()
                FL.FLIGHT.note(
                    "profile.sketch_underestimate",
                    rid=rid, est=int(e), exact=exact_lo, wid=w,
                )
            covered = self._complete.get(rid, False) or (
                self._first.get(rid, w) <= hi_min
            )
            if covered and e > exact_hi + eps_budget:
                viol += 1
                self._c_eps.inc()
        self._last_audit = {
            "wid": w,
            "resources": len(rids),
            "volume": vol,
            "eps_budget": round(eps_budget, 2),
            "underestimates": under,
            "eps_violations": viol,
        }

    def flight_section(self) -> dict:
        return {
            "k": self.k,
            "period": self.period,
            "tracked": len(self._tracked),
            "ticks": self._ticks,
            "window": f"{self.sample_count}x{self.window_ms}ms"
            f"+{self.slack_buckets}slack",
            "checks": int(self._c_checks.value),
            "underestimates": int(self._c_under.value),
            "eps_violations": int(self._c_eps.value),
            "failures": int(self._c_fail.value),
            "last_audit": self._last_audit,
        }


# ---------------------------------------------------------------------------
# flight providers: memory + retrace ride every bundle process-wide
# ---------------------------------------------------------------------------

FL.FLIGHT.register_provider("memory", LEDGER.flight_section)
FL.FLIGHT.register_provider("retrace", RETRACE.flight_section)
