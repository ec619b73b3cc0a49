"""Black-box flight recorder: an always-on journal of state transitions
plus triggered post-mortem bundles.

The port's copy of ``sentinel_tpu/obs/flight.py`` (pure host code; the
bundle's metrics and spans are the port's own ``REGISTRY`` and
``TRACER``).  The degrade protocol can *survive* a token-server loss and
the watchdog can fail a stalled tick closed, but neither captures the
state that produced the incident — by the time a human looks, the trace
ring has wrapped and the registry deltas are gone.  This module is the
black box for that moment:

* **Journal** (``FlightRecorder.note``): a lock-light bounded ring (the
  ``obs/trace.py`` ring pattern — ``itertools.count`` slot index, one
  tuple store, writers never block) of rare state-transition events:
  cluster degrade enter/exit, rule recompiles, seg resizes, connection
  teardowns (with kind), chaos failpoint fires, resolve-fail-closed
  ticks, watchdog fires, degrade-ladder moves.  Always on — a black box
  that must be enabled before the crash is not a black box — and cheap
  enough for that (<5 µs an append, guarded by a test).

* **Bundles** (``dump_bundle``): one JSON document freezing the process
  at capture time — registry snapshot, trace-ring export, the last-N
  journal events, and whatever registered providers contribute (the
  runtime client registers rule fingerprints, pending-tick/pipeline
  summary, and a config digest; its timeline and explain planes add
  theirs).  Captured automatically on cluster-degrade entry and on any
  ``chaos.invariants`` breach (rate-limited; the last K bundles are
  kept), on demand via the command center's ``GET /api/flight``, read
  back with ``load_bundle`` and analyzed offline by ``python -m
  sentinel_tpu_torch.obs --postmortem bundle.json``.

Set ``SENTINEL_FLIGHT_DIR`` to also persist each triggered bundle as
``flight_<seq>_<reason>.json`` in that directory (post-mortem survives
the process).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Callable, Dict, List, Optional

from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY
from sentinel_tpu_torch.utils.time_source import wall_ms_now


def _pow2_at_least(n: int) -> int:
    n = max(int(n), 2)
    return 1 << (n - 1).bit_length()


class FlightRecorder:
    """Bounded journal + bundle capture.  One process-global instance
    (``FLIGHT``) mirrors the TRACER/REGISTRY convention."""

    def __init__(
        self,
        capacity: int = 1024,
        keep: int = 8,
        min_interval_s: float = 2.0,
    ):
        self.capacity = _pow2_at_least(capacity)
        self._mask = self.capacity - 1
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._seq = itertools.count()
        self._providers: Dict[str, Callable[[], dict]] = {}
        self._bundles: List[dict] = []  # last `keep`, oldest first
        self.keep = keep
        self.min_interval_s = float(min_interval_s)
        # None = never triggered: a 0 sentinel would rate-limit the first
        # trigger whenever the monotonic clock itself is younger than
        # min_interval_s (a host up for less than that)
        self._last_trigger_ns: Optional[int] = None
        self._lock = threading.Lock()  # guards bundles/providers, NOT note()
        self._bundle_seq = itertools.count(1)
        self._c_bundles: Dict[str, object] = {}  # reason -> counter
        self._c_rate_limited = REGISTRY.counter(
            "sentinel_flight_bundles_rate_limited_total",
            "flight-bundle triggers suppressed by the min-interval limiter",
        )

    # -- journal (hot-ish path: rare events, but must stay O(1)) -------------

    def note(self, kind: str, /, **fields) -> None:
        """Append one journal event: a counter bump + one slot store, no
        lock (the trace-ring concurrency model).  ``kind`` is a dotted
        event name (``cluster.degrade.enter``, ``failpoint.fire``, …);
        positional-only so a field may itself be named ``kind``."""
        i = next(self._seq)
        self._ring[i & self._mask] = (i, OT.now_ns(), kind, fields or None)

    def events(self, last: Optional[int] = None) -> List[dict]:
        """Journal events currently in the ring, oldest first (at most
        ``last`` newest ones when given)."""
        recs = [r for r in list(self._ring) if r is not None]
        recs.sort(key=lambda r: r[0])
        if last is not None:
            recs = recs[-last:]
        return [
            {"seq": seq, "t_ns": t, "kind": kind, "fields": fields or {}}
            for seq, t, kind, fields in recs
        ]

    def recorded_total(self) -> int:
        recs = [r for r in list(self._ring) if r is not None]
        return (max(r[0] for r in recs) + 1) if recs else 0

    # -- providers -----------------------------------------------------------

    def register_provider(self, name: str, fn: Callable[[], dict]) -> None:
        """Contribute a named section to every future bundle.  Last
        registration under a name wins (a restarted client re-registers)."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str, fn: Optional[Callable] = None) -> None:
        """Remove a provider; with ``fn`` given, only if it is still the
        registered one (a stopped client must not evict its successor)."""
        with self._lock:
            if fn is None or self._providers.get(name) is fn:
                self._providers.pop(name, None)

    # -- bundles -------------------------------------------------------------

    def dump_bundle(self, reason: str = "manual", journal_last: int = 256,
                    trace_last: int = 2048) -> dict:
        """Freeze the process into one JSON-able document.  Never raises:
        a provider that crashes contributes its error string instead."""
        with self._lock:
            providers = dict(self._providers)
        sections: Dict[str, dict] = {}
        for name, fn in providers.items():
            try:
                sections[name] = fn()
            except Exception as e:  # a crashed provider must not lose the rest of the black box
                sections[name] = {"error": f"{type(e).__name__}: {e}"}
        spans = OT.TRACER.snapshot()
        return {
            "kind": "sentinel-flight-bundle",
            "reason": reason,
            "pid": os.getpid(),
            "captured_wall_ms": wall_ms_now(),
            "captured_mono_ns": OT.now_ns(),
            "journal": self.events(last=journal_last),
            "journal_recorded_total": self.recorded_total(),
            "metrics": REGISTRY.snapshot(),
            "trace_enabled": OT.TRACER.enabled,
            "spans": spans[-trace_last:],
            "providers": sections,
        }

    def trigger(self, reason: str) -> Optional[dict]:
        """Rate-limited automatic capture (cluster-degrade entry).  Returns the bundle, or None when inside the
        min-interval window.  Keeps the last ``keep`` bundles; persists
        to ``SENTINEL_FLIGHT_DIR`` when set."""
        now = OT.now_ns()
        with self._lock:
            if self._last_trigger_ns is not None and now - self._last_trigger_ns < self.min_interval_s * 1e9:
                self._c_rate_limited.inc()
                return None
            self._last_trigger_ns = now
        b = self.dump_bundle(reason=reason)
        with self._lock:
            self._bundles.append(b)
            del self._bundles[: -self.keep]
            c = self._c_bundles.get(reason)
            if c is None:
                c = self._c_bundles[reason] = REGISTRY.counter(
                    "sentinel_flight_bundles_total",
                    "flight bundles captured, by trigger reason",
                    labels={"reason": reason},
                )
        c.inc()
        self.note("flight.bundle", reason=reason)
        d = os.environ.get("SENTINEL_FLIGHT_DIR", "")
        if d:
            try:
                os.makedirs(d, exist_ok=True)
                seq = next(self._bundle_seq)
                path = os.path.join(
                    d,
                    f"flight_{b['captured_wall_ms']}_{seq:03d}_{reason}.json",
                )
                with open(path, "w") as f:
                    json.dump(b, f)
            except OSError:
                pass  # a full/read-only disk must not break the degrade path
        return b

    def reset_rate_limit(self) -> None:
        """Let the next trigger() through immediately (test harnesses pin
        bundle capture deterministically with this)."""
        with self._lock:
            self._last_trigger_ns = None

    def bundles(self) -> List[dict]:
        with self._lock:
            return list(self._bundles)

    def last_bundle(self) -> Optional[dict]:
        with self._lock:
            return self._bundles[-1] if self._bundles else None


def _env_capacity(default: int = 1024) -> int:
    try:
        return int(os.environ.get("SENTINEL_FLIGHT_CAPACITY", default))
    except ValueError:
        return default


#: process-global flight recorder (always on — it is the black box)
FLIGHT = FlightRecorder(capacity=_env_capacity())

#: module-level shorthand used by the instrumented call sites
note = FLIGHT.note


def load_bundle(path: str) -> dict:
    """Read a bundle back (the ``--postmortem`` input side)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("kind") != "sentinel-flight-bundle":
        raise ValueError(f"{path}: not a sentinel flight bundle")
    return data
