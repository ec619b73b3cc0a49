"""Failpoint registry: named fault-injection sites on the product's
failure-handling paths.

The port's copy of ``sentinel_tpu/chaos/failpoints.py`` (copied, not
imported: this package never imports the JAX package).  One difference:
an injected fault is not journalled in a flight recorder, which the port
does not carry yet (ROADMAP.md, Queue A item 6).

Every place the system claims to degrade gracefully — cluster RPC
round-trips, remote-shard chunk pipelines, resolver-pool readbacks,
datasource refresh loops, the command plane — declares a named SITE here
at import time and calls one of the three hot-path hooks at the exact
point a real fault would strike:

    FP.hit("cluster.rpc.send")              # may raise / delay
    data = FP.pipe("parallel.shard.recv", data)  # may drop / corrupt /
                                                 # short-read / raise / delay
    t += FP.skew_ms("runtime.tick.clock")   # deterministic clock skew

Overhead discipline (same contract as ``obs/trace.py``, guarded by the
same <5 µs/site-call CI test): a DISARMED site costs exactly one module
flag check — no dict lookup, no allocation, no clock read.  Arming
happens only inside the chaos harness (``chaos/runner.py``) or an
explicit test; production processes never pay more than the flag.

Site naming scheme (enforced by ``register`` and the catalog test):
``<layer>.<component>.<operation>``, three dot-separated ``[a-z0-9_]``
segments, where ``<layer>`` is the owning subsystem (``transport``,
``cluster``, ``runtime``, ``parallel``, ``datasource``).

Determinism: when armed, every fire decision comes from the plan's
seeded PRNG and per-spec hit counters (``chaos/plans.py``), so a run
replays exactly from its seed; injected events are counted per
(site, action) and exposed via the ``ArmedState`` handle plus the
``sentinel_chaos_injections_total`` registry counter.

Time-source note: the ``delay`` action sleeps (``time.sleep`` is not a
clock READ) and ``clock_skew`` only returns a configured offset — but
this module is the chaos plane's single sanctioned home for any clock
manipulation.  Keep all such code HERE.
"""

from __future__ import annotations

import re
import threading
import time as _time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: process-global arm flag — the ONE check disarmed sites pay
_ARMED = False
_STATE: Optional["ArmedState"] = None
#: guards arm/disarm and site registration (never on the hot path)
_LOCK = threading.Lock()

_SITE_RE = re.compile(
    r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$"
)
_LAYERS = (
    "transport", "cluster", "runtime", "parallel", "datasource", "obs",
    "sketch", "workload",
)

#: actions a call style supports: ``hit`` sites can only raise or stall,
#: ``pipe`` sites additionally mangle the payload, ``skew`` sites shift
#: a clock value
HIT_ACTIONS = ("raise", "delay")
PIPE_ACTIONS = ("raise", "delay", "drop", "corrupt", "short_read")
SKEW_ACTIONS = ("clock_skew",)

#: exception classes the ``raise`` action may instantiate, by name —
#: the plan format stays JSON-serializable
EXCEPTIONS = {
    "OSError": OSError,
    "ConnectionResetError": ConnectionResetError,
    "ConnectionRefusedError": ConnectionRefusedError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
}


@dataclass(frozen=True)
class Site:
    """One registered injection point."""

    name: str
    desc: str
    kinds: Tuple[str, ...]  # actions the call site honors


#: name -> Site; populated at import time by the instrumented modules
SITES: Dict[str, Site] = {}


def register(name: str, desc: str = "", kinds: Tuple[str, ...] = HIT_ACTIONS) -> str:
    """Declare an injection site (idempotent for identical re-imports).
    Returns ``name`` so call sites can bind it to a module constant."""
    if not _SITE_RE.match(name):
        raise ValueError(
            f"failpoint {name!r} violates the <layer>.<component>.<operation> scheme"
        )
    if name.split(".", 1)[0] not in _LAYERS:
        raise ValueError(
            f"failpoint {name!r}: layer must be one of {_LAYERS}"
        )
    unknown = [k for k in kinds if k not in HIT_ACTIONS + PIPE_ACTIONS + SKEW_ACTIONS]
    if unknown:
        raise ValueError(f"failpoint {name!r}: unknown action kinds {unknown}")
    with _LOCK:
        old = SITES.get(name)
        if old is not None and (old.desc, old.kinds) != (desc, tuple(kinds)):
            raise ValueError(f"failpoint {name!r} already registered differently")
        SITES[name] = Site(name, desc, tuple(kinds))
    return name


# -- armed-run state ---------------------------------------------------------


class _LiveFault:
    """A FaultSpec compiled against one armed run: its own PRNG stream and
    hit/fire counters, so replaying a seed replays every decision."""

    __slots__ = ("spec", "rng", "hits", "fires", "counter")

    def __init__(self, spec, rng, counter):
        self.spec = spec
        self.rng = rng
        self.hits = 0
        self.fires = 0
        self.counter = counter  # obs counter (or None in bare tests)

    def decide(self) -> bool:
        """One hit: advance counters, decide whether to fire.  The PRNG is
        drawn exactly once per hit when probability gating is set, so the
        decision stream depends only on the per-site hit ORDER."""
        s = self.spec
        i = self.hits
        self.hits += 1
        if s.max_fires and self.fires >= s.max_fires:
            return False
        if s.burst_len and not (s.burst_start <= i < s.burst_start + s.burst_len):
            return False
        if s.every_nth and (i + 1) % s.every_nth != 0:
            return False
        if s.probability > 0.0 and self.rng.random() >= s.probability:
            return False
        self.fires += 1
        return True


_EVENT_CAP = 50_000


class ArmedState:
    """Handle for one armed plan: per-site hit counts, injected events,
    and the compiled per-spec state.  Returned by ``arm`` and kept valid
    after ``disarm`` (the scenario report reads it afterwards)."""

    def __init__(self, plan):
        from sentinel_tpu_torch.obs.registry import REGISTRY

        self.plan = plan
        self.lock = threading.Lock()
        self.hits: Dict[str, int] = {}
        self.events: List[Tuple[str, str, int]] = []  # (site, action, site-hit idx)
        self.by_site: Dict[str, List[_LiveFault]] = {}
        for idx, spec in enumerate(plan.faults):
            counter = REGISTRY.counter(
                "sentinel_chaos_injections_total",
                "faults injected by armed chaos plans",
                labels={"site": spec.site, "action": spec.action},
            )
            self.by_site.setdefault(spec.site, []).append(
                _LiveFault(spec, plan.spec_rng(idx), counter)
            )

    def injected(self) -> Dict[str, int]:
        """``{"site:action": fires}`` over every spec of the plan."""
        out: Dict[str, int] = {}
        with self.lock:
            for site, lives in sorted(self.by_site.items()):
                for lf in lives:
                    key = f"{site}:{lf.spec.action}"
                    out[key] = out.get(key, 0) + lf.fires
        return out

    def hit_counts(self) -> Dict[str, int]:
        """Site -> times the armed run crossed it (fired or not)."""
        with self.lock:
            return dict(self.hits)


def arm(plan) -> ArmedState:
    """Install a FaultPlan process-wide.  Exactly one plan may be armed;
    call ``disarm()`` first (the runner's sessions always pair them)."""
    global _ARMED, _STATE
    plan.validate(SITES)
    st = ArmedState(plan)
    with _LOCK:
        if _ARMED:
            raise RuntimeError("a chaos plan is already armed")
        _STATE = st
        _ARMED = True
    return st


def disarm() -> Optional[ArmedState]:
    """Remove the armed plan (idempotent); returns its state handle."""
    global _ARMED, _STATE
    with _LOCK:
        st, _STATE = _STATE, None
        _ARMED = False
    return st


@contextmanager
def armed(plan):
    """``with armed(plan) as st:`` — arm/disarm bracketed."""
    st = arm(plan)
    try:
        yield st
    finally:
        disarm()


# -- hot-path hooks ----------------------------------------------------------


def is_armed() -> bool:
    """Whether a chaos plan is currently armed.  Instrumented code may
    consult this to keep injected counts a pure function of the seed —
    e.g. the shard lease refresher runs its async hop inline while a
    plan is armed, so a refresh-site raise lands on the driving thread
    deterministically instead of racing a background worker."""
    return _ARMED


def hit(site: str) -> None:
    """Cross a raise/delay site.  Disarmed: one flag check."""
    if not _ARMED:
        return
    _apply(site, None)


def pipe(site: str, data: bytes) -> bytes:
    """Pass a payload through a byte-mangling site.  Disarmed: one flag
    check, payload returned untouched."""
    if not _ARMED:
        return data
    return _apply(site, data)


def skew_ms(site: str) -> int:
    """Clock-skew offset (ms) for a time-reading site; 0 when disarmed."""
    if not _ARMED:
        return 0
    out = _apply(site, 0)
    return out if isinstance(out, int) else 0


def _apply(site: str, value):
    """Armed-path dispatch: count the hit, run each matching spec's
    schedule, execute fired actions.  Raise/delay execute OUTSIDE the
    state lock so a stall never blocks other sites."""
    st = _STATE
    if st is None:
        return value
    delay_s = 0.0
    raise_exc = None
    with st.lock:
        st.hits[site] = hit_idx = st.hits.get(site, 0) + 1
        lives = st.by_site.get(site)
        if not lives:
            return value
        for lf in lives:
            if not lf.decide():
                continue
            s = lf.spec
            if len(st.events) < _EVENT_CAP:
                st.events.append((site, s.action, hit_idx - 1))
            if lf.counter is not None:
                lf.counter.inc()
            if s.action == "delay":
                delay_s += s.delay_ms / 1000.0
            elif s.action == "raise":
                raise_exc = EXCEPTIONS.get(s.exc, OSError)(
                    f"chaos[{site}] injected {s.exc}"
                )
            elif s.action == "clock_skew":
                value = int(value or 0) + int(s.skew_ms)
            elif isinstance(value, (bytes, bytearray)):
                if s.action == "drop":
                    value = b""
                elif s.action == "corrupt" and len(value) > 0:
                    i = lf.rng.randrange(len(value))
                    value = value[:i] + bytes([value[i] ^ 0xFF]) + value[i + 1 :]
                elif s.action == "short_read" and len(value) > 1:
                    value = value[: lf.rng.randrange(1, len(value))]
    if delay_s > 0.0:
        _time.sleep(delay_s)
    if raise_exc is not None:
        raise raise_exc
    return value


def catalog() -> Dict[str, Site]:
    """Immutable view of every registered site (the catalog test and the
    CLI's ``--sites`` listing read this)."""
    with _LOCK:
        return dict(SITES)
