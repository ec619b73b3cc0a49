"""Unified degrade semantics: ONE hysteresis primitive, ONE ladder.

The port's copy of ``sentinel_tpu/adaptive/degrade.py``.  ``Hysteresis``
is the enter-on-failure / cooldown / exit-on-healthy-probe shape the
client's cluster degrade (runtime/client.py) and the hot-set manager
(sketch/hotset.py) share; ``Backoff`` throttles the cluster token
client's reconnects (cluster/client.py).  Transitions count on the
metrics the caller hands in, are mirrored as zero-duration trace events
(``obs.trace``) and are journalled in the flight recorder
(``obs.flight``).

On top of the shared primitive sits the ONE ordered degrade ladder the
closed-loop controller (adaptive/controller.py) climbs under overload::

    NORMAL -> SHED_LOW_PRIORITY -> PARAM_TAIL_OFF -> CLUSTER_FALLBACK
           -> FAIL_CLOSED

Climbing requires ``climb_hold_ms`` of sustained overload evidence per
rung; descending requires ``cool_hold_ms`` of sustained health — both in
ENGINE time (the tick's ``now_ms``), so ladder motion is a pure function
of the driven traffic and replays deterministically under virtual time.
Every transition is journalled in ``obs.flight`` and mirrored on the
``sentinel_adaptive_level`` gauge.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Dict, Optional

from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.time_source import mono_s

# -- the ladder rungs --------------------------------------------------------

NORMAL = 0
SHED_LOW_PRIORITY = 1  # non-prioritized work sheds above the soft queue mark
PARAM_TAIL_OFF = 2  # host param-tail bookkeeping (hot-param values) off
CLUSTER_FALLBACK = 3  # cluster token RPCs bypassed; local fallback enforces
FAIL_CLOSED = 4  # every new admission fails closed until health returns

LEVEL_NAMES = (
    "NORMAL",
    "SHED_LOW_PRIORITY",
    "PARAM_TAIL_OFF",
    "CLUSTER_FALLBACK",
    "FAIL_CLOSED",
)

_G_LEVEL = _OBS.gauge(
    "sentinel_adaptive_level",
    "current degrade-ladder rung (0=NORMAL .. 4=FAIL_CLOSED)",
)
_C_LADDER = {
    d: _OBS.counter(
        "sentinel_adaptive_ladder_transitions_total",
        "degrade-ladder moves, by direction",
        labels={"direction": d},
    )
    for d in ("up", "down")
}


class Hysteresis:
    """Enter-on-failure / cooldown-hold / exit state.

    ``enter()`` arms (or re-arms) a cooldown of ``cooldown_s`` REAL seconds
    (degrade windows track wall progress even under a virtual time
    source); ``cooling`` is True while it runs (serve the fallback, don't
    probe); ``exit()`` disarms on the first healthy answer.
    ``counter_enter`` / ``counter_exit`` count the transitions and
    ``gauge`` reads 1 while active."""

    __slots__ = (
        "kind", "cooldown_s", "attrs", "active", "until",
        "_clock", "_lock", "_c_enter", "_c_exit", "_gauge",
    )

    def __init__(
        self,
        kind: str,
        cooldown_s: float,
        attrs: Optional[Dict[str, str]] = None,
        counter_enter=None,
        counter_exit=None,
        gauge=None,
        clock: Callable[[], float] = mono_s,
    ):
        self.kind = kind
        self.cooldown_s = float(cooldown_s)
        self.attrs = dict(attrs or {})
        self.active = False
        self.until = 0.0
        self._clock = clock
        self._lock = threading.Lock()
        self._c_enter = counter_enter
        self._c_exit = counter_exit
        self._gauge = gauge

    def enter(self, cooldown_s: Optional[float] = None, **extra) -> bool:
        """Arm (idempotent: extends the cooldown without re-journalling
        when already active).  Returns True on the enter TRANSITION."""
        cd = self.cooldown_s if cooldown_s is None else float(cooldown_s)
        with self._lock:
            self.until = self._clock() + cd
            if self.active:
                return False
            self.active = True
            if self._c_enter is not None:
                self._c_enter.inc()
            if self._gauge is not None:
                self._gauge.set(1)
        OT.event(f"{self.kind}.enter", attrs=self.attrs or None)
        FL.note(f"{self.kind}.enter", cooldown_s=cd, **self.attrs, **extra)
        return True

    def exit(self, **extra) -> bool:
        """Disarm on a healthy probe.  Returns True on the transition."""
        with self._lock:
            if not self.active:
                return False
            self.active = False
            if self._c_exit is not None:
                self._c_exit.inc()
            if self._gauge is not None:
                self._gauge.set(0)
        OT.event(f"{self.kind}.exit", attrs=self.attrs or None)
        FL.note(f"{self.kind}.exit", **self.attrs, **extra)
        return True

    @property
    def cooling(self) -> bool:
        """Degraded and inside the cooldown: serve the fallback."""
        return self.active and self._clock() < self.until

    @property
    def probe_due(self) -> bool:
        """Degraded with the cooldown lapsed: a probe may go out."""
        return self.active and self._clock() >= self.until

    def remaining_s(self) -> float:
        return max(self.until - self._clock(), 0.0) if self.active else 0.0


class Backoff:
    """Exponential backoff with FULL jitter: attempt ``n`` waits
    ``uniform(0, min(cap, base * 2**n))``, so clients that lost the same
    server do not retry on one beat and stampede it as it comes back.

    ``base_s == 0`` degrades to "always ready" (the tests' no-throttle
    configuration).  ``clock`` / ``rng`` are injectable so tests run on
    virtual time with a seeded stream."""

    __slots__ = ("base_s", "cap_s", "attempt", "_next_at", "_rng", "_clock")

    def __init__(
        self,
        base_s: float,
        cap_s: float = 30.0,
        rng: Optional[random.Random] = None,
        clock: Callable[[], float] = mono_s,
    ):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.attempt = 0
        self._next_at = 0.0
        # a per-instance stream: two clients sharing the module RNG would
        # re-correlate under load
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock

    def ready(self) -> bool:
        """May an attempt go out now?"""
        return self._clock() >= self._next_at

    def failure(self) -> float:
        """Record a failed attempt; returns the jittered delay armed."""
        # exponent clamped: 2.0 ** 1024 after a long outage would overflow
        ceil = min(self.cap_s, self.base_s * (2.0 ** min(self.attempt, 63)))
        delay = self._rng.uniform(0.0, ceil) if ceil > 0 else 0.0
        self.attempt += 1
        self._next_at = self._clock() + delay
        return delay

    def success(self) -> None:
        """Healthy attempt: reset to the un-backed-off state."""
        self.attempt = 0
        self._next_at = 0.0


class DegradeLadder:
    """The ordered overload ladder, driven once per tick in engine time.

    ``observe(now_ms, overloaded, severe)``: ``overloaded`` is this tick's
    pressure verdict (the controller computes it from live signals);
    ``severe`` escalates straight past the hold (a watchdog firing must
    not wait out the hysteresis window rung by rung — it still climbs ONE
    rung at a time, so transitions stay monotone steps).

    Climb: ``climb_hold_ms`` of uninterrupted overload per rung.  Descend:
    ``cool_hold_ms`` of uninterrupted health per rung.  Any contradicting
    tick resets the opposite hold — that IS the hysteresis."""

    def __init__(
        self,
        climb_hold_ms: int = 200,
        cool_hold_ms: int = 1000,
        max_level: int = FAIL_CLOSED,
    ):
        self.level = NORMAL
        self.climb_hold_ms = int(climb_hold_ms)
        self.cool_hold_ms = int(cool_hold_ms)
        self.max_level = int(max_level)
        self._over_since: Optional[int] = None
        self._calm_since: Optional[int] = None
        self.transitions: list = []  # [(now_ms, from, to)] — bounded below
        self._lock = threading.Lock()

    _TRANSITION_CAP = 4096

    def observe(self, now_ms: int, overloaded: bool, severe: bool = False) -> int:
        """Advance the ladder for one tick; returns the (new) level."""
        with self._lock:
            if overloaded:
                self._calm_since = None
                if self._over_since is None:
                    self._over_since = now_ms
                held = now_ms - self._over_since
                if self.level < self.max_level and (severe or held >= self.climb_hold_ms):
                    self._move(now_ms, self.level + 1)
                    # each rung re-arms its own hold (severe re-climbs next
                    # tick; ordinary pressure waits the full hold)
                    self._over_since = now_ms
            else:
                self._over_since = None
                if self.level > NORMAL:
                    if self._calm_since is None:
                        self._calm_since = now_ms
                    if now_ms - self._calm_since >= self.cool_hold_ms:
                        self._move(now_ms, self.level - 1)
                        self._calm_since = now_ms
            return self.level

    def _move(self, now_ms: int, to: int) -> None:
        frm, self.level = self.level, to
        if len(self.transitions) < self._TRANSITION_CAP:
            self.transitions.append((int(now_ms), frm, to))
        _G_LEVEL.set(to)
        _C_LADDER["up" if to > frm else "down"].inc()
        OT.event("adaptive.ladder", attrs={"from": LEVEL_NAMES[frm], "to": LEVEL_NAMES[to]})
        FL.note("adaptive.ladder", now_ms=int(now_ms), frm=LEVEL_NAMES[frm], to=LEVEL_NAMES[to])

    def reset(self) -> None:
        with self._lock:
            self.level = NORMAL
            self._over_since = None
            self._calm_since = None
            self.transitions = []
            _G_LEVEL.set(0)
