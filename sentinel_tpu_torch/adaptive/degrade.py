"""The hysteresis primitive of the degrade sites, and the reconnect backoff.

The port's copy of ``Hysteresis`` and ``Backoff`` from
``sentinel_tpu/adaptive/degrade.py``.  ``Hysteresis`` is the
enter-on-failure / cooldown / exit-on-healthy-probe shape the client's
cluster degrade (runtime/client.py) and the hot-set manager
(sketch/hotset.py) share; ``Backoff`` throttles the cluster token
client's reconnects (cluster/client.py).  Transitions count on the metrics
the caller hands in and are mirrored as zero-duration trace events
(``obs.trace``).  The reference also journals every transition in the
flight recorder (``obs.flight``), which is not ported yet (ROADMAP.md
Queue A item 6); the degrade ladder comes with the adaptive controller.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Dict, Optional

from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.utils.time_source import mono_s


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

    def enter(self, cooldown_s: Optional[float] = None) -> bool:
        """Arm (idempotent: extends the cooldown when already active).
        Returns True on the enter TRANSITION."""
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
        return True

    def exit(self) -> bool:
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
        return True

    @property
    def cooling(self) -> bool:
        """Degraded and inside the cooldown: serve the fallback."""
        return self.active and self._clock() < self.until


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
