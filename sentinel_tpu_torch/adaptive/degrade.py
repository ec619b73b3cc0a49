"""The one hysteresis primitive of the degrade sites.

The port's copy of ``Hysteresis`` from ``sentinel_tpu/adaptive/degrade.py``
— the enter-on-failure / cooldown / exit-on-healthy-probe shape the
hot-set manager (sketch/hotset.py) damps promotion flapping with.  The
reference also journals every transition in the flight recorder
(``obs.flight``) and mirrors it as a trace event (``obs.trace``); neither
is ported yet (ROADMAP.md Queue A item 6), so this copy leaves both out.
The degrade ladder and ``Backoff`` come with the adaptive controller.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from sentinel_tpu_torch.utils.time_source import mono_s


class Hysteresis:
    """Enter-on-failure / cooldown-hold / exit state.

    ``enter()`` arms (or re-arms) a cooldown of ``cooldown_s`` REAL seconds
    (degrade windows track wall progress even under a virtual time
    source); ``cooling`` is True while it runs; ``exit()`` disarms.  The
    reference's metric hooks and probe helpers come with the adaptive
    controller."""

    __slots__ = ("kind", "cooldown_s", "attrs", "active", "until", "_clock", "_lock")

    def __init__(
        self,
        kind: str,
        cooldown_s: float,
        attrs: Optional[Dict[str, str]] = None,
        clock: Callable[[], float] = mono_s,
    ):
        self.kind = kind
        self.cooldown_s = float(cooldown_s)
        self.attrs = dict(attrs or {})
        self.active = False
        self.until = 0.0
        self._clock = clock
        self._lock = threading.Lock()

    def enter(self, cooldown_s: Optional[float] = None) -> bool:
        """Arm (idempotent: extends the cooldown when already active).
        Returns True on the enter TRANSITION."""
        cd = self.cooldown_s if cooldown_s is None else float(cooldown_s)
        with self._lock:
            self.until = self._clock() + cd
            if self.active:
                return False
            self.active = True
        return True

    def exit(self) -> bool:
        """Disarm.  Returns True on the transition."""
        with self._lock:
            if not self.active:
                return False
            self.active = False
        return True

    @property
    def cooling(self) -> bool:
        """Degraded and inside the cooldown: serve the fallback."""
        return self.active and self._clock() < self.until
