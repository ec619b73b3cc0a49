"""Time source with virtual-time support.

The reference caches wall-clock in a 1 ms daemon thread
(sentinel-core/.../util/TimeUtil.java:25-50) and its entire test suite mocks
that static method (AbstractTimeBasedTest.java:36-58).  Here the design goes
further: no jitted code ever reads a clock — kernels take ``now_ms``
explicitly — so the only clock consumer is the host tick loop, and tests
simply drive a ``VirtualTimeSource``.

Engine time is int32 milliseconds since an epoch captured at engine start
(keeps device-side time arithmetic in int32; wraps after ~24 days, at which
point windows self-heal within one interval since all comparisons are
windowed).
"""

from __future__ import annotations

import time

# -- module helpers ----------------------------------------------------------
# The ONLY sanctioned raw-clock reads outside a TimeSource instance (the
# stlint time-source pass enforces this structurally).  Deadline/cool-down
# bookkeeping that deliberately tracks REAL elapsed time even under a
# VirtualTimeSource (reconnect back-offs, degrade cool-downs, profiling)
# routes through these, so every clock read in the tree stays greppable
# from one module and a future cached/virtualized variant needs one edit.


def mono_s() -> float:
    """Monotonic seconds — deadline and back-off arithmetic."""
    return time.monotonic()


def wall_s() -> float:
    """Wall-clock seconds — heartbeat stamps, second-boundary alignment."""
    return time.time()


def wall_ms_now() -> int:
    """Wall-clock milliseconds — metric/dashboard timestamps."""
    return int(time.time() * 1000)


class TimeSource:
    """Real wall clock, ms since construction."""

    def __init__(self) -> None:
        self._epoch_ns = time.monotonic_ns()
        # wall-clock epoch for metric-log timestamps
        self.wall_epoch_ms = int(time.time() * 1000) - 0

    def now_ms(self) -> int:
        return (time.monotonic_ns() - self._epoch_ns) // 1_000_000

    def wall_ms(self, engine_ms: int | None = None) -> int:
        """Wall-clock ms corresponding to an engine timestamp."""
        if engine_ms is None:
            engine_ms = self.now_ms()
        return self.wall_epoch_ms + engine_ms

    def sleep_ms(self, ms: float) -> None:
        if ms > 0:
            time.sleep(ms / 1000.0)


class VirtualTimeSource(TimeSource):
    """Deterministic time for tests (analog of AbstractTimeBasedTest)."""

    def __init__(self, start_ms: int = 0) -> None:
        self._now = int(start_ms)
        self.wall_epoch_ms = 1_700_000_000_000  # arbitrary fixed wall epoch

    def now_ms(self) -> int:
        return self._now

    def set_ms(self, ms: int) -> None:
        self._now = int(ms)

    def advance(self, ms: int) -> None:
        self._now += int(ms)

    def sleep_ms(self, ms: float) -> None:
        # virtual sleep advances virtual time
        self._now += int(ms)
