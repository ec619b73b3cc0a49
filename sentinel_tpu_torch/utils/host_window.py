"""Host-side sliding window counter.

The port's copy of ``sentinel_tpu/utils/host_window.py`` (host-only numpy).

A tiny NumPy LeapArray for host-plane accounting where a device round-trip
would be absurd overhead: the cluster token server's per-namespace request
guard (reference: RequestLimiter.java:29-39 over UnaryLeapArray(10, 1000))
and host-level self-metrics.

Same bucket arithmetic as the device windows (ops/window.py) and the
reference (LeapArray.java:112-124): bucket i = (t // len) % n, with lazy
epoch-tagged reset instead of locking.  Single counter per bucket
(UnaryLeapArray) or a small vector of event counters.

Thread-safety: guarded by a mutex; this path runs at host-RPC rate
(thousands/sec), not the device decision rate.
"""

from __future__ import annotations

import threading

import numpy as np


class HostWindow:
    """Sliding window of ``sample_count`` buckets over ``interval_ms``."""

    def __init__(self, sample_count: int = 10, interval_ms: int = 1000, events: int = 1):
        assert interval_ms % sample_count == 0
        self.sample_count = sample_count
        self.interval_ms = interval_ms
        self.window_ms = interval_ms // sample_count
        self.events = events
        self._counts = np.zeros((sample_count, events), dtype=np.int64)
        self._epochs = np.full((sample_count,), -1, dtype=np.int64)
        self._lock = threading.Lock()

    def _idx(self, now_ms: int):
        wid = now_ms // self.window_ms
        return int(wid % self.sample_count), wid

    def add(self, now_ms: int, count: int = 1, event: int = 0) -> None:
        i, wid = self._idx(now_ms)
        with self._lock:
            if self._epochs[i] != wid:
                self._counts[i] = 0
                self._epochs[i] = wid
            self._counts[i, event] += count

    def sum(self, now_ms: int, event: int = 0) -> int:
        _, wid = self._idx(now_ms)
        lo = wid - self.sample_count + 1
        with self._lock:
            valid = (self._epochs >= lo) & (self._epochs <= wid)
            return int(self._counts[valid, event].sum())

    def qps(self, now_ms: int, event: int = 0) -> float:
        return self.sum(now_ms, event) / (self.interval_ms / 1000.0)

    def try_pass(self, now_ms: int, limit_qps: float, count: int = 1) -> bool:
        """Admit-and-count iff the windowed QPS stays within ``limit_qps``
        (GlobalRequestLimiter.tryPass semantics)."""
        with self._lock:
            wid = now_ms // self.window_ms
            i = int(wid % self.sample_count)
            if self._epochs[i] != wid:
                self._counts[i] = 0
                self._epochs[i] = wid
            lo = wid - self.sample_count + 1
            valid = (self._epochs >= lo) & (self._epochs <= wid)
            cur = int(self._counts[valid, 0].sum())
            if cur + count > limit_qps * (self.interval_ms / 1000.0):
                return False
            self._counts[i, 0] += count
            return True
