"""Host load / CPU sampling for system-adaptive protection.

Analog of SystemStatusListener.java:31-67, which polls
OperatingSystemMXBean once a second.  Uses os.getloadavg + /proc/stat
deltas (no psutil dependency); values are fed to the engine as explicit
tick inputs, never read inside jit.
"""

from __future__ import annotations

import os

from sentinel_tpu_torch.utils.time_source import mono_s
from typing import Tuple


class SystemStatusSampler:
    def __init__(self, min_interval_s: float = 1.0):
        self._min_interval = min_interval_s
        self._last_sample = 0.0
        self._load = 0.0
        self._cpu = 0.0
        self._prev_total = 0
        self._prev_idle = 0

    def _read_proc_stat(self) -> Tuple[int, int]:
        try:
            with open("/proc/stat", "r") as f:
                parts = f.readline().split()
            vals = [int(x) for x in parts[1:11]]
            idle = vals[3] + vals[4]  # idle + iowait
            return sum(vals), idle
        except (OSError, ValueError, IndexError):
            return 0, 0

    def sample(self) -> Tuple[float, float]:
        """(load_average_1min, process+system cpu usage in [0,1])."""
        now = mono_s()
        if now - self._last_sample < self._min_interval:
            return self._load, self._cpu
        self._last_sample = now
        try:
            self._load = os.getloadavg()[0]
        except OSError:
            self._load = 0.0
        total, idle = self._read_proc_stat()
        dt = total - self._prev_total
        di = idle - self._prev_idle
        if dt > 0 and self._prev_total > 0:
            self._cpu = max(0.0, min(1.0, 1.0 - di / dt))
        self._prev_total, self._prev_idle = total, idle
        return self._load, self._cpu
