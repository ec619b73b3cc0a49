"""Metric log writer — per-second metric lines + a seek index.

The port's copy of ``sentinel_tpu/metrics/writer.py``.

The analog of the reference's MetricWriter (node/metric/MetricWriter.java:36-58):
each app process appends one line per active resource per second to

    {base_dir}/{app}-metrics.log.pid{pid}.{yyyy-mm-dd}[.{n}]

and maintains a companion ``.idx`` file with one ``second_ts offset`` text
line per second written, so a reader can seek straight to a time range
without scanning (MetricSearcher / the dashboard's catch-up fetch).

Rolling: a new dated file per day; within a day, a new ``.n`` suffix when
the current file exceeds ``single_file_size``; at most ``total_file_count``
files are kept (oldest deleted), mirroring SentinelConfig's
``metric file size/count`` knobs (SentinelConfig.java:49-59).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from sentinel_tpu_torch.metrics.node import MetricNode

DEFAULT_SINGLE_FILE_SIZE = 50 * 1024 * 1024
DEFAULT_TOTAL_FILE_COUNT = 6


def metric_file_base(app_name: str, pid: Optional[int] = None) -> str:
    pid = os.getpid() if pid is None else pid
    return f"{app_name}-metrics.log.pid{pid}"


def list_metric_files(base_dir: str, app_name: str) -> List[str]:
    """All metric files for app (any pid), oldest → newest.

    Ordering key: (date, roll-index) — the reference sorts by file name then
    index (MetricWriter.listMetricFiles)."""
    if not os.path.isdir(base_dir):
        return []
    prefix = f"{app_name}-metrics.log.pid"
    out = []
    for fn in os.listdir(base_dir):
        if fn.startswith(prefix) and ".idx" not in fn:
            out.append(fn)
    return [os.path.join(base_dir, f) for f in sorted(out, key=_file_sort_key)]


def _pid_of(basename: str) -> int:
    # {app}-metrics.log.pid{pid}.{date}[.{n}]
    try:
        return int(basename.split(".pid", 1)[1].split(".", 1)[0])
    except (IndexError, ValueError):
        return -1


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else


def _file_sort_key(fn: str):
    # {app}-metrics.log.pid{pid}.{date}[.{n}]
    parts = fn.rsplit(".", 2)
    if len(parts) == 3 and parts[2].isdigit():
        return (parts[1], int(parts[2]))
    return (fn.rsplit(".", 1)[-1], 0)


class MetricWriter:
    def __init__(
        self,
        base_dir: str,
        app_name: str,
        single_file_size: int = DEFAULT_SINGLE_FILE_SIZE,
        total_file_count: int = DEFAULT_TOTAL_FILE_COUNT,
    ):
        self.base_dir = base_dir
        self.app_name = app_name
        self.single_file_size = single_file_size
        self.total_file_count = total_file_count
        self._lock = threading.Lock()
        self._fh = None
        self._idx_fh = None
        self._cur_path: Optional[str] = None
        self._cur_date: Optional[str] = None
        self._roll_n = 0
        self._last_sec = -1
        os.makedirs(base_dir, exist_ok=True)

    # -- public -------------------------------------------------------------

    def write(self, time_ms: int, nodes: List[MetricNode]) -> None:
        """Append nodes stamped at the second containing time_ms.

        Inactive (all-zero) nodes are skipped, as the reference does."""
        sec_ms = (time_ms // 1000) * 1000
        active = [n for n in nodes if n.is_active()]
        if not active:
            return
        with self._lock:
            self._ensure_file(sec_ms)
            if sec_ms // 1000 != self._last_sec:
                self._last_sec = sec_ms // 1000
                self._idx_fh.write(f"{sec_ms} {self._fh.tell()}\n")
                self._idx_fh.flush()
            for n in active:
                n.timestamp = sec_ms
                self._fh.write(n.to_line() + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            for fh in (self._fh, self._idx_fh):
                if fh is not None:
                    fh.close()
            self._fh = self._idx_fh = None
            self._cur_path = None

    # -- internals ----------------------------------------------------------

    def _ensure_file(self, time_ms: int) -> None:
        date = time.strftime("%Y-%m-%d", time.localtime(time_ms / 1000.0))
        need_new = (
            self._fh is None
            or date != self._cur_date
            or self._fh.tell() >= self.single_file_size
        )
        if not need_new:
            return
        if self._fh is not None:
            self._fh.close()
            self._idx_fh.close()
        if date != self._cur_date:
            self._cur_date = date
            self._roll_n = 0
        else:
            self._roll_n += 1
        base = metric_file_base(self.app_name)
        name = f"{base}.{date}" + (f".{self._roll_n}" if self._roll_n else "")
        self._cur_path = os.path.join(self.base_dir, name)
        self._fh = open(self._cur_path, "a", encoding="utf-8")
        self._idx_fh = open(self._cur_path + ".idx", "a", encoding="utf-8")
        self._last_sec = -1
        self._trim_old_files()

    def _trim_old_files(self) -> None:
        # eligible for deletion: this process's own files, plus files left
        # by pids that are no longer alive (dead runs would otherwise
        # accumulate forever).  Files of OTHER LIVE pids are never touched —
        # that process may have one open for append.
        own_prefix = metric_file_base(self.app_name) + "."
        files = []
        for f in list_metric_files(self.base_dir, self.app_name):
            base = os.path.basename(f)
            if base.startswith(own_prefix) or not _pid_alive(_pid_of(base)):
                files.append(f)
        excess = len(files) - self.total_file_count
        for path in files[: max(excess, 0)]:
            if path == self._cur_path:
                continue
            for p in (path, path + ".idx"):
                try:
                    os.remove(p)
                except OSError:
                    pass
