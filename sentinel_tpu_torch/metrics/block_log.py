"""Block-event log — rate-limited ``sentinel-block.log``.

The analog of LogSlot → EagleEyeLogUtil.java:24-36 backed by the embedded
EagleEye StatLogger: every blocked request is recorded, but writes are
aggregated per (resource, exception, origin, provenance) per second so a
block storm costs one line per distinct key per second, not one line per
request.

Aggregation is inline (flushed when the wall second advances) instead of
an async appender thread — the host tick loop already gives a natural
cadence and this keeps the writer allocation-free.  The port's copy of
``sentinel_tpu/metrics/block_log.py``: the same lines, byte for byte.

Line formats (both are valid; ``parse_line`` reads either):

  legacy:   timestamp|resource|exceptionName|count|origin
  explain:  timestamp|resource|exceptionName|count|origin|kind|rule

The two trailing fields are the verdict provenance key from the explain
plane (obs/explain.py): the cause name ("flow"/"degrade"/…) and the
blamed rule slot (empty when unattributable).  Lines carry them only
when the caller supplied provenance, so a client without the explain
plane writes byte-identical legacy lines.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple


def parse_line(line: str) -> Optional[dict]:
    """One log line -> dict, accepting BOTH the legacy 5-field format and
    the 7-field explain format.  Returns None on a malformed line."""
    parts = line.rstrip("\n").split("|")
    if len(parts) not in (5, 7):
        return None
    try:
        out = {
            "ts": int(parts[0]),
            "resource": parts[1],
            "exception": parts[2],
            "count": int(parts[3]),
            "origin": parts[4],
            "kind": None,
            "rule": None,
        }
    except ValueError:
        return None
    if len(parts) == 7:
        out["kind"] = parts[5] or None
        try:
            out["rule"] = int(parts[6]) if parts[6] else None
        except ValueError:
            return None
    return out


class BlockLogger:
    def __init__(
        self,
        base_dir: str,
        filename: str = "sentinel-block.log",
        max_file_size: int = 50 * 1024 * 1024,
        backup_count: int = 3,
    ):
        os.makedirs(base_dir, exist_ok=True)
        self.path = os.path.join(base_dir, filename)
        self.max_file_size = max_file_size
        self.backup_count = backup_count
        self._lock = threading.Lock()
        self._cur_sec = -1
        self._pending: Dict[Tuple[str, str, str, Optional[str], Optional[int]], int] = {}

    def log(
        self,
        now_ms: int,
        resource: str,
        exception_name: str,
        origin: str = "",
        count: int = 1,
        kind: Optional[str] = None,
        rule: Optional[int] = None,
    ) -> None:
        sec = now_ms // 1000
        with self._lock:
            if sec != self._cur_sec:
                self._flush_locked()
                self._cur_sec = sec
            key = (resource, exception_name, origin, kind, rule)
            self._pending[key] = self._pending.get(key, 0) + count

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        ts = self._cur_sec * 1000
        lines = []
        for (res, exc, origin, kind, rule), cnt in self._pending.items():
            if kind is None and rule is None:
                lines.append(f"{ts}|{res}|{exc}|{cnt}|{origin}\n")
            else:
                lines.append(
                    f"{ts}|{res}|{exc}|{cnt}|{origin}"
                    f"|{kind or ''}|{'' if rule is None else rule}\n"
                )
        self._pending.clear()
        try:
            self._roll_if_needed()
            with open(self.path, "a", encoding="utf-8") as f:
                f.writelines(lines)
        except OSError:
            pass

    def _roll_if_needed(self) -> None:
        """Size-capped rotation (EagleEyeRollingFileAppender analog):
        block.log → block.log.1 → … → block.log.{backup_count} → dropped."""
        try:
            if os.path.getsize(self.path) < self.max_file_size:
                return
        except OSError:
            return
        for i in range(self.backup_count - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        os.replace(self.path, f"{self.path}.1")


_default: Optional[BlockLogger] = None
_default_lock = threading.Lock()


def default_block_logger() -> BlockLogger:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                from sentinel_tpu_torch.utils.record_log import log_dir

                _default = BlockLogger(log_dir())
    return _default
