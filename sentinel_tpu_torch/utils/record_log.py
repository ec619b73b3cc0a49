"""RecordLog: the framework's operational log (log/RecordLog.java).

The port's copy of ``sentinel_tpu/utils/record_log.py``, with loggers of
its own (``sentinel_tpu_torch.record``, ``sentinel_tpu_torch.command``).

Writes to ``~/logs/csp/sentinel-record.log`` by default (log/LogBase.java's
``~/logs/csp/`` convention), overridable via env:

  * ``CSP_SENTINEL_LOG_DIR``            — base directory
  * ``CSP_SENTINEL_LOG_OUTPUT_TYPE``    — "file" (default) | "console"
  * ``CSP_SENTINEL_LOG_USE_PID``        — "true" appends .pid<pid>

Lazy singleton; safe to import anywhere (no handlers until first use).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

_lock = threading.Lock()
_logger: Optional[logging.Logger] = None
_command_logger: Optional[logging.Logger] = None


def log_dir() -> str:
    d = os.environ.get("CSP_SENTINEL_LOG_DIR") or os.path.join(
        os.path.expanduser("~"), "logs", "csp"
    )
    os.makedirs(d, exist_ok=True)
    return d


def _log_name(base: str) -> str:
    if os.environ.get("CSP_SENTINEL_LOG_USE_PID", "").lower() == "true":
        return "%s.pid%d" % (base, os.getpid())
    return base


def _build(name: str, filename: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if os.environ.get("CSP_SENTINEL_LOG_OUTPUT_TYPE", "file") == "console":
        h: logging.Handler = logging.StreamHandler()
    else:
        try:
            h = logging.FileHandler(os.path.join(log_dir(), _log_name(filename)))
        except OSError:
            h = logging.StreamHandler()
    h.setFormatter(fmt)
    logger.addHandler(h)
    return logger


def record_log() -> logging.Logger:
    global _logger
    if _logger is None:
        with _lock:
            if _logger is None:
                _logger = _build("sentinel_tpu_torch.record", "sentinel-record.log")
    return _logger


def command_center_log() -> logging.Logger:
    global _command_logger
    if _command_logger is None:
        with _lock:
            if _command_logger is None:
                _command_logger = _build(
                    "sentinel_tpu_torch.command", "command-center.log"
                )
    return _command_logger
