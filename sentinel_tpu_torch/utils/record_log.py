"""Where the framework's logs live (log/LogBase.java's ``~/logs/csp/``).

The port's copy of ``log_dir`` from ``sentinel_tpu/utils/record_log.py``:
the base directory the timeline's metric log defaults to.  Overridable
with ``CSP_SENTINEL_LOG_DIR``.  The record and command-center loggers are
not ported yet (ROADMAP.md, Queue A item 6).
"""

from __future__ import annotations

import os


def log_dir() -> str:
    d = os.environ.get("CSP_SENTINEL_LOG_DIR") or os.path.join(
        os.path.expanduser("~"), "logs", "csp"
    )
    os.makedirs(d, exist_ok=True)
    return d
