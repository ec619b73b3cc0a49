"""Metric extension SPI — external-metrics callbacks (Prometheus-style).

The port's copy of ``sentinel_tpu/metrics/extension.py``; its error
counter lives in the port's own registry.

The analog of metric/extension/MetricExtension.java +
MetricCallbackInit.java: registered extensions get a callback on every
pass / block / completion so users can bridge verdict telemetry into their
own metrics system.  Callbacks run on the caller thread and must be cheap;
when no extension is registered the hot path pays one truthiness check.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.time_source import mono_s

_log = logging.getLogger(__name__)

#: swallowed extension exceptions, visible on /metrics — a throwing user
#: extension must never corrupt engine accounting, but it must not fail
#: SILENTLY either (the counter keeps climbing even while logs are
#: rate-limited)
_C_EXT_ERRORS = _OBS.counter(
    "sentinel_extension_errors_total",
    "metric-extension callbacks that raised and were swallowed",
)

#: seconds between log warnings per (extension class, hook) — a
#: hot-path extension failing on EVERY pass would otherwise write the
#: log at traffic rate
_WARN_INTERVAL_S = 10.0


class MetricExtension:
    """Subclass and override what you need; all hooks default to no-ops."""

    def on_pass(self, resource: str, count: int, origin: str, args: Optional[Sequence] = None) -> None:
        pass

    def on_block(
        self,
        resource: str,
        count: int,
        origin: str,
        block_exception: BaseException,
        args: Optional[Sequence] = None,
    ) -> None:
        pass

    def on_complete(self, resource: str, rt_ms: float, success: int, origin: str) -> None:
        pass

    def on_exception(self, resource: str, count: int, origin: str) -> None:
        pass

    def on_thread_change(self, resource: str, delta: int) -> None:
        pass


_lock = threading.Lock()
_extensions: List[MetricExtension] = []
# (ext class name, hook) -> (last warning stamp, failures since that log);
# all writes under _lock (the module's one owning lock)
_warn_state: Dict[Tuple[str, str], Tuple[float, int]] = {}


def register_extension(ext: MetricExtension) -> None:
    global _extensions
    with _lock:
        _extensions = _extensions + [ext]


def unregister_extension(ext: MetricExtension) -> None:
    global _extensions
    with _lock:
        _extensions = [x for x in _extensions if x is not ext]


def clear_extensions() -> None:
    global _extensions
    with _lock:
        _extensions = []


def get_extensions() -> List[MetricExtension]:
    # copy-on-write: registration rebinds a fresh list under the lock, so
    # lock-free readers always iterate an immutable snapshot
    return _extensions


def safe_dispatch(hook: str, *args) -> None:
    """Invoke one hook on every registered extension, isolating failures —
    a throwing user extension must never corrupt engine accounting.

    Every swallowed exception increments
    ``sentinel_extension_errors_total``; the log warning is
    rate-limited to one per (extension class, hook) per
    ``_WARN_INTERVAL_S`` and carries the count of failures the limiter
    suppressed since the previous log, so a persistently-failing
    extension stays VISIBLE without writing the log at traffic rate."""
    exts = _extensions
    if not exts:
        return
    for x in exts:
        try:
            getattr(x, hook)(*args)
        except Exception:  # noqa: BLE001
            _C_EXT_ERRORS.inc()
            key = (type(x).__name__, hook)
            now = mono_s()
            with _lock:
                last, suppressed = _warn_state.get(key, (-1e18, 0))
                if now - last >= _WARN_INTERVAL_S:
                    _warn_state[key] = (now, 0)
                    do_log, since = True, suppressed
                else:
                    _warn_state[key] = (last, suppressed + 1)
                    do_log, since = False, 0
            if do_log:
                _log.exception(
                    "metric extension %s.%s failed (+%d more failures "
                    "suppressed in the last %.0fs; total on "
                    "sentinel_extension_errors_total)",
                    key[0], hook, since, _WARN_INTERVAL_S,
                )
