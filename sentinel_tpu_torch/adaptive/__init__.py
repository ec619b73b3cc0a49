"""sentinel_tpu_torch.adaptive — closed-loop system-adaptive protection.

Three pieces (see each module's docstring):

* ``signals``   — lock-light per-tick ``SystemSignals`` rows collected
  from the obs plane and the tick loop's own state;
* ``controller``— the BBR-style closed loop that republishes the
  SystemSlot ceilings (maxPass × minRT) as live rule-tensor columns,
  and drives the degrade ladder;
* ``degrade``   — the shared ``Hysteresis`` / ``Backoff`` primitives and
  the ONE ordered ladder
  (NORMAL → SHED_LOW_PRIORITY → PARAM_TAIL_OFF → CLUSTER_FALLBACK →
  FAIL_CLOSED) every degrade site in the tree delegates to.

Enable on a client with ``client.enable_adaptive()`` (see
``runtime/client.py``); disabled mode costs one ``is None`` check per
tick/submission, same contract as obs tracing and chaos failpoints.
``simload`` is the deterministic flash-crowd simulator that drives a real
sync client through a healthy -> storm -> recovery schedule.

The port's copy of ``sentinel_tpu/adaptive`` (pure host code).
"""

from sentinel_tpu_torch.adaptive.controller import AdaptiveConfig, AdaptiveController
from sentinel_tpu_torch.adaptive.degrade import (
    CLUSTER_FALLBACK,
    FAIL_CLOSED,
    LEVEL_NAMES,
    NORMAL,
    PARAM_TAIL_OFF,
    SHED_LOW_PRIORITY,
    Backoff,
    DegradeLadder,
    Hysteresis,
)
from sentinel_tpu_torch.adaptive.signals import SignalCollector, SystemSignals

__all__ = [
    "AdaptiveConfig",
    "AdaptiveController",
    "Backoff",
    "DegradeLadder",
    "Hysteresis",
    "SignalCollector",
    "SystemSignals",
    "NORMAL",
    "SHED_LOW_PRIORITY",
    "PARAM_TAIL_OFF",
    "CLUSTER_FALLBACK",
    "FAIL_CLOSED",
    "LEVEL_NAMES",
]
