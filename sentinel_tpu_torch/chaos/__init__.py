"""sentinel_tpu_torch.chaos — the fault-injection plane's failpoints.

The port's copies of ``sentinel_tpu/chaos/failpoints.py`` (named
injection sites: one flag check when disarmed) and ``chaos/plans.py``
(the declarative, seeded fault plans that arm them); every injected
fault is journalled in the flight recorder (obs/flight.py).  The runner,
its scenarios and the invariant monitors are not ported yet (ROADMAP.md,
Queue A item A10).
"""

from sentinel_tpu_torch.chaos import failpoints
from sentinel_tpu_torch.chaos.failpoints import arm, armed, catalog, disarm, hit, pipe, skew_ms
from sentinel_tpu_torch.chaos.plans import ACTIONS, FaultPlan, FaultSpec

__all__ = [
    "ACTIONS",
    "FaultPlan",
    "FaultSpec",
    "arm",
    "armed",
    "catalog",
    "disarm",
    "failpoints",
    "hit",
    "pipe",
    "skew_ms",
]
