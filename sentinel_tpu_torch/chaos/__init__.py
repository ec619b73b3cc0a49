"""sentinel_tpu_torch.chaos — the fault-injection plane's failpoints.

The port's copies of ``sentinel_tpu/chaos/failpoints.py`` (named
injection sites: one flag check when disarmed) and ``chaos/plans.py``
(the declarative, seeded fault plans that arm them).  The runner, its
scenarios and the invariant monitors are not ported yet (ROADMAP.md,
Queue A items 6 and 10).
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
