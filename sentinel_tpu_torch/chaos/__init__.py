"""sentinel_tpu_torch.chaos — deterministic fault-injection plane.

The port's copy of ``sentinel_tpu/chaos``:

  * ``failpoints`` — named injection sites threaded through transport,
    cluster, runtime, parallel, and datasource code; one flag check when
    disarmed, seeded deterministic actions when armed; every injected
    fault is journalled in the flight recorder (``obs/flight.py``)
  * ``plans`` — declarative fault plans (what/where/when), JSON
    round-trippable so any run replays from its serialized plan + seed
  * ``invariants`` + ``runner`` — safety monitors over ``obs.REGISTRY``
    metrics, client state and the lock witness, plus eleven built-in
    scenarios driving real clients, token servers, fleets and remote
    shards under a plan

CLI: ``python -m sentinel_tpu_torch.chaos --seed 7`` runs every built-in
scenario on the card (``--device cpu`` on the CPU) and reports
per-scenario invariant verdicts and injected-event counts (identical for
identical seeds — the determinism contract).

NOTE: importing this package must stay cheap — ``failpoints`` is
imported by hot product modules at process start.  The runner's
scenarios stay inside ``runner`` / ``__main__``.
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
