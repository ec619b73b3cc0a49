"""Declarative fault plans: what to inject, where, and on which schedule.

The port's copy of ``sentinel_tpu/chaos/plans.py``.

A ``FaultPlan`` is a seed plus a list of ``FaultSpec`` entries; it is the
unit the runner arms (``failpoints.arm(plan)``) and the unit that
round-trips through JSON, so a failing chaos run can be replayed exactly
from its serialized plan:

    plan = FaultPlan(name="burst", seed=7, faults=[
        FaultSpec("cluster.rpc.send", "raise", burst_start=2, burst_len=2),
        FaultSpec("cluster.rpc.send", "delay", every_nth=5, delay_ms=2.0),
    ])
    FaultPlan.from_json(plan.to_json()) == plan

Schedules compose as an AND over whichever gates are set, evaluated per
SITE-hit in order (see ``_LiveFault.decide``):

  * ``burst_start``/``burst_len`` — fire only within a hit-index window
  * ``every_nth``                 — fire on every Nth hit
  * ``probability``               — seeded Bernoulli draw per hit
  * ``max_fires``                 — hard cap on total fires (the lever
                                    that pins injected-event counts when
                                    hit counts could vary with timing)

With no gate set a spec fires on every hit.  All randomness comes from a
per-spec ``random.Random`` derived from ``(plan.seed, spec index)``, so
identical plans driven over identical per-site hit sequences inject the
identical event sequence — the determinism contract the CLI asserts.
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import Dict, List

from sentinel_tpu_torch.chaos import failpoints as FP

ACTIONS = ("delay", "raise", "drop", "corrupt", "short_read", "clock_skew")


@dataclass(frozen=True)
class FaultSpec:
    """One fault: a site, an action, a schedule, and action parameters."""

    site: str
    action: str
    # schedule gates (AND of the ones set; none set = every hit)
    probability: float = 0.0
    every_nth: int = 0
    burst_start: int = 0
    burst_len: int = 0
    max_fires: int = 0
    # action parameters
    delay_ms: float = 0.0
    skew_ms: int = 0
    exc: str = "OSError"

    def validate(self, sites: Dict[str, FP.Site]) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"unknown action {self.action!r}")
        site = sites.get(self.site)
        if site is None:
            raise ValueError(f"failpoint site {self.site!r} is not registered")
        if self.action not in site.kinds:
            raise ValueError(
                f"site {self.site!r} honors {site.kinds}, not {self.action!r}"
            )
        if self.action == "raise" and self.exc not in FP.EXCEPTIONS:
            raise ValueError(f"unknown exception class {self.exc!r}")
        if not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")
        if min(self.every_nth, self.burst_start, self.burst_len, self.max_fires) < 0:
            raise ValueError("schedule fields must be >= 0")
        if self.burst_start and not self.burst_len:
            # burst_len == 0 disables the burst gate entirely; a lone
            # burst_start would silently fire on EVERY hit, not a window
            raise ValueError("burst_start requires burst_len > 0")
        if self.delay_ms < 0:
            raise ValueError("delay_ms must be >= 0")


@dataclass(frozen=True)
class FaultPlan:
    """A named, seeded set of FaultSpecs — the armable/replayable unit."""

    name: str = ""
    seed: int = 0
    faults: List[FaultSpec] = field(default_factory=list)

    def validate(self, sites: Dict[str, FP.Site]) -> None:
        for spec in self.faults:
            spec.validate(sites)

    def spec_rng(self, idx: int) -> random.Random:
        """Per-spec PRNG stream: seeded from (plan seed, spec index) with
        a fixed odd multiplier so adjacent seeds don't share streams."""
        return random.Random((int(self.seed) * 0x9E3779B1 + idx) & 0xFFFFFFFF)

    # -- JSON round-trip -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "faults": [asdict(s) for s in self.faults],
        }

    def to_json(self, indent: int = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @staticmethod
    def from_dict(d: dict) -> "FaultPlan":
        return FaultPlan(
            name=str(d.get("name", "")),
            seed=int(d.get("seed", 0)),
            faults=[FaultSpec(**f) for f in d.get("faults", ())],
        )

    @staticmethod
    def from_json(s: str) -> "FaultPlan":
        return FaultPlan.from_dict(json.loads(s))
