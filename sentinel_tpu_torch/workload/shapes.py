"""Composable, seeded traffic shapes for the workload engine.

A shape is a pure function ``rate_at(step) -> float`` (mean offered
events for that virtual-time step) plus an optional key mix override —
diurnal curves, flash crowds, adversarial hot-param floods and
shard-skewed hotspots compose by summation into one offered stream.
Randomness (arrival jitter, key draws, churn) never lives here: shapes
are ARITHMETIC, so the generator's per-shape PRNG streams (the chaos
plane's ``FaultPlan.spec_rng`` derivation) are the only entropy and two
runs at one seed replay bit-identically.

Key mixes map an event index to a concrete key: ``ZipfKeys`` draws
ranks from a truncated Zipf(alpha) over ``n_keys`` keys and CHURNS the
rank→key binding every ``churn_every_steps`` (rotating which keys are
hot — the cache-busting pattern), ``SkewedKeys`` picks from explicit
weights (shard-skewed hotspots: weight mass on one shard's keys).

The port's copy of ``sentinel_tpu/workload/shapes.py`` (pure arithmetic).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


# -- key mixes ---------------------------------------------------------------


@dataclass(frozen=True)
class ZipfKeys:
    """Truncated Zipf(alpha) over ``{prefix}{i}`` with rank churn: every
    ``churn_every_steps`` the rank→key binding rotates by ``churn_shift``
    so yesterday's cold keys become today's hot set."""

    n_keys: int = 64
    alpha: float = 1.1
    churn_every_steps: int = 0  # 0 = static binding
    churn_shift: int = 7
    prefix: str = "wl/key"

    def _cdf(self) -> Tuple[float, ...]:
        w = [1.0 / (i + 1) ** self.alpha for i in range(self.n_keys)]
        tot = sum(w)
        acc, out = 0.0, []
        for x in w:
            acc += x / tot
            out.append(acc)
        return tuple(out)

    def key_for(self, step: int, u: float, cdf: Tuple[float, ...]) -> str:
        rank = bisect.bisect_left(cdf, u)
        rank = min(rank, self.n_keys - 1)
        if self.churn_every_steps:
            rot = (step // self.churn_every_steps) * self.churn_shift
            rank = (rank + rot) % self.n_keys
        return f"{self.prefix}{rank}"


@dataclass(frozen=True)
class SkewedKeys:
    """Explicit (key, weight) mix — the shard-skewed hotspot: put most
    of the mass on keys one ring shard owns."""

    keys: Tuple[Tuple[str, float], ...] = (("wl/hot", 0.8), ("wl/cold", 0.2))

    def _cdf(self) -> Tuple[float, ...]:
        tot = sum(w for _k, w in self.keys) or 1.0
        acc, out = 0.0, []
        for _k, w in self.keys:
            acc += w / tot
            out.append(acc)
        return tuple(out)

    def key_for(self, step: int, u: float, cdf: Tuple[float, ...]) -> str:
        i = min(bisect.bisect_left(cdf, u), len(self.keys) - 1)
        return self.keys[i][0]


# -- rate shapes -------------------------------------------------------------


@dataclass(frozen=True)
class Constant:
    """Flat offered load."""

    rate: float = 4.0
    name: str = "constant"
    keys: Optional[object] = None  # key-mix override for this shape's events
    param: Optional[str] = None  # hot-param payload carried by events

    def rate_at(self, step: int) -> float:
        return self.rate


@dataclass(frozen=True)
class Diurnal:
    """Sinusoidal day curve: ``base * (1 + amplitude * sin)`` with the
    period in steps (virtual time makes a 'day' as short as the test
    wants)."""

    base: float = 4.0
    amplitude: float = 0.5
    period_steps: int = 200
    phase: float = 0.0
    name: str = "diurnal"
    keys: Optional[object] = None
    param: Optional[str] = None

    def rate_at(self, step: int) -> float:
        w = 2.0 * math.pi * (step / max(1, self.period_steps)) + self.phase
        return max(0.0, self.base * (1.0 + self.amplitude * math.sin(w)))


@dataclass(frozen=True)
class FlashCrowd:
    """Ramp → hold → decay spike on top of zero (compose with a
    Constant/Diurnal baseline): the 2×-sustained flash crowd is
    ``FlashCrowd(peak=base)`` over ``Constant(base)``."""

    peak: float = 8.0
    start_step: int = 50
    ramp_steps: int = 10
    hold_steps: int = 100
    decay_steps: int = 20
    name: str = "flash_crowd"
    keys: Optional[object] = None
    param: Optional[str] = None

    def rate_at(self, step: int) -> float:
        t = step - self.start_step
        if t < 0:
            return 0.0
        if t < self.ramp_steps:
            return self.peak * (t + 1) / self.ramp_steps
        t -= self.ramp_steps
        if t < self.hold_steps:
            return self.peak
        t -= self.hold_steps
        if t < self.decay_steps:
            return self.peak * (self.decay_steps - t) / self.decay_steps
        return 0.0


@dataclass(frozen=True)
class HotParamFlood:
    """Adversarial burst hammering ONE param value on one key — the
    hot-param rule's attack shape.  Events carry ``param`` so the
    drivers route them through the param-flow path."""

    rate: float = 16.0
    start_step: int = 0
    duration_steps: int = 50
    param: Optional[str] = "attacker-1"
    key: str = "wl/param-target"
    name: str = "hot_param_flood"

    @property
    def keys(self) -> object:
        return SkewedKeys(keys=((self.key, 1.0),))

    def rate_at(self, step: int) -> float:
        t = step - self.start_step
        return self.rate if 0 <= t < self.duration_steps else 0.0


@dataclass(frozen=True)
class WorkloadSpec:
    """One offered-traffic plan: shapes summed over ``steps`` virtual
    steps of ``step_ms`` each, keys drawn from ``keys`` unless a shape
    overrides, all entropy derived from ``seed`` (generator.py)."""

    seed: int = 7
    steps: int = 200
    step_ms: int = 10
    shapes: Tuple[object, ...] = field(default_factory=tuple)
    keys: object = field(default_factory=ZipfKeys)

    def with_seed(self, seed: int) -> "WorkloadSpec":
        import dataclasses

        return dataclasses.replace(self, seed=seed)


def flash_crowd_2x(
    seed: int = 7,
    base: float = 4.0,
    steps: int = 240,
    step_ms: int = 10,
    start_step: int = 60,
    keys: Optional[object] = None,
) -> WorkloadSpec:
    """The acceptance shape: sustained ``base`` with a flash crowd that
    doubles the offered load (2× sustained) for the middle third."""
    hold = max(1, steps // 3)
    return WorkloadSpec(
        seed=seed,
        steps=steps,
        step_ms=step_ms,
        shapes=(
            Constant(rate=base, name="sustained"),
            FlashCrowd(
                peak=base,
                start_step=start_step,
                ramp_steps=10,
                hold_steps=hold,
                decay_steps=10,
            ),
        ),
        keys=keys if keys is not None else ZipfKeys(n_keys=16),
    )
