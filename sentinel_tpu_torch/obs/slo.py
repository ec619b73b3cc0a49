"""Declarative SLOs with multi-window burn-rate evaluation over the
metrics registry.

The port's copy of ``sentinel_tpu/obs/slo.py`` (pure host code over the
port's own ``REGISTRY`` and ``FLIGHT``).  Every counter ``default_slos()``
reads is registered by the port once a client has served, except
``sentinel_shard_requests_total`` and the two shard-failure counters of
``fleet_error_budget``: they come with the sharded token client
(``cluster/shard.py``, ROADMAP.md Queue A item A7b).  Until then that
spec reads 0 / 0 and reports no burn.

The obs plane measures; this module JUDGES: an ``SloSpec`` names a
good/bad event ratio (counter sums, or a latency histogram judged
against a threshold), an objective (target good fraction), and the
classic multi-window page rule — alert only when BOTH a short and a long
window burn error budget faster than a threshold (fast-burn pages catch
cliffs, the long window filters blips; the Google SRE workbook shape).

Everything is computed from REGISTRY DELTAS between ``step(now_ms)``
calls: the engine keeps a ring of ``(t, bad, total)`` snapshots per
spec, so burn rates need no extra instrumentation in any hot path and
the whole evaluation replays deterministically under a virtual clock
(``now_ms`` is an explicit input — the chaos plane's requirement).

On every step the engine publishes
``sentinel_slo_burn_rate{slo,window}`` and
``sentinel_slo_budget_remaining{slo}``; an alert transition journals
``slo.alert`` into the flight recorder and (for ``auto_bundle`` specs)
captures a post-mortem bundle — a budget-burn breach IS an incident, and
the black box should freeze the process that burned it.  Every engine
also registers the ``slo`` bundle provider, so ANY bundle (degrade
entry, invariant breach, ``GET /api/flight``) shows whether the fleet
was burning budget when it was captured.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs.registry import Histogram, MetricRegistry, REGISTRY


def _labels_match(series_labels: Tuple[Tuple[str, str], ...], want: Tuple) -> bool:
    if not want:
        return True
    have = dict(series_labels)
    return all(have.get(k) == v for k, v in want)


@dataclass(frozen=True)
class CounterSum:
    """Sum of every series under the named families (optional label
    subset filter) — the ratio-SLO event source."""

    names: Tuple[str, ...]
    labels: Tuple[Tuple[str, str], ...] = ()

    def read(self, registry: MetricRegistry) -> float:
        total = 0.0
        for name in self.names:
            for m in registry.series(name):
                if _labels_match(m.labels, self.labels):
                    total += float(m.value)
        return total


@dataclass(frozen=True)
class HistogramOver:
    """Latency-SLO event source: ``bad`` = observations above
    ``threshold_ms`` (bucket resolution), ``total`` = all observations,
    summed over every series of the named histogram."""

    name: str
    threshold_ms: float

    def read_bad_total(self, registry: MetricRegistry) -> Tuple[float, float]:
        bad = total = 0.0
        for m in registry.series(self.name):
            if isinstance(m, Histogram):
                bad += m.count_over(self.threshold_ms)
                total += m.count
        return bad, total


@dataclass(frozen=True)
class SloSpec:
    """One objective.  ``windows`` are ``(short_ms, long_ms, burn_thr)``
    pages: alert when some page's short AND long burn rates are both at
    or above its threshold; clear when every window burns below 1.0
    (budget-neutral)."""

    name: str
    objective: float  # target good fraction, e.g. 0.999
    bad: Optional[CounterSum] = None
    total: Optional[CounterSum] = None
    latency: Optional[HistogramOver] = None  # alternative to bad/total
    windows: Tuple[Tuple[int, int, float], ...] = (
        (5 * 60_000, 60 * 60_000, 14.4),  # fast burn: page in minutes
        (30 * 60_000, 6 * 3_600_000, 6.0),  # slow burn: page in hours
    )
    budget_window_ms: int = 3_600_000  # error-budget accounting horizon
    auto_bundle: bool = True  # capture a flight bundle on alert entry

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


@dataclass
class SloStatus:
    """One spec's judgement at a step (also the flight provider row)."""

    name: str
    burn: Dict[str, float] = field(default_factory=dict)  # window -> rate
    budget_remaining: float = 1.0
    alerting: bool = False
    fired: bool = False  # alert TRANSITION happened on this step

    def to_dict(self) -> dict:
        return {
            "burn": {k: round(v, 4) for k, v in self.burn.items()},
            "budget_remaining": round(self.budget_remaining, 4),
            "alerting": self.alerting,
        }


def default_slos(req_p99_ms: float = 10.0) -> Tuple[SloSpec, ...]:
    """The six stock objectives: request latency, shed ratio,
    fail-closed rate, the fleet's routing error budget, the online
    sketch-accuracy eps posture, and the memory ledger's capacity
    posture.  Totals are denominated in the device telemetry verdict
    counters (``sentinel_device_verdicts_total``) — the fleet's
    decisions as the DEVICE counted them — except the last two, which
    ride their own check counters (obs/profile.py).  The shard counters
    of ``fleet_error_budget`` wait for ``cluster/shard.py`` (A7b)."""
    verdicts = ("sentinel_device_verdicts_total",)
    return (
        SloSpec(
            "req_p99",
            objective=0.99,
            latency=HistogramOver("sentinel_tick_device_ms", req_p99_ms),
        ),
        SloSpec(
            "shed_ratio",
            objective=0.99,
            bad=CounterSum(("sentinel_shed_total",)),
            total=CounterSum(("sentinel_shed_total",) + verdicts),
        ),
        SloSpec(
            "fail_closed",
            objective=0.999,
            bad=CounterSum(
                (
                    "sentinel_resolve_failures_total",
                    "sentinel_watchdog_fired_total",
                    "sentinel_seg_dropped_total",
                )
            ),
            total=CounterSum(verdicts),
        ),
        SloSpec(
            "fleet_error_budget",
            objective=0.999,
            bad=CounterSum(
                (
                    "sentinel_shard_route_failures_total",
                    "sentinel_shard_fallback_total",
                )
            ),
            total=CounterSum(("sentinel_shard_requests_total",)),
        ),
        # online sketch-accuracy audit (obs/profile.SketchAudit): the
        # offline benchmark posture (within_eps ≈ 0.993) continuously — bad
        # events are estimates above the slack-adjusted exact bound plus
        # the CMS eps budget; underestimates alert through the chaos
        # invariant (must stay 0), not a ratio
        SloSpec(
            "sketch_eps",
            objective=0.99,
            bad=CounterSum(("sentinel_sketch_eps_violations_total",)),
            total=CounterSum(("sentinel_sketch_audit_checks_total",)),
        ),
        # HBM memory ledger capacity (obs/profile.MemoryLedger): every
        # ledger mutation while a capacity is configured is one check;
        # mutations that leave tracked bytes above capacity burn budget
        SloSpec(
            "hbm_capacity",
            objective=0.999,
            bad=CounterSum(("sentinel_hbm_capacity_breaches_total",)),
            total=CounterSum(("sentinel_hbm_capacity_checks_total",)),
        ),
    )


class SloEngine:
    """Burn-rate evaluator over one registry.  Call ``step(now_ms)`` on
    any cadence (the tick loop, a dashboard poller, a chaos scenario);
    engine time in, judgements out."""

    def __init__(
        self,
        specs: Optional[Tuple[SloSpec, ...]] = None,
        registry: MetricRegistry = REGISTRY,
        flight: Optional[FL.FlightRecorder] = None,
        gauge_registry: Optional[MetricRegistry] = None,
    ):
        self.specs = tuple(specs if specs is not None else default_slos())
        self.registry = registry
        self.flight = flight if flight is not None else FL.FLIGHT
        # snapshot ring per spec: (now_ms, bad, total), oldest first
        self._snaps: Dict[str, List[Tuple[int, float, float]]] = {
            s.name: [] for s in self.specs
        }
        self._alerting: Dict[str, bool] = {s.name: False for s in self.specs}
        self.last: Dict[str, SloStatus] = {}
        greg = gauge_registry or REGISTRY
        self._g_burn: Dict[Tuple[str, str], object] = {}
        self._g_budget = {
            s.name: greg.gauge(
                "sentinel_slo_budget_remaining",
                "fraction of the SLO error budget left over the budget window",
                labels={"slo": s.name},
            )
            for s in self.specs
        }
        self._c_alerts = {
            s.name: greg.counter(
                "sentinel_slo_alerts_total",
                "multi-window burn-rate alert transitions (entries)",
                labels={"slo": s.name},
            )
            for s in self.specs
        }
        self._greg = greg
        # the black box shows budget state in EVERY bundle from now on
        self.flight.register_provider("slo", self._provider)

    # -- reads ---------------------------------------------------------------

    def _read(self, spec: SloSpec) -> Tuple[float, float]:
        if spec.latency is not None:
            return spec.latency.read_bad_total(self.registry)
        bad = spec.bad.read(self.registry) if spec.bad else 0.0
        total = spec.total.read(self.registry) if spec.total else 0.0
        return bad, total

    def _burn_over(
        self, snaps, now_ms: int, bad: float, total: float, window_ms: int,
        budget: float,
    ) -> float:
        """Error-budget burn rate over the trailing window: the newest
        snapshot at least ``window_ms`` old anchors the delta (the oldest
        available when the ring is younger than the window — early
        samples judge what has been seen, they never block alerting)."""
        anchor = None
        for t, b, n in snaps:
            if now_ms - t >= window_ms:
                anchor = (t, b, n)
            else:
                break
        if anchor is None:
            anchor = snaps[0] if snaps else (now_ms, bad, total)
        d_bad = max(bad - anchor[1], 0.0)
        d_total = max(total - anchor[2], 0.0)
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / budget

    # -- evaluation ----------------------------------------------------------

    def step(self, now_ms: int) -> List[SloStatus]:
        out: List[SloStatus] = []
        for spec in self.specs:
            bad, total = self._read(spec)
            snaps = self._snaps[spec.name]
            status = SloStatus(name=spec.name)
            max_w = max(
                [w for page in spec.windows for w in page[:2]]
                + [spec.budget_window_ms]
            )
            page = False
            short_calm = True
            for short_ms, long_ms, thr in spec.windows:
                bs = self._burn_over(snaps, now_ms, bad, total, short_ms, spec.budget)
                bl = self._burn_over(snaps, now_ms, bad, total, long_ms, spec.budget)
                status.burn[f"{short_ms // 1000}s"] = bs
                status.burn[f"{long_ms // 1000}s"] = bl
                if bs >= thr and bl >= thr:
                    page = True
                if bs >= 1.0:
                    short_calm = False
            consumed = self._burn_over(
                snaps, now_ms, bad, total, spec.budget_window_ms, spec.budget
            )
            status.budget_remaining = max(0.0, min(1.0, 1.0 - consumed))
            was = self._alerting[spec.name]
            if page and not was:
                status.fired = True
                self._alerting[spec.name] = True
            elif was and not page and short_calm:
                # clear on calm SHORT windows (the long windows keep
                # burning for their whole span after a recovered incident
                # — holding the alert that long would mask the recovery)
                self._alerting[spec.name] = False
                self.flight.note("slo.alert.clear", slo=spec.name)
            status.alerting = self._alerting[spec.name]
            # publish the status BEFORE capturing any bundle so the
            # bundle's own `slo` provider section shows the alert that
            # caused it
            self.last[spec.name] = status
            if status.fired:
                self._c_alerts[spec.name].inc()
                self.flight.note(
                    "slo.alert",
                    slo=spec.name,
                    burn=round(max(status.burn.values(), default=0.0), 3),
                    budget_remaining=round(status.budget_remaining, 4),
                )
                if spec.auto_bundle:
                    self.flight.trigger(f"slo-burn-{spec.name}")
            for wname, rate in status.burn.items():
                g = self._g_burn.get((spec.name, wname))
                if g is None:
                    g = self._g_burn[(spec.name, wname)] = self._greg.gauge(
                        "sentinel_slo_burn_rate",
                        "error-budget burn rate (1.0 = exactly on budget)",
                        labels={"slo": spec.name, "window": wname},
                    )
                g.set(rate)
            self._g_budget[spec.name].set(status.budget_remaining)
            snaps.append((int(now_ms), bad, total))
            # prune beyond the widest window (keep one anchor past it)
            while len(snaps) > 2 and now_ms - snaps[1][0] >= max_w:
                snaps.pop(0)
            out.append(status)
        return out

    # -- flight provider -----------------------------------------------------

    def _provider(self) -> dict:
        return {name: st.to_dict() for name, st in self.last.items()}

    def close(self) -> None:
        """Detach from the flight recorder (tests; a replaced engine
        re-registers on construction anyway)."""
        self.flight.unregister_provider("slo", self._provider)
