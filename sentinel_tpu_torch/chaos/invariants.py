"""Safety invariants evaluated over a chaos run.

The port's copy of ``sentinel_tpu/chaos/invariants.py``: the fourteen
monitors read the port's ``obs.REGISTRY``, the port's client and the
port's lock witness, and a RED verdict triggers the port's ``FLIGHT``.

Each invariant is a small pure check over a ``ScenarioContext`` — the
counts the scenario gathered, deltas of ``obs.REGISTRY`` metrics across
the run (the registry is process-global and cumulative, so monitors
always diff a before/after snapshot), and the driven client's state.
A scenario names the invariants it must keep green; the runner evaluates
them after the faults and reports one verdict per invariant.

The catalog (the reference's README "Chaos & fault injection" documents each):

  verdict-accounting   passed + blocked + degraded == submitted — no
                       request vanishes, none is double-decided
  no-degraded-pass     zero PASS verdicts produced BY a degraded/failed
                       cluster decision (STATUS_FAIL may fall back to
                       local enforcement, never map to OK)
  degrade-hysteresis   degrade enter/exit transitions pair up and the
                       live gauge equals enters - exits ∈ {0, 1}
  token-conservation   every token request returned exactly one result;
                       failures equal the injected fault count
  no-chunk-replay      the shard host processed every chunk at most once
                       (answered + degraded == chunks submitted)
  pipeline-drained     the client's tick pipeline is empty at rest:
                       occupancy and resolver-queue gauges at 0, no
                       pending ticks
  no-stranded-futures  every future the scenario submitted is resolved
  seg-drops-counted    fail-closed segment-overflow drops surfaced on
                       the seg-drop counter (and only when expected)
  rules-intact         the rule set survived the datasource fault window
                       unchanged, then applied the post-heal update
  metric-deltas        named registry series moved exactly as expected
                       (e.g. the labeled RPC failure KIND that fired)
  injected-as-planned  observed injected-event counts equal the
                       scenario's expectation (the determinism anchor)
  shard-degrade-hysteresis
                       per-SHARD failover transitions pair up (the fleet
                       analog of degrade-hysteresis): for every shard the
                       scenario names, enter/exit counts match the
                       expectation and the live per-shard gauge equals
                       enters - exits ∈ {0, 1}
  ladder-monotone      degrade-ladder transitions move one rung at a time
                       (monotone steps within the hysteresis holds), the
                       run climbed when the scenario expected it to, and
                       goodput never hit zero while the ladder sat below
                       FAIL_CLOSED
  no-order-violations  the runtime lock witness recorded zero lock-order
                       inversions and no dynamic held→acquired edge the
                       static tier-3 graph missed (trivially green when
                       the witness is not installed)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from sentinel_tpu_torch.obs.registry import REGISTRY


class MetricsDelta:
    """Before/after diff over REGISTRY's scalar series (counters/gauges
    by `name{labels}` key, histograms by their count)."""

    def __init__(self):
        self._before = self._flatten()

    @staticmethod
    def _flatten() -> Dict[str, float]:
        out: Dict[str, float] = {}
        for key, v in REGISTRY.snapshot().items():
            out[key] = float(v["count"]) if isinstance(v, dict) else float(v)
        return out

    def delta(self, key: str) -> float:
        """Change of one series since construction (0.0 if never seen)."""
        now = self._flatten()
        return now.get(key, 0.0) - self._before.get(key, 0.0)

    def deltas(self, keys) -> Dict[str, float]:
        """Changes for many series off ONE registry snapshot — checks
        over several keys must not re-walk every histogram per key."""
        now = self._flatten()
        return {
            k: now.get(k, 0.0) - self._before.get(k, 0.0) for k in keys
        }

    @staticmethod
    def value(key: str) -> float:
        """Current absolute value (gauges)."""
        now = MetricsDelta._flatten()
        return now.get(key, 0.0)


@dataclass
class ScenarioContext:
    """Everything the invariant checks read.  Scenarios fill the counts
    they can attest to; unused fields stay at their neutral defaults."""

    metrics: MetricsDelta
    client: Optional[object] = None  # the driven SentinelClient
    submitted: int = 0
    passed: int = 0
    blocked: int = 0
    degraded: int = 0  # items decided by an explicit degrade path
    degraded_passes: int = 0  # PASS produced BY a failed cluster decision
    futures: list = field(default_factory=list)
    injected: Dict[str, int] = field(default_factory=dict)  # observed
    expect_injected: Dict[str, int] = field(default_factory=dict)
    extra: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Verdict:
    name: str
    ok: bool
    detail: str = ""


def _v(name: str, ok: bool, detail: str = "") -> Verdict:
    return Verdict(name, bool(ok), detail)


# -- checks ------------------------------------------------------------------


def verdict_accounting(ctx: ScenarioContext) -> Verdict:
    total = ctx.passed + ctx.blocked + ctx.degraded
    return _v(
        "verdict-accounting",
        total == ctx.submitted,
        f"submitted={ctx.submitted} passed={ctx.passed} "
        f"blocked={ctx.blocked} degraded={ctx.degraded}",
    )


def no_degraded_pass(ctx: ScenarioContext) -> Verdict:
    return _v(
        "no-degraded-pass",
        ctx.degraded_passes == 0,
        f"degraded_passes={ctx.degraded_passes}",
    )


def degrade_hysteresis(ctx: ScenarioContext) -> Verdict:
    enters = ctx.metrics.delta(
        'sentinel_cluster_degrade_transitions_total{transition="enter"}'
    )
    exits = ctx.metrics.delta(
        'sentinel_cluster_degrade_transitions_total{transition="exit"}'
    )
    gauge = MetricsDelta.value("sentinel_cluster_degraded")
    open_ = enters - exits
    ok = open_ in (0.0, 1.0) and gauge == open_
    want = ctx.extra.get("expect_degrade_enters")
    if want is not None:
        ok = ok and enters == want and exits == want
    return _v(
        "degrade-hysteresis",
        ok,
        f"enters={enters:g} exits={exits:g} gauge={gauge:g}",
    )


def shard_degrade_hysteresis(ctx: ScenarioContext) -> Verdict:
    """Fleet failover discipline: ``extra["expect_shard_transitions"]``
    maps shard name → expected (enters, exits) over the run; every named
    shard must also leave its ``sentinel_shard_degraded`` gauge equal to
    the open transition count (0 or 1)."""
    want: Dict[str, tuple] = ctx.extra.get("expect_shard_transitions", {})
    bad = []
    k_enter = {
        name: f'sentinel_shard_degrade_transitions_total{{shard="{name}",transition="enter"}}'
        for name in want
    }
    k_exit = {
        name: f'sentinel_shard_degrade_transitions_total{{shard="{name}",transition="exit"}}'
        for name in want
    }
    # ONE registry walk for every shard's pair (deltas contract), plus
    # one for the gauges, instead of 3 full walks per shard
    d = ctx.metrics.deltas(list(k_enter.values()) + list(k_exit.values()))
    now = MetricsDelta._flatten()
    for name, (w_enter, w_exit) in want.items():
        enters = d[k_enter[name]]
        exits = d[k_exit[name]]
        gauge = now.get(f'sentinel_shard_degraded{{shard="{name}"}}', 0.0)
        open_ = enters - exits
        if not (
            enters == w_enter
            and exits == w_exit
            and open_ in (0.0, 1.0)
            and gauge == open_
        ):
            bad.append(
                f"{name}: enters={enters:g}/{w_enter} exits={exits:g}/{w_exit} "
                f"gauge={gauge:g}"
            )
    return _v(
        "shard-degrade-hysteresis",
        not bad,
        "; ".join(bad) or f"{len(want)} shards paired",
    )


def token_conservation(ctx: ScenarioContext) -> Verdict:
    c = ctx.extra.get("token_counts", {})
    requests = c.get("requests", 0)
    resolved = sum(v for k, v in c.items() if k != "requests")
    want_failed = ctx.extra.get("expect_token_failures")
    ok = requests == resolved
    if want_failed is not None:
        ok = ok and c.get("failed", 0) == want_failed
    return _v("token-conservation", ok, f"{c}")


def no_chunk_replay(ctx: ScenarioContext) -> Verdict:
    processed = ctx.extra.get("server_chunks_processed", 0)
    written = ctx.extra.get("chunks_written", 0)
    answered = ctx.metrics.delta("sentinel_shard_chunks_total")
    degr = ctx.metrics.delta("sentinel_shard_chunks_degraded_total")
    ok = processed <= written and answered + degr == written
    return _v(
        "no-chunk-replay",
        ok,
        f"written={written} server_processed={processed} "
        f"answered={answered:g} degraded={degr:g}",
    )


def pipeline_drained(ctx: ScenarioContext) -> Verdict:
    occ = MetricsDelta.value("sentinel_pipeline_occupancy")
    rq = MetricsDelta.value("sentinel_resolver_queue_depth")
    pend = len(ctx.client._pending_ticks) if ctx.client is not None else 0
    return _v(
        "pipeline-drained",
        occ == 0.0 and rq == 0.0 and pend == 0,
        f"occupancy={occ:g} resolver_q={rq:g} pending_ticks={pend}",
    )


def no_stranded_futures(ctx: ScenarioContext) -> Verdict:
    stranded = sum(1 for f in ctx.futures if f is not None and not f.done())
    return _v(
        "no-stranded-futures",
        stranded == 0,
        f"{stranded}/{len(ctx.futures)} unresolved",
    )


def seg_drops_counted(ctx: ScenarioContext) -> Verdict:
    drops = ctx.metrics.delta("sentinel_seg_dropped_total")
    expect = ctx.extra.get("expect_seg_drops", True)
    ok = drops > 0 if expect else drops == 0
    return _v("seg-drops-counted", ok, f"drops={drops:g} expected={expect}")


def rules_intact(ctx: ScenarioContext) -> Verdict:
    ok = bool(ctx.extra.get("rules_intact_during_fault")) and bool(
        ctx.extra.get("rules_updated_after_heal")
    )
    return _v(
        "rules-intact",
        ok,
        f"during_fault={ctx.extra.get('rules_intact_during_fault')} "
        f"after_heal={ctx.extra.get('rules_updated_after_heal')}",
    )


def metric_deltas(ctx: ScenarioContext) -> Verdict:
    """Exact expected movement of named registry series over the run —
    the scenario's way of asserting WHICH counter (e.g. which labeled
    failure kind) recorded the injected fault."""
    want: Dict[str, float] = ctx.extra.get("expect_metric_deltas", {})
    got = ctx.metrics.deltas(want)
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    return _v(
        "metric-deltas",
        not bad,
        "; ".join(f"{k}: got {g:g}, want {w:g}" for k, (g, w) in bad.items())
        or f"{len(want)} series as expected",
    )


def ladder_monotone(ctx: ScenarioContext) -> Verdict:
    """Degrade-ladder discipline over one run:
    ``extra["ladder_transitions"]`` is the controller's ordered
    ``(now_ms, from, to)`` list.  Every move must be exactly one rung
    (the shared hysteresis makes jumps impossible — a jump means a
    second transition path snuck in); a climb must have happened iff
    ``extra["expect_ladder_climb"]``; and ``extra["goodput_floor"]``
    (min rolling-window goodput while below FAIL_CLOSED) must stay
    positive — protection that zeroes goodput before fail-closed is
    just an outage with extra steps."""
    trans = ctx.extra.get("ladder_transitions", [])
    jumps = [t for t in trans if abs(t[2] - t[1]) != 1]
    climbed = any(t[2] > t[1] for t in trans)
    want_climb = ctx.extra.get("expect_ladder_climb", True)
    floor = ctx.extra.get("goodput_floor")
    ok = (
        not jumps
        and climbed == bool(want_climb)
        and (floor is None or floor > 0)
    )
    return _v(
        "ladder-monotone",
        ok,
        f"transitions={[(t[1], t[2]) for t in trans]} jumps={len(jumps)} "
        f"climbed={climbed} goodput_floor={floor}",
    )


def injected_as_planned(ctx: ScenarioContext) -> Verdict:
    return _v(
        "injected-as-planned",
        ctx.injected == ctx.expect_injected,
        f"observed={ctx.injected} expected={ctx.expect_injected}",
    )


def no_order_violations(ctx: ScenarioContext) -> Verdict:
    """The runtime lock witness (analysis/concurrency/witness.py) saw no
    lock-order inversion and no dynamic held→acquired edge the static
    tier-3 graph missed.  Trivially green when the witness was never
    installed — scenarios run unwitnessed by default; the witness matrix
    turns it on."""
    from sentinel_tpu_torch.analysis.concurrency import witness as W

    ok, detail = W.verdict()
    return _v("no-order-violations", ok, detail)


#: name -> check; scenarios select by name, README documents each
CATALOG: Dict[str, Callable[[ScenarioContext], Verdict]] = {
    "verdict-accounting": verdict_accounting,
    "no-degraded-pass": no_degraded_pass,
    "degrade-hysteresis": degrade_hysteresis,
    "shard-degrade-hysteresis": shard_degrade_hysteresis,
    "token-conservation": token_conservation,
    "no-chunk-replay": no_chunk_replay,
    "pipeline-drained": pipeline_drained,
    "no-stranded-futures": no_stranded_futures,
    "seg-drops-counted": seg_drops_counted,
    "rules-intact": rules_intact,
    "metric-deltas": metric_deltas,
    "ladder-monotone": ladder_monotone,
    "injected-as-planned": injected_as_planned,
    "no-order-violations": no_order_violations,
}


def evaluate(names: List[str], ctx: ScenarioContext) -> List[Verdict]:
    """Run the named invariants in order; unknown names fail loudly (a
    scenario typo must not silently skip a safety check).  Any RED
    verdict triggers a flight-recorder bundle (obs/flight.py) so the
    state that produced the breach survives for post-mortem.

    ``no-order-violations`` is UNIVERSAL: every scenario evaluates it
    whether it names it or not (appended here, deterministically — the
    check reads the witness ledger, never the seed), because a lock
    acquired against the blessed order during ANY fault window is a
    latent deadlock regardless of what the scenario was probing."""
    out: List[Verdict] = []
    if "no-order-violations" not in names:
        names = list(names) + ["no-order-violations"]
    for n in names:
        chk = CATALOG.get(n)
        if chk is None:
            out.append(_v(n, False, "unknown invariant"))
            continue
        try:
            out.append(chk(ctx))
        except Exception as e:  # noqa: BLE001 — a crashed monitor is a RED verdict, never a skipped one
            out.append(_v(n, False, f"monitor crashed: {type(e).__name__}: {e}"))
    breached = [v.name for v in out if not v.ok]
    if breached:
        from sentinel_tpu_torch.obs.flight import FLIGHT

        FLIGHT.note("invariant.breach", invariants=breached)
        FLIGHT.trigger("invariant-breach")
    return out
