"""Closed-loop LIVE autotuner over an SLO-burn-rate objective.

The tuning half of the workload plane: adaptive protection guards
serving and obs/profile measures it; this module turns those read-only
instruments into an actuator.  An ``AutoTuner`` owns a candidate grid of
``OperatingPoint``s (seeded exploration order — decisions replay
bit-identically) and walks it with a measure → move → settle → judge
loop:

* **objective** — the burn rate of one ``SloSpec`` (default the
  ``workload_latency`` spec over ``sentinel_workload_req_ms``), read
  through a real ``obs/slo.SloEngine`` on engine time.  Never raw dps:
  a point that wins throughput while burning latency budget loses.
* **HBM guardrail** — before applying a candidate the tuner projects the
  sketch-pool delta against ``obs/profile.LEDGER``'s configured
  capacity and REJECTS points that would tune into an OOM
  (``sentinel_tuner_retunes_total{outcome="rejected_hbm"}``; the
  capacity-breach counter must stay flat through every retune).
* **retrace guardrail** — every engine move goes through
  ``SentinelClient.apply_operating_point``, whose compiles run under
  ``obs/profile.expected_retrace``; a tuning session journals zero
  surprise retraces by construction (asserted by the chaos scenario).
* **fail-open** — a raising step (the ``workload.tuner.step`` failpoint
  or any internal error) rolls back to the LAST-GOOD operating point
  and touches nothing else: serving decisions continue uninterrupted,
  the failure is counted exactly
  (``sentinel_tuner_step_failures_total``).

``run_closed_loop`` wires generator + service backend + SLO engine +
tuner into the one loop bench/chaos/tests all drive.

The port's copy of ``sentinel_tpu/workload/tuner.py``, over the port's
client, ``obs/slo``, ``obs/profile`` and registry: on one spec, seed and
candidate set its decision journal, latencies and counts equal the
reference's.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.obs import profile as PROF
from sentinel_tpu_torch.obs.registry import REGISTRY
from sentinel_tpu_torch.obs.slo import CounterSum, HistogramOver, SloEngine, SloSpec
from sentinel_tpu_torch.workload.generator import (
    ServiceBackend,
    ServiceModel,
    TrafficGenerator,
    drive_client,
)
from sentinel_tpu_torch.workload.operating_point import OperatingPoint
from sentinel_tpu_torch.workload.shapes import WorkloadSpec

FP_TUNER_STEP = FP.register(
    "workload.tuner.step",
    "autotuner control step (a raise fails OPEN to the last-good point)",
    FP.HIT_ACTIONS,
)

_C_STEPS = REGISTRY.counter(
    "sentinel_tuner_steps_total", "autotuner control steps taken"
)
_C_STEP_FAILURES = REGISTRY.counter(
    "sentinel_tuner_step_failures_total",
    "tuner steps that raised and failed OPEN to the last-good point",
)
_C_RETUNES: Dict[str, object] = {}
_C_RETUNES_LOCK = threading.Lock()


def _c_retunes(outcome: str):
    c = _C_RETUNES.get(outcome)
    if c is None:
        with _C_RETUNES_LOCK:
            c = _C_RETUNES.get(outcome)
            if c is None:
                c = _C_RETUNES[outcome] = REGISTRY.counter(
                    "sentinel_tuner_retunes_total",
                    "live operating-point moves, by outcome "
                    "(applied|accepted|rollback|rejected_hbm)",
                    labels={"outcome": outcome},
                )
    return c


_G_OBJ_BURN = REGISTRY.gauge(
    "sentinel_tuner_objective_burn",
    "objective SLO burn rate at the tuner's last control step",
)


def workload_slos(
    req_ms: float = 60.0,
    short_ms: int = 300,
    long_ms: int = 1_500,
    burn_thr: float = 2.0,
    budget_window_ms: int = 4_000,
) -> Tuple[SloSpec, ...]:
    """The workload plane's objectives, sized for virtual-time runs a
    few engine-seconds long (the stock ``default_slos`` windows are
    production-scale minutes/hours): modeled request latency and the
    offered-stream shed ratio, plus the profiling plane's guard
    objectives the tuner must never burn — HBM capacity and
    sketch-accuracy eps."""
    return (
        SloSpec(
            "workload_latency",
            objective=0.95,
            latency=HistogramOver("sentinel_workload_req_ms", req_ms),
            windows=((short_ms, long_ms, burn_thr),),
            budget_window_ms=budget_window_ms,
            auto_bundle=False,
        ),
        SloSpec(
            "workload_shed",
            objective=0.95,
            bad=CounterSum(("sentinel_workload_blocked_total",)),
            total=CounterSum(
                (
                    "sentinel_workload_passed_total",
                    "sentinel_workload_blocked_total",
                )
            ),
            windows=((short_ms, long_ms, burn_thr),),
            budget_window_ms=budget_window_ms,
            auto_bundle=False,
        ),
        SloSpec(
            "hbm_capacity",
            objective=0.999,
            bad=CounterSum(("sentinel_hbm_capacity_breaches_total",)),
            total=CounterSum(("sentinel_hbm_capacity_checks_total",)),
            windows=((short_ms, long_ms, burn_thr),),
            budget_window_ms=budget_window_ms,
            auto_bundle=False,
        ),
        SloSpec(
            "sketch_eps",
            objective=0.99,
            bad=CounterSum(("sentinel_sketch_eps_violations_total",)),
            total=CounterSum(("sentinel_sketch_audit_checks_total",)),
            windows=((short_ms, long_ms, burn_thr),),
            budget_window_ms=budget_window_ms,
            auto_bundle=False,
        ),
    )


def _sketch_pool_bytes(cfg) -> int:
    """Formulaic sketch-pool HBM for a config (the ledger's sketch pool
    agrees within 10%), 0 when the sketch tier is off."""
    if not getattr(cfg, "sketch_stats", False):
        return 0
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.ops import gsketch as GS
    from sentinel_tpu_torch.sketch import salsa as SA

    scfg = E.sketch_config(cfg)
    if cfg.sketch_salsa:
        return SA.hbm_bytes(scfg)
    return 4 * scfg.sample_count * scfg.depth * scfg.width * GS.PLANES


@dataclass(frozen=True)
class TunerConfig:
    objective: str = "workload_latency"
    settle_steps: int = 4  # control steps a point serves before judgement
    warmup_steps: int = 1  # leading settle readings discarded: completions
    # draining right after a move were queued under the PREVIOUS point,
    # and judging them would misattribute its latency to the new one
    min_improvement: float = 0.02  # relative burn drop a move must earn
    max_moves: int = 8


class AutoTuner:
    """Deterministic candidate-walk tuner; see module docstring."""

    def __init__(
        self,
        client,
        slo: SloEngine,
        op0: OperatingPoint,
        candidates: Sequence[OperatingPoint],
        seed: int = 7,
        tcfg: Optional[TunerConfig] = None,
        backend: Optional[ServiceBackend] = None,
    ):
        self.client = client
        self.slo = slo
        self.tcfg = tcfg or TunerConfig()
        self.current = op0
        self.best = op0  # last-good: rollback / fail-open target
        self.best_burn: Optional[float] = None
        self.converged = False
        self.backend = backend
        #: ordered decision journal — the bit-replay surface
        self.decisions: List[dict] = []
        # seeded exploration order (the chaos plan derivation: one odd
        # multiplier keeps adjacent seeds on distinct orders)
        cands = [c for c in candidates if c != op0]
        random.Random((int(seed) * 0x9E3779B1) & 0xFFFFFFFF).shuffle(cands)
        self._pending: List[OperatingPoint] = cands
        self._since_move = 0
        self._burn_acc = 0.0
        self._burn_n = 0
        self._moves = 0

    # -- guardrails ----------------------------------------------------------

    def _hbm_ok(self, cand: OperatingPoint) -> bool:
        snap = PROF.LEDGER.snapshot()
        cap = int(snap.get("capacity_bytes") or 0)
        if cap <= 0:
            return True
        delta = _sketch_pool_bytes(
            cand.apply_to_config(self.client.cfg)
        ) - _sketch_pool_bytes(self.client.cfg)
        return PROF.LEDGER.total_bytes() + max(0, delta) <= cap

    # -- moves ---------------------------------------------------------------

    def _journal(self, now_ms: int, action: str, op: OperatingPoint, **kw):
        self.decisions.append(
            {"now_ms": int(now_ms), "action": action, "op": op.describe(), **kw}
        )

    def _apply(self, op: OperatingPoint, now_ms: int, outcome: str) -> None:
        self.client.apply_operating_point(op, cause=f"tuner-{outcome}")
        if self.backend is not None:
            self.backend.set_op(op)
        self.current = op
        _c_retunes(outcome).inc()
        self._journal(now_ms, outcome, op)
        self._since_move = 0
        self._burn_acc = 0.0
        self._burn_n = 0

    def _explore(self, now_ms: int) -> None:
        while self._pending and self._moves < self.tcfg.max_moves:
            cand = self._pending.pop(0)
            if cand == self.current:
                continue
            if not self._hbm_ok(cand):
                _c_retunes("rejected_hbm").inc()
                self._journal(now_ms, "rejected_hbm", cand)
                continue
            self._moves += 1
            self._apply(cand, now_ms, "applied")
            return
        # grid exhausted (or move budget spent): settle on the best
        if self.current != self.best:
            self._apply(self.best, now_ms, "rollback")
        if not self.converged:
            self.converged = True
            self._journal(
                now_ms, "converged", self.best,
                burn=round(self.best_burn or 0.0, 4),
            )

    # -- the control step ----------------------------------------------------

    def step(self, now_ms: int) -> Optional[dict]:
        """One control step: judge SLO burn, settle, move.  Any raise
        (the ``workload.tuner.step`` failpoint included) fails OPEN."""
        _C_STEPS.inc()
        try:
            FP.hit(FP_TUNER_STEP)  # chaos: a raise fails this step open
            return self._step_inner(now_ms)
        except Exception:
            _C_STEP_FAILURES.inc()
            if self.current != self.best:
                try:
                    self._apply(self.best, now_ms, "rollback")
                except Exception:
                    # even the rollback failing must not surface into
                    # the serving path; the next healthy step retries
                    pass
            self._journal(now_ms, "fail_open", self.best)
            return None

    def _step_inner(self, now_ms: int) -> Optional[dict]:
        statuses = self.slo.step(now_ms)
        burn = 0.0
        for st in statuses:
            if st.name == self.tcfg.objective:
                burn = min(st.burn.values()) if st.burn else 0.0
        _G_OBJ_BURN.set(burn)
        if self.converged:
            return None
        self._since_move += 1
        if self._since_move > self.tcfg.warmup_steps:
            self._burn_acc += burn
            self._burn_n += 1
        if self._since_move < self.tcfg.settle_steps:
            return None
        avg = self._burn_acc / max(1, self._burn_n)
        if self.current == self.best:
            # measuring the incumbent (initial baseline or post-rollback)
            if self.best_burn is None or avg < self.best_burn:
                self.best_burn = avg
            self._journal(now_ms, "measured", self.current, burn=round(avg, 4))
        elif self.best_burn is not None and self.best_burn - avg > max(
            1e-9, self.tcfg.min_improvement * self.best_burn
        ):
            # strict improvement only: a tie keeps the incumbent, so a
            # flat objective can never walk the point around for free
            self.best = self.current
            self.best_burn = avg
            _c_retunes("accepted").inc()
            self._journal(now_ms, "accepted", self.current, burn=round(avg, 4))
        else:
            self._journal(now_ms, "worse", self.current, burn=round(avg, 4))
            self._apply(self.best, now_ms, "rollback")
        self._explore(now_ms)
        return self.decisions[-1] if self.decisions else None


# -- the closed loop ---------------------------------------------------------


@dataclass
class LoopResult:
    submitted: int = 0
    passed: int = 0
    blocked: int = 0
    latencies_ms: List[float] = field(default_factory=list)
    req_ms: float = 0.0  # the objective's latency threshold
    objective_burn: float = 0.0  # long-window burn at loop end
    budget_consumed: float = 0.0  # 1 - budget_remaining at loop end
    decisions: List[dict] = field(default_factory=list)
    converged_op: Optional[OperatingPoint] = None

    def p99_ms(self) -> float:
        if not self.latencies_ms:
            return 0.0
        xs = sorted(self.latencies_ms)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    def bad_frac(self) -> float:
        """Whole-run SLO-bad fraction (latencies over the objective
        threshold) — the saturation-proof static-vs-converged comparison
        surface: window burns clip once the budget is gone, this
        doesn't."""
        if not self.latencies_ms:
            return 0.0
        bad = sum(1 for x in self.latencies_ms if x > self.req_ms)
        return bad / len(self.latencies_ms)


def run_closed_loop(
    client,
    spec: WorkloadSpec,
    op: OperatingPoint,
    candidates: Sequence[OperatingPoint] = (),
    tune: bool = True,
    tune_every: int = 5,
    model: Optional[ServiceModel] = None,
    tcfg: Optional[TunerConfig] = None,
    slo_specs: Optional[Tuple[SloSpec, ...]] = None,
    req_ms: float = 60.0,
) -> LoopResult:
    """Generator → real client decisions → service model → SLO engine
    [→ tuner] on the client's clock.  ``tune=False`` is the static
    control run the bench row compares against."""
    gen = TrafficGenerator(spec, start_ms=client.time.now_ms())
    svc = model or ServiceModel(step_ms=spec.step_ms)
    backend = ServiceBackend(svc, op)
    slo = SloEngine(
        specs=slo_specs or workload_slos(req_ms=req_ms), registry=REGISTRY
    )
    tuner = (
        AutoTuner(
            client,
            slo,
            op,
            candidates,
            seed=spec.seed,
            tcfg=tcfg,
            backend=backend,
        )
        if tune
        else None
    )
    slo.step(client.time.now_ms())  # anchor the burn windows pre-traffic

    def on_step(step: int, _n: int) -> None:
        if step % tune_every:
            return
        now = client.time.now_ms()
        if tuner is not None:
            tuner.step(now)
        else:
            slo.step(now)

    drive = drive_client(client, gen, backend=backend, on_step=on_step)
    final = slo.step(client.time.now_ms())
    out = LoopResult(
        submitted=drive.submitted,
        passed=drive.passed,
        blocked=drive.blocked,
        latencies_ms=drive.latencies_ms,
        req_ms=req_ms,
        decisions=list(tuner.decisions) if tuner else [],
        converged_op=tuner.best if tuner else op,
    )
    objective = (tcfg or TunerConfig()).objective
    for st in final:
        if st.name == objective:
            out.objective_burn = min(st.burn.values()) if st.burn else 0.0
            out.budget_consumed = 1.0 - st.budget_remaining
    slo.close()
    return out
