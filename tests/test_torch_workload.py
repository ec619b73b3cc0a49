"""sentinel_tpu_torch.workload and the client's live operating-point swap,
against the JAX package's.

* the offered half: ``TrafficGenerator(spec).all_events()`` equals the
  reference's event for event for three shapes and two seeds; the shapes'
  arithmetic, the emit failpoint, ``ServiceModel`` and ``ServiceBackend``
  equal the reference's on the same inputs;
* ``apply_operating_point`` (return values as tests/test_workload.py's),
  the tuner failing open and refusing a point that would breach the
  memory ledger's capacity, with decision journals equal to the
  reference's;
* the live swap with ticks in flight (a sync client on virtual time,
  ``platform_config()`` at small widths, ``pipeline_depth=2``): two ticks
  dispatched, the swap from batch 64 to 16 and back, then the same
  stream; verdicts, state and the packed-wire readback equal the
  reference's tick by tick.  And a swap made INSIDE the tick loop (a
  future's callback) takes the new batch size at the loop's next tick;
* the slice as a whole: ``run_closed_loop`` on both packages' sync
  clients under ``platform_config()`` at small widths with the
  reference's candidates — decision journals, latency sequences and
  submitted / passed / blocked counts equal, the retrace journal equal,
  no surprise retrace; and a tuned run replays bit-identically.

The JAX client runs ``platform_config()``'s host path (count clamp,
narrow uploads, presort) with its jitted plain tick
(``tests/torch_harness.jax_host_client``): the same verdicts and state,
compiled in seconds.  Tolerances: integers and strings equal; float state
leaves within rtol 1e-6 / atol 1e-4 (tests/test_torch_stats.py).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu import workload as JWL
from sentinel_tpu.chaos import failpoints as JFP
from sentinel_tpu.chaos.plans import FaultPlan as JPlan
from sentinel_tpu.chaos.plans import FaultSpec as JSpec
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs import profile as JPROF
from sentinel_tpu.obs.registry import REGISTRY as JREG
from sentinel_tpu.obs.slo import SloEngine as JSlo
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

import sentinel_tpu_torch as st
from sentinel_tpu_torch import workload as WL
from sentinel_tpu_torch.chaos import failpoints as TFP
from sentinel_tpu_torch.chaos.plans import FaultPlan as TPlan
from sentinel_tpu_torch.chaos.plans import FaultSpec as TSpec
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core.config import platform_config, small_engine_config
from sentinel_tpu_torch.obs import profile as PROF
from sentinel_tpu_torch.obs.registry import REGISTRY
from sentinel_tpu_torch.obs.slo import SloEngine
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.test_torch_stats import _assert_state_matches
from tests.torch_harness import jax_host_client

#: the small config's widths (small_engine_config) under platform_config()'s flags
SMALL = dict(max_resources=64, max_nodes=128, max_flow_rules=64, max_degrade_rules=32, max_param_rules=8,
             batch_size=64, complete_batch_size=64, param_width=512)
#: what platform_config() turns on, for the JAX client's host path
PLATFORM_FLAGS = dict(use_mxu_tables=True, fused_effects=True, seg_effects=True, seg_fallback=True)


def _cval(reg, name, labels=None):
    m = reg.get(name, labels)
    return float(m.value) if m is not None else 0.0


def _pair(monkeypatch, **kw):
    """A started JAX client (platform flags, plain tick) and a started port
    client (platform_config()), both sync at small widths on virtual time
    1,000."""
    jc = jax_host_client(monkeypatch, jax_small_cfg(**PLATFORM_FLAGS), JVT(1_000))
    tc = SentinelClient(cfg=platform_config(**SMALL), time_source=VirtualTimeSource(1_000), mode="sync",
                        device="cpu", **kw)
    if "pipeline_depth" in kw:
        jc._pipeline_depth = kw["pipeline_depth"]
    jc.start()
    tc.start()
    return jc, tc


# -- shapes and the generator ------------------------------------------------------


SPECS = {
    "flash_crowd_2x": lambda m, seed: m.flash_crowd_2x(seed=seed, base=3.0, steps=60, start_step=10),
    "diurnal_churn": lambda m, seed: m.WorkloadSpec(
        seed=seed, steps=80, shapes=(m.Diurnal(base=5.0, amplitude=0.6, period_steps=40),),
        keys=m.ZipfKeys(n_keys=24, alpha=1.3, churn_every_steps=15, churn_shift=5)),
    "param_flood": lambda m, seed: m.WorkloadSpec(
        seed=seed, steps=50, shapes=(m.Constant(rate=2.5, name="base"),
                                     m.HotParamFlood(rate=7.0, start_step=10, duration_steps=20)),
        keys=m.SkewedKeys(keys=(("wl/hot", 0.7), ("wl/warm", 0.2), ("wl/cold", 0.1)))),
}


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("shape", sorted(SPECS))
def test_the_offered_stream_equals_the_reference(shape, seed):
    t = WL.TrafficGenerator(SPECS[shape](WL, seed), start_ms=1_000).all_events()
    j = JWL.TrafficGenerator(SPECS[shape](JWL, seed), start_ms=1_000).all_events()
    assert [tuple(e) for e in t] == [tuple(e) for e in j] and len(t) > 0
    if shape == "flash_crowd_2x":  # error diffusion: counts are the cumulative rate's floor
        spec = SPECS[shape](WL, seed)
        for s in spec.shapes:
            assert sum(1 for ev in t if ev.shape == s.name) == math.floor(sum(s.rate_at(i) for i in range(spec.steps)))


def test_shape_arithmetic_and_key_mixes_equal_the_reference():
    def rates(m):
        fc = m.FlashCrowd(peak=8.0, start_step=10, ramp_steps=4, hold_steps=6, decay_steps=2)
        d = m.Diurnal(base=4.0, amplitude=0.5, period_steps=8)
        hp = m.HotParamFlood(rate=5.0, start_step=2, duration_steps=3, key="wl/t")
        z = m.ZipfKeys(n_keys=8, churn_every_steps=10, churn_shift=3, prefix="k")
        sk = m.SkewedKeys(keys=(("hot", 0.9), ("cold", 0.1)))
        return ([fc.rate_at(s) for s in range(25)], [d.rate_at(s) for s in range(16)],
                [hp.rate_at(s) for s in range(6)], hp.keys.key_for(0, 0.3, hp.keys._cdf()),
                [z.key_for(s, u, z._cdf()) for s in (0, 10, 20) for u in (0.0, 0.5, 0.99)],
                [sk.key_for(0, u, sk._cdf()) for u in (0.5, 0.95)])

    got = rates(WL)
    assert got == rates(JWL)
    assert got[0][10] == pytest.approx(2.0) and got[0][14] == 8.0 and got[0][22] == 0.0
    assert got[2] == [0.0, 0.0, 5.0, 5.0, 5.0, 0.0] and got[3] == "wl/t"
    assert got[4][0] == "k0" and got[4][3] == "k3" and got[4][6] == "k6"


def test_gen_emit_failpoint_drops_steps_exactly():
    def run(m, FP, Plan, Spec, reg):
        spec = m.flash_crowd_2x(seed=5, base=2.0, steps=30, start_step=8)
        baseline = m.TrafficGenerator(spec).all_events()
        drops0 = _cval(reg, "sentinel_workload_emit_drops_total")
        plan = Plan(seed=3, faults=[Spec("workload.gen.emit", "raise", every_nth=7, max_fires=2, exc="RuntimeError")])
        with FP.armed(plan) as armed:
            got = m.TrafficGenerator(spec).all_events()
        dropped = {ev.step for ev in baseline} - {ev.step for ev in got}
        return (armed.injected(), _cval(reg, "sentinel_workload_emit_drops_total") - drops0,
                [tuple(e) for e in got], [tuple(e) for e in baseline if e.step not in dropped], len(baseline))

    t = run(WL, TFP, TPlan, TSpec, REGISTRY)
    assert t == run(JWL, JFP, JPlan, JSpec, JREG)
    injected, drops, got, survivors, n = t
    assert injected == {"workload.gen.emit:raise": 2} and drops == 2.0
    assert got == survivors and 0 < len(got) < n


def test_service_model_and_backend_equal_the_reference():
    def run(m):
        model = m.ServiceModel()
        ops = [m.OperatingPoint(batch_size=b, complete_batch_size=b, pipeline_depth=p, audit_period=a,
                                sketch_sample_count=sc, sketch_slack_frac=sf)
               for b, p, a, sc, sf in ((2, 0, 16, 0, 0.05), (16, 2, 4, 60, 0.1), (64, 4, 64, 60, 0.0),
                                       (512, 1, 16, 8, 0.25))]
        costs = [(model.tick_us(op), model.ticks_per_step(op), model.extra_wait_ms(op)) for op in ops]
        b = m.ServiceBackend(m.ServiceModel(flush_steps=3), m.OperatingPoint(batch_size=4, complete_batch_size=4))
        rng = np.random.default_rng(3)
        trace = []
        for step in range(40):
            for rid in rng.integers(0, 9, int(rng.integers(0, 7))).tolist():
                b.submit(step, rid)
            if step == 20:
                b.set_op(m.OperatingPoint(batch_size=2, complete_batch_size=2, pipeline_depth=2))
            trace.append((b.advance(step), b.depth()))
        return costs, trace

    got = run(WL)
    assert got == run(JWL)
    costs, trace = got
    assert costs[0][0] < costs[1][0] < costs[2][0]
    assert sum(len(d) for d, _ in trace) > 0


# -- apply_operating_point and the tuner -------------------------------------------------


def _plain_pair():
    jc = JaxClient(cfg=jax_small_cfg(), time_source=JVT(1_000), mode="sync")
    tc = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    jc.start()
    tc.start()
    return jc, tc


def test_apply_operating_point_live_swap():
    jc, tc = _plain_pair()
    try:
        outs = []
        for c, m, P in ((jc, JWL, JPROF), (tc, WL, PROF)):
            surprise0 = P.RETRACE.surprise_count()
            op0 = m.OperatingPoint.from_engine_config(c.cfg)
            got = [c.apply_operating_point(op0), c.apply_operating_point(op0.replace(pipeline_depth=2)),
                   c.apply_operating_point(op0.replace(batch_size=16, complete_batch_size=16, pipeline_depth=2))]
            got.append((c.cfg.batch_size, c.cfg.complete_batch_size, c._pipeline_depth))
            got.append([tuple(map(int, v)) for v in c.check_batch(["wl/after-swap"] * 3, inbound=True)])
            got.append(P.RETRACE.surprise_count() - surprise0)
            outs.append(got)
        assert outs[1] == outs[0]
        assert outs[1][:3] == [{"engine": False, "host": []}, {"engine": False, "host": ["pipeline_depth"]},
                               {"engine": True, "host": []}]
        assert outs[1][3] == (16, 16, 2) and len(outs[1][4]) == 3 and outs[1][5] == 0
    finally:
        jc.stop()
        tc.stop()


def _fail_open(c, m, P, FP, Plan, Spec, Slo, reg):
    slo = Slo(specs=m.workload_slos(), registry=reg)
    try:
        op0 = m.OperatingPoint.from_engine_config(c.cfg)
        cand = op0.replace(batch_size=16, complete_batch_size=16)
        t = m.AutoTuner(c, slo, op0, [cand], seed=3, tcfg=m.TunerConfig(settle_steps=1, warmup_steps=0))
        fails0 = _cval(reg, "sentinel_tuner_step_failures_total")
        t.step(c.time.now_ms())
        moved = (t.current == cand, t.best == op0)
        plan = Plan(seed=1, faults=[Spec("workload.tuner.step", "raise", max_fires=1, exc="RuntimeError")])
        with FP.armed(plan) as armed:
            t.step(c.time.now_ms())
        after = len(c.check_batch(["wl/post-fail"] * 2, inbound=True))
        return (moved, armed.injected(), _cval(reg, "sentinel_tuner_step_failures_total") - fails0,
                t.current == op0 and t.best == op0, c.cfg.batch_size, t.decisions, after)
    finally:
        slo.close()


def test_tuner_step_fail_open_rolls_back_to_last_good():
    jc, tc = _plain_pair()
    try:
        j = _fail_open(jc, JWL, JPROF, JFP, JPlan, JSpec, JSlo, JREG)
        t = _fail_open(tc, WL, PROF, TFP, TPlan, TSpec, SloEngine, REGISTRY)
    finally:
        jc.stop()
        tc.stop()
    assert t == j
    moved, injected, fails, back, bs, decisions, after = t
    assert moved == (True, True) and injected == {"workload.tuner.step:raise": 1} and fails == 1.0
    assert back and bs == 64 and decisions[-1]["action"] == "fail_open" and after == 2


def test_tuner_rejects_a_candidate_that_would_breach_the_ledgers_capacity():
    c = SentinelClient(cfg=small_engine_config(sketch_stats=True), time_source=VirtualTimeSource(1_000), mode="sync",
                       device="cpu")
    c.start()
    slo = SloEngine(specs=WL.workload_slos(), registry=REGISTRY)
    cap0 = int(PROF.LEDGER.snapshot().get("capacity_bytes") or 0)
    PROF.LEDGER.set_capacity(PROF.LEDGER.total_bytes() + 1)
    try:
        op0 = WL.OperatingPoint.from_engine_config(c.cfg)
        grown = op0.replace(sketch_sample_count=max(8, op0.sketch_sample_count) * 8)
        t = WL.AutoTuner(c, slo, op0, [grown], seed=3, tcfg=WL.TunerConfig(settle_steps=1, warmup_steps=0))
        breach0 = _cval(REGISTRY, "sentinel_hbm_capacity_breaches_total")
        t.step(c.time.now_ms())
        acts = [d["action"] for d in t.decisions]
        assert "rejected_hbm" in acts and "converged" in acts
        assert t.current == op0 and t.best == op0 and t.converged
        assert c.cfg.sketch_sample_count == op0.sketch_sample_count
        assert _cval(REGISTRY, "sentinel_hbm_capacity_breaches_total") == breach0
    finally:
        PROF.LEDGER.set_capacity(cap0)
        slo.close()
        c.stop()


# -- the live swap with ticks in flight ----------------------------------------------------


NAMES = [f"r{i}" for i in range(8)]


def _rules(c, m):
    c.flow_rules.load([m.FlowRule(resource="r0", count=40), m.FlowRule(resource="r1", count=6)])


def _queue(c, names):
    """Queue acquires without ticking (a sync client ticks on submit)."""
    c.mode = "threaded"
    futs = [c.submit_acquire(n, inbound=True) for n in names]
    c.mode = "sync"
    return futs


def _dispatch(c, n):
    """Dispatch ONE tick of the next ``n`` queued acquires; its wire is in
    flight until _resolve_tick."""
    acq, c._acquires = c._acquires[:n], c._acquires[n:]
    return c._run_tick(acq, None, c.time.now_ms())


def _wire(p) -> list:
    """A resolved tick's packed wire, as host integers."""
    w = p.out.wire
    return np.asarray(w.cpu() if hasattr(w, "cpu") else w).tolist()


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    return [NAMES[i] for i in np.minimum(rng.zipf(1.4, n) - 1, len(NAMES) - 1)]


def _inflight_run(c, m, op_cls):
    """Two ticks in flight at batch 64, the swap to 16, a tick at 16, the
    three resolved in order; the swap back to 64 with a tick in flight;
    then the same stream through the loop.  Returns the swaps' answers,
    the verdicts, the replayed stream's verdicts, every tick's wire words
    and the final shape; the caller compares the state."""
    _rules(c, m)
    op0 = op_cls.from_engine_config(c.cfg).replace(pipeline_depth=2)
    op16 = op0.replace(batch_size=16, complete_batch_size=16)
    ticks = []
    s1 = _stream(1, 150)
    futs = _queue(c, s1)
    p1 = _dispatch(c, 64)
    c.time.advance(3)
    p2 = _dispatch(c, 64)
    applied = [c.apply_operating_point(op16)]
    c.time.advance(3)
    p3 = _dispatch(c, 16)
    for p in (p1, p2, p3):
        c._resolve_tick(p)
        ticks.append(_wire(p))
    p4 = _dispatch(c, 6)  # the rest at 16's light shape, in flight over the swap back
    applied.append(c.apply_operating_point(op0))
    c._resolve_tick(p4)
    ticks.append(_wire(p4))
    verdicts = [tuple(map(int, f.result(timeout=5))) for f in futs]
    c.time.advance(250)
    again = [tuple(map(int, v)) for v in c.check_batch(s1, inbound=True)]
    return applied, verdicts, again, ticks, (c.cfg.batch_size, c.cfg.complete_batch_size, c._pipeline_depth)


def test_a_swap_with_ticks_in_flight_equals_the_reference_tick_by_tick(monkeypatch):
    jc, tc = _pair(monkeypatch, pipeline_depth=2)
    try:
        j = _inflight_run(jc, jst, JWL.OperatingPoint)
        t = _inflight_run(tc, st, WL.OperatingPoint)
        _assert_state_matches(tc, jc)
    finally:
        jc.stop()
        tc.stop()
    applied, verdicts, again, ticks, shape = t
    assert applied == j[0] == [{"engine": True, "host": []}, {"engine": True, "host": []}]
    assert verdicts == j[1] and again == j[2] and shape == j[4] == (64, 64, 2)
    assert len(ticks) == len(j[3]) == 4
    for i, (tw, jw) in enumerate(zip(ticks, j[3])):
        # every word equal but two: the telemetry row's live-segment count,
        # which the reference's plain tick does not have (it reports 0; the
        # port runs the segment path), and the checksum over it; the port's
        # own checksum holds (the wire decodes)
        (lo,) = [x for x in (WIRE.layout_for(tc.cfg, b) for b in (64, 16)) if x.total == len(tw)]
        skip = {3, lo.off_stats + E.STAT_SEG_LIVE}
        assert len(tw) == len(jw) == lo.total, i
        bad = [k for k, (a, b) in enumerate(zip(tw, jw)) if (a - b) % (1 << 32) and k not in skip]
        assert not bad, f"tick {i}: the packed wire differs at {bad}"
        WIRE.unpack(np.asarray(tw, np.int64).astype(np.uint32).view(np.int32).tobytes(), lo)
    assert {v for v, _w in verdicts} >= {ERR.PASS, ERR.BLOCK_FLOW}


def _callback_swap_run(c, m, op_cls):
    """A swap made inside the tick loop: the first request's future
    callback (run where the tick resolves) moves the batch 64 -> 16 while
    100 more requests are queued behind it."""
    _rules(c, m)
    op16 = op_cls.from_engine_config(c.cfg).replace(batch_size=16, complete_batch_size=16)
    names = _stream(2, 101)
    futs = _queue(c, names)
    shapes = []
    futs[0].add_done_callback(lambda f: shapes.append(c.apply_operating_point(op16)))
    real = c._run_tick

    def spy(acq, comp, now_ms, *a, **kw):
        shapes.append((len(acq) + sum(t for _b, _o, t in kw.get("blocks", ())), c.cfg.batch_size))
        return real(acq, comp, now_ms, *a, **kw)

    c._run_tick = spy
    try:
        c.tick_once()
    finally:
        c._run_tick = real
    return shapes, [tuple(map(int, f.result(timeout=5))) for f in futs]


def test_a_swap_inside_the_tick_loop_takes_the_new_batch_size(monkeypatch):
    """Step 0's fault: the port's loop read the batch size once per
    ``tick_once``, so after a swap made mid-loop it kept cutting 64-item
    batches for a 16-row tick (the tick raised and failed them closed);
    the reference reads it at every tick."""
    jc, tc = _pair(monkeypatch)
    try:
        j = _callback_swap_run(jc, jst, JWL.OperatingPoint)
        t = _callback_swap_run(tc, st, WL.OperatingPoint)
    finally:
        jc.stop()
        tc.stop()
    assert t == j
    shapes, verdicts = t
    assert shapes[:2] == [(64, 64), {"engine": True, "host": []}]
    assert shapes[2:] == [(16, 16), (16, 16), (5, 16)]
    assert ERR.BLOCK_SYSTEM not in {v for v, _w in verdicts}


def test_a_pipeline_depth_cut_drains_the_ticks_in_flight_in_order():
    """``pipeline_depth`` 4 -> 0 while ticks sit on the resolver thread:
    the next ticks queue behind them (never resolve inline ahead of them)
    and every future resolves."""
    c = SentinelClient(cfg=platform_config(**SMALL), time_source=VirtualTimeSource(1_000), mode="sync",
                       device="cpu", pipeline_depth=4)
    c.start()
    dispatched, resolved = [], []
    run, resolve = c._run_tick, c._resolve_tick

    def run_spy(*a, **kw):
        p = run(*a, **kw)
        dispatched.append(id(p))
        return p

    def resolve_spy(p):
        resolved.append(id(p))
        resolve(p)

    c._run_tick, c._resolve_tick = run_spy, resolve_spy
    try:
        op = WL.OperatingPoint.from_engine_config(c.cfg)
        futs = _queue(c, _stream(3, 64 * 12))
        futs[0].add_done_callback(lambda f: c.apply_operating_point(op.replace(pipeline_depth=0)))
        c.tick_once()
        res = [f.result(timeout=5) for f in futs]
    finally:
        c._run_tick, c._resolve_tick = run, resolve
        c.stop()
    assert c._pipeline_depth == 0 and len(res) == 64 * 12
    assert len(dispatched) == 12 and resolved == dispatched


# -- the slice: the closed loop on both packages ----------------------------------------------


def _loop_run(c, m, tune, spec_fn):
    c.flow_rules.load([(st if m is WL else jst).FlowRule(resource="wl/key0", count=120)])
    op0 = m.OperatingPoint.from_engine_config(c.cfg)
    cands = [op0.replace(batch_size=16, complete_batch_size=16), op0.replace(batch_size=8, complete_batch_size=8)]
    out = m.run_closed_loop(c, spec_fn(m), op0, candidates=cands if tune else (), tune=tune)
    return dict(counts=(out.submitted, out.passed, out.blocked), latencies=out.latencies_ms,
                decisions=out.decisions, converged=out.converged_op.describe(), bad_frac=out.bad_frac(),
                burn=(out.objective_burn, out.budget_consumed))


def test_the_closed_loop_through_the_port_equals_the_reference(monkeypatch):
    spec_fn = lambda m: m.flash_crowd_2x(seed=7, steps=160)  # noqa: E731
    runs = {}
    for name, Eng, P in (("jax", JE, JPROF), ("torch", E, PROF)):
        with Eng._TICK_CACHE_LOCK:
            Eng._TICK_CACHE.clear()
        P.RETRACE.reset()
        runs[name] = {"retrace": None}
    for tune in (False, True):
        jc, tc = _pair(monkeypatch)
        try:
            runs["jax"][tune] = _loop_run(jc, JWL, tune, spec_fn)
            runs["torch"][tune] = _loop_run(tc, WL, tune, spec_fn)
        finally:
            jc.stop()
            tc.stop()
    runs["jax"]["retrace"] = JPROF.RETRACE.recent()
    runs["torch"]["retrace"] = PROF.RETRACE.recent()
    assert runs["torch"] == runs["jax"]
    static, tuned = runs["torch"][False], runs["torch"][True]
    for r in (static, tuned):
        assert r["counts"][0] == r["counts"][1] + r["counts"][2] > 0
        assert len(r["latencies"]) == r["counts"][1]  # every admit completed
    assert static["counts"][2] > 0  # the flow rule bound in the crowd
    assert static["decisions"] == [] and tuned["converged"] != static["converged"]
    assert any(d["action"] == "applied" for d in tuned["decisions"])
    assert tuned["decisions"][-1]["action"] in ("converged", "rollback")
    assert tuned["bad_frac"] < static["bad_frac"]
    assert not [r for r in runs["torch"]["retrace"] if not r["expected"]]


def test_a_tuned_closed_loop_replays_bit_identically():
    spec = WL.flash_crowd_2x(seed=7, base=3.0, steps=60, start_step=10)

    def run():
        c = SentinelClient(cfg=platform_config(**SMALL), time_source=VirtualTimeSource(1_000), mode="sync",
                           device="cpu")
        c.start()
        try:
            op0 = WL.OperatingPoint.from_engine_config(c.cfg)
            return WL.run_closed_loop(
                c, spec, op0, tune=True, tune_every=4, tcfg=WL.TunerConfig(settle_steps=3, warmup_steps=1),
                candidates=[op0.replace(batch_size=16, complete_batch_size=16),
                            op0.replace(batch_size=8, complete_batch_size=8, pipeline_depth=2)])
        finally:
            c.stop()

    a, b = run(), run()
    assert a.decisions == b.decisions and len(a.decisions) > 0
    assert a.latencies_ms == b.latencies_ms
    assert (a.submitted, a.passed, a.blocked) == (b.submitted, b.passed, b.blocked)
    assert a.converged_op == b.converged_op
