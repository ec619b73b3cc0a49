"""sentinel_tpu_torch.obs.profile against the JAX package's obs/profile.

The counterparts of tests/test_profile.py's ledger, retrace, capture and
audit cases, on the CPU:

* the memory ledger and the retrace observatory, driven through both
  packages' classes on the same sequence: snapshots, records and counters
  equal;
* the client's ledger pools: the port's client and the reference's, one
  config each way, claim equal bytes in every pool (``windows``,
  ``rules``, ``sketch``, ``wire``), the sketch pool within 10 % of
  ``salsa.hbm_bytes``, and ``stop()`` releases them;
* the retrace JOURNAL (``entry``, ``cause``, ``expected``, ``reason``) of
  a client across its init, a rule-feature change, a window reshape and
  an operating-point swap equals the reference client's;
* every ``SketchAudit`` unit case through both packages' audits, counters
  and shadows equal; the client's online audit end to end (checks,
  underestimates, eps violations equal to the reference client's on one
  stream), its reader held against the reference's on the same sketch
  state (the port's SALSA estimate equals the reference's, and no
  estimate is under the exact shadow);
* ``capture_profile`` (ok, clamped, rate-limited, failing open) and the
  ``api/profile`` / ``api/memory`` commands.

Both clients run the reference's test config (``small_engine_config``,
the plain path) on virtual time, the JAX side jitted.  Tolerances:
integers and strings equal (every number compared is a byte or event
count).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from sentinel_tpu.chaos import failpoints as JFP
from sentinel_tpu.chaos.plans import FaultPlan as JPlan
from sentinel_tpu.chaos.plans import FaultSpec as JSpec
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs import profile as JPROF
from sentinel_tpu.obs.registry import MetricRegistry as JReg
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

import sentinel_tpu_torch as st
from sentinel_tpu_torch import workload as WL
from sentinel_tpu_torch.chaos import failpoints as TFP
from sentinel_tpu_torch.chaos.plans import FaultPlan as TPlan
from sentinel_tpu_torch.chaos.plans import FaultSpec as TSpec
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs import flight as TFL
from sentinel_tpu_torch.obs import profile as PROF
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY
from sentinel_tpu_torch.obs.registry import MetricRegistry as TReg
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.sketch import salsa as SA
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

#: package label -> (profile module, failpoints, FaultPlan, FaultSpec, registry class)
PKGS = {
    "jax": (JPROF, JFP, JPlan, JSpec, JReg),
    "torch": (PROF, TFP, TPlan, TSpec, TReg),
}

#: the reference test's sketch-tier client config
SKETCH = dict(max_resources=4, max_nodes=8, sketch_stats=True, sketch_width=256)


def _both(fn):
    out = {name: fn(*mods) for name, mods in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _metric(name, **labels):
    m = REGISTRY.get(name, labels or None)
    return float(m.value) if m is not None else 0.0


# -- memory ledger ---------------------------------------------------------------


def test_ledger_set_track_drop_gauges_and_owner_scopes():
    def run(P, FP, Plan, Spec, Reg):
        reg = Reg()
        led = P.MemoryLedger(registry=reg)
        with P.ledger_owner("unit-a"):
            led.set("rules", "tbl", 1024)
            n = led.track("windows", "gs", {"a": np.zeros((4, 8), np.float32)})
        with P.ledger_owner("unit-b"):
            led.set("sketch", "s", 200)
        snap = led.snapshot()
        gauge = float(reg.get("sentinel_hbm_bytes", {"pool": "windows"}).value)
        with P.ledger_owner("unit-a"):
            led.drop("rules", "tbl")
        led.drop_owner("unit-b")
        return n, snap, gauge, led.snapshot(), float(reg.get("sentinel_hbm_bytes", {"pool": "rules"}).value)

    n, snap, gauge, after, rules_gauge = _both(run)
    assert n == 4 * 8 * 4 and gauge == n
    assert snap["entries"]["rules/unit-a:tbl"] == 1024 and snap["total_bytes"] == 1024 + n + 200
    assert after["pools"] == {"windows": n} and after["total_bytes"] == n
    assert rules_gauge == 0


def test_ledger_capacity_checks_and_breaches():
    def run(P, FP, Plan, Spec, Reg):
        reg = Reg()
        led = P.MemoryLedger(registry=reg)

        def c(name):
            m = reg.get(name)
            return float(m.value) if m is not None else 0.0

        seq = []
        led.set("wire", "a", 10)  # no capacity: no check
        seq.append((c("sentinel_hbm_capacity_checks_total"), c("sentinel_hbm_capacity_breaches_total")))
        led.set_capacity(100)
        led.set("wire", "b", 20)
        seq.append((c("sentinel_hbm_capacity_checks_total"), c("sentinel_hbm_capacity_breaches_total")))
        led.set("tokens", "big", 500)
        seq.append((c("sentinel_hbm_capacity_checks_total"), c("sentinel_hbm_capacity_breaches_total")))
        return seq, led.snapshot()

    seq, snap = _both(run)
    assert seq == [(0, 0), (1, 0), (2, 1)]
    assert snap["capacity_bytes"] == 100 and snap["in_breach"] is True


def test_ledger_reconcile_on_the_cpu_reads_no_allocator_and_tree_nbytes_walks_tensors():
    import torch

    led = PROF.MemoryLedger(registry=TReg())
    led.set("rules", "r", 64)
    rec = led.reconcile("cpu")
    assert rec["total_bytes"] == 64 and rec["pools"]["rules"] == 64
    assert rec["live_array_bytes"] is None and rec["device_memory_stats"] is None
    assert rec["unaccounted_bytes"] is None
    assert led.flight_section()["pools"]["rules"] == 64
    tree = {"a": np.zeros(10, np.int32), "b": (np.zeros(3, np.float64), 7)}
    assert PROF.tree_nbytes(tree) == JPROF.tree_nbytes(tree) == 10 * 4 + 3 * 8
    state = E.init_state(small_engine_config(), "cpu")
    assert PROF.tree_nbytes(state) == sum(t.numel() * t.element_size() for t in _leaves(state))
    assert PROF.tree_nbytes(torch.zeros(3, dtype=torch.int16)) == 6


def _leaves(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _mine(snap, owner):
    return {k.replace(f"/{owner}:", "/"): v for k, v in snap["entries"].items() if f"/{owner}:" in k}


def test_client_ledger_pools_equal_the_reference_and_release_on_stop():
    """Every pool the client claims holds the same bytes as the reference
    client's on one config (each leaf's dtype and shape copied), the
    sketch pool within 10 % of the analytic salsa footprint."""
    jc = JaxClient(cfg=jax_small_cfg(**SKETCH), time_source=JVT(1_000), mode="sync", sketch_audit_k=4)
    tc = SentinelClient(cfg=small_engine_config(**SKETCH), time_source=VirtualTimeSource(1_000), mode="sync",
                        device="cpu", sketch_audit_k=4)
    try:
        for c in (jc, tc):
            c.start()
            c.flow_rules.load([st.FlowRule(resource="a", count=5)] if c is tc else [JR.FlowRule(resource="a", count=5)])
            c.entry("a").exit()
        jm = _mine(JPROF.LEDGER.snapshot(), jc._ledger_name)
        tm = _mine(PROF.LEDGER.snapshot(), tc._ledger_name)
        assert tm == jm
        assert {k.split("/", 1)[0] for k in tm} >= {"windows", "sketch", "rules", "wire"}
        sketch = sum(v for k, v in tm.items() if k.startswith("sketch/"))
        want = SA.hbm_bytes(E.sketch_config(tc.cfg))
        assert abs(sketch - want) <= 0.1 * want
    finally:
        jc.stop()
        tc.stop()
    assert not _mine(PROF.LEDGER.snapshot(), tc._ledger_name)


def test_the_token_column_claims_and_releases_its_state():
    """The token column's state is the "tokens" pool under its batcher's
    own owner (the reference's ``token_service.py:302-303``); ``close()``
    releases it."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

    dec = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                         device="cpu")
    svc = DefaultTokenService(dec, use_token_column=True)
    b = svc.col
    try:
        entries = _mine(PROF.LEDGER.snapshot(), b._ledger_name)
        assert entries == {"tokens/token_col.state": PROF.tree_nbytes(b._state)}
        assert entries["tokens/token_col.state"] > 0
    finally:
        svc.close()
        dec.stop()
    assert not _mine(PROF.LEDGER.snapshot(), b._ledger_name)


# -- retrace observatory -----------------------------------------------------------


def test_retrace_names_fields_expected_contexts_and_flight_section():
    def run(P, FP, Plan, Spec, Reg):
        reg = Reg()
        ro = P.RetraceObservatory(registry=reg)
        recs = [ro.observe("unit.fn", width=256, donate=True), ro.observe("unit.fn", width=512, donate=True)]
        with P.expected_retrace("test-resize"):
            recs.append(ro.observe("unit.fn", width=1024, donate=True))
        recs.append(ro.observe("unit.set", feats=frozenset({"a", "b"})))
        recs.append(ro.observe("unit.set", feats=frozenset({"b", "c"})))
        recs.append(ro.observe("unit.set"))
        ro.observe_compile_ms("unit.fn", 12.5)
        m = reg.get("sentinel_retraces_total", {"entry": "unit.fn", "expected": "false"})
        h = reg.get("sentinel_compile_ms", {"entry": "unit.fn"})
        return recs, ro.surprise_count(), float(m.value), h.count, ro.flight_section()

    recs, surprises, n_false, n_hist, sect = _both(run)
    assert recs[0]["cause"] == "warmup" and recs[0]["expected"]
    assert not recs[1]["expected"] and "256" in recs[1]["cause"] and "512" in recs[1]["cause"]
    assert recs[2]["expected"] and recs[2]["reason"] == "test-resize"
    assert recs[4]["cause"] == "feats: +c -a" and recs[5]["cause"] == "feats: removed"
    assert surprises == 3 and n_false == 1 and n_hist == 1
    assert sect["total_seen"] == 6 and sect["entries"] == ["unit.fn", "unit.set"]


def test_retrace_diffs_config_fields():
    a = small_engine_config(sketch_stats=True, sketch_width=256)
    ja = jax_small_cfg(sketch_stats=True, sketch_width=256)

    def run(P, FP, Plan, Spec, Reg):
        ro = P.RetraceObservatory(registry=Reg())
        x = a if P is PROF else ja
        ro.observe("unit.cfg", cfg=x)
        return ro.observe("unit.cfg", cfg=dataclasses.replace(x, sketch_width=512))

    rec = _both(run)
    assert not rec["expected"] and rec["cause"] == "cfg.sketch_width: 256→512"


def _journal_run(make_client, pkg_rules, wl_op):
    c = make_client()
    c.start()
    c.flow_rules.load([pkg_rules.FlowRule(resource="a", count=5)])
    c.param_flow_rules.load([pkg_rules.ParamFlowRule(resource="a", count=5, param_idx=0)])
    c.entry("a", args=["v"]).exit()
    c.update_window_shape(sample_count=4, window_ms=250)
    c.entry("a", args=["v"]).exit()
    op0 = wl_op.from_engine_config(c.cfg)
    out = [c.apply_operating_point(op0.replace(batch_size=16, complete_batch_size=16))]
    c.entry("a", args=["v"]).exit()
    out.append(c.apply_operating_point(op0.replace(batch_size=16, complete_batch_size=16, pipeline_depth=2)))
    c.stop()
    return out


def test_the_retrace_journal_equals_the_reference_across_init_rules_reshape_and_swap():
    from sentinel_tpu import workload as JWL

    journals = {}
    for name, P, Eng, make, rules, op in (
        ("jax", JPROF, JE, lambda: JaxClient(cfg=jax_small_cfg(), time_source=JVT(1_000), mode="sync"), JR,
         JWL.OperatingPoint),
        ("torch", PROF, E, lambda: SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000),
                                                  mode="sync", device="cpu"), st, WL.OperatingPoint),
    ):
        with Eng._TICK_CACHE_LOCK:
            Eng._TICK_CACHE.clear()
        P.RETRACE.reset()
        applied = _journal_run(make, rules, op)
        journals[name] = (P.RETRACE.recent(), applied)
    assert journals["torch"] == journals["jax"]
    recs, applied = journals["torch"]
    assert [r["reason"] for r in recs] == ["warmup", "rule-feature-change", "window-reshape", "tuner-retune"]
    assert all(r["expected"] for r in recs)
    assert recs[2]["cause"] == "cfg.second_sample_count: 2→4; cfg.second_window_ms: 500→250"
    assert applied == [{"engine": True, "host": []}, {"engine": False, "host": ["pipeline_depth"]}]


def test_engine_tick_bindings_steady_state_and_a_config_change():
    """A warmed client binds no new tick in steady state; an induced
    config change outside any expected context journals exactly one
    surprise naming the changed field."""
    c = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    c.start()
    try:
        base = PROF.RETRACE.surprise_count()
        for i in range(8):
            c.entry(f"rt-{i % 3}").exit()
        assert PROF.RETRACE.surprise_count() == base
        assert E.make_tick(c.cfg, c._features) is c._tick  # a cache hit
        cfg_a = small_engine_config(max_resources=7, max_nodes=13)
        cfg_b = dataclasses.replace(cfg_a, second_window_ms=cfg_a.second_window_ms + 500)
        with PROF.expected_retrace("test-setup"):
            E.make_tick(cfg_a)
        E.make_tick(cfg_b)
        assert PROF.RETRACE.surprise_count() == base + 1
        last = [r for r in PROF.RETRACE.recent() if not r["expected"]][-1]
        assert last["entry"] == "engine.tick" and "second_window_ms" in last["cause"]
    finally:
        c.stop()


# -- profile capture ----------------------------------------------------------------


def _reset_capture_clock():
    PROF._LAST_CAPTURE[0] = 0.0


def test_capture_profile_ok_clamped_rate_limited_and_failing_open():
    _reset_capture_clock()
    assert not OT.TRACER.enabled
    ok0 = _metric("sentinel_profile_captures_total", result="ok")

    def _sleep(s):
        assert OT.TRACER.enabled  # the tracer is live inside the window
        with OT.TRACER.span("unit.captured"):
            time.sleep(0.001)

    cap = PROF.capture_profile(ms=0.0, min_interval_s=0.0, sleep=_sleep)
    assert cap["ms"] == PROF.MIN_CAPTURE_MS and cap["span_count"] >= 1
    assert cap["chrome_trace"]["traceEvents"]
    assert not OT.TRACER.enabled  # the prior state restored
    assert _metric("sentinel_profile_captures_total", result="ok") == ok0 + 1
    rl0 = _metric("sentinel_profile_captures_total", result="rate_limited")
    cap = PROF.capture_profile(ms=1.0, min_interval_s=60.0, sleep=lambda s: None)
    assert cap["error"] == "rate_limited" and cap["retry_after_s"] > 0
    assert _metric("sentinel_profile_captures_total", result="rate_limited") == rl0 + 1
    _reset_capture_clock()
    err0 = _metric("sentinel_profile_captures_total", result="error")
    plan = TPlan(name="capture-fail", seed=1,
                 faults=[TSpec("obs.profile.capture", "raise", burst_start=0, burst_len=1, exc="RuntimeError")])
    with TFP.armed(plan):
        cap = PROF.capture_profile(ms=1.0, min_interval_s=0.0, sleep=lambda s: None)
    assert "error" in cap and cap["error"] != "rate_limited"
    assert not OT.TRACER.enabled
    assert _metric("sentinel_profile_captures_total", result="error") == err0 + 1
    _reset_capture_clock()
    OT.TRACER.reset()  # the window's spans: other files expect an empty ring


def test_api_profile_and_memory_endpoints():
    from sentinel_tpu_torch.transport import build_default_handlers
    from sentinel_tpu_torch.transport.command import CommandRequest

    _reset_capture_clock()
    c = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    c.start()
    try:
        reg = build_default_handlers(c)
        rsp = reg.handle("api/profile", CommandRequest(parameters={"ms": "1"}))
        assert rsp.success and "chrome_trace" in rsp.result
        rsp = reg.handle("api/profile", CommandRequest(parameters={"ms": "1"}))
        assert rsp.success and rsp.result["error"] == "rate_limited"
        rsp = reg.handle("api/memory", CommandRequest(parameters={}))
        assert rsp.success
        assert {"rules", "windows"} <= set(rsp.result["pools"])
        assert rsp.result["live_array_bytes"] is None  # the CPU allocator keeps no statistics
        b = TFL.FLIGHT.dump_bundle(reason="unit-profile")
        assert set(b["providers"]["memory"]["pools"]) <= set(PROF.MemoryLedger.POOLS)
        assert {"surprises", "recent"} <= set(b["providers"]["retrace"])
    finally:
        c.stop()
        _reset_capture_clock()
        OT.TRACER.reset()


# -- the sketch-accuracy audit -------------------------------------------------------


def _audit(P, Reg, k=2, period=1, **kw):
    kw.setdefault("node_rows", 8)
    kw.setdefault("window_ms", 1000)
    kw.setdefault("sample_count", 2)
    kw.setdefault("slack_buckets", 1)
    kw.setdefault("width", 256)
    kw.setdefault("registry", Reg())
    return P.SketchAudit(k=k, period=period, **kw)


def _vals(a):
    return {"checks": int(a._c_checks.value), "under": int(a._c_under.value), "eps": int(a._c_eps.value),
            "fail": int(a._c_fail.value), "tracked": sorted(a._tracked), "last": dict(a._last_audit),
            "vol": dict(a._vol), "hist": a._h_err.count}


def _i32(*xs):
    return np.asarray(xs, np.int32)


def _tracks_sketch_ids(a, FP, Plan, Spec):
    a.observe(1_000, _i32(2, 9, 10, 9), _i32(5, 3, 7, 1))
    first = sorted(a._tracked)
    a.observe(1_050, _i32(2, 9, 10, 9), _i32(5, 3, 7, 1), reader=lambda rids, t: [100, 100])
    return first


def _underestimate(a, FP, Plan, Spec):
    for t in (1_000, 1_100):
        a.observe(t, _i32(9), _i32(10))
    a.observe(1_200, _i32(9), _i32(10), reader=lambda rids, t: [5])


def _slack_only(a, FP, Plan, Spec):
    for t in (1_000, 2_000, 3_000):
        a.observe(t, _i32(9), _i32(10))
    a.observe(4_500, _i32(9), _i32(10), reader=lambda rids, t: [30])


def _eps_violation(a, FP, Plan, Spec):
    for t in (1_000, 2_000, 3_000):
        a.observe(t, _i32(9), _i32(10))
    a.observe(4_500, _i32(9), _i32(10), reader=lambda rids, t: [500])


def _uncovered(a, FP, Plan, Spec):
    a.observe(1_000, _i32(9), _i32(10))
    a.observe(1_100, _i32(9), _i32(10), reader=lambda rids, t: [10_000])


def _trash_row(a, FP, Plan, Spec):
    a.observe(1_000, _i32(63, 2, 9), _i32(5, 7, 11))


def _rotation(a, FP, Plan, Spec):
    for i in range(3):
        a.observe(1_000 + i, _i32(9), _i32(1))
    first = sorted(a._tracked)
    a.observe(1_003, _i32(10), _i32(1))
    return first


def _raising_reader(a, FP, Plan, Spec):
    a.observe(1_000, _i32(9), _i32(1))

    def boom(rids, t):
        raise RuntimeError("reader exploded")

    a.observe(1_100, _i32(9), _i32(1), reader=boom)
    a.observe(1_200, _i32(9), _i32(1), reader=lambda rids, t: [100])


def _shadow_failpoint(a, FP, Plan, Spec):
    plan = Plan(name="audit-fail", seed=1,
                faults=[Spec("sketch.audit.shadow", "raise", burst_start=0, burst_len=2, exc="RuntimeError")])
    with FP.armed(plan):
        a.observe(1_000, _i32(9), _i32(1))
        a.observe(1_100, _i32(9), _i32(1))
    mid = sorted(a._tracked)
    a.observe(1_200, _i32(9), _i32(1))
    return mid


AUDIT_CASES = {
    "tracks_sketch_ids_only": (dict(k=4), _tracks_sketch_ids,
                               lambda v, r: r == [9, 10] and v["checks"] == 2 and v["vol"][1] == 32),
    "underestimate": (dict(k=1), _underestimate, lambda v, r: v["under"] == 1 and v["checks"] == 1 and v["eps"] == 0),
    "slack_only_overestimate": (dict(k=1), _slack_only,
                                lambda v, r: v["eps"] == 0 and v["under"] == 0 and v["hist"] >= 1),
    "eps_violation": (dict(k=1), _eps_violation, lambda v, r: v["eps"] == 1 and v["last"]["eps_violations"] == 1),
    "uncovered_skips_eps": (dict(k=1, fresh_state=False), _uncovered, lambda v, r: v["eps"] == 0 and v["checks"] == 1),
    "trash_row_excluded": (dict(k=2, trash_row=63), _trash_row, lambda v, r: v["vol"][1] == 18 and v["tracked"] == [9]),
    "rotation_retires_oldest": (dict(k=1, period=4, rotate_every=4), _rotation,
                                lambda v, r: r == [9] and v["tracked"] == [10]),
    "raising_reader_fails_open": (dict(k=1), _raising_reader, lambda v, r: v["fail"] == 1 and v["checks"] == 1),
    "shadow_failpoint_fails_open": (dict(k=1), _shadow_failpoint,
                                    lambda v, r: v["fail"] == 2 and r == [] and v["tracked"] == [9]),
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_sketch_audit_unit_case_equals_the_reference(case):
    kw, drive, check = AUDIT_CASES[case]

    def run(P, FP, Plan, Spec, Reg):
        a = _audit(P, Reg, **kw)
        r = drive(a, FP, Plan, Spec)
        return _vals(a), r, a.flight_section()

    v, r, sect = _both(run)
    assert check(v, r), (v, r)
    assert sect["checks"] == v["checks"]


def test_sketch_audit_disabled_mode_under_five_micros():
    a = _audit(PROF, TReg, k=0)
    res, cnt = _i32(9), _i32(1)
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        a.observe(1_000, res, cnt)
    per = (time.perf_counter() - t0) / n
    assert per < 5e-6, f"disarmed audit costs {per * 1e6:.2f}us"
    assert a._ticks == 0


def _audit_counts(metric):
    return {
        "checks": metric("sentinel_sketch_audit_checks_total"),
        "under": metric("sentinel_sketch_underestimates_total"),
        "eps": metric("sentinel_sketch_eps_violations_total"),
        "fail": metric("sentinel_sketch_audit_failures_total"),
    }


def test_the_clients_online_audit_equals_the_reference_clients():
    """The wired path on one stream: checks, underestimates and eps
    violations of the port's client equal the reference client's; the
    reader agrees with the reference's on the same sketch state (the
    estimate of every tracked id), never under the exact shadow; the
    flight bundle carries the audit section."""
    from sentinel_tpu.obs.registry import REGISTRY as JREG

    def jmetric(name):
        m = JREG.get(name)
        return float(m.value) if m is not None else 0.0

    jc = JaxClient(cfg=jax_small_cfg(**SKETCH), time_source=JVT(1_000), mode="sync", sketch_audit_k=4,
                   sketch_audit_period=2)
    tc = SentinelClient(cfg=small_engine_config(**SKETCH), time_source=VirtualTimeSource(1_000), mode="sync",
                        device="cpu", sketch_audit_k=4, sketch_audit_period=2)
    deltas = {}
    try:
        for name, c, metric in (("jax", jc, jmetric), ("torch", tc, _metric)):
            c.start()
            before = _audit_counts(metric)
            for i in range(40):
                c.entry(f"audit-res-{i % 12}").exit()
                c.time.advance(5)
            after = _audit_counts(metric)
            deltas[name] = ({k: after[k] - before[k] for k in after}, sorted(c._audit._tracked),
                            dict(c._audit._last_audit))
        assert deltas["torch"] == deltas["jax"]
        d, tracked, last = deltas["torch"]
        assert d["checks"] > 0 and d["under"] == 0 and d["eps"] == 0 and d["fail"] == 0
        now = tc.time.now_ms()
        assert jc.time.now_ms() == now
        t_est = tc._audit_attempts(tracked, now)
        j_est = jc._audit_attempts(tracked, now)
        assert t_est.tolist() == np.asarray(j_est).tolist()
        sect = TFL.FLIGHT.dump_bundle(reason="unit-audit")["providers"]["audit"]
        assert sect["k"] == 4 and sect["tracked"] >= 1 and sect["underestimates"] == 0
    finally:
        jc.stop()
        tc.stop()
    assert "audit" not in TFL.FLIGHT.dump_bundle(reason="unit-audit-after")["providers"]


def test_the_plain_path_serves_sketch_ids_as_the_reference_does():
    """A fault the audit's client test found: the plain path's flow read
    (``ops/engine._check_flow``) indexed the node tables at a sketch id
    (>= node_rows) and raised IndexError on the first tick that carried
    one; the reference's gathers clamp the index (the item is not
    applicable there).  Verdicts on twelve names past the exact rows, one
    flow rule on an exact row, equal the reference's."""
    jc = JaxClient(cfg=jax_small_cfg(**SKETCH), time_source=JVT(1_000), mode="sync")
    tc = SentinelClient(cfg=small_engine_config(**SKETCH), time_source=VirtualTimeSource(1_000), mode="sync",
                        device="cpu")
    outs = []
    try:
        for c, m in ((jc, JR), (tc, st)):
            c.start()
            c.flow_rules.load([m.FlowRule(resource="res-0", count=3)])
            out = []
            for i in range(40):
                out.append(c.try_entry(f"res-{i % 12}") is not None)
                c.time.advance(5)
            outs.append((out, [c.registry.is_sketch_id(c.registry.peek_resource_id(f"res-{i}")) for i in range(12)]))
    finally:
        jc.stop()
        tc.stop()
    assert outs[1] == outs[0]
    assert any(outs[1][1]) and not all(outs[1][0])
