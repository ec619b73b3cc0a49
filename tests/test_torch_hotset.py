"""The port's sketch tier through the client against the JAX package's
client: the hot-set promotion loop (sketch/hotset.py — promote, two cold
evaluations to demote, the cooldown), rule-load promotion into the
reserve rows and the tail rules that stay on sketch ids, on the same
names, rules and virtual clock, in mode="sync".

As in tests/test_hotset.py and tests/test_tail_rules.py, which these
mirror.  The port runs on the CPU (its kernels' plain versions) with the
fused engine; the JAX client runs its default CPU engine (jitted, plain
scatters — its verdicts equal the fused path's by the JAX package's own
tests; see tests/test_torch_client.py).  Every verdict, every registry id,
the hot-set candidates (QPS, float) and the promoted / demoted sets must
be EQUAL; the candidates' folded estimates are integer window counts over
the interval, exact in both.
"""

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.chaos.plans import FaultPlan, FaultSpec
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.runtime.registry import Registry
from sentinel_tpu_torch.sketch import hotset as HS
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

NO_PLANES = dict(device_telemetry=False, timeline_k=0, explain_k=0)
#: the manager's own cadence runs on the REAL clock (``hotset_eval_s``); set
#: out of reach, so evaluations happen only where a test calls
#: ``evaluate_now`` and both clients evaluate at the same steps
MANUAL = dict(hotset_eval_s=1.0e9)
HOT = dict(
    max_resources=32, max_nodes=64, sketch_stats=True, sketch_width=256, hotset_k=8,
    hotset_promote_qps=3.0, hotset_demote_qps=1.0, hotset_cooldown_s=30.0, **MANUAL,
)
TINY = dict(max_resources=4, max_nodes=16, sketch_stats=True, sketch_width=512, sketch_depth=2, **MANUAL)


def _pair(**kw):
    """A started JAX client and a started port client on one config and a
    virtual clock each, starting at 1,000 ms."""
    jc = JaxClient(cfg=jax_small_cfg(**NO_PLANES, **kw), time_source=JaxVT(1_000), mode="sync")
    upload = jc._dev_col  # a private copy per upload (tests/test_torch_client.py)
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    tc = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES, **kw),
                        time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    jc.start()
    tc.start()
    return jc, tc


def _burn_exact(c):
    i = 0
    while not c.registry.is_sketch_id(c.registry.resource_id(f"burn-{i}")):
        i += 1


def _hits(c, name, n, step_ms=5):
    """n entries on ``name``, each exited, the clock advancing between:
    which of them passed."""
    out = []
    for _ in range(n):
        e = c.try_entry(name)
        out.append(e is not None)
        if e is not None:
            e.exit()
        c.time.advance(step_ms)
    return out


def _ids(c, names):
    return [c.registry.peek_resource_id(n) for n in names]


def test_promote_demote_loop_matches_jax_client():
    """A hot sketched resource is folded as a candidate, promoted into an
    exact row, graded cold twice after its traffic stops, demoted back to
    the tail, and refused re-promotion during the cooldown — step for
    step as the JAX client does it."""
    jc, tc = _pair(**HOT)
    try:
        for c in (jc, tc):
            _burn_exact(c)
            assert c.registry.is_sketch_id(c.registry.resource_id("hot-svc"))
            c.registry.resource_id("fades")
        assert _ids(tc, ["hot-svc", "fades"]) == _ids(jc, ["hot-svc", "fades"])
        for name in ("hot-svc", "fades"):
            assert _hits(tc, name, 8) == _hits(jc, name, 8)
        assert tc.hotset._cand == jc.hotset._cand
        assert tc.hotset._cand[tc.registry.peek_resource_id("hot-svc")] >= 3.0
        p0 = HS._C_PROMOTIONS.value
        for c in (jc, tc):
            c.hotset.evaluate_now()
        assert HS._C_PROMOTIONS.value > p0
        assert tc.hotset.promoted == jc.hotset.promoted
        assert set(tc.hotset.promoted) == {"hot-svc", "fades"}
        assert not tc.registry.is_sketch_id(tc.registry.peek_resource_id("hot-svc"))
        # the exact tier serves the promoted resources; traffic on one only
        assert _hits(tc, "hot-svc", 4) == _hits(jc, "hot-svc", 4)
        # the window slides past "fades": one cold evaluation holds, the
        # second demotes it back to the tail
        for c in (jc, tc):
            c.time.advance(2_000)
            c.tick_once()
            assert c.try_entry("hot-svc") is not None
            c.hotset.evaluate_now()
        assert tc.hotset.promoted == jc.hotset.promoted and "fades" in tc.hotset.promoted
        for c in (jc, tc):
            _hits(c, "hot-svc", 3)
            c.hotset.evaluate_now()
        assert tc.hotset.promoted == jc.hotset.promoted == {"hot-svc": tc.hotset.promoted["hot-svc"]}
        assert _ids(tc, ["hot-svc", "fades"]) == _ids(jc, ["hot-svc", "fades"])
        rid = tc.registry.peek_resource_id("fades")
        assert tc.registry.is_sketch_id(rid)
        # the cooldown refuses re-promotion
        assert tc.hotset._cool["fades"].cooling
        for c in (jc, tc):
            c.hotset._cand[rid] = 100.0
            c.hotset.evaluate_now()
        assert tc.registry.is_sketch_id(tc.registry.peek_resource_id("fades"))
        assert tc.hotset.promoted == jc.hotset.promoted
    finally:
        jc.stop()
        tc.stop()


def test_tail_rules_block_recover_and_spare_unruled_like_jax_client():
    """A QPS rule on a sketch id enforces from the tail tables (blocks,
    then recovers when the window slides); unruled tail resources pass;
    the ``tail_flow`` stage is on while such a rule is loaded."""
    jc, tc = _pair(**TINY)
    try:
        for c, m in ((jc, jst), (tc, tst)):
            for i in range(10):
                c.try_entry(f"filler-{i}")
            for n in ("first", "svc-tail"):
                assert c.registry.is_sketch_id(c.registry.resource_id(n))
            # "first" takes the one reserve row; "svc-tail" stays a sketch id
            c.flow_rules.load([m.FlowRule(resource="first", count=1000),
                               m.FlowRule(resource="svc-tail", count=3)])
        assert _ids(tc, ["first", "svc-tail"]) == _ids(jc, ["first", "svc-tail"])
        assert tc.registry.is_sketch_id(tc.registry.peek_resource_id("svc-tail"))
        assert "tail_flow" in tc._features and "tail_flow" in jc._features
        got = _hits(tc, "svc-tail", 10, step_ms=1)
        assert got == _hits(jc, "svc-tail", 10, step_ms=1)
        assert 1 <= sum(got) <= 3
        for c in (jc, tc):
            c.time.advance(1_500)
        after_t, after_j = _hits(tc, "svc-tail", 6, step_ms=200), _hits(jc, "svc-tail", 6, step_ms=200)
        assert after_t == after_j, (after_t, after_j)
        assert any(after_t)
        free_t = [tc.try_entry(f"free-{i}") is not None for i in range(30)]
        free_j = [jc.try_entry(f"free-{i}") is not None for i in range(30)]
        assert free_t == free_j and sum(free_t) >= 29
        for c in (jc, tc):
            c.flow_rules.load([])
        assert "tail_flow" not in tc._features
    finally:
        jc.stop()
        tc.stop()


def test_rule_load_promotion_prioritizes_unservable_grades_like_jax_client():
    """More ruled tail names than reserve rows: the rate limiter (which
    the tail tables cannot serve) wins an exact row and paces; the QPS
    rules left in the tail enforce approximately — equal verdicts and
    equal ids in both clients."""
    kw = dict(TINY, max_resources=16, max_nodes=32)
    jc, tc = _pair(**kw)
    try:
        for c, m in ((jc, jst), (tc, tst)):
            _burn_exact(c)
            reserve = c.cfg.max_resources - c.registry.num_resources
            qps = [f"qps-{k}" for k in range(reserve + 2)]
            for n in qps + ["rl-prio"]:
                assert c.registry.is_sketch_id(c.registry.resource_id(n))
            c.flow_rules.load(
                [m.FlowRule(resource=n, count=5.0) for n in qps]
                + [m.FlowRule(resource="rl-prio", count=10.0, control_behavior=m.CONTROL_RATE_LIMITER,
                              max_queueing_time_ms=2000)]
            )
        names = qps + ["rl-prio"]
        assert _ids(tc, names) == _ids(jc, names)
        assert not tc.registry.is_sketch_id(tc.registry.peek_resource_id("rl-prio"))
        waits = []
        for c in (jc, tc):
            e1, e2 = c.try_entry("rl-prio"), c.try_entry("rl-prio")
            waits.append((e1.wait_ms, e2.wait_ms))
        assert waits[0] == waits[1] and waits[1][1] >= 50
        tail_qps = [n for n in qps if tc.registry.is_sketch_id(tc.registry.peek_resource_id(n))]
        assert tail_qps
        got = _hits(tc, tail_qps[0], 12, step_ms=1)
        assert got == _hits(jc, tail_qps[0], 12, step_ms=1) and sum(got) <= 5
    finally:
        jc.stop()
        tc.stop()


def test_failed_promotion_keeps_the_tail_rule_enforcing():
    """``runtime.hotset.promote`` failing (the port's failpoint): the ruled
    resource stays on its sketch id, the failure is counted, and its rule
    still blocks from the tail tables — fail CLOSED for verdicts."""
    tc = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES, **HOT),
                        time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    tc.start()
    try:
        _burn_exact(tc)
        assert tc.registry.is_sketch_id(tc.registry.resource_id("guarded"))
        fails0 = HS._C_PROMOTE_FAIL.value
        plan = FaultPlan(name="hotset_promote_fail", seed=1, faults=[
            FaultSpec("runtime.hotset.promote", "raise", burst_start=0, burst_len=1000, exc="RuntimeError")])
        st = FP.arm(plan)
        try:
            tc.flow_rules.load([tst.FlowRule(resource="guarded", count=2)])
        finally:
            FP.disarm()
        assert st.injected().get("runtime.hotset.promote:raise", 0) >= 1
        assert HS._C_PROMOTE_FAIL.value > fails0
        assert tc.registry.is_sketch_id(tc.registry.peek_resource_id("guarded"))
        got = sum(1 for _ in range(8) if tc.try_entry("guarded"))
        assert 1 <= got <= 2
        # the sketch id's windowed stats come from the sketch: estimates
        # that only ever overcount
        s = tc.stats.resource("guarded")
        assert s["passQps"] >= got and s["blockQps"] >= 8 - got and s["curThreadNum"] == 0
    finally:
        tc.stop()


def test_manager_bookkeeping():
    """The fold keeps QPS (a minute-window sketch folds 120 events as 2 QPS),
    ``guarded_promote`` counts transitions only, a demoted row recycles
    after a zero quarantine, and the hot block is off with hotset_k=0."""
    cfg = small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES,
                              **dict(HOT, sketch_sample_count=60, sketch_window_ms=1000))
    tc = SentinelClient(cfg=cfg, time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    rid = cfg.node_rows + 7
    tc.hotset.fold(np.asarray([[float(rid), 120.0], [3.0, 500.0]], np.float32))
    assert tc.hotset._cand == {rid: 2.0}  # 120 events / 60 s; exact rows never fold
    reg = Registry(small_engine_config(**HOT))
    i = 0
    while not reg.is_sketch_id(reg.resource_id(f"b{i}")):
        i += 1
    p0 = HS._C_PROMOTIONS.value
    assert HS.guarded_promote(reg, f"b{i}") is not None
    assert HS.guarded_promote(reg, f"b{i}") is not None
    assert HS._C_PROMOTIONS.value == p0 + 1
    row = reg.peek_resource_id(f"b{i}")
    assert reg.is_sketch_id(reg.demote_resource(f"b{i}", quarantine_s=0.0))
    reg.resource_id("next-hot")
    assert reg.promote_resource("next-hot") == row
    assert E.hotset_k(small_engine_config(**dict(HOT, hotset_k=0))) == 0
    off = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **dict(HOT, hotset_k=0)), mode="sync",
                         device="cpu")
    assert off.hotset is None
