"""sentinel_tpu_torch.adaptive and the client's overload protection: the
port's counterparts of tests/test_adaptive.py's cases, on the CPU.

* the SystemSlot BBR math through the client (a pinned load sample);
* the adaptive columns: ceilings uploaded into the live system columns
  decide exactly like an equivalent static rule and never rebuild the
  tick; an operator rule stricter than the controller wins;
* the ladder and the shared hysteresis, held against the reference's on
  the same inputs; the controller on one signal stream, step for step;
* deadlines on ``entry`` / ``submit_acquire`` / ``check_batch`` / blocks,
  the shed rungs (SHED_LOW_PRIORITY, PARAM_TAIL_OFF, CLUSTER_FALLBACK,
  FAIL_CLOSED), the admission bound counting block items;
* the watchdog failing a stalled tick closed, exactly once;
* the disabled-mode overhead guards (<5 µs a call);
* ``run_overload_sim`` with the controller on and off: the port's
  ``SimResult`` equals the reference's field for field.  The schedule is
  shortened through its own ``healthy_steps`` / ``storm_steps`` /
  ``recover_steps`` to keep the file's run time down (the full schedule
  runs on the card, ``chip_smoke.py --overload``); the storm still climbs
  the ladder to FAIL_CLOSED.
"""

import dataclasses
import time as _time

import numpy as np
import pytest

from sentinel_tpu.adaptive import controller as JC
from sentinel_tpu.adaptive import degrade as JDG
from sentinel_tpu.adaptive import simload as JS
from sentinel_tpu.adaptive.signals import SystemSignals as JSignals

import sentinel_tpu_torch as st
from sentinel_tpu_torch.adaptive import degrade as DG
from sentinel_tpu_torch.adaptive import simload as TS
from sentinel_tpu_torch.adaptive.controller import AdaptiveConfig, AdaptiveController
from sentinel_tpu_torch.adaptive.degrade import DegradeLadder, Hysteresis
from sentinel_tpu_torch.adaptive.signals import SignalCollector, SystemSignals
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs.registry import REGISTRY as OBS
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource, mono_s


@pytest.fixture()
def vt():
    return VirtualTimeSource(start_ms=1_000)


@pytest.fixture()
def client_factory(vt):
    """Sync-mode port clients on the reference's test config (the plain
    path) and virtual time, on the CPU; stopped at teardown."""
    made = []

    def factory(**kw):
        kw.setdefault("cfg", small_engine_config())
        kw.setdefault("time_source", vt)
        kw.setdefault("mode", "sync")
        kw.setdefault("device", "cpu")
        c = SentinelClient(**kw)
        c.start()
        made.append(c)
        return c

    yield factory
    for c in made:
        c.stop()


@pytest.fixture()
def client(client_factory):
    return client_factory()


def _loaded(client, load, cpu=0.0):
    """Pin the host load / CPU sample the tick feeds the SystemSlot."""
    client._sys.sample = lambda: (load, cpu)


def _shed(stage, reason):
    return OBS.counter("sentinel_shed_total", labels={"stage": stage, "reason": reason}).value


# -- SystemSlot BBR math (SystemRuleManager.checkBbr) ---------------------------


def test_system_negative_fields_are_off(client, vt):
    client.system_rules.load([st.SystemRule()])
    _loaded(client, 99.0, 0.99)
    got = [client.try_entry("api", inbound=True) for _ in range(8)]
    assert all(e is not None for e in got)
    for e in got:
        e.exit()


def test_bbr_min_rt_floor_admits_one(client, vt):
    client.system_rules.load([st.SystemRule(highest_system_load=0.5)])
    _loaded(client, 2.0)
    entries = [client.try_entry("api", inbound=True) for _ in range(3)]
    assert [e is not None for e in entries] == [True, False, False]
    entries[0].exit()


def test_bbr_concurrency_estimate_tracks_product(client, vt):
    """8 successes at 500 ms in the window: maxSuccessQps 16/s x 500 ms =
    8 concurrent entries admitted under load."""
    client.system_rules.load([st.SystemRule(highest_system_load=0.5)])
    _loaded(client, 0.0)
    seed = [client.entry("api", inbound=True) for _ in range(8)]
    vt.advance(500)
    for e in seed:
        e.exit()
    _loaded(client, 2.0)
    got = [client.try_entry("api", inbound=True) for _ in range(12)]
    assert sum(1 for e in got if e is not None) == 8
    for e in got:
        if e is not None:
            e.exit()


def test_bbr_inactive_below_load_threshold(client, vt):
    client.system_rules.load([st.SystemRule(highest_system_load=0.5)])
    _loaded(client, 0.2)
    got = [client.try_entry("api", inbound=True) for _ in range(6)]
    assert all(e is not None for e in got)
    for e in got:
        e.exit()


# -- the adaptive columns ---------------------------------------------------------


def test_adaptive_columns_decide_like_static_rule(client_factory, vt):
    static = client_factory()
    static.system_rules.load([st.SystemRule(qps=2)])
    adaptive = client_factory()
    ad = adaptive.enable_adaptive()
    tick_before, rules_before = adaptive._tick, adaptive._rules_dev
    sys_np = ad.system_columns(adaptive._system_static, qps=2.0, max_thread=-1.0)
    with adaptive._engine_lock:
        adaptive._rules_dev = E.replace_system_columns(adaptive._rules_dev, sys_np, adaptive._sys_stage)
    want = [v in (ERR.PASS, ERR.PASS_WAIT) for v, _ in static.check_batch(["api"] * 5, inbound=True)]
    got = [v in (ERR.PASS, ERR.PASS_WAIT) for v, _ in adaptive.check_batch(["api"] * 5, inbound=True)]
    assert got == want and sum(got) == 2
    # the upload swapped the system VALUES only: the same tick, and every
    # other leaf of the ruleset is the very same tensor
    assert adaptive._tick is tick_before
    after = adaptive._rules_dev
    for f in after._fields:
        if f != "system":
            assert getattr(after, f) is getattr(rules_before, f), f
    assert [float(x) for x in after.system] == [float(sys_np.load), float(sys_np.cpu), 2.0,
                                                float(sys_np.avg_rt), -1.0]


def test_adaptive_tightest_wins_against_static(client_factory, vt):
    c = client_factory()
    c.system_rules.load([st.SystemRule(qps=1)])
    ad = c.enable_adaptive()
    sys_np = ad.system_columns(c._system_static, qps=50.0, max_thread=100.0)
    assert float(sys_np.qps) == 1.0 and float(sys_np.max_thread) == 100.0
    sys_np = ad.system_columns(c._system_static, qps=-1.0, max_thread=-1.0)
    assert float(sys_np.qps) == 1.0


def test_enable_adaptive_compiles_system_stage_once(client_factory):
    c = client_factory()
    assert "system" not in c._features
    c.enable_adaptive()
    assert "system" in c._features
    tick = c._tick
    c._adaptive.ceiling = 4.0
    for _ in range(5):
        c.try_entry("api", inbound=True)
    assert c._tick is tick
    c.disable_adaptive()
    assert "system" not in c._features


# -- the ladder, the hysteresis, the controller ------------------------------------


def _ladder_run(mod, steps):
    lad = mod.DegradeLadder(climb_hold_ms=100, cool_hold_ms=200)
    for t, over, severe in steps:
        lad.observe(t, over, severe=severe)
    return lad.level, list(lad.transitions)


def test_ladder_climbs_descends_and_matches_the_reference():
    rng = np.random.default_rng(4)
    steps = [(i * 10, i < 60 or bool(rng.random() < 0.3), bool(rng.random() < 0.02)) for i in range(400)]
    assert _ladder_run(DG, steps) == _ladder_run(JDG, steps)
    lad = DegradeLadder(climb_hold_ms=100, cool_hold_ms=200)
    t = 0
    while lad.level != DG.FAIL_CLOSED:
        lad.observe(t, True)
        t += 10
    while lad.level != DG.NORMAL:
        lad.observe(t, False)
        t += 10
    assert all(abs(to - frm) == 1 for _t, frm, to in lad.transitions)
    assert len(lad.transitions) == 8
    # every move is journalled in the flight recorder
    kinds = [e for e in FL.FLIGHT.events(last=8) if e["kind"] == "adaptive.ladder"]
    assert [(e["fields"]["frm"], e["fields"]["to"]) for e in kinds][-1] == ("SHED_LOW_PRIORITY", "NORMAL")


def test_ladder_hysteresis_resets_on_contradiction():
    lad = DegradeLadder(climb_hold_ms=100, cool_hold_ms=100)
    t = 0
    for _ in range(9):
        lad.observe(t, True)
        t += 10
    lad.observe(t, False)
    t += 10
    for _ in range(9):
        lad.observe(t, True)
        t += 10
    assert lad.level == DG.NORMAL


def test_ladder_severe_climbs_without_hold():
    lad = DegradeLadder(climb_hold_ms=10_000, cool_hold_ms=100)
    lad.observe(0, True, severe=True)
    assert lad.level == DG.SHED_LOW_PRIORITY
    lad.observe(1, True, severe=True)
    assert lad.level == DG.PARAM_TAIL_OFF


def test_hysteresis_enter_exit_cooling_and_journal():
    now = [100.0]
    hy = Hysteresis("test.degrade", cooldown_s=5.0, attrs={"site": "t"}, clock=lambda: now[0])
    assert not hy.active and not hy.cooling
    assert hy.enter() is True
    assert hy.enter() is False
    assert hy.active and hy.cooling and not hy.probe_due
    now[0] += 5.1
    assert hy.probe_due and not hy.cooling and hy.remaining_s() == 0.0
    assert hy.exit() is True and hy.exit() is False
    ev = [e for e in FL.FLIGHT.events(last=16) if e["kind"].startswith("test.degrade.")]
    assert [e["kind"] for e in ev][-2:] == ["test.degrade.enter", "test.degrade.exit"]
    assert ev[-2]["fields"] == {"cooldown_s": 5.0, "site": "t"}


def test_controller_matches_the_reference_step_for_step():
    """One seeded signal stream through both controllers: the same
    (qps, max_thread) uploads, ceilings, ladder levels and capacity."""
    rng = np.random.default_rng(9)
    cfg = dict(queue_high=64, climb_hold_ms=30, cool_hold_ms=120, block_pressure_ratio=1.0, min_ceiling=4.0)
    mine, ref = AdaptiveController(AdaptiveConfig(**cfg)), JC.AdaptiveController(JC.AdaptiveConfig(**cfg))
    for i in range(300):
        storm = 80 <= i < 200
        row = dict(
            now_ms=1_000 + 10 * i,
            queue_depth=int(rng.integers(0, 200 if storm else 40)),
            pass_rate=float(rng.random() * 400),
            block_rate=float(rng.random() * (800 if storm else 50)),
            max_pass_rate=float(300 + rng.random() * 200),
            min_rt_ms=float(rng.choice([0.0, 5.0, 20.0])),
            rt_ewma_ms=float(rng.random() * (200 if storm else 30)),
            inflight=float(rng.random() * 50),
            sys_cpu=float(rng.random()),
        )
        if i == 150:
            mine.note_severe()
            ref.note_severe()
        assert mine.on_tick(SystemSignals(**row)) == ref.on_tick(JSignals(**row)), i
        assert (mine.ceiling, mine.cap_est, mine.level) == (ref.ceiling, ref.cap_est, ref.level), i


def test_controller_publishes_ceiling_gauge():
    ad = AdaptiveController(AdaptiveConfig(queue_high=4, climb_hold_ms=0, min_ceiling=2.0))
    ad.on_tick(SystemSignals(now_ms=1000, queue_depth=100, max_pass_rate=100.0, min_rt_ms=20.0))
    assert OBS.gauge("sentinel_adaptive_ceiling").value == pytest.approx(ad.ceiling)
    assert ad.ceiling == pytest.approx(2.0)


# -- deadlines ---------------------------------------------------------------------


def test_expired_deadline_sheds_before_dispatch(client, vt):
    client.registry.resource_id("api")
    before = _shed("tick", "deadline")
    f = client.submit_acquire("api", deadline_ms=vt.now_ms() - 1)
    assert f.result(timeout=5) == (ERR.BLOCK_SYSTEM, 0)
    assert _shed("tick", "deadline") == before + 1
    assert not client._deadlines_live  # nothing deadline-carrying is left


def test_live_deadline_passes(client, vt):
    f = client.submit_acquire("api", deadline_ms=vt.now_ms() + 1000)
    assert f.result(timeout=5)[0] in (ERR.PASS, ERR.PASS_WAIT)
    e = client.entry("api", deadline_ms=vt.now_ms() + 1000)
    e.exit()


def test_expired_deadlines_on_the_bulk_api(client, vt):
    rid = client.registry.resource_id("api")
    v, w = client.check_batch_ids(np.full(4, rid, np.int32), deadline_ms=vt.now_ms() - 1)
    assert (v == ERR.BLOCK_SYSTEM).all() and (w == 0).all()
    assert client.check_batch(["api"] * 3, deadline_ms=vt.now_ms() - 1) == [(ERR.BLOCK_SYSTEM, 0)] * 3
    assert client.check_batch(["api"] * 2, deadline_ms=vt.now_ms() + 50) == [(ERR.PASS, 0)] * 2


def test_a_block_expiring_in_the_queue_fails_its_untaken_rest(client, vt):
    """A threaded-style queue (filled, then ticked): the block's deadline
    passes while it waits, so none of its items reaches the engine."""
    rid = client.registry.resource_id("api")
    client.mode = "threaded"
    try:
        fut = client.submit_block(np.full(150, rid, np.int32), deadline_ms=vt.now_ms() + 5)
    finally:
        client.mode = "sync"
    vt.advance(10)
    before = _shed("tick", "deadline")
    client.tick_once()
    v, _w = fut.result(timeout=5)
    assert (v == ERR.BLOCK_SYSTEM).all()
    assert _shed("tick", "deadline") == before + 150


def test_entry_deadline_already_expired_raises(client, vt):
    before = _shed("admit", "deadline")
    with pytest.raises(ERR.SystemBlockException):
        client.entry("api", deadline_ms=vt.now_ms() - 5)
    assert _shed("admit", "deadline") == before + 1


# -- the shed rungs at the admission gate --------------------------------------------


def test_shed_low_priority_spares_prioritized(client, vt):
    ad = client.enable_adaptive(AdaptiveConfig(queue_max=0))
    ad.ladder.level = DG.SHED_LOW_PRIORITY
    client._bp_armed = True
    with pytest.raises(ERR.SystemBlockException):
        client.entry("api")
    client.entry("api", prioritized=True).exit()


def test_param_tail_off_rung_stops_hot_param_counting(client, vt):
    client.param_flow_rules.load([st.ParamFlowRule(resource="api", count=100, param_idx=0)])
    client.entry("api", args=["u1"], prioritized=True).exit()
    assert dict(client.top_params("api"))["u1"] == 1
    ad = client.enable_adaptive(AdaptiveConfig(queue_max=0))
    ad.ladder.level = DG.PARAM_TAIL_OFF
    client._bp_armed = True
    for _ in range(3):
        client.entry("api", args=["u1"], prioritized=True).exit()
    # the enforcement hashes still flow; the host tail counters do not
    assert dict(client.top_params("api"))["u1"] == 1


def test_fail_closed_sheds_everything(client, vt):
    rid = client.registry.resource_id("api")
    ad = client.enable_adaptive(AdaptiveConfig(queue_max=0))
    ad.ladder.level = DG.FAIL_CLOSED
    client._bp_armed = True
    with pytest.raises(ERR.SystemBlockException):
        client.entry("api", prioritized=True)
    assert client.submit_acquire("api").result(timeout=5) == (ERR.BLOCK_SYSTEM, 0)
    v, _ = client.check_batch_ids(np.full(3, rid, np.int32))
    assert (v == ERR.BLOCK_SYSTEM).all()


def test_cluster_fallback_rung_stops_token_rpcs(client_factory, vt):
    """At CLUSTER_FALLBACK the client's cluster hysteresis arms and the
    admission path stops paying token-server round trips; the degrade
    entry captures a flight bundle."""
    from sentinel_tpu_torch.cluster import constants as CC
    from sentinel_tpu_torch.cluster.token_service import TokenResult

    calls = []

    class _Svc:
        def request_token(self, *a, **k):
            calls.append(a)
            return TokenResult(CC.STATUS_OK)

    class _Mgr:
        def token_service(self):
            return _SVC

    _SVC = _Svc()
    c = client_factory()
    c.set_cluster(_Mgr())
    c.flow_rules.load([st.FlowRule(resource="api", count=100, cluster_mode=True, cluster_flow_id=9)])
    ad = c.enable_adaptive(AdaptiveConfig(queue_max=0))
    ad.ladder.level = DG.CLUSTER_FALLBACK
    assert not c._cluster_degraded_active
    FL.FLIGHT.reset_rate_limit()
    n_bundles = len(FL.FLIGHT.bundles())
    e = c.try_entry("api", prioritized=True)
    if e:
        e.exit()
    assert c._cluster_degraded_active
    assert len(FL.FLIGHT.bundles()) == min(n_bundles + 1, FL.FLIGHT.keep)
    assert FL.FLIGHT.last_bundle()["reason"] == "cluster-degrade-enter"
    n_before = len(calls)
    e = c.try_entry("api", prioritized=True)
    if e:
        e.exit()
    assert len(calls) == n_before


def test_sync_fail_closed_ladder_still_descends(client, vt):
    ad = client.enable_adaptive(AdaptiveConfig(queue_max=0, cool_hold_ms=100))
    ad.ladder.level = DG.FAIL_CLOSED
    client._bp_armed = True
    with pytest.raises(ERR.SystemBlockException):
        client.entry("api", prioritized=True)
    for _ in range(30):
        try:
            client.entry("api", prioritized=True).exit()
        except ERR.SystemBlockException:
            pass
        vt.advance(50)
        if ad.ladder.level < DG.FAIL_CLOSED:
            break
    assert ad.ladder.level < DG.FAIL_CLOSED


def test_admission_bound_counts_block_items(client_factory):
    from sentinel_tpu_torch.runtime.client import ArrayBlock

    c = client_factory(admission_queue_limit=8)
    assert c._bp_armed and c._admission_shed(1) is None
    c._acq_blocks.append(ArrayBlock(res=np.zeros(10, np.int32)))
    try:
        assert c._admission_shed(1) == "queue_full"
    finally:
        c._acq_blocks.clear()


def test_disable_adaptive_resets_gauges(client_factory):
    c = client_factory()
    ad = c.enable_adaptive(AdaptiveConfig(queue_high=4, climb_hold_ms=0))
    ad.on_tick(SystemSignals(now_ms=500, queue_depth=100, max_pass_rate=100.0, min_rt_ms=20.0))
    assert OBS.gauge("sentinel_adaptive_ceiling").value > 0
    c.disable_adaptive()
    assert OBS.gauge("sentinel_adaptive_ceiling").value == -1
    assert OBS.gauge("sentinel_adaptive_level").value == 0


def test_the_adaptive_step_publishes_ceilings_into_the_columns(client_factory, vt):
    """Driven through the client: an overloaded signal row arms the
    ceiling, and the step uploads it into the live system columns."""
    c = client_factory()
    ad = c.enable_adaptive(AdaptiveConfig(queue_high=0, climb_hold_ms=0, min_ceiling=3.0))
    ups = c._sys_stage.uploads
    # more items than one batch: the first tick's step sees the rest queued
    c.check_batch(["api"] * (c.cfg.batch_size + 20))
    assert ad.ceiling == 3.0 and c._sys_stage.uploads == ups + 1
    assert float(c._rules_dev.system.max_thread) == 3.0
    assert c.adaptive_step_us > 0


# -- the watchdog ----------------------------------------------------------------


def test_watchdog_fails_stalled_tick_closed():
    from sentinel_tpu_torch.chaos import FaultPlan, FaultSpec, armed

    c = SentinelClient(cfg=small_engine_config(), mode="threaded", tick_interval_ms=1.0,
                       entry_timeout_s=10.0, watchdog_timeout_s=0.25, device="cpu")
    c.start()
    try:
        assert c.submit_acquire("wd/api").result(timeout=10.0)[0] == ERR.PASS
        before = OBS.counter("sentinel_watchdog_fired_total").value
        plan = FaultPlan(name="wd", seed=3, faults=[
            FaultSpec("runtime.watchdog.stall", "delay", delay_ms=1500, max_fires=1)
        ])
        with armed(plan):
            t0 = mono_s()
            v, _w = c.submit_acquire("wd/api").result(timeout=5.0)
            took = mono_s() - t0
            assert v == ERR.BLOCK_SYSTEM and took < 1.4
            assert OBS.counter("sentinel_watchdog_fired_total").value == before + 1
            _time.sleep(1.6)  # the stalled resolver finishes: it must not fan out again
        assert OBS.counter("sentinel_watchdog_fired_total").value == before + 1
        assert c._inflight_ticks == {}
        kinds = [e["kind"] for e in FL.FLIGHT.events(last=64)]
        assert "watchdog.fired" in kinds and "failpoint.fire" in kinds
        # serving goes on
        assert c.submit_acquire("wd/api").result(timeout=10.0)[0] == ERR.PASS
    finally:
        c.stop()


def test_watchdog_disabled_runs_no_thread(client):
    assert client._wd_thread is None
    client.try_entry("api").exit()
    assert client._inflight_ticks == {}


# -- disabled-mode overhead guards (<5 µs a call) ------------------------------------


def test_admission_shed_disabled_overhead_guard(client):
    assert not client._bp_armed
    n = 20_000
    t0 = mono_s()
    acc = sum(1 for _ in range(n) if client._admission_shed(1) is not None)
    elapsed = mono_s() - t0
    assert acc == 0 and elapsed / n < 5e-6


def test_adaptive_disabled_tick_hook_overhead_guard(client):
    assert client._adaptive is None
    n = 20_000
    t0 = mono_s()
    hits = 0
    for _ in range(n):
        ad = client._adaptive
        if ad is not None:  # pragma: no cover
            hits += 1
    assert hits == 0 and (mono_s() - t0) / n < 5e-6


def test_signal_collector_note_overhead():
    sc = SignalCollector()
    n = 20_000
    t0 = mono_s()
    for _ in range(n):
        sc.note_resolved(1, 0)
    assert (mono_s() - t0) / n < 5e-6


def test_adaptive_metrics_registered_on_the_ports_registry():
    text = OBS.exposition()
    for name in ("sentinel_shed_total", "sentinel_watchdog_fired_total", "sentinel_adaptive_ceiling",
                 "sentinel_adaptive_level"):
        assert name in text


# -- the overload simulator against the reference's -------------------------------------

#: the shortened schedule (time, not a defect: the full 100 / 200 / 120
#: steps take about a minute a run on the reference side here)
SHORT = dict(healthy_steps=20, storm_steps=40, recover_steps=30)


@pytest.mark.parametrize("adaptive", [True, False], ids=["controller-on", "controller-off"])
def test_overload_sim_matches_the_reference(adaptive):
    ref = JS.run_overload_sim(adaptive=adaptive, adaptive_cfg=JS.storm_controller_preset() if adaptive else None,
                              **SHORT)
    mine = TS.run_overload_sim(adaptive=adaptive, adaptive_cfg=TS.storm_controller_preset() if adaptive else None,
                               device="cpu", **SHORT)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    if adaptive:
        assert mine.max_level == DG.FAIL_CLOSED and mine.blocked > 0
        assert mine.p99_storm_ms < TS.run_overload_sim(adaptive=False, device="cpu", **SHORT).p99_storm_ms
    else:
        assert mine.blocked == 0 and mine.ladder_transitions == []
