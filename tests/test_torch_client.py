"""sentinel_tpu_torch's SentinelClient against the JAX package's, verdict
for verdict: the same scripted entry()/exit()/trace() stream on virtual
time, in mode="sync", through both clients.

The port runs on the CPU (its kernels' plain versions).  The JAX client
runs its default CPU engine path (jitted, plain scatters): its verdicts
equal the fused path's by the JAX package's own equivalence tests, and a
jitted interpret-mode fused client would compile for minutes.  RTs are
whole virtual milliseconds, so the fused path's 1/8 ms RT quantization is
exact on both sides.
"""

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

NO_PLANES = dict(device_telemetry=False, timeline_k=0, explain_k=0)


def _rules(m):
    return dict(
        flow=[
            m.FlowRule(resource="a", count=3),
            m.FlowRule(resource="b", count=10, control_behavior=m.CONTROL_RATE_LIMITER),
            m.FlowRule(resource="w", count=5, control_behavior=m.CONTROL_WARM_UP, warm_up_period_sec=2),
            m.FlowRule(resource="o", count=2, limit_app="good"),
        ],
        degrade=[m.DegradeRule(resource="c", grade=m.CB_STRATEGY_ERROR_COUNT, count=2, time_window=1, min_request_amount=1)],
        authority=[m.AuthorityRule(resource="d", limit_app="bad", strategy=m.AUTHORITY_BLACK)],
        system=[m.SystemRule(qps=6)],
    )


def _drive(client, m, seed: int, n: int = 90):
    """Scripted traffic; returns the outcome of every entry attempt."""
    rules = _rules(m)
    client.flow_rules.load(rules["flow"])
    client.degrade_rules.load(rules["degrade"])
    client.authority_rules.load(rules["authority"])
    client.system_rules.load(rules["system"])
    rng = np.random.default_rng(seed)
    vt = client.time
    held = []
    out = []
    for _ in range(n):
        res = str(rng.choice(["a", "b", "c", "d", "w", "o", "x"]))
        origin = str(rng.choice(["", "bad", "good"]))
        inbound = bool(rng.random() < 0.4)
        prio = bool(rng.random() < 0.2)
        try:
            e = client.entry(res, origin=origin, inbound=inbound, prioritized=prio)
            out.append(("pass", res, e.wait_ms))
            held.append(e)
        except m.BlockException as exc:
            out.append((type(exc).__name__, res, 0))
        vt.advance(int(rng.integers(0, 120)))
        while held and rng.random() < 0.6:
            e = held.pop(int(rng.integers(0, len(held))))
            if e.resource == "c" and rng.random() < 0.7:
                e.trace(RuntimeError("boom"))
            e.exit()
    for e in held:
        e.exit()
    return out


def _jax_client():
    """The JAX client, with every column upload handed a private copy.

    On the CPU backend ``jnp.asarray`` may alias a numpy buffer instead of
    copying it, and the JAX client reuses its two-slot staging buffers — so
    a cached column could change under it between ticks and its verdicts
    vary run to run (see ROADMAP.md, Queue C).  The copy removes that and
    nothing else."""
    jc = JaxClient(cfg=jax_small_cfg(**NO_PLANES), time_source=JaxVT(1_000), mode="sync")
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    return jc


@pytest.mark.parametrize("seed", [0, 1])
def test_client_matches_jax_client_verdict_for_verdict(seed):
    jc = _jax_client()
    tc = SentinelClient(
        cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES),
        time_source=VirtualTimeSource(1_000),
        mode="sync",
        device="cpu",
    )
    jc.start()
    tc.start()
    try:
        want = _drive(jc, jst, seed)
        got = _drive(tc, tst, seed)
    finally:
        jc.stop()
        tc.stop()
    assert got == want
    kinds = {o[0] for o in got}
    # the stream exercises every rule kind the port carries
    assert {"pass", "FlowException", "DegradeException", "AuthorityException", "SystemBlockException"} <= kinds


def test_client_fails_tick_closed_on_corrupt_wire(monkeypatch):
    from sentinel_tpu_torch.ops import wire as WIRE

    tc = SentinelClient(
        cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES),
        time_source=VirtualTimeSource(1_000),
        mode="sync",
        device="cpu",
    )
    tc.start()
    real = WIRE.unpack

    def corrupt(data, lo):
        b = bytearray(data)
        b[-1] ^= 0x5A
        return real(bytes(b), lo)

    monkeypatch.setattr(WIRE, "unpack", corrupt)
    with pytest.raises(tst.SystemBlockException):
        tc.entry("anything")
    monkeypatch.setattr(WIRE, "unpack", real)
    tc.entry("anything").exit()
    assert tc.wire_decode_failures == 1
    tc.stop()


def test_param_rules_raise_not_implemented():
    """Param rules load, cluster-mode ones too (the cluster layer is
    ported: they are kept out of the compiled ruleset and consult the
    token service); what still raises is a config with an unported stage
    on (the unpacked wire, ``packed_wire=False``); the observability
    planes, the sketch tier and ``seg_fallback=True`` are ported and
    build."""
    tc = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES), mode="sync", device="cpu")
    tc.param_flow_rules.load([tst.ParamFlowRule(resource="p", count=1, param_idx=0)])
    assert "param" in tc._features
    tc.param_flow_rules.load([tst.ParamFlowRule(resource="p", count=1, cluster_mode=True, cluster_flow_id=5)])
    assert len(tc.param_flow_rules.get()) == 1
    assert set(tc._cluster_param_by_res) == {"p"}
    assert "param" not in tc._features  # not compiled while the cluster is not degraded
    tc.param_flow_rules.load([])
    assert "param" not in tc._features  # the stage is on only while param rules are loaded
    with pytest.raises(NotImplementedError):
        SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, packed_wire=False), mode="sync", device="cpu")
    fallback = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, seg_effects=True, seg_fallback=True),
                              mode="sync", device="cpu")
    assert fallback.cfg.seg_fallback
    planes = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True), mode="sync", device="cpu")
    assert planes.explain_plane is not None and planes.cfg.device_telemetry
    sketch = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, sketch_stats=True), mode="sync", device="cpu")
    assert sketch.hotset is not None


def test_facade_quick_start_on_cpu():
    tst.reset()
    try:
        tst.init(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES), mode="sync", device="cpu")
        tst.load_flow_rules([tst.FlowRule(resource="HelloWorld", count=2)])
        seen = []
        for _ in range(4):
            try:
                with tst.entry("HelloWorld"):
                    seen.append("pass")
            except tst.BlockException:
                seen.append("block")
        assert seen == ["pass", "pass", "block", "block"]
    finally:
        tst.reset()


def test_threaded_client_under_contention_loses_no_entry_or_exit():
    """More request threads than cores, a short switch interval: every
    entry resolves, and once every exit has landed the concurrency rows
    are back to zero (a lost or doubled completion would leave them off)."""
    import sys
    import threading

    tc = SentinelClient(
        cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES), mode="threaded",
        device="cpu", entry_timeout_s=30.0,
    )
    tc.start()
    tc.flow_rules.load([tst.FlowRule(resource="hot", count=1e6)])
    outcomes = []
    lock = threading.Lock()

    def worker(i):
        mine = []
        for k in range(25):
            try:
                with tc.entry("hot" if k % 2 else f"r{i % 5}"):
                    mine.append("pass")
            except tst.BlockException:
                mine.append("block")
        with lock:
            outcomes.extend(mine)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(outcomes) == 16 * 25 and outcomes.count("pass") == 16 * 25
    tc.tick_once()  # land any exit still queued
    tc.stop()
    assert int(tc._state.concurrency.sum()) == 0


def test_a_tick_that_cannot_run_fails_its_entries_closed(monkeypatch):
    """A tick that raises (a lost device, say) resolves its waiting entries
    as system blocks instead of leaving them to time out."""
    tc = SentinelClient(
        cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES), mode="threaded",
        device="cpu", entry_timeout_s=30.0,
    )
    tc.start()

    def broken(*a, **k):
        raise RuntimeError("device lost")

    real = tc._tick
    tc._tick = broken
    try:
        with pytest.raises(tst.SystemBlockException):
            tc.entry("anything")
    finally:
        tc._tick = real
    tc.entry("anything").exit()
    tc.stop()


# -- the segment path (presort, unsort, seg_u sizing, static ranks) ----------

SEG = dict(use_mxu_tables=True, fused_effects=True, seg_effects=True, seg_fallback=False, **NO_PLANES)
SINGLE_LANE = dict(flow_rules_per_resource=1, degrade_rules_per_resource=1, param_rules_per_resource=1)


# -- hot-parameter rules through the client ------------------------------------


def _param_rules(m, swapped=False):
    """QPS and THREAD grade, two durations, an exception item; on "pa" one
    rule an argument.  ``swapped`` lists pa's rules the other way round,
    which swaps the lanes its two arguments hash into."""
    pa = [
        m.ParamFlowRule(resource="pa", count=2, duration_in_sec=1, param_idx=0),
        m.ParamFlowRule(resource="pa", count=2, param_idx=1, grade=m.GRADE_THREAD),
    ]
    return (pa[::-1] if swapped else pa) + [
        m.ParamFlowRule(resource="pb", count=1, duration_in_sec=2,
                        param_flow_item_list=[m.ParamFlowItem(object="vip", count=3)]),
        m.ParamFlowRule(resource="pc", count=1, grade=m.GRADE_THREAD),
    ]


def _drive_param(client, m, seed: int, n: int = 80):
    """Scripted traffic with arguments; a rule reload at the half changes
    the lane map.  Every entry exits at the end."""
    client.flow_rules.load([m.FlowRule(resource="pa", count=6), m.FlowRule(resource="x", count=2)])
    client.param_flow_rules.load(_param_rules(m))
    rng = np.random.default_rng(seed)
    held, out = [], []
    for i in range(n):
        if i == n // 2:
            # a held entry's release lanes were hashed by the OLD map: exit
            # them first, so that every THREAD acquire finds its row again
            while held:
                held.pop().exit()
            client.param_flow_rules.load(_param_rules(m, swapped=True))
        res = str(rng.choice(["pa", "pb", "pc", "x"]))
        args = [str(rng.choice(["u1", "u2", "vip"])), int(rng.integers(0, 3))][: int(rng.integers(0, 3))]
        try:
            e = client.entry(res, args=args)
            out.append(("pass", res, tuple(args)))
            held.append(e)
        except m.BlockException as exc:
            out.append((type(exc).__name__, res, tuple(args)))
        client.time.advance(int(rng.integers(0, 150)))
        while held and rng.random() < 0.4:
            held.pop(int(rng.integers(0, len(held)))).exit()
    for e in held:
        e.exit()
    return out


@pytest.mark.parametrize("path", ["fused", "seg-four", "seg-single"])
def test_param_client_matches_jax_client_verdict_for_verdict(path):
    """Param rules and ``args`` through both clients: hashed lanes by the
    rule compile's lane map, THREAD-grade release on exit(), a reload that
    changes the lane map — on the per-item fused path and on the segment
    path (4 lanes and single lanes, where the hashes ride the presort)."""
    extra = SINGLE_LANE if path == "seg-single" else {}
    flags = dict(use_mxu_tables=True, fused_effects=True, **NO_PLANES) if path == "fused" else SEG
    jc = JaxClient(cfg=jax_small_cfg(**NO_PLANES, **extra), time_source=JaxVT(1_000), mode="sync")
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    tc = SentinelClient(
        cfg=small_engine_config(**flags, **extra), time_source=VirtualTimeSource(1_000),
        mode="sync", device="cpu",
    )
    jc.start()
    tc.start()
    try:
        want = _drive_param(jc, jst, 3)
        got = _drive_param(tc, tst, 3)
        lanes = (tc.param_lane("pa", 0), tc.param_lane("pa", 1), jc.param_lane("pa", 0), jc.param_lane("pa", 1))
        jstore = [np.asarray(x) for x in (jc._state.pcms, jc._state.pcms_epochs, jc._state.pconc)]
    finally:
        jc.stop()
        tc.stop()
    assert got == want
    kinds = {(o[0], o[1]) for o in got}
    assert ("ParamFlowException", "pb") in kinds and ("ParamFlowException", "pc") in kinds
    assert ("FlowException", "x") in kinds and ("pass", "pa") in kinds
    assert lanes == (1, 0, 1, 0)  # the reload swapped pa's lanes, in both clients
    # every THREAD-grade acquire was released on exit()
    assert int(tc._state.pconc.sum()) == 0 and int(tc._state.pcms.sum()) > 0
    for mine, theirs in zip((tc._state.pcms, tc._state.pcms_epochs, tc._state.pconc), jstore):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    assert tc.seg_dropped_total == 0


def test_param_hashes_follow_the_lane_map():
    from sentinel_tpu_torch.core.rule_tensors import hash_param

    tc = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES), mode="sync", device="cpu")
    assert tc.param_hashes("r", ["a", "b"]) == (hash_param("a"), 0)  # no rule: lane 0 reads args[0]
    assert tc.param_hashes("r", None) == (0, 0)
    tc.param_flow_rules.load([
        tst.ParamFlowRule(resource="r", count=1, param_idx=2),
        tst.ParamFlowRule(resource="r", count=1, param_idx=0),
        tst.ParamFlowRule(resource="r", count=1, param_idx=1),  # a third index: no lane left
    ])
    assert tc.param_hashes("r", ["a", "b", 7]) == (hash_param(7), hash_param("a"))
    assert tc.param_hashes("r", ["a"]) == (0, hash_param("a"))  # args[2] is absent
    assert (tc.param_lane("r", 2), tc.param_lane("r", 0), tc.param_lane("r", 1)) == (0, 1, None)
    assert tc.param_lane("other", 0) == 0 and tc.param_lane("other", 1) is None


@pytest.mark.parametrize("lanes", ["four", "single"])
def test_segment_client_matches_jax_client_verdict_for_verdict(lanes):
    """The port's client on the segment path (4 lanes: per-item checks;
    single lanes: the segment check phase) against the JAX client, entry
    for entry, PASS_WAIT waits included."""
    extra = SINGLE_LANE if lanes == "single" else {}
    jc = JaxClient(cfg=jax_small_cfg(**NO_PLANES, **extra), time_source=JaxVT(1_000), mode="sync")
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    tc = SentinelClient(
        cfg=small_engine_config(**SEG, **extra), time_source=VirtualTimeSource(1_000),
        mode="sync", device="cpu",
    )
    jc.start()
    tc.start()
    try:
        want = _drive(jc, jst, 5)
        got = _drive(tc, tst, 5)
    finally:
        jc.stop()
        tc.stop()
    assert got == want
    assert any(o[0] == "pass" and o[2] > 0 for o in got)  # paced (PASS_WAIT) entries
    assert tc.seg_dropped_total == 0
    # the rule set has an origin-limited rule: no scan-only ranks
    assert not tc.cfg.seg_static_ranks


def _queue(client, names, prio=()):
    """Queue one acquire per name (no origin, default context) and decide
    them all in ONE tick; returns (verdict, wait) per name."""
    from concurrent.futures import Future

    from sentinel_tpu_torch.runtime.client import AcquireRequest

    trash = client.cfg.trash_row
    reqs = [
        AcquireRequest(
            res=client.registry.resource_id(n), count=1, prio=1 if i in prio else 0,
            origin_id=-1, origin_node=trash, ctx_node=trash, ctx_name=-1, inbound=0,
            future=Future(),
        )
        for i, n in enumerate(names)
    ]
    client._acquires.extend(reqs)
    client.tick_once()
    return [r.future.result(timeout=5) for r in reqs]


def test_segment_client_unsorts_multi_item_ticks():
    """Ticks of many interleaved acquires: the segment client presorts them,
    and its verdicts and waits (the sidecar's rows are sorted positions)
    come back in submission order — equal to the per-item fused client's,
    since a stable sort keeps arrival order inside each resource."""
    rng = np.random.default_rng(9)
    rules = [
        tst.FlowRule(resource="a", count=3),
        tst.FlowRule(resource="b", count=50, control_behavior=tst.CONTROL_RATE_LIMITER, max_queueing_time_ms=500),
        tst.FlowRule(resource="c", count=2),
    ]
    outs = []
    for cfg in (small_engine_config(**SEG, **SINGLE_LANE), small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES)):
        c = SentinelClient(cfg=cfg, time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
        c.start()
        c.flow_rules.load(rules)
        for n in ("a", "b", "c", "d", "e"):
            c.registry.resource_id(n)
        rng = np.random.default_rng(9)
        got = []
        for _ in range(4):
            names = [str(x) for x in rng.choice(["a", "b", "c", "d", "e"], size=40)]
            got.append(_queue(c, names, prio=set(rng.choice(40, size=5).tolist())))
            c.time.advance(300)
        c.stop()
        outs.append((got, c))
    (seg, sc), (fused, _fc) = outs
    assert sc.cfg.seg_static_ranks  # DIRECT / default rules on single lanes
    assert seg == fused
    flat = [v for tick in seg for v in tick]
    assert any(w > 0 for _v, w in flat) and any(v != 0 for v, _w in flat)


def test_rule_loads_set_seg_static_ranks():
    c = SentinelClient(cfg=small_engine_config(**SEG, **SINGLE_LANE), mode="sync", device="cpu")
    c.flow_rules.load([tst.FlowRule(resource="a", count=3)])
    assert c.cfg.seg_static_ranks
    c.flow_rules.load([tst.FlowRule(resource="a", count=3, limit_app="bad")])
    assert not c.cfg.seg_static_ranks
    c.flow_rules.load([tst.FlowRule(resource="a", count=3, strategy=tst.STRATEGY_RELATE, ref_resource="b")])
    assert not c.cfg.seg_static_ranks
    c.flow_rules.load([])
    assert c.cfg.seg_static_ranks
    four = SentinelClient(cfg=small_engine_config(**SEG), mode="sync", device="cpu")
    four.flow_rules.load([tst.FlowRule(resource="a", count=3)])
    assert not four.cfg.seg_static_ranks  # 4 lanes: the per-item checks rank


def _wide_client(batch=512, **extra):
    cfg = small_engine_config(
        **SEG, max_resources=512, max_nodes=1024, batch_size=batch, complete_batch_size=batch, **extra
    )
    c = SentinelClient(cfg=cfg, time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    c.start()
    return c


def test_seg_u_grows_before_an_overflowing_tick():
    """200 distinct resources in a 256-row tick: more live segments than
    the automatic capacity (97).  The client sees it on the host and grows
    seg_u to ceil((1.25 * 200 + 128) / 128) * 128 = 384 before the tick
    runs, so nothing fails closed."""
    from sentinel_tpu_torch.ops import engine_seg as ES

    c = _wide_client()
    assert ES.seg_capacity(c.cfg, 256) == 97
    out = _queue(c, [f"r{i}" for i in range(200)])
    assert c.cfg.seg_u == 384
    assert c.seg_dropped_total == 0 and all(v == 0 for v, _w in out)
    c.stop()


def test_a_light_tick_past_its_capacity_pins_seg_u_at_the_full_shape():
    """Batch 2,048: a 256-row light tick of 100 resources (101 segments with
    the trash padding) overflows the light shape's automatic capacity (97)
    while the full shape's (328) covers the grown peak (256).  The client
    pins seg_u at 328, so every shape holds the tick and nothing fails
    closed."""
    from sentinel_tpu_torch.ops import engine_seg as ES

    c = _wide_client(batch=2048)
    assert ES.seg_capacity(c.cfg, 256) == 97 and ES.seg_capacity(c.cfg, 2048) == 328
    out = _queue(c, [f"r{i}" for i in range(100)])
    assert c.cfg.seg_u == 328
    assert c.seg_dropped_total == 0 and all(v == 0 for v, _w in out)
    c.stop()


def test_seg_dropped_total_counts_items_failed_closed(monkeypatch):
    """Without the resize, the segment check phase (single lanes) fails the
    overflow segments' items closed as system blocks, and the wire's count
    lands in seg_dropped_total."""
    c = _wide_client(**SINGLE_LANE)
    monkeypatch.setattr(c, "_note_seg_count", lambda segs, b: None)
    out = _queue(c, [f"r{i}" for i in range(200)])
    from sentinel_tpu_torch.core.errors import BLOCK_SYSTEM

    blocked = [i for i, (v, _w) in enumerate(out) if v == BLOCK_SYSTEM]
    # one resource a segment: segments 97..199 lie past the capacity
    assert c.seg_dropped_total == len(blocked) == 200 - 97
    assert blocked == list(range(97, 200))
    c.stop()


def test_presort_copy_matches_lexsort_and_the_jax_package():
    from sentinel_tpu.native import ring as RING
    from sentinel_tpu.runtime.client import SentinelClient as JC

    from sentinel_tpu_torch.runtime import presort as PS

    rng = np.random.default_rng(4)
    n = 3000
    keys = [rng.integers(-1, k, n).astype(np.int32) for k in (50, 3, 4, 2, 5)]
    order, inv = PS.batch_sort5(*keys)
    np.testing.assert_array_equal(order, np.lexsort(tuple(reversed(keys))))
    np.testing.assert_array_equal(inv[order], np.arange(n))
    jorder, jinv = RING.batch_sort5(*keys)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(inv, jinv)
    order3, inv3 = PS.batch_sort3(*keys[:3])
    jorder3, jinv3 = RING.batch_sort3(*keys[:3], want_inv=True)
    np.testing.assert_array_equal(order3, jorder3)
    np.testing.assert_array_equal(inv3, jinv3)
    cols = [k[order] for k in keys]
    assert PS.host_seg_count(cols) == JC._host_seg_count(cols)
    assert PS.host_seg_count([np.zeros(0, np.int32)]) == 0
