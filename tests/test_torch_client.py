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
        cfg=small_engine_config(fused_effects=True, **NO_PLANES),
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
        cfg=small_engine_config(fused_effects=True, **NO_PLANES),
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
    tc = SentinelClient(cfg=small_engine_config(fused_effects=True, **NO_PLANES), mode="sync", device="cpu")
    with pytest.raises(NotImplementedError):
        tc.param_flow_rules.load([tst.ParamFlowRule(resource="p", count=1, param_idx=0)])
    with pytest.raises(NotImplementedError):
        SentinelClient(cfg=small_engine_config(fused_effects=True), mode="sync", device="cpu")


def test_facade_quick_start_on_cpu():
    tst.reset()
    try:
        tst.init(cfg=small_engine_config(fused_effects=True, **NO_PLANES), mode="sync", device="cpu")
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
        cfg=small_engine_config(fused_effects=True, **NO_PLANES), mode="threaded",
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
        cfg=small_engine_config(fused_effects=True, **NO_PLANES), mode="threaded",
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
