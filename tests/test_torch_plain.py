"""The port's plain effects path against the JAX package's.

The reference runs its fused path only when ``fused_effects`` AND
``use_mxu_tables`` are set (``ops/engine._use_fused``); every other config
— its default ``small_engine_config()`` among them — runs the plain
per-table scatter path, which carries counts exactly up to 65,535 an item
where the fused path clamps them to ``max_batch_count``.  The port selects
its path the same way.

- the count-400 case: a sync client, one QPS rule of 1,000 and three
  entries of 400 — the third must block, as in the reference;
- the plain tick against the JAX plain tick (eager, ``jax.disable_jit``)
  with counts of 256–65,535 and completions with large success and error
  counts, on ``fused_effects=False`` and on ``fused_effects=True`` without
  the one-hot tables: integer state leaves and the wire EQUAL, float
  leaves within rtol=1e-6 / atol=1e-4 (the two packages add float32 values
  in a different order);
- the port's client against the JAX client on ``small_engine_config()``'s
  defaults, verdict for verdict;
- the plain table helpers and the param class-table read against the
  reference's ``use_mxu_tables=False`` branches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sentinel_tpu as jst
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.ops import param as JP
from sentinel_tpu.ops import tables as JT
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.runtime.registry import Registry as JaxRegistry
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch.core import rules as TR
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import param as PM
from sentinel_tpu_torch.ops import tables as T
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.runtime.registry import Registry
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests import torch_harness as H
from tests.test_torch_engine import _assert_states_match, _jax_tick, _port_tick

NO_PLANES = dict(device_telemetry=False, timeline_k=0, explain_k=0)
#: the two plain configs: fused_effects off, and fused_effects on without
#: the one-hot tables (the reference's _use_fused is False for both)
PLAIN = {
    "unfused": dict(fused_effects=False),
    "no-mxu": dict(fused_effects=True, use_mxu_tables=False),
}
NOWS = [1_000, 1_130, 4_050]


def _count_400(cfg):
    c = SentinelClient(cfg=cfg, time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    c.start()
    out = []
    try:
        c.flow_rules.load([tst.FlowRule(resource="r", count=1000)])
        for _ in range(3):
            try:
                c.entry("r", count=400).exit()
                out.append("pass")
            except tst.BlockException as exc:
                out.append(type(exc).__name__)
    finally:
        c.stop()
    return out


def test_fused_flag_without_mxu_tables_counts_400_exactly():
    """``small_engine_config(fused_effects=True)`` has no one-hot tables, so
    the reference runs its plain path and counts each entry as 400: the
    third entry takes the window to 1,200 > 1,000 and blocks.  (Clamped
    to 255 a count, as the fused path does, all three would pass.)"""
    assert _count_400(small_engine_config(fused_effects=True, **NO_PLANES)) == [
        "pass", "pass", "FlowException",
    ]
    # the fused path proper clamps, in both packages
    assert _count_400(small_engine_config(fused_effects=True, use_mxu_tables=True, **NO_PLANES)) == [
        "pass", "pass", "pass",
    ]


@pytest.mark.parametrize("flags", [dict(fused_effects=False), dict(fused_effects=True),
                                   dict(fused_effects=True, seg_effects=True)])
def test_use_fused_is_the_references_rule(flags):
    from sentinel_tpu.ops import fused as JFU

    for mxu in (False, True):
        t = small_engine_config(use_mxu_tables=mxu, packed_wire=True, **flags)
        j = jax_small_cfg(use_mxu_tables=mxu, packed_wire=True, **flags)
        assert E._use_fused(t) == JE._use_fused(j) == (flags["fused_effects"] and mxu and JFU.available())
        E.check_supported(t)
        # the wire's count columns narrow only where the client clamps
        assert (WIRE.acquire_wire_dtypes(t).get("count") is None) == (not E._use_fused(t))


def _big_workload(tcfg, treg, seed, b):
    """H.workload with counts of 256–65,535 on half the acquires, large
    success and error counts on the completions, and RTs off the 1/8 ms
    grid (the plain path lands raw RT sums)."""
    w = H.workload(tcfg, treg, seed=seed, b=b, param=True)
    rng = np.random.default_rng(seed + 7)
    a, c = w["acq"], w["comp"]
    a["count"] = np.where(rng.random(b) < 0.5, 1, rng.integers(256, 65536, b)).astype(np.int32)
    c["success"] = rng.integers(0, 65536, b).astype(np.int32)
    c["error"] = np.where(rng.random(b) < 0.4, rng.integers(1, 65536, b), 0).astype(np.int32)
    c["rt"] = (rng.random(b) * 150.0).astype(np.float32)
    return w


@pytest.mark.parametrize("path", sorted(PLAIN))
def test_plain_tick_matches_jax_plain_tick(path):
    b = 64
    kw = dict(batch_size=b, complete_batch_size=b, packed_wire=True, **NO_PLANES, **PLAIN[path])
    jcfg, tcfg = jax_small_cfg(**kw), small_engine_config(**kw)
    assert not E._use_fused(tcfg) and not JE._use_fused(jcfg)
    jreg, treg = JaxRegistry(jcfg), Registry(tcfg)
    H.intern(jreg)
    H.intern(treg)
    rules_j, rules_t = H.make_rules(JR, param=True), H.make_rules(TR, param=True)
    # a system budget the big counts cross mid-batch (the float32 rank)
    rules_j["system_rules"] = [JR.SystemRule(qps=300_000)]
    rules_t["system_rules"] = [TR.SystemRule(qps=300_000)]
    jrs = JE.compile_ruleset(jcfg, jreg, **rules_j)
    trs = E.compile_ruleset(tcfg, treg, device="cpu", **rules_t)
    with jax.disable_jit():
        js = JE.init_state(jcfg)
    ts = E.init_state(tcfg, "cpu")
    seen = set()
    for step, now in enumerate(NOWS):
        w = _big_workload(tcfg, treg, 31 * step + 5, b)
        js, jwire, jwait = _jax_tick(jcfg, js, jrs, w, now, features=H.PARAM_FEATURES)
        ts, twire, twait = _port_tick(tcfg, ts, trs, w, now, features=H.PARAM_FEATURES)
        assert twire.tobytes() == jwire.tobytes(), step
        np.testing.assert_array_equal(twait, jwait)
        _assert_states_match(tcfg, js, ts)
        seen |= set(WIRE.unpack(twire.tobytes(), WIRE.layout_for(tcfg, b)).verdict.tolist())
    # pass, flow, degrade, system, param and authority verdicts all occurred
    assert {0, 2, 3, 4, 5, 6} <= seen
    # the counts landed unclamped: the windows hold sums far past 255 an item
    assert int(ts.win_sec.run.max()) > 65_535


def _drive_counts(client, m, seed: int, n: int = 60):
    """Scripted entries with counts up to 65,535 on QPS, THREAD and
    rate-limited rules plus a system budget; returns every outcome."""
    client.flow_rules.load([
        m.FlowRule(resource="a", count=2_000),
        m.FlowRule(resource="t", count=70_000, grade=m.GRADE_THREAD),
        m.FlowRule(resource="b", count=50_000, control_behavior=m.CONTROL_RATE_LIMITER),
    ])
    client.system_rules.load([m.SystemRule(qps=150_000)])
    rng = np.random.default_rng(seed)
    held, out = [], []
    for _ in range(n):
        res = str(rng.choice(["a", "t", "b", "x"]))
        cnt = int(rng.choice([1, 300, 4_000, 65_535]))
        try:
            e = client.entry(res, count=cnt, inbound=bool(rng.random() < 0.5))
            out.append(("pass", res, cnt, e.wait_ms))
            held.append(e)
        except m.BlockException as exc:
            out.append((type(exc).__name__, res, cnt, 0))
        client.time.advance(int(rng.integers(0, 200)))
        while held and rng.random() < 0.5:
            held.pop(int(rng.integers(0, len(held)))).exit()
    for e in held:
        e.exit()
    return out


def test_plain_client_matches_jax_client_on_the_default_config():
    """``small_engine_config()`` as it comes (the plain path, the planes on)
    through both clients, verdict for verdict."""
    jc = JaxClient(cfg=jax_small_cfg(), time_source=JaxVT(1_000), mode="sync")
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    tc = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                        device="cpu")
    assert not E._use_fused(tc.cfg)
    jc.start()
    tc.start()
    try:
        want = _drive_counts(jc, jst, 11)
        got = _drive_counts(tc, tst, 11)
    finally:
        jc.stop()
        tc.stop()
    assert got == want
    kinds = {o[0] for o in got}
    assert {"pass", "FlowException", "SystemBlockException"} <= kinds
    # some large count passed whole
    assert any(o[0] == "pass" and o[2] > 255 for o in got)


def test_plain_table_helpers_match_the_reference():
    jcfg = jax_small_cfg()
    rng = np.random.default_rng(3)
    n = 40
    idx = rng.integers(-3, n + 3, 200).astype(np.int32)
    ivals = rng.integers(0, 65536, (200, 3)).astype(np.int32)
    fvals = (rng.random(200) * 100).astype(np.float32)
    table = rng.integers(0, 1000, (n, 3)).astype(np.int32)

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    t = torch.as_tensor
    same(T.big_scatter_add(t(table), t(idx), t(ivals), n), JT.big_scatter_add(jcfg, jnp.asarray(table),
                                                                              jnp.asarray(idx), jnp.asarray(ivals), n))
    same(T.histogram(t(idx), t(ivals), n), JT.histogram(jcfg, jnp.asarray(idx), jnp.asarray(ivals), n))
    same(T.small_scatter_add(t(table), t(idx), t(ivals)),
         JT.small_scatter_add(jcfg, jnp.asarray(table), jnp.asarray(idx), jnp.asarray(ivals)))
    np.testing.assert_allclose(
        T.histogram(t(idx), t(fvals), n).numpy(), np.asarray(JT.histogram(jcfg, jnp.asarray(idx), jnp.asarray(fvals), n)),
        rtol=1e-6, atol=1e-4,
    )
    # a max into a table whose untouched rows keep their value
    ftab = (rng.random(n) * 50).astype(np.float32)
    same(T.small_scatter_max(t(ftab), t(idx), t(fvals)),
         JT.small_scatter_max(jcfg, jnp.asarray(ftab), jnp.asarray(idx), jnp.asarray(fvals), -1.0))
    col = rng.integers(0, 1 << 20, n).astype(np.int32)
    same(T.lane_gather_1col_int(t(col), t(idx), n), JT.lane_gather_1col_int(jcfg, jnp.asarray(col), jnp.asarray(idx), n))


def test_param_plain_estimate_matches_the_reference_and_the_fused_read():
    tcfg, jcfg = small_engine_config(), jax_small_cfg()
    rng = np.random.default_rng(5)
    C = 3
    wtab = rng.integers(0, 1 << 26, (tcfg.param_depth, tcfg.param_width, C)).astype(np.float32)
    rows = rng.integers(0, tcfg.param_width, (90, tcfg.param_depth)).astype(np.int32)
    cls = rng.integers(-1, C + 1, 90).astype(np.int32)
    got = PM.estimate(tcfg, torch.as_tensor(wtab), torch.as_tensor(rows), torch.as_tensor(cls))
    want = JP.estimate(jcfg, jnp.asarray(wtab), jnp.asarray(rows), jnp.asarray(cls))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fused = PM.estimate_fused(tcfg, torch.as_tensor(wtab), torch.as_tensor(rows), torch.as_tensor(cls))
    np.testing.assert_array_equal(got.numpy(), fused.numpy())
