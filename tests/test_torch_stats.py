"""The port's control-plane readers and live window reshape against the JAX
package's client.

Both clients run in mode="sync" on one virtual clock each (the same
start, the same steps) and take the same scripted stream; the port runs
its fused engine on the CPU, the JAX client its default CPU engine
(jitted plain scatters: equal verdicts by the JAX package's own tests,
see tests/test_torch_client.py).  Held equal:

- ``stats.snapshot``, ``stats.resource``, ``stats.origin``,
  ``stats.entry_node`` and ``stats.registry_peek`` at several points of
  the stream, with entries held open (concurrency), origins, a context,
  traced errors and blocks;
- ``rt_quantiles`` (inbound entries with RTs on the virtual clock) and
  ``top_params``, the 512-value decimation of the hot-param counters
  included;
- the sketch ids' windowed stats (``_sketch_stats`` through ``resource``
  and ``snapshot``) on a sketch configuration;
- the three scenarios of tests/test_window_reshape.py, verdict for
  verdict, with every leaf of the engine state after each swap.

Tolerances: integers (counts, concurrency, verdicts, integer state
leaves) are EQUAL; floats (QPS, average and minimum RT, quantile edges,
float state leaves) within rtol 1e-6 and atol 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.datasource.property import DynamicSentinelProperty as JaxProperty
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import state as S
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.datasource.property import DynamicSentinelProperty
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

NO_PLANES = dict(device_telemetry=False, timeline_k=0, explain_k=0)
RTOL, ATOL = 1e-6, 1e-4


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


def assert_close(got, want, path="$"):
    """Recursive equality: ints and strings equal, floats within the
    tolerances in this module's docstring."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got.keys()) == list(want.keys()), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), (path, got)
        assert got == pytest.approx(want, rel=RTOL, abs=ATOL), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _readers(c, names, origins, qs=(0.5, 0.9, 0.99)):
    """Everything the control plane reads off a client, as plain data."""
    return dict(
        snapshot=c.stats.snapshot(),
        resource={n: c.stats.resource(n) for n in names + ["never-seen"]},
        origin={f"{r}|{o}": c.stats.origin(r, o) for r in names for o in origins},
        entry=c.stats.entry_node(),
        peek={n: c.stats.registry_peek(n) for n in names + ["never-seen"]},
        rtq=c.rt_quantiles(qs),
        top={n: c.top_params(n, 8) for n in names},
    )


def _rules(m):
    return dict(
        flow=[m.FlowRule(resource="a", count=4), m.FlowRule(resource="b", count=6, grade=m.GRADE_THREAD)],
        degrade=[m.DegradeRule(resource="c", grade=m.CB_STRATEGY_ERROR_COUNT, count=3, time_window=1,
                               min_request_amount=1)],
        authority=[m.AuthorityRule(resource="d", limit_app="bad", strategy=m.AUTHORITY_BLACK)],
    )


def _drive(c, m, seed, checkpoints):
    """One seeded script: entries on a..e with origins, a context, one
    argument, inbound flags, held entries and traced errors; the clock
    steps 1-40 ms between calls.  Returns the verdicts and the readers at
    each checkpoint (an entry index)."""
    r = _rules(m)
    c.flow_rules.load(r["flow"])
    c.degrade_rules.load(r["degrade"])
    c.authority_rules.load(r["authority"])
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c", "d", "e"]
    origins = ["good", "bad"]
    held, verdicts, reads = [], [], []
    for i in range(120):
        name = names[rng.integers(len(names))]
        origin = origins[rng.integers(2)] if rng.random() < 0.5 else None
        args = [f"v{int(rng.zipf(1.5)) % 40}"]
        inbound = bool(rng.random() < 0.6)
        try:
            if rng.random() < 0.2:
                with c.context("ctxA", origin or ""):
                    e = c.entry(name, args=args, inbound=inbound)
            else:
                e = c.entry(name, args=args, inbound=inbound, origin=origin)
            verdicts.append("pass")
        except m.BlockException as exc:
            verdicts.append(type(exc).__name__)
            e = None
        if e is not None:
            if rng.random() < 0.25:
                held.append(e)
            else:
                c.time.advance(int(rng.integers(1, 40)))
                if rng.random() < 0.3:
                    e.trace(RuntimeError("boom"))
                e.exit()
        if held and rng.random() < 0.3:
            held.pop(0).exit()
        c.time.advance(int(rng.integers(1, 25)))
        if i in checkpoints:
            c.tick_once()
            reads.append(_readers(c, names, origins))
    return verdicts, reads


@pytest.mark.parametrize("seed", [0, 1])
def test_readers_match_jax_client(seed):
    jc, tc = _pair()
    try:
        want = _drive(jc, jst, seed, {30, 75, 119})
        got = _drive(tc, tst, seed, {30, 75, 119})
    finally:
        jc.stop()
        tc.stop()
    assert got[0] == want[0]
    assert {"pass", "FlowException", "AuthorityException"} <= set(want[0])
    assert_close(got[1], want[1])
    # the script exercised what the readers read
    reads = want[1]
    assert any(s["curThreadNum"] > 0 for r in reads for s in r["snapshot"].values())
    assert any(s is not None and s["passQps"] > 0 for r in reads for s in r["origin"].values())
    assert any(q > 0 for r in reads for q in r["rtq"].values())
    assert any(s["exceptionQps"] > 0 for r in reads for s in r["snapshot"].values())
    assert all(len(v) > 1 for k, v in reads[-1]["top"].items() if reads[-1]["peek"][k] is not None)


def test_top_params_decimation_matches_jax_client():
    """Past 512 distinct values a resource's counter keeps its 256 most
    seen (a stable sort: ties keep first-seen order) — on the entry path
    and on the counter itself, value for value."""
    jc, tc = _pair()
    try:
        for c, m in ((jc, jst), (tc, tst)):
            c.param_flow_rules.load([m.ParamFlowRule(resource="p", count=1000, param_idx=1)])
        rng = np.random.default_rng(7)
        values = [f"u{int(k)}" for k in rng.zipf(1.3, 1_400) % 900]
        for c in (jc, tc):
            for v in values[:40]:
                c.entry("p", args=["other", v]).exit()  # lane 0 hashes args[1]
            for v in values[40:]:
                c._note_hot_param("p", v)
            c._note_hot_param("p", ["unhashable"])  # skipped, as in the reference
        want, got = jc.top_params("p", 600), tc.top_params("p", 600)
    finally:
        jc.stop()
        tc.stop()
    assert got == want
    assert 256 <= len(want) <= 512  # decimated at least once
    assert tc._hot_params["p"] == jc._hot_params["p"]


def _burn_exact(c):
    i = 0
    while not c.registry.is_sketch_id(c.registry.resource_id(f"burn-{i}")):
        i += 1


def test_sketch_id_stats_match_jax_client():
    """Names past the exact row space read the global sketch: the same
    estimates through ``resource`` and ``snapshot``, on SALSA (the
    default), at two times."""
    tiny = dict(max_resources=4, max_nodes=16, sketch_stats=True, sketch_width=512, sketch_depth=2,
                hotset_eval_s=1.0e9)
    jc, tc = _pair(**tiny)
    try:
        outs = []
        for c in (jc, tc):
            _burn_exact(c)
            rng = np.random.default_rng(3)
            tail = [f"tail-{k}" for k in range(6)]
            for k in rng.integers(0, 6, 60):
                e = c.entry(tail[k], inbound=True)
                c.time.advance(int(rng.integers(1, 9)))
                e.exit()
            c.tick_once()
            first = {n: c.stats.resource(n) for n in tail}
            snap = c.stats.snapshot()
            c.time.advance(700)
            c.tick_once()
            later = {n: c.stats.resource(n) for n in tail}
            outs.append((first, {n: snap[n] for n in tail}, later,
                         [c.registry.is_sketch_id(c.registry.peek_resource_id(n)) for n in tail]))
    finally:
        jc.stop()
        tc.stop()
    assert_close(outs[1], outs[0])
    assert all(outs[0][3])
    assert sum(s["passQps"] for s in outs[0][0].values()) >= 60.0  # sketch estimates overcount, never under


def _assert_state_matches(tc, jc):
    want = S.leaves(S.state_from_numpy(tc.cfg, jax.tree.map(np.asarray, jc._state), "cpu"))
    got = S.leaves(tc._state)
    assert want.keys() == got.keys()
    for k in want:
        a, b = want[k].numpy(), got[k].cpu().numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def _tries(c, name, n):
    return [c.try_entry(name) is not None for _ in range(n)]


def test_reshape_preserves_budget_under_traffic():
    """tests/test_window_reshape.py's first scenario on both clients."""
    jc, tc = _pair()
    try:
        out = []
        for c, m in ((jc, jst), (tc, tst)):
            c.flow_rules.load([m.FlowRule(resource="api", count=5)])
            before = _tries(c, "api", 3)
            c.update_window_shape(sample_count=4, window_ms=250)
            shape = (c.cfg.second_sample_count, c.cfg.second_window_ms)
            after = _tries(c, "api", 5)
            snap = c.stats.resource("api")
            c.time.advance(1100)
            reopened = c.try_entry("api") is not None
            out.append((before, shape, after, snap, reopened))
        _assert_state_matches(tc, jc)
    finally:
        jc.stop()
        tc.stop()
    assert_close(out[1], out[0])
    assert out[0][1] == (4, 250) and sum(out[0][2]) == 2 and out[0][4]
    assert out[0][3]["passQps"] == 5.0 and out[0][3]["blockQps"] == 3.0


def test_reshape_via_property_push():
    """The second scenario: a ``{"sampleCount": 5, "intervalMs": 1000}``
    push through a property; then a partial push that keeps the total."""
    jc, tc = _pair()
    try:
        out = []
        for c, m, prop in ((jc, jst, JaxProperty()), (tc, tst, DynamicSentinelProperty())):
            c.flow_rules.load([m.FlowRule(resource="p", count=4)])
            c.register_window_property(prop)
            first = _tries(c, "p", 2)
            prop.update_value({"sampleCount": 5, "intervalMs": 1000})
            shape = (c.cfg.second_sample_count, c.cfg.second_window_ms)
            second = _tries(c, "p", 4)
            c.time.advance(130)
            prop.update_value({"sampleCount": 2})
            partial = (c.cfg.second_sample_count, c.cfg.second_window_ms)
            third = _tries(c, "p", 3)
            out.append((first, shape, second, partial, third, c.stats.resource("p")))
        _assert_state_matches(tc, jc)
    finally:
        jc.stop()
        tc.stop()
    assert_close(out[1], out[0])
    assert out[0][1] == (5, 200) and sum(out[0][2]) == 2 and out[0][3] == (2, 500)


def test_reshape_rejects_capacity_changes():
    """The third scenario: ``migrate_state`` refuses a capacity change on
    both; the minute window reshapes too, and the state still matches."""
    jc, tc = _pair()
    try:
        from sentinel_tpu.ops import engine as JE

        for c, mod in ((jc, JE), (tc, E)):
            bad = dataclasses.replace(c.cfg, max_flow_rules=c.cfg.max_flow_rules * 2)
            with pytest.raises(ValueError):
                mod.migrate_state(c._state, c.cfg, bad, c.time.now_ms())
        for c, m in ((jc, jst), (tc, tst)):
            c.flow_rules.load([m.FlowRule(resource="q", count=3)])
            assert _tries(c, "q", 2) == [True, True]
            c.update_window_shape(minute_sample_count=30, minute_window_ms=2000)
            c.update_window_shape()  # nothing to change: no swap
        _assert_state_matches(tc, jc)
        assert [_tries(c, "q", 3) for c in (jc, tc)] == [[True, False, False]] * 2
    finally:
        jc.stop()
        tc.stop()
