"""The port's unpacked-wire client (``packed_wire=False``) against the JAX
package's unpacked client, and against the port's own packed client.

Under ``packed_wire=False`` the tick returns the classic ``TickOutput``
tensors and the client reads them one by one: the verdict, then the
telemetry row, the timeline rows and the hot block, ``seg_dropped`` (from
the telemetry row, else a 4-byte read of its own on the segment path
without its fallback), and the wait column only when a verdict may be
PASS_WAIT.  Every column is a full upload (no dirty-column delta), in
full int32.

Held here, on sync clients on virtual time:

- tick by tick against the JAX package's unpacked client, on the fused,
  seg4 and seg1 configurations with the telemetry planes on and off: the
  verdicts and waits, the tx / rx bytes (``sentinel_wire_bytes_total``
  and the timeline's own path), the skipped columns (none), the adaptive
  signals the resolver feeds, ``seg_dropped``, and at the end the
  timeline's rows and the device-stat counters.  The JAX client runs its
  host path on the same flags with its jitted plain tick (as
  tests/torch_harness.jax_host_client does), whose telemetry row leaves the
  segment slots at 0, so ``sentinel_device_seg_live`` is held only
  between the port's own clients (below);
- the hot-set folds on a sketch configuration, against the JAX client;
- the port's unpacked client bit-identical to its packed one on the same
  traffic (tests/test_wire.py's golden test), the telemetry gauges
  included; ``explain()`` is empty unpacked;
- a readback or fan-out failpoint fails the tick closed and the next
  entry serves.

Tolerances: verdicts, waits, byte counts, counters and timeline rows
equal; the adaptive signals' floats within rtol 1e-6 and atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs import timeline as JTL
from sentinel_tpu.obs.registry import REGISTRY as JREG
from sentinel_tpu.runtime import client as JCL
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch.chaos import FaultPlan, FaultSpec, armed
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs import timeline as TTL
from sentinel_tpu_torch.obs.registry import REGISTRY as TREG
from sentinel_tpu_torch.runtime import client as TCL
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.test_torch_obs import COUNTERS, GAUGES
from tests.test_torch_stats import assert_close

FUSED = dict(use_mxu_tables=True, fused_effects=True)
SEG4 = dict(FUSED, seg_effects=True, seg_fallback=False)
SEG1 = dict(SEG4, flow_rules_per_resource=1, degrade_rules_per_resource=1, param_rules_per_resource=1)
PATHS = {"fused": FUSED, "seg4": SEG4, "seg1": SEG1}
PLANES = {"planes": {}, "no_planes": dict(device_telemetry=False, timeline_k=0, explain_k=0)}
NAMES = ("a", "w", "x", "b")
#: the sketch configuration of the hot-set fold (tests/test_torch_hotset.py)
HOT = dict(
    max_resources=32, max_nodes=64, sketch_stats=True, sketch_width=256, hotset_k=8,
    hotset_promote_qps=3.0, hotset_demote_qps=1.0, hotset_cooldown_s=30.0, hotset_eval_s=1.0e9,
)


def _jax_unpacked(monkeypatch, flags):
    """The JAX package's unpacked client on ``flags``' host path, its tick
    the jitted plain path (tests/torch_harness.jax_host_client, with the
    segment check phase's static ranks, which the client turns on for
    single-lane rules, off with the segment flags)."""
    from sentinel_tpu.ops import engine as JE

    real = JE.make_tick

    def plain_tick(c, *args, **kw):
        return real(dataclasses.replace(c, fused_effects=False, use_mxu_tables=False, seg_effects=False,
                                        seg_static_ranks=False), *args, **kw)

    monkeypatch.setattr(JE, "make_tick", plain_tick)
    jc = JaxClient(cfg=jax_small_cfg(**flags, packed_wire=False), time_source=JaxVT(1_000), mode="sync")
    upload = jc._dev_col  # a private copy per upload (ROADMAP.md Queue C)
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    return jc


def _port(flags, packed=False):
    return SentinelClient(cfg=small_engine_config(**flags, packed_wire=packed), time_source=VirtualTimeSource(1_000),
                          mode="sync", device="cpu")


def _signals(c):
    s = c._adaptive.signals
    return (s._pass_total, s._block_total, s._comp_total, float(s._dev_win_pass), float(s.rt_ewma_ms))


def _stat_values(reg):
    out = {}
    for name, labels in COUNTERS + [(g, None) for g in GAUGES]:
        m = reg.get(name, labels)
        out[(name, tuple(sorted((labels or {}).items())))] = None if m is None else m.value
    return out


def _drive(c, m, seed, rounds=7):
    """Object entries and exits, bulk blocks with counts, a rate-limited
    resource (PASS_WAIT rows), an error-count breaker and completions, one
    tick a call.  Returns each tick's (tx, rx, timeline rx, skipped)
    deltas, the adaptive signals and seg_dropped after it, and the
    verdicts with their waits."""
    jax_side = m is jst
    mod, tl = (JCL, JTL) if jax_side else (TCL, TTL)
    ctrs = (mod._C_WIRE["tx"], mod._C_WIRE["rx"], tl._C_WIRE["rx"], mod._C_COLS_SKIPPED)
    c._sys.sample = lambda: (0.25, 0.5)  # the host's load / CPU: pinned on both
    c.flow_rules.load([
        m.FlowRule(resource="a", count=4),
        m.FlowRule(resource="w", count=20, control_behavior=m.CONTROL_RATE_LIMITER, max_queueing_time_ms=400),
    ])
    c.degrade_rules.load([m.DegradeRule(resource="x", grade=m.CB_STRATEGY_ERROR_COUNT, count=2, time_window=1,
                                        min_request_amount=1)])
    c.enable_adaptive()
    for n in NAMES:
        c.registry.resource_id(n)
    ids = np.array([c.registry.peek_resource_id(n) for n in NAMES], np.int32)
    rng = np.random.default_rng(seed)
    steps, got = [], []

    def step(fn):
        before = [x.value for x in ctrs]
        r = fn()
        steps.append((tuple(x.value - b for x, b in zip(ctrs, before)), _signals(c), c.seg_dropped_total))
        return r

    for _ in range(rounds):
        names = [str(x) for x in rng.choice(NAMES, size=int(rng.integers(3, 9)))]
        got.append(step(lambda: c.check_batch(names, inbound=True)))
        blk = ids[rng.integers(0, len(NAMES), 30)]
        v, w = step(lambda: c.check_batch_ids(blk, counts=rng.integers(1, 3, 30).astype(np.int32)))
        got.append((v.tolist(), w.tolist()))
        for _k in range(2):  # the same block twice: packed, its varying columns skip
            v, w = step(lambda: c.check_batch_ids(blk))
            got.append((v.tolist(), w.tolist()))
        e = step(lambda: c.try_entry(str(rng.choice(NAMES))))
        got.append(None if e is None else (e.resource, e.wait_ms))
        if e is not None:
            c.time.advance(int(rng.integers(1, 9)))
            if e.resource == "x":
                e.trace(RuntimeError("business"))
            e.exit()
        step(lambda: c.submit_completion_block(blk[:12], np.full(12, 2.0, np.float32), error=(blk[:12] % 2).astype(np.int32)))
        c.time.advance(int(rng.integers(30, 260)))
        step(c.tick_once)
    return steps, got


@pytest.mark.parametrize("planes", list(PLANES))
@pytest.mark.parametrize("path", list(PATHS))
def test_unpacked_client_equals_the_jax_unpacked_client_tick_by_tick(monkeypatch, path, planes):
    flags = dict(PATHS[path], **PLANES[planes])
    jc = _jax_unpacked(monkeypatch, flags)
    tc = _port(flags)
    assert jc.cfg.packed_wire is False and tc.cfg.packed_wire is False
    jc.start()
    tc.start()
    try:
        j0, t0 = _stat_values(JREG), _stat_values(TREG)
        want_steps, want = _drive(jc, jst, 11)
        got_steps, got = _drive(tc, tst, 11)
        j1, t1 = _stat_values(JREG), _stat_values(TREG)
        span = (0, 2**62)
        if tc.timeline is not None:
            rows_t = [r.to_dict() for r in tc.timeline.find(None, *span)]
            assert rows_t == [r.to_dict() for r in jc.timeline.find(None, *span)] and rows_t
        else:
            assert jc.timeline is None
        assert tc.explain("a") == [] and jc.explain("a") == []
    finally:
        jc.stop()
        tc.stop()
    assert got == want
    assert [s[0] for s in got_steps] == [s[0] for s in want_steps]
    assert_close([s[1:] for s in got_steps], [s[1:] for s in want_steps])
    assert sum(s[0][3] for s in got_steps) == 0  # no column skipped: every column uploads
    assert sum(s[0][0] for s in got_steps) > 0 and sum(s[0][1] for s in got_steps) > 0
    assert any(w > 0 for out in got if isinstance(out, list) for _v, w in out)  # PASS_WAIT rows were read
    for key in j1:
        if key[0] == "sentinel_device_seg_live":
            continue  # the JAX plain tick leaves the segment slots at 0
        if key[0] in GAUGES:
            assert t1[key] == j1[key], key
        else:
            assert (t1[key] or 0) - (t0[key] or 0) == (j1[key] or 0) - (j0[key] or 0), key


def _hits(c, name, n, step_ms=5):
    out = []
    for _ in range(n):
        e = c.try_entry(name)
        out.append(e is not None)
        if e is not None:
            e.exit()
        c.time.advance(step_ms)
    return out


def test_unpacked_hot_set_folds_equal_the_jax_unpacked_client():
    """The hot block is its own read unpacked: the candidates it folds, and
    the rx bytes of each tick, equal the JAX client's."""
    jc = JaxClient(cfg=jax_small_cfg(**HOT, packed_wire=False), time_source=JaxVT(1_000), mode="sync")
    upload = jc._dev_col  # a private copy per upload (tests/test_torch_client.py)
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    tc = _port(dict(FUSED, **HOT))
    jc.start()
    tc.start()
    try:
        for c in (jc, tc):
            i = 0
            while not c.registry.is_sketch_id(c.registry.resource_id(f"burn-{i}")):
                i += 1
            assert c.registry.is_sketch_id(c.registry.resource_id("hot-svc"))
        rx = []
        for c, mod in ((jc, JCL), (tc, TCL)):
            r0 = mod._C_WIRE["rx"].value
            rx.append((_hits(c, "hot-svc", 8), mod._C_WIRE["rx"].value - r0))
        assert rx[1] == rx[0]
        assert tc.hotset._cand == jc.hotset._cand
        assert tc.hotset._cand[tc.registry.peek_resource_id("hot-svc")] >= 3.0
        for c in (jc, tc):
            c.hotset.evaluate_now()
        assert tc.hotset.promoted == jc.hotset.promoted and "hot-svc" in tc.hotset.promoted
    finally:
        jc.stop()
        tc.stop()


@pytest.mark.parametrize("path", list(PATHS))
def test_unpacked_client_is_bit_identical_to_the_packed_client(path):
    """tests/test_wire.py's golden test on the port: the packed client
    (one fused readback, narrow and delta uploads) and the unpacked one
    give the same verdicts, waits, timeline rows and folded telemetry on
    the same traffic; only the packed one skips columns, only the packed
    one explains."""
    out = {}
    for packed in (False, True):
        c = _port(PATHS[path], packed=packed)
        assert c.cfg.packed_wire is packed
        c.start()
        try:
            s0 = _stat_values(TREG)
            steps, got = _drive(c, tst, 5)
            s1 = _stat_values(TREG)
            rows = [r.to_dict() for r in c.timeline.find(None, 0, 2**62)]
            explained = len(c.explain("a"))
        finally:
            c.stop()
        # every folded series but the explain plane's, which only the packed wire carries
        stats = {k: (s1[k] if k[0] in GAUGES else (s1[k] or 0) - (s0[k] or 0)) for k in s1
                 if not k[0].startswith("sentinel_explain_")}
        out[packed] = (got, rows, stats, [s[1:] for s in steps], sum(s[0][3] for s in steps), explained)
    assert out[True][:4] == out[False][:4]
    assert out[False][4] == 0 and out[True][4] > 0  # the repeated block's columns skip only packed
    assert out[False][5] == 0 and out[True][5] > 0
    assert any(w > 0 for o in out[False][0] if isinstance(o, list) for _v, w in o)


@pytest.mark.parametrize("site", ["runtime.resolve.readback", "runtime.resolve.fanout"])
def test_a_readback_failure_fails_the_unpacked_tick_closed(site):
    c = _port(FUSED)
    c.start()
    try:
        c.flow_rules.load([tst.FlowRule(resource="r", count=100)])
        c.entry("r").exit()
        with armed(FaultPlan(seed=1, faults=[FaultSpec(site, "raise", max_fires=1)])):
            with pytest.raises(tst.SystemBlockException):
                c.entry("r")
        c.entry("r").exit()  # the next tick serves
    finally:
        c.stop()
