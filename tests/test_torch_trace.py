"""The port's span tracer (obs/trace.py) and the client's stage spans
against the JAX package's.

First the tracers alone: the same span sequence through both gives the
same snapshot, ``summarize`` rows, ring wrap and drop count, and the same
Chrome trace, which reads back through ``load_spans``.  Then the clients:
a sync-mode, virtual-time port client and the JAX client on the same
host path (tests/torch_harness.jax_host_client), with tracing on, take
the same entries, exits and blocks on the per-item fused path and on the
segment path; every tick records the same ``tick.*`` names, in the same
order, with the same attributes, all under one trace id a tick.  Disabled,
the tracer records nothing and reads no clock.
"""

import json

import numpy as np
import pytest
import torch

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs import trace as JOT
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import obs
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs import trace as TOT
from sentinel_tpu_torch.obs.registry import REGISTRY as TREG
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.test_torch_client import NO_PLANES, SEG
from tests.torch_harness import jax_host_client

FUSED = dict(use_mxu_tables=True, fused_effects=True, **NO_PLANES)
#: the JAX client's host flags for each path (its tick: tests/torch_harness.jax_host_client)
JAX_HOST = {"fused": dict(FUSED, use_mxu_tables=True), "seg": dict(SEG, use_mxu_tables=True)}
PORT = {"fused": FUSED, "seg": SEG}


def _record_script(tr):
    """The same spans into a tracer: explicit records (one ring wrap past
    capacity 8), a begin/end pair and a context-manager span."""
    for i in range(13):
        tr.record(f"s{i % 3}", 1_000 * i, 250 * (i + 1), trace=i % 4, attrs={"i": i} if i % 2 else None)
    h = tr.begin("cross", trace=7, side="a")
    tr.end(h, done=True)
    with tr.span("cm", trace=9, k=1):
        pass


def _stable(spans):
    """A snapshot without its clock and thread fields (begin/end and the
    context-manager span read the clock)."""
    return [
        (s["seq"], s["name"], s["trace"], s["attrs"],
         s["t0_ns"] if s["name"].startswith("s") else 0, s["dur_ns"] if s["name"].startswith("s") else 0)
        for s in spans
    ]


def test_the_same_spans_through_both_tracers_give_the_same_ring_summary_and_chrome_trace(tmp_path):
    jt, tt = JOT.SpanTracer(capacity=6), TOT.SpanTracer(capacity=6)
    assert jt.capacity == tt.capacity == 8
    for tr in (jt, tt):
        tr.enable()
        _record_script(tr)
    js, ts = jt.snapshot(), tt.snapshot()
    assert _stable(ts) == _stable(js)
    assert len(ts) == 8 and ts[0]["seq"] == 7  # the ring wrapped: the oldest 7 are gone
    assert tt.recorded_total == jt.recorded_total == 15
    assert tt.spans_dropped_total() == jt.spans_dropped_total() == 7
    fixed = [s for s in ts if s["name"].startswith("s")]
    assert TOT.summarize(fixed) == JOT.summarize([s for s in js if s["name"].startswith("s")])
    assert set(TOT.summarize(ts)) == set(JOT.summarize(js)) == {"s0", "s1", "s2", "cross", "cm"}
    assert TOT.summarize(ts, prefix="s1") == JOT.summarize(js, prefix="s1")
    # Chrome trace: the same events; written and read back, the same spans
    jc, tc = jt.chrome_trace(fixed), tt.chrome_trace(fixed)
    assert [dict(e, pid=0) for e in tc["traceEvents"]] == [dict(e, pid=0) for e in jc["traceEvents"]]
    path = tmp_path / "trace.json"
    tt.dump(str(path))
    back = TOT.load_spans(str(path))
    # the export keeps microseconds as floats: the clock-read spans come
    # back to within float rounding, the fixed ones exactly
    assert [s["name"] for s in back] == [s["name"] for s in ts]
    assert [s["dur_ns"] for s in back] == pytest.approx([s["dur_ns"] for s in ts], rel=1e-12)
    fixed_back = [s for s in back if s["name"].startswith("s")]
    assert [s["dur_ns"] for s in fixed_back] == [float(s["dur_ns"]) for s in fixed]
    assert TOT.summarize(fixed_back) == TOT.summarize(fixed)
    assert TOT.load_spans(str(path)) == JOT.load_spans(str(path))
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"x": 1}))
        TOT.load_spans(str(bad))
    tt.reset()
    assert tt.snapshot() == []


def test_the_global_tracer_counts_its_drops_in_the_ports_registry():
    c = TREG.get("sentinel_trace_spans_dropped_total")
    assert c is not None and obs.TRACER._drop_counter is c
    tr = TOT.SpanTracer(capacity=2, drop_counter=c)
    tr.enable()
    before = c.value
    for i in range(5):
        tr.record("x", i, 1)
    tr.snapshot()
    tr.snapshot()  # the delta is added once
    assert c.value - before == 3


def test_trace_context_and_helpers_match_the_reference():
    for m in (JOT, TOT):
        tr = m.SpanTracer(capacity=16)
        tr.enable()
        with m.trace_ctx(0xABC, 0x12):
            h = tr.begin("child")
            with tr.span("inner"):
                pass
            assert m.current_ctx() == (0xABC, 0x12)
        tr.end(h)
        assert m.current_ctx() == (0, 0)
        got = [(s["name"], s["trace"], s["attrs"]) for s in tr.snapshot()]
        assert got == [("inner", 0xABC, {"parent": 0x12}), ("child", 0xABC, {"parent": 0x12})]
        assert m.new_trace_id() != m.new_trace_id() and m.new_span_id() != 0


def test_a_disabled_tracer_records_nothing_and_reads_no_clock(monkeypatch):
    obs.disable()
    assert not obs.enabled()
    tr = TOT.SpanTracer()

    def no_clock():
        raise AssertionError("the disabled path read the clock")

    monkeypatch.setattr(TOT, "now_ns", no_clock)
    assert TOT.t0() == 0
    assert obs.span("x") is TOT._NOOP and tr.span("x") is TOT._NOOP
    assert tr.begin("x") is None
    tr.end(None)
    TOT.event("x")
    assert TOT.maybe_ctx(5) is TOT._NOOP
    assert tr.snapshot() == [] and obs.TRACER.snapshot() == []


def test_torch_annotations_put_host_spans_in_a_torch_profiler_capture():
    obs.enable(torch_annotations=True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.span("client.span_under_profile"):
                torch.ones(4).sum()
    finally:
        obs.disable()
        obs.TRACER.reset()
    assert "client.span_under_profile" in {e.name for e in prof.events()}


def _script(client, m):
    """Entries (one blocked), their exits, a bulk block of 40 ids and its
    completions: ticks with acquires only, completions only, and both."""
    client.flow_rules.load([m.FlowRule(resource="a", count=2)])
    for name in ("a", "b", "c"):
        client.registry.resource_id(name)
    held = []
    for name in ("a", "b", "a", "a"):
        try:
            held.append(client.entry(name))
        except m.BlockException:
            pass
        client.time.advance(5)
    for e in held:
        e.exit()
    ids = np.array([client.registry.peek_resource_id(n) for n in "abcabcab" * 5], np.int32)
    client.mode = "threaded"  # queue a block and its completions for ONE tick
    fut = client.submit_block(ids)
    client.submit_completion_block(ids, np.full(len(ids), 3.0, np.float32))
    client.mode = "sync"
    client.tick_once()
    return fut.result(timeout=30)


def _ticks(spans):
    """tick.* spans grouped by trace id, in the order the ticks ran:
    [(name, attrs), ...] a tick."""
    ticks = {}
    for s in spans:
        if s["name"].startswith("tick."):
            ticks.setdefault(s["trace"], []).append((s["name"], s["attrs"]))
    return list(ticks.values())


@pytest.mark.parametrize("path", ["fused", "seg"])
def test_client_stage_spans_match_the_jax_client(monkeypatch, path):
    jc = jax_host_client(monkeypatch, jax_small_cfg(**JAX_HOST[path]), JaxVT(1_000))
    tc = SentinelClient(cfg=small_engine_config(**PORT[path]), time_source=VirtualTimeSource(1_000),
                        mode="sync", device="cpu")
    jc.start()
    tc.start()
    JOT.TRACER.enable()
    obs.enable()
    try:
        JOT.TRACER.reset()
        obs.TRACER.reset()
        want_v = _script(jc, jst)
        got_v = _script(tc, tst)
        jspans, tspans = JOT.TRACER.snapshot(), obs.TRACER.snapshot()
    finally:
        JOT.TRACER.disable()
        obs.disable()
        jc.stop()
        tc.stop()
    np.testing.assert_array_equal(got_v[0], want_v[0])
    want, got = _ticks(jspans), _ticks(tspans)
    assert got == want
    assert len(got) == 8  # 4 entries, 3 exits, then the block with its completions
    names = {n for t in got for n, _a in t}
    expect = {"tick.assemble", "tick.dispatch", "tick.device", "tick.readback", "tick.resolve"}
    assert names == (expect | {"tick.presort"} if path == "seg" else expect)
    # each tick's spans share one trace id, and no two ticks share one
    ids = [s["trace"] for s in tspans if s["name"] == "tick.assemble"]
    assert len(set(ids)) == len(ids) == len(got) and all(ids)
    assert {s["name"] for s in tspans if not s["name"].startswith("tick.")} == {"client.recompile_rules"}
    assert tc.host_build_ms_avg > 0
    assert tc.host_sort == ("native" if path == "seg" else None)
    s = obs.summarize(tspans, prefix="tick.")
    assert s["tick.assemble"]["count"] == len(got) and s["tick.dispatch"]["p50_ms"] > 0


def test_the_client_records_no_span_with_tracing_off():
    obs.disable()
    obs.TRACER.reset()
    hist = TREG.get("sentinel_tick_assemble_ms")
    n0 = hist.count
    tc = SentinelClient(cfg=small_engine_config(**SEG), time_source=VirtualTimeSource(1_000), mode="sync",
                        device="cpu")
    tc.start()
    _script(tc, tst)
    tc.stop()
    assert obs.TRACER.snapshot() == []
    assert hist.count == n0
    assert tc.host_build_ms_avg > 0  # the build average is kept untraced too
