"""The port's trace CLI (``python -m sentinel_tpu_torch.obs``) against the
reference's (``sentinel_tpu/obs/__main__.py``): the same dumps merged by
both packages' ``merge_traces`` give equal JSON; the same flight bundle
gives equal ``--postmortem`` text; the self-captures run on the CPU when
asked (six ``tick.*`` stages, explanations, a profile window) and on the
card otherwise.  Every test leaves the port's span ring empty and its
tracer as it found it."""

from __future__ import annotations

import json

import pytest

from sentinel_tpu.obs import __main__ as JM
from sentinel_tpu_torch import obs
from sentinel_tpu_torch.obs import __main__ as TM
from sentinel_tpu_torch.obs import trace as OT


@pytest.fixture(autouse=True)
def _clean_tracer():
    was = obs.TRACER.enabled
    obs.TRACER.reset()
    yield
    obs.TRACER.reset()
    if not was:
        obs.disable()


def _rpc_dumps(tmp_path):
    """A client's and a token server's dumps of one RPC, written by the
    port's tracer: the client's ``cluster.rpc`` carries the wire span id,
    the server's decision span names it as parent; plus a raw snapshot
    list (the other input format)."""
    tid, sid = OT.new_trace_id(), OT.new_span_id()
    cl = OT.SpanTracer(capacity=16)
    cl.enable()
    cl.record("cluster.rpc", t0_ns=1_000_000, dur_ns=900_000, trace=tid,
              attrs={"span_id": sid, "ok": True, "type": 1})
    sv = OT.SpanTracer(capacity=16)
    sv.enable()
    with OT.trace_ctx(tid, sid):
        sv.record("token.decision", t0_ns=5_000_000, dur_ns=400_000, trace=tid,
                  attrs={"parent": sid, "flow_id": 101})
        sv.record("token.decision.batch", t0_ns=6_000_000, dur_ns=100_000, trace=tid,
                  attrs={"parent": sid, "n": 4})
    server_doc = sv.chrome_trace()
    for e in server_doc["traceEvents"]:
        e["pid"] = e["pid"] + 1
    paths = [tmp_path / "client.json", tmp_path / "server.json", tmp_path / "raw.json"]
    paths[0].write_text(json.dumps(cl.chrome_trace()))
    paths[1].write_text(json.dumps(server_doc))
    paths[2].write_text(json.dumps(sv.snapshot()))
    return [str(p) for p in paths], sid


def test_merge_gives_the_references_document(tmp_path, capsys):
    paths, sid = _rpc_dumps(tmp_path)
    for inputs in (paths[:2], paths):
        mine = TM.merge_traces(inputs)
        assert json.dumps(mine, sort_keys=True) == json.dumps(JM.merge_traces(inputs), sort_keys=True)
    starts = [e for e in mine["traceEvents"] if e.get("ph") == "s"]
    assert starts and all(e["id"] == sid for e in starts)
    assert mine["otherData"]["flow_links"] == 4  # two server spans in each of two dumps
    out = tmp_path / "merged.json"
    assert TM.main(["--merge", *paths[:2], "-o", str(out)]) == 0
    assert json.loads(out.read_text()) == TM.merge_traces(paths[:2])
    assert "2 flow links" in capsys.readouterr().out


def _bundle(tmp_path):
    """A bundle the port's flight recorder captured on a red invariant, with
    spans, a timeline provider and incident counters in it."""
    from sentinel_tpu_torch.chaos.invariants import MetricsDelta, ScenarioContext, evaluate
    from sentinel_tpu_torch.obs.flight import FLIGHT

    obs.enable()
    with obs.span("tick.device", trace=7):
        pass
    FLIGHT.note("failpoint.fire", site="cluster.rpc.send", action="raise", hit=2)
    FLIGHT.register_provider("timeline", lambda: {"window_s": 30, "resources": ["r"], "rows": [
        {"ts": 1000, "resource": "r", "pass": 3, "block": 1, "success": 2, "exception": 0, "rt_sum": 5.0,
         "rt_min": 1.5, "concurrency": 1, "sources": {"api": 3}}]})
    try:
        FLIGHT.reset_rate_limit()
        evaluate(["verdict-accounting"], ScenarioContext(metrics=MetricsDelta(), submitted=2, passed=1))
        b = FLIGHT.last_bundle()
    finally:
        FLIGHT.unregister_provider("timeline")
    assert b["reason"] == "invariant-breach"
    p = tmp_path / "bundle.json"
    p.write_text(json.dumps(b))
    return str(p)


def test_postmortem_text_equals_the_references(tmp_path, capsys):
    path = _bundle(tmp_path)
    assert TM.main(["--postmortem", path]) == 0
    mine = capsys.readouterr().out
    assert JM.main(["--postmortem", path]) == 0
    assert capsys.readouterr().out == mine
    assert "reason='invariant-breach'" in mine
    for text in ("invariant.breach", "failpoint.fire", "tick.device", "provider [timeline]"):
        assert text in mine
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": 1}))
    with pytest.raises(ValueError):
        TM.main(["--postmortem", str(bad)])


def test_cli_self_capture_prints_all_six_stages(capsys):
    assert TM.main(["--summary", "--blocks", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in TM.TICK_STAGES:
        assert name in out, f"{name} missing from the CLI summary:\n{out}"
    assert TM.TICK_STAGES == JM.TICK_STAGES
    assert "p50 ms" in out and "p99 ms" in out
    assert "absent from this trace" not in out
    assert not obs.TRACER.enabled


def test_cli_explain_self_capture_and_json(capsys):
    """``explain``'s self-capture on the CPU against the reference's: both
    drive a client on the real clock past a 2-a-second limit, so how many
    of the 16 items block depends on how long the first tick took (the
    reference's compiles for seconds and may leave the first window); the
    causes and the records' contents are the same, and every block is
    explained."""
    assert TM.main(["explain", "--device", "cpu", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    want = JM._explain_self_capture()

    def causes(p):
        return {(c["name"], c["kind"], c["rule"], c["origin"]) for c in p["top_causes"]}

    def records(p):
        return {tuple(sorted((k, v) for k, v in r.items() if k != "ts_ms")) for r in p["recent"]}

    assert causes(payload) == causes(want) == {("cli/checkout", "flow", 0, "local"), ("cli/search", "flow", 1, "local")}
    assert records(payload) == records(want)
    cov = payload["coverage"]
    assert cov["blocked"] == cov["explained"] >= 8 and cov["frac"] == 1.0
    assert TM.main(["explain", "--device", "cpu", "--resource", "cli/search", "--top", "1"]) == 0
    out = capsys.readouterr().out
    assert "explain coverage: blocked=" in out and "(100.0%)" in out
    assert "recent explanations (" in out and "cli/checkout" not in out.split("recent explanations")[1]


def test_cli_profile_window(capsys):
    from sentinel_tpu_torch.obs import profile as PROF

    PROF._LAST_CAPTURE[0] = 0.0
    assert TM.main(["--profile", "250", "--blocks", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    head = json.loads(out[: out.index("}") + 1])
    assert head["ms"] == 250.0 and head["span_count"] > 0


def test_the_self_captures_run_on_the_card_unless_asked():
    for argv in (["--summary"], ["explain"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.main(argv)
