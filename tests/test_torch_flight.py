"""The port's flight recorder (obs/flight.py), the failpoint journal, the
client's providers and journal notes, ``api/flight``, and the block log
(metrics/block_log.py) with the explain plane's provenance key — each
held against the JAX package's on the same inputs, on the CPU.
"""

import json

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.metrics.block_log import BlockLogger as JaxBlockLogger
from sentinel_tpu.obs.flight import FlightRecorder as JaxFlightRecorder
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import transport as TT
from sentinel_tpu_torch.chaos import FaultPlan, FaultSpec, armed
from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.metrics.block_log import BlockLogger, parse_line
from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs.flight import FlightRecorder, load_bundle
from sentinel_tpu_torch.obs.registry import REGISTRY as OBS
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.transport.command import CommandRequest
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource, mono_s


def _strip(events):
    """Journal events without their clock stamps (kind, fields, order)."""
    return [(e["seq"], e["kind"], e["fields"]) for e in events]


def test_flight_journal_ring_matches_the_reference():
    mine, ref = FlightRecorder(capacity=8), JaxFlightRecorder(capacity=8)
    for fr in (mine, ref):
        for i in range(12):
            fr.note("k", i=i, kind="x" if i % 2 else "y")
    assert _strip(mine.events()) == _strip(ref.events())
    assert [e["fields"]["i"] for e in mine.events()] == list(range(4, 12))
    assert mine.recorded_total() == ref.recorded_total() == 12
    assert [e["fields"]["i"] for e in mine.events(last=3)] == [9, 10, 11]
    assert mine.events()[0]["t_ns"] > 0


def test_flight_bundle_contents_and_providers():
    fr = FlightRecorder(capacity=32)
    fr.note("cluster.degrade.enter", cooldown_s=5.0)
    fr.register_provider("good", lambda: {"x": 1})
    fr.register_provider("bad", lambda: 1 / 0)
    b = fr.dump_bundle("unit")
    ref = JaxFlightRecorder(capacity=32).dump_bundle("unit")
    assert set(b) == set(ref)
    assert b["kind"] == "sentinel-flight-bundle" and b["reason"] == "unit"
    assert b["journal"][-1]["kind"] == "cluster.degrade.enter"
    assert isinstance(b["metrics"], dict) and "captured_wall_ms" in b
    assert b["providers"]["good"] == {"x": 1}
    assert "ZeroDivisionError" in b["providers"]["bad"]["error"]
    json.dumps(b)  # a bundle is JSON
    keeper = lambda: {}  # noqa: E731
    fr.register_provider("good", keeper)
    fr.unregister_provider("good", lambda: {})  # not the registered one
    assert "good" in fr.dump_bundle("u2")["providers"]
    fr.unregister_provider("good", keeper)
    assert "good" not in fr.dump_bundle("u3")["providers"]


def test_flight_trigger_rate_limit_keep_k_and_load(tmp_path, monkeypatch):
    """The first trigger always captures, however young the monotonic
    clock (the reference's 0 sentinel rate-limits it on a host up for less
    than ``min_interval_s``)."""
    monkeypatch.setenv("SENTINEL_FLIGHT_DIR", str(tmp_path))
    fr = FlightRecorder(capacity=8, keep=2, min_interval_s=3600.0)
    assert fr.trigger("breach") is not None
    assert fr.trigger("breach") is None  # inside the window
    fr.reset_rate_limit()
    assert fr.trigger("degrade") is not None
    fr.reset_rate_limit()
    assert fr.trigger("third") is not None
    assert [b["reason"] for b in fr.bundles()] == ["degrade", "third"]
    assert fr.last_bundle()["reason"] == "third"
    files = sorted(tmp_path.glob("flight_*.json"))
    assert len(files) == 3
    assert load_bundle(str(files[0]))["kind"] == "sentinel-flight-bundle"
    (tmp_path / "x.json").write_text("{}")
    with pytest.raises(ValueError):
        load_bundle(str(tmp_path / "x.json"))
    assert OBS.counter("sentinel_flight_bundles_total", labels={"reason": "third"}).value >= 1


def test_flight_note_overhead_guard():
    fr = FlightRecorder(capacity=1024)
    n = 20_000
    t0 = mono_s()
    for i in range(n):
        fr.note("k", i=i)
    assert (mono_s() - t0) / n < 5e-6


def test_failpoint_fires_are_journalled():
    site = FP.register("obs.flight.test", "a site for this test", FP.HIT_ACTIONS)
    plan = FaultPlan(name="fl", seed=1, faults=[FaultSpec(site, "delay", delay_ms=0, max_fires=2)])
    with armed(plan):
        for _ in range(3):
            FP.hit(site)
    ev = [e for e in FL.FLIGHT.events(last=32) if e["kind"] == "failpoint.fire" and e["fields"]["site"] == site]
    assert [(e["fields"]["action"], e["fields"]["hit"]) for e in ev] == [("delay", 0), ("delay", 1)]


def test_client_providers_notes_and_api_flight():
    """A started client contributes its ``client``, ``timeline`` and
    ``explain`` sections; a rule load journals ``rules.recompile``; the
    command center's ``api/flight`` answers a fresh bundle and the stored
    ones; stop() takes the sections back."""
    c = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                       device="cpu")
    c.start()
    try:
        c.flow_rules.load([tst.FlowRule(resource="api", count=1)])
        for _ in range(3):
            c.try_entry("api")
        ev = [e for e in FL.FLIGHT.events(last=16) if e["kind"] == "rules.recompile"]
        assert ev and ev[-1]["fields"] == {"degraded": False, "flow": 1, "param": 0}
        reg = TT.build_default_handlers(c)
        r = reg.handle("api/flight", CommandRequest())
        assert r.success
        b = r.result
        assert {"client", "timeline", "explain"} <= set(b["providers"])
        sec = b["providers"]["client"]
        assert sec["device"] == "cpu" and sec["rule_fingerprints"]["flow_rules"]["count"] == 1
        assert sec["adaptive"] is None
        assert b["providers"]["explain"]["coverage"]["blocked"] >= 2
        json.dumps(b)
        FL.FLIGHT.reset_rate_limit()
        FL.FLIGHT.trigger("test-stored")
        stored = reg.handle("api/flight", CommandRequest({"stored": "1"}))
        assert stored.success and [x["reason"] for x in stored.result] == ["test-stored"]
        assert reg.handle("api/flight", CommandRequest({"stored": "0"})).result == []
        c.enable_adaptive()
        assert FL.FLIGHT.dump_bundle("x")["providers"]["client"]["adaptive"]["level"] == "NORMAL"
    finally:
        c.stop()
    assert "client" not in FL.FLIGHT.dump_bundle("after")["providers"]


def test_hotset_promotions_are_journalled():
    from sentinel_tpu_torch.runtime.registry import Registry
    from sentinel_tpu_torch.sketch.hotset import guarded_promote

    cfg = small_engine_config(sketch_stats=True)
    reg = Registry(cfg)
    i = 0
    while not reg.is_sketch_id(reg.resource_id(f"n{i}")):
        i += 1
    name = f"n{i}"
    row = guarded_promote(reg, name)
    assert row is not None and not reg.is_sketch_id(row)
    ev = [e for e in FL.FLIGHT.events(last=8) if e["kind"] == "hotset.promote"]
    assert ev[-1]["fields"] == {"resource": name, "row": row}


def test_block_logger_lines_equal_the_references(tmp_path):
    mine, ref = BlockLogger(str(tmp_path / "t")), JaxBlockLogger(str(tmp_path / "j"))
    calls = [
        (1_700_000_000_100, "a", "FlowException", "", 1, None, None),
        (1_700_000_000_200, "a", "FlowException", "", 3, None, None),
        (1_700_000_000_300, "b", "DegradeException", "o1", 1, "degrade", 4),
        (1_700_000_001_050, "a", "FlowException", "", 2, "flow", None),
        (1_700_000_002_000, "c", "SystemBlockException", "", 5, "system", 0),
    ]
    for lg in (mine, ref):
        for now, res, exc, origin, cnt, kind, rule in calls:
            lg.log(now, res, exc, origin, cnt, kind=kind, rule=rule)
        lg.flush()
    got = (tmp_path / "t" / "sentinel-block.log").read_bytes()
    assert got == (tmp_path / "j" / "sentinel-block.log").read_bytes()
    rows = [parse_line(x) for x in got.decode().splitlines()]
    assert rows[0] == {"ts": 1_700_000_000_000, "resource": "a", "exception": "FlowException", "count": 4,
                       "origin": "", "kind": None, "rule": None}
    assert rows[1]["kind"] == "degrade" and rows[1]["rule"] == 4


def _drive_blocks(client, m):
    client.flow_rules.load([m.FlowRule(resource="a", count=2)])
    client.degrade_rules.load([m.DegradeRule(resource="c", grade=m.CB_STRATEGY_ERROR_COUNT, count=1,
                                             time_window=5, min_request_amount=1)])
    client.system_rules.load([m.SystemRule(qps=7)])
    rng = np.random.default_rng(2)
    for _ in range(40):
        res = str(rng.choice(["a", "c", "x"]))
        try:
            e = client.entry(res, inbound=bool(rng.random() < 0.5), origin=str(rng.choice(["", "o1"])))
            if res == "c":
                e.trace(RuntimeError("boom"))
            e.exit()
        except m.BlockException:
            pass
        client.time.advance(int(rng.integers(0, 90)))


def test_client_block_log_lines_equal_the_references(tmp_path):
    """Both clients on the default config (explain plane on) write the
    same sentinel-block.log: keys, counts, seconds, causes and blamed
    rule slots (``ExplainPlane.latest_rule``)."""
    jc = JaxClient(cfg=jax_small_cfg(), time_source=JaxVT(1_000), mode="sync", block_log=True)
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    tc = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                        device="cpu", block_log=True)
    jc.block_log = JaxBlockLogger(str(tmp_path / "j"))
    tc.block_log = BlockLogger(str(tmp_path / "t"))
    jc.start()
    tc.start()
    try:
        _drive_blocks(jc, jst)
        _drive_blocks(tc, tst)
    finally:
        jc.stop()
        tc.stop()
    got = (tmp_path / "t" / "sentinel-block.log").read_text()
    want = (tmp_path / "j" / "sentinel-block.log").read_text()
    assert got == want
    kinds = {parse_line(x)["kind"] for x in got.splitlines()}
    assert {"flow", "system"} <= kinds
    assert any(parse_line(x)["rule"] is not None for x in got.splitlines())
