"""The port's host observability planes against the JAX package's.

A sync-mode, virtual-time port client and JAX client, both with the
reference's planes on (device telemetry, timeline rows, explain records),
take the same scripted entries and exits (tests/test_torch_client.py's
stream); the deltas of the device-stat counters and gauges in each
package's own registry, the timeline rows and the explain readers must be
equal.  Then the copied host modules alone: the timeline's record codec and
on-disk log, the explain fixed-point codec and section decoder, and the
failpoints that guard the readback.
"""

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs import explain as JX
from sentinel_tpu.obs import timeline as JTL
from sentinel_tpu.obs.registry import REGISTRY as JREG
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch.chaos import FaultPlan, FaultSpec, armed
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs import explain as TX
from sentinel_tpu_torch.obs import timeline as TTL
from sentinel_tpu_torch.obs.registry import REGISTRY as TREG
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.test_torch_client import _drive

#: the device-stat series the readback folds (reference runtime/client.py)
COUNTERS = (
    [("sentinel_device_verdicts_total", {"verdict": v}) for v in (
        "pass", "pass_wait", "block_authority", "block_system", "block_param", "block_flow", "block_degrade")]
    + [("sentinel_device_tokens_total", {"result": r}) for r in ("pass", "block")]
    + [("sentinel_device_forced_verdicts_total", None), ("sentinel_packed_decode_failures_total", None),
       ("sentinel_explain_records_total", None), ("sentinel_explain_unexplained_total", None)]
)
GAUGES = (
    "sentinel_device_entry_pass_window", "sentinel_device_entry_min_rt_ms", "sentinel_device_entry_concurrency",
    "sentinel_device_ceiling_utilization", "sentinel_device_seg_live",
)


def _values(reg):
    out = {}
    for name, labels in COUNTERS + [(g, None) for g in GAUGES]:
        m = reg.get(name, labels)
        out[(name, tuple(sorted((labels or {}).items())))] = None if m is None else m.value
    return out


def _jax_client():
    """The JAX client with its planes on, every column upload handed a
    private copy (ROADMAP.md Queue C: on the CPU ``jnp.asarray`` may alias
    the client's reused staging buffers)."""
    jc = JaxClient(cfg=jax_small_cfg(), time_source=JaxVT(1_000), mode="sync")
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    return jc


def _port_client():
    return SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True), time_source=VirtualTimeSource(1_000),
                          mode="sync", device="cpu")


def test_client_planes_match_jax_client():
    jc, tc = _jax_client(), _port_client()
    assert jc.cfg.device_telemetry and jc.cfg.timeline_k > 0 and jc.cfg.explain_k > 0
    assert (tc.cfg.device_telemetry, tc.cfg.timeline_k, tc.cfg.explain_k) == (True, 128, 32)
    jc.start()
    tc.start()
    try:
        j0, t0 = _values(JREG), _values(TREG)
        want = _drive(jc, jst, 4)
        got = _drive(tc, tst, 4)
        j1, t1 = _values(JREG), _values(TREG)
        # folded counters: the same deltas; gauges: the same last values
        for key in j1:
            if key[0] in GAUGES:
                assert t1[key] == j1[key], key
            else:
                assert t1[key] - (t0[key] or 0) == j1[key] - (j0[key] or 0), key
        # the timeline, after the stream's seconds have closed
        span = (0, 2**62)
        rows_j = [r.to_dict() for r in jc.timeline.find(None, *span)]
        rows_t = [r.to_dict() for r in tc.timeline.find(None, *span)]
        assert rows_t == rows_j and len({r["ts"] for r in rows_t}) > 2
        for res in ("a", "c", "x"):
            assert [r.to_dict() for r in tc.timeline.find(res, *span)] == [
                r.to_dict() for r in jc.timeline.find(res, *span)]
        # the explain readers
        for res in ("a", "b", "c", "d", "o", "w", "x", "never-seen"):
            assert [r.to_dict() for r in tc.explain(res)] == [r.to_dict() for r in jc.explain(res)], res
        assert tc.explain_top_causes() == jc.explain_top_causes()
        assert tc.explain_coverage() == jc.explain_coverage()
    finally:
        jc.stop()
        tc.stop()
    assert got == want
    blocked = [o for o in got if o[0] != "pass"]
    assert blocked and tc.explain_coverage()["blocked"] == len(blocked)
    # every block kind the stream carries is explained, with its rule
    kinds = {c["kind"] for c in tc.explain_top_causes(50)}
    assert {"flow", "degrade", "authority", "system"} <= kinds
    assert tc.timeline is None  # stop() closed it


def test_a_corrupt_readback_fails_closed_and_a_corrupt_explain_section_open():
    """The port's failpoints on the readback: a corrupted main section
    fails the tick CLOSED (and counts it); a corrupted explain section
    drops only that tick's explanations."""
    tc = _port_client()
    tc.start()
    tc.flow_rules.load([tst.FlowRule(resource="a", count=1)])
    tc.entry("a").exit()
    fails = TREG.get("sentinel_packed_decode_failures_total").value
    with armed(FaultPlan(seed=1, faults=[FaultSpec("transport.packed.decode", "corrupt", max_fires=1)])):
        with pytest.raises(tst.SystemBlockException):
            tc.entry("a")
    assert tc.wire_decode_failures == 1 and TREG.get("sentinel_packed_decode_failures_total").value == fails + 1
    cov = tc.explain_coverage()
    dropped = TREG.get("sentinel_explain_decode_failures_total").value
    with armed(FaultPlan(seed=2, faults=[FaultSpec("obs.explain.decode", "corrupt", max_fires=1)])):
        with pytest.raises(tst.FlowException):  # the verdict is untouched
            tc.entry("a")
    assert TREG.get("sentinel_explain_decode_failures_total").value == dropped + 1
    assert tc.explain_coverage() == cov  # that tick's record was dropped
    with pytest.raises(tst.FlowException):
        tc.entry("a")
    assert tc.explain_coverage()["explained"] == cov["explained"] + 1
    assert tc.explain("a")[0].kind_name == "flow" and tc.explain("a")[0].threshold == 1.0
    tc.stop()


def test_timeline_dir_attaches_the_metric_log(tmp_path):
    """``timeline_dir`` puts the recorder's rows on disk (a pid-suffixed
    MetricLog under the directory); a closed second is found there, and
    stop() flushes the open one."""
    import os

    tc = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True), time_source=VirtualTimeSource(1_000),
                        mode="sync", device="cpu", timeline_dir=str(tmp_path), app_name="app")
    tc.start()
    tc.flow_rules.load([tst.FlowRule(resource="a", count=2)])
    for _ in range(3):
        for _ in range(3):
            try:
                tc.entry("a").exit()
            except tst.FlowException:
                pass
        tc.time.advance(1_000)
    log = tc.timeline.log
    assert log is not None and log.base_dir == os.path.join(str(tmp_path), f"app-timeline.pid{os.getpid()}")
    wall0 = tc.time.wall_ms(1_000) // 1000 * 1000
    on_disk = log.find("a", 0, 2**62)
    assert [(r.sec_ms - wall0, r.pass_count, r.block_count) for r in on_disk[:2]] == [(0, 2, 1), (1000, 2, 1)]
    tc.stop()
    again = TTL.MetricLog(log.base_dir)
    assert len(again.find("a", 0, 2**62)) == 3  # stop() flushed the open second
    again.close()


# -- the copied host modules -------------------------------------------------


def _rows(mod, n=40):
    rng = np.random.default_rng(n)
    return [
        mod.MetricRow(
            sec_ms=1_700_000_000_000 + 1000 * (i // 4), resource=f"res-{i % 7}" + ("é" if i % 5 == 0 else ""),
            pass_count=int(rng.integers(0, 2**32)), block_count=int(rng.integers(0, 99)),
            success_count=i, exception_count=i % 3, rt_sum=float(np.float32(rng.random() * 1e4)),
            rt_min=float(rng.integers(0, 40) / 8), concurrency=int(rng.integers(0, 9)),
        )
        for i in range(n)
    ]


def test_record_codec_is_the_reference_byte_for_byte():
    for rt, rj in zip(_rows(TTL), _rows(JTL)):
        data = TTL.pack_record(rt)
        assert data == JTL.pack_record(rj)
        back, end = TTL.unpack_record(data + b"tail")
        assert back == rt and end == len(data)
        assert JTL.unpack_record(data)[0].to_dict() == back.to_dict()
        assert TTL.unpack_record(data[:-1]) is None  # a torn record is not a record


def test_metric_log_round_trip_rotation_and_recovery(tmp_path):
    """The port's MetricLog and the reference's write the same files for the
    same rows (rotation included), answer the same queries, and reopen a log
    with a torn tail the same way."""
    logs = {}
    for name, mod in (("port", TTL), ("ref", JTL)):
        log = mod.MetricLog(str(tmp_path / name), max_segment_bytes=600, max_segments=3)
        log.append(_rows(mod))
        logs[name] = (mod, log)
    (tmod, tlog), (jmod, jlog) = logs["port"], logs["ref"]
    assert [p.split("/")[-1] for p in tlog.segments()] == [p.split("/")[-1] for p in jlog.segments()]
    assert 1 < len(tlog.segments()) <= 3
    for a, b in zip(tlog.segments(), jlog.segments()):
        assert open(a, "rb").read() == open(b, "rb").read()
    t0 = 1_700_000_000_000
    for res, lo, hi in ((None, 0, 2**62), ("res-3", t0 + 3000, t0 + 7000), ("res-0é", t0, t0 + 4000)):
        assert [r.to_dict() for r in tlog.find(res, lo, hi)] == [r.to_dict() for r in jlog.find(res, lo, hi)]
    last = tlog.segments()[-1]
    tlog.close()
    jlog.close()
    with open(last, "ab") as f:  # a torn tail
        f.write(b"\x4c\x54\x00")
    again = TTL.MetricLog(str(tmp_path / "port"), max_segment_bytes=600, max_segments=3)
    assert [r.to_dict() for r in again.find(None, 0, 2**62)] == [r.to_dict() for r in jlog.find(None, 0, 2**62)]
    again.close()


@pytest.mark.parametrize("v", [None, 0.0, -3.0, 1 / 256, 2.5, 12345.678, 1e9, 1e12, float("inf")])
def test_fixed_point_codec_is_the_reference(v):
    w = TX.fx_encode(v)
    assert w == JX.fx_encode(v)
    assert TX.fx_decode(w) == JX.fx_decode(w)
    assert (TX.FX, TX.FX_MAX, TX.FX_UNKNOWN) == (JX.FX, JX.FX_MAX, JX.FX_UNKNOWN)


def test_section_decoder_is_the_reference():
    """The same raw words through both decoders: n_blocked, the records and
    every decoded field agree, padding rows and unknown kinds included."""
    rng = np.random.default_rng(11)
    k = 12
    recs = np.zeros((k, 4), np.uint64)
    kinds = [1, 2, 3, 4, 5, 1 | 8, 1 | 16, 0, 6, 7, 2, 5]
    for i, kind in enumerate(kinds):
        slot = int(rng.integers(0, 70))
        recs[i] = [rng.integers(0, 2**20), kind | (slot << 16), TX.fx_encode(rng.random() * 100),
                   TX.FX_UNKNOWN if i % 3 else TX.fx_encode(7.5)]
    n_blocked = 10
    flat = recs.reshape(-1)
    sec = (WIRE.EXPLAIN_MAGIC + n_blocked + int(flat.sum())) & 0xFFFFFFFF
    words = np.concatenate([[n_blocked, sec], flat]).astype(np.uint32)
    nt, rt = TX.decode_section(words)
    nj, rj = JX.decode_section(words)
    assert nt == nj == n_blocked
    np.testing.assert_array_equal(rt, rj)
    decoded = [TX.decode_record(r, ts_ms=5) for r in rt]
    assert [None if d is None else d.to_dict() for d in decoded] == [
        None if d is None else d.to_dict() for d in (JX.decode_record(r, ts_ms=5) for r in rj)]
    assert sum(d is not None for d in decoded) == 9  # kinds 0, 6 and 7 are no block
    bad = words.copy()
    bad[5] ^= 1
    with pytest.raises(TX.ExplainDecodeError):
        TX.decode_section(bad)
