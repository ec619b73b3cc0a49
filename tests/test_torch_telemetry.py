"""The port's observability planes against the JAX package's: the device
telemetry row, the top-K timeline rows and the explain records, as both
engines pack them into the wire, tick by tick.

Both run with ``device_telemetry=True``, small ``timeline_k`` and
``explain_k`` and the packed wire, on the fused, seg4 and seg1 paths, over
the same rules and the same seeded numpy stream (presorted on the segment
paths, as the client presorts it).  The JAX tick runs eagerly
(``jax.disable_jit``) with its Pallas kernels in interpret mode; the port
runs on the CPU with its kernels' plain versions.

Verdicts, waits, ``seg_dropped``, every integer stats slot, the timeline
row ids and counts, ``n_blocked`` and every explain word must be EQUAL.
The float sums (``STAT_WIN_RT_SUM``, ``STAT_WIN_RT_MIN``, ``TL_RT_SUM``,
``TL_RT_MIN``) are held to the state tolerance of tests/test_torch_engine.py,
rtol=1e-6, atol=1e-4; RTs are on the 1/8 ms grid, where they are exact.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_harness as H
from tests.test_torch_engine import _assert_states_match
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs import explain as JX
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.ops import wire as JW
from sentinel_tpu.runtime.registry import Registry as JaxRegistry
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core import rules as TR
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs import explain as TX
from sentinel_tpu_torch.obs.registry import MetricRegistry
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime.registry import Registry

#: the planes on, small
PLANES = dict(device_telemetry=True, timeline_k=8, explain_k=32)
#: flags of the three paths (the packed wire is in H.FUSED_FLAGS)
PATHS = {
    "fused": {},
    "seg4": dict(H.SEG_FLAGS),
    "seg1": dict(H.SEG_FLAGS, **H.SINGLE_LANE),
}
#: tick timestamps: two ticks in one 500 ms bucket, then a gap longer than
#: the second window (every bucket stale)
NOWS = [1_000, 1_130, 4_050]
#: float slots, held to the tolerance; every other slot is exact
FLOAT_STATS = (E.STAT_WIN_RT_SUM, E.STAT_WIN_RT_MIN)
FLOAT_TL = (E.TL_RT_SUM, E.TL_RT_MIN)


def _cfgs(b, flags):
    kw = dict(H.FUSED_FLAGS, batch_size=b, complete_batch_size=b)
    kw.update(PLANES)
    kw.update(flags)
    return jax_small_cfg(**kw), small_engine_config(**kw)


def _setup(b, flags, system=True, param=True):
    jcfg, tcfg = _cfgs(b, flags)
    jreg, treg = JaxRegistry(jcfg), Registry(tcfg)
    H.intern(jreg)
    H.intern(treg)
    rules_j, rules_t = H.make_rules(JR, param=param), H.make_rules(TR, param=param)
    rules_j["system_rules"] = [JR.SystemRule(qps=40)] if system else []
    rules_t["system_rules"] = [TR.SystemRule(qps=40)] if system else []
    jrs = JE.compile_ruleset(jcfg, jreg, **rules_j)
    trs = E.compile_ruleset(tcfg, treg, device="cpu", **rules_t)
    return jcfg, tcfg, treg, jrs, trs


def _ticks(jcfg, tcfg, jrs, trs, stream, nows, features):
    """Both engines over the stream: [(JAX frame, port frame)] and the two
    final states."""
    with jax.disable_jit():
        js = JE.init_state(jcfg)
    ts = E.init_state(tcfg, "cpu")
    frames = []
    for w, now in zip(stream, nows):
        b = w["acq"]["res"].shape[0]
        acq = JE.AcquireBatch(**{k: jnp.asarray(v) for k, v in w["acq"].items()})
        comp = JE.CompleteBatch(**{k: jnp.asarray(v) for k, v in w["comp"].items()})
        with jax.disable_jit():
            js, jout = JE.tick(js, jrs, acq, comp, jnp.int32(now), jnp.float32(0.5),
                               jnp.float32(0.2), jcfg, features)
            jwire = np.asarray(jout.wire)
        tacq = E.AcquireBatch(**{k: torch.as_tensor(v) for k, v in w["acq"].items()})
        tcomp = E.CompleteBatch(**{k: torch.as_tensor(v) for k, v in w["comp"].items()})
        ts, tout = E.tick(ts, trs, tacq, tcomp, now, 0.5, 0.2, tcfg, features)
        twire = tout.wire.numpy()
        jlo, tlo = JW.layout_for(jcfg, b), WIRE.layout_for(tcfg, b)
        assert tuple(tlo) == tuple(jlo)
        assert twire.shape == jwire.shape == (tlo.total,)
        frames.append((JW.unpack(jwire.tobytes(), jlo), WIRE.unpack(twire.tobytes(), tlo)))
    return frames, js, ts


def _assert_frames_match(jf, tf):
    np.testing.assert_array_equal(tf.verdict, jf.verdict)
    np.testing.assert_array_equal(tf.wait, jf.wait)
    assert tf.seg_dropped == jf.seg_dropped
    exact = [i for i in range(E.N_STATS) if i not in FLOAT_STATS]
    np.testing.assert_array_equal(tf.stats[exact], jf.stats[exact])
    np.testing.assert_allclose(tf.stats[list(FLOAT_STATS)], jf.stats[list(FLOAT_STATS)], rtol=1e-6, atol=1e-4)
    exact = [i for i in range(E.TL_COLS) if i not in FLOAT_TL]
    np.testing.assert_array_equal(tf.res_stats[:, exact], jf.res_stats[:, exact])
    np.testing.assert_allclose(tf.res_stats[:, list(FLOAT_TL)], jf.res_stats[:, list(FLOAT_TL)], rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(tf.expl, jf.expl)  # n_blocked, sec_sum and every record word


def _records(frame):
    n_blocked, rows = TX.decode_section(frame.expl)
    return n_blocked, [TX.decode_record(r) for r in rows[:n_blocked]]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_planes_match_jax_on_every_path(path):
    """Three ticks per path with the param stage on: every block kind, more
    blocked rows than explain_k, forced pre_verdict rows, two ticks in one
    bucket and a gap past the window; states equal as in the engine tests."""
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, PATHS[path])
    stream = [H.workload(tcfg, treg, seed=900 + i, b=b, param=True) for i in range(len(NOWS))]
    if path != "fused":
        stream = [H.presort(w) for w in stream]
    frames, js, ts = _ticks(jcfg, tcfg, jrs, trs, stream, NOWS, H.PARAM_FEATURES)
    _assert_states_match(tcfg, js, ts)
    kinds, forced, over_k = set(), 0, 0
    for (jf, tf), w in zip(frames, stream):
        _assert_frames_match(jf, tf)
        # the stats row's verdict mix is the bitmap's, over valid rows
        valid = w["acq"]["res"] != tcfg.trash_row
        mix = np.bincount(tf.verdict[valid], minlength=7)
        assert tf.stats[E.STAT_VALID] == valid.sum()
        for slot, code in zip(range(E.STAT_PASS, E.STAT_BLOCK_DEGRADE + 1), E._STAT_VERDICTS):
            assert tf.stats[slot] == mix[code]
        assert tf.stats[E.STAT_SEG_LIVE] > 0 if path != "fused" else tf.stats[E.STAT_SEG_LIVE] == 0
        n_blocked, recs = _records(tf)
        assert n_blocked == int(((tf.verdict >= ERR.BLOCK_FLOW) & (tf.verdict <= ERR.BLOCK_AUTHORITY) & valid).sum())
        over_k += n_blocked > tcfg.explain_k
        # the records are the first blocked rows, in batch order
        blocked_rows = np.flatnonzero((tf.verdict >= 1) & (tf.verdict <= 5) & valid)[: tcfg.explain_k]
        assert [r.resource for r in recs] == w["acq"]["res"][blocked_rows].tolist()
        assert [r.kind for r in recs] == tf.verdict[blocked_rows].tolist()
        kinds |= {r.kind for r in recs}
        forced += sum(r.forced and r.rule is None for r in recs)
        # K distinct resource rows, never the ENTRY row
        rids = tf.res_stats[:, E.TL_RID].astype(int)
        assert len(set(rids.tolist())) == tcfg.timeline_k and rids.min() >= 1
    assert kinds == {ERR.BLOCK_FLOW, ERR.BLOCK_DEGRADE, ERR.BLOCK_PARAM, ERR.BLOCK_SYSTEM, ERR.BLOCK_AUTHORITY}
    assert forced > 0 and over_k > 0


@pytest.mark.parametrize("system", [True, False])
def test_ceiling_utilization_with_and_without_a_system_qps_rule(system):
    """STAT_CEIL_QPS is the rule's ceiling (-1 unset) and STAT_CEIL_UTIL the
    windowed ENTRY pass over it (0 unset)."""
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, {}, system=system, param=False)
    stream = [H.workload(tcfg, treg, seed=40 + i, b=b) for i in range(2)]
    frames, _, _ = _ticks(jcfg, tcfg, jrs, trs, stream, NOWS[:2], H.FEATURES)
    for jf, tf in frames:
        _assert_frames_match(jf, tf)
        s = tf.stats
        if system:
            assert s[E.STAT_CEIL_QPS] == 40
            assert s[E.STAT_CEIL_UTIL] == np.float32(s[E.STAT_WIN_PASS]) / np.float32(40) > 0
        else:
            assert s[E.STAT_CEIL_QPS] == -1 and s[E.STAT_CEIL_UTIL] == 0


def _tie_stream(tcfg, treg, n_res, b):
    """Every one of ``n_res`` resources takes the same number of items (no
    rules: all pass), so their windowed scores tie."""
    res = np.full(b, tcfg.trash_row, np.int32)
    ids = [treg.resource_id(f"r{i}") for i in range(1, n_res + 1)]
    res[: 2 * n_res] = np.repeat(ids, 2)
    w = H.workload(tcfg, treg, seed=5, b=b)
    w["acq"] = {k: (np.zeros_like(v) if k != "res" else res) for k, v in w["acq"].items()}
    w["acq"].update(
        res=res, origin_id=np.full(b, -1, np.int32), origin_node=np.full(b, tcfg.trash_row, np.int32),
        ctx_node=np.full(b, tcfg.trash_row, np.int32), ctx_name=np.full(b, -1, np.int32),
        count=np.ones(b, np.int32),
    )
    w["comp"]["res"] = np.full(b, tcfg.trash_row, np.int32)
    return w


@pytest.mark.parametrize("path", ["fused", "seg1"])
def test_timeline_ties_take_the_lower_rows_as_the_reference(path):
    """20 resources tie at the same windowed score and timeline_k is 8:
    both engines list the 8 lowest rows, in ascending row order."""
    b = 64
    jcfg, tcfg = _cfgs(b, PATHS[path])
    jreg, treg = JaxRegistry(jcfg), Registry(tcfg)
    H.intern(jreg)
    H.intern(treg)
    jrs, trs = JE.compile_ruleset(jcfg, jreg), E.compile_ruleset(tcfg, treg, device="cpu")
    w = _tie_stream(tcfg, treg, 20, b)
    frames, _, _ = _ticks(jcfg, tcfg, jrs, trs, [w], [1_000], H.FEATURES)
    (jf, tf), = frames
    _assert_frames_match(jf, tf)
    ids = sorted(treg.resource_id(f"r{i}") for i in range(1, 21))
    assert tf.res_stats[:, E.TL_RID].astype(int).tolist() == ids[:8]
    assert np.all(tf.res_stats[:, E.TL_PASS] == 2)


def test_explain_records_past_k_and_the_forced_flag():
    """More blocked rows than explain_k, forced rows among them: n_blocked
    counts them all, the records are the first K in batch order, and a
    forced row carries the forced flag and no rule slot."""
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, dict(explain_k=8), param=False)
    w = H.workload(tcfg, treg, seed=77, b=b)
    w["acq"]["pre_verdict"][:] = 0
    w["acq"]["pre_verdict"][2:5] = ERR.BLOCK_FLOW  # forced, early in the batch
    w["acq"]["res"][2:5] = treg.resource_id("r12")  # a resource without rules
    frames, _, _ = _ticks(jcfg, tcfg, jrs, trs, [w], [1_000], H.FEATURES)
    (jf, tf), = frames
    _assert_frames_match(jf, tf)
    n_blocked, recs = _records(tf)
    assert n_blocked > tcfg.explain_k and len(recs) == tcfg.explain_k
    forced = [r for r in recs if r.forced]
    assert len(forced) == 3 and all(r.rule is None and r.resource == treg.resource_id("r12") for r in forced)
    assert all(r.observed is None and r.threshold is None for r in forced)
    assert {r.kind for r in recs if not r.forced} >= {ERR.BLOCK_AUTHORITY}


def test_seg1_window_key_at_the_int32_wrap():
    """seg1's occupy-ahead pool read keys the next window as the reference's
    int32 does: with 1 ms buckets the window id reaches 2^31 - 1 and the
    next one wraps to -2^31.  Two ticks in that window and one in the next,
    against the JAX segment check."""
    b = 64
    flags = dict(PATHS["seg1"], second_window_ms=1, second_sample_count=2)
    jcfg, tcfg, treg, jrs, trs = _setup(b, flags, param=False)
    top = 2**31 - 1
    stream = [H.presort(H.workload(tcfg, treg, seed=60 + i, b=b)) for i in range(3)]
    for w in stream:
        w["acq"]["prio"][:] = 1  # every flow-blocked item tries to borrow ahead
    # the window 2^31 - 1 alone: its ticks book tokens under the wrapped key
    _, _, ts = _ticks(jcfg, tcfg, jrs, trs, stream[:2], [top, top], H.FEATURES)
    assert int((ts.occ_epoch == -(2**31)).sum()) > 0
    frames, js, ts = _ticks(jcfg, tcfg, jrs, trs, stream, [top, top, -(2**31)], H.FEATURES)
    for jf, tf in frames:
        _assert_frames_match(jf, tf)
    _assert_states_match(tcfg, js, ts)
    assert any(ERR.PASS_WAIT in tf.verdict for _, tf in frames)


# -- the wire ----------------------------------------------------------------


@pytest.mark.parametrize(
    "telemetry,timeline_k,explain_k,packed", list(itertools.product([True, False], [0, 8, 500], [0, 8, 100], [True, False]))
)
def test_layout_matches_the_reference(telemetry, timeline_k, explain_k, packed):
    """layout_for gives the reference's offsets for every flag combination,
    at both batch shapes, the sketch tier's hot block included."""
    for b, sketch in itertools.product([64, 256], [False, True]):
        kw = dict(device_telemetry=telemetry, timeline_k=timeline_k, explain_k=explain_k,
                  packed_wire=packed, sketch_stats=sketch, batch_size=b, complete_batch_size=b)
        assert tuple(WIRE.layout_for(small_engine_config(**kw), b)) == tuple(
            JW.layout_for(jax_small_cfg(**kw), b)
        ), kw


def _one_frame():
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, {}, param=False)
    ts = E.init_state(tcfg, "cpu")
    w = H.workload(tcfg, treg, seed=3, b=b)
    acq = E.AcquireBatch(**{k: torch.as_tensor(v) for k, v in w["acq"].items()})
    comp = E.CompleteBatch(**{k: torch.as_tensor(v) for k, v in w["comp"].items()})
    _, out = E.tick(ts, trs, acq, comp, 1_000, 0.5, 0.2, tcfg, H.FEATURES)
    return out.wire.numpy().tobytes(), WIRE.layout_for(tcfg, b)


def test_a_flipped_byte_in_the_explain_section_drops_only_the_explanations():
    data, lo = _one_frame()
    plane = TX.ExplainPlane(registry=MetricRegistry())
    good = WIRE.unpack(data, lo)
    assert plane.ingest_section(good.expl) > 0
    for at in (lo.off_expl * 4, lo.off_expl * 4 + 5, lo.total * 4 - 1):  # n_blocked, sec_sum, a record
        bad = bytearray(data)
        bad[at] ^= 0x5A
        fr = WIRE.unpack(bytes(bad), lo)  # the main section still validates
        np.testing.assert_array_equal(fr.verdict, good.verdict)
        np.testing.assert_array_equal(fr.stats, good.stats)
        before = plane._c_decode_fail.value
        assert plane.ingest_section(fr.expl) == 0
        assert plane._c_decode_fail.value == before + 1
        with pytest.raises(JX.ExplainDecodeError):  # the reference's decoder agrees
            JX.decode_section(fr.expl)


def test_a_flipped_byte_in_the_main_section_fails_the_tick():
    data, lo = _one_frame()
    for at in (0, 13, lo.off_stats * 4 + 2, lo.off_tl * 4 + 7, lo.off_expl * 4 - 1):
        bad = bytearray(data)
        bad[at] ^= 0x01
        with pytest.raises(WIRE.WireDecodeError):
            WIRE.unpack(bytes(bad), lo)
        with pytest.raises(JW.WireDecodeError):
            JW.unpack(bytes(bad), lo)
