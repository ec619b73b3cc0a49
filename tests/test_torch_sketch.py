"""The port's sketch tier against the JAX package's: the count-min seed
(ops/gsketch.py) and SALSA's self-adjusting counters (sketch/salsa.py).

The same seeded numpy events go through both modules over tick sequences
that cross bucket boundaries and the slack rotation: cells pushed past 255
and 65,535 (their words escalate to int16 and int32 lanes when the bucket
lands), an idle gap then ``sweep_expired``, and a clock that crosses the
int32 wrap.  Every state leaf (``words``, ``lvlmap``, ``run``, ``epochs``,
``rot_wid``, ``cur``, ``cur_wid``; ``counts`` for the seed) and every
estimate must be EQUAL: the sketch is integer arithmetic throughout.  The
JAX functions run eagerly on the CPU, their table reads through the native
branch (``ecfg=None``); the engine tests hold the MXU branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.ops import gsketch as JGS
from sentinel_tpu.sketch import salsa as JSA
from sentinel_tpu_torch.ops import gsketch as GS
from sentinel_tpu_torch.ops import tables as T
from sentinel_tpu_torch.sketch import impl_for
from sentinel_tpu_torch.sketch import salsa as SA

#: (sample_count, window_ms, slack_frac): the second window without slack,
#: and a 4-bucket window whose expiry runs every 2 buckets (5 ring columns)
SHAPES = {"noslack": (2, 500, 0.0), "slack": (4, 100, 0.5)}
WIDTH = 256
DEPTH = 2


def _cfgs(shape):
    nb, wms, slack = SHAPES[shape]
    return (JGS.SketchConfig(nb, wms, DEPTH, WIDTH, slack),
            GS.SketchConfig(nb, wms, DEPTH, WIDTH, slack))


def _assert_leaves_equal(jstate, tstate, where):
    for f in type(tstate)._fields:
        np.testing.assert_array_equal(
            getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f"{where}: {f}"
        )


def _events(rng, n, heavy):
    """res ids (exact rows and sketch ids), per-event (pass, block) values
    and a valid mask; ``heavy`` puts a few cells past 255 and 65,535."""
    res = rng.integers(0, 5_000, n).astype(np.int32)
    vals = rng.integers(0, 4, (n, 2)).astype(np.int32)
    if heavy:
        vals[:3, 0] = [300, 70_000, 40]
        res[:3] = [17, 17, 4_242]
    valid = rng.random(n) < 0.9
    return res, vals, valid


def _upd(rng, heavy):
    """A dense [depth, width, 3] histogram (the scatter jobs' landing)."""
    u = rng.integers(0, 3, (DEPTH, WIDTH, 3)).astype(np.int32)
    if heavy:
        u[0, 5, 0] = 254
        u[1, 9, 1] = 65_000
        u[0, 77, 2] = 2_000_000
    return u


def _step_both(mod_j, mod_t, js, ts, jc, tc, now, rng, heavy):
    """One tick's worth of writes: a dense completion-side landing that
    refreshes, then an acquire-side add at the same now_ms."""
    u = _upd(rng, heavy)
    planes_c = (JGS.RT_PLANE - 2, JGS.RT_PLANE - 3, JGS.RT_PLANE)  # success, exception, rt
    js = mod_j.add_dense(js, jnp.int32(now), jnp.asarray(u), planes_c, jc)
    ts = mod_t.add_dense(ts, now, torch.as_tensor(u), planes_c, tc)
    res, vals, valid = _events(rng, 96, heavy)
    js = mod_j.add(js, jnp.int32(now), jnp.asarray(res), jnp.asarray(vals), (0, 1),
                   jnp.asarray(valid), jc, pre_refreshed=True)
    ts = mod_t.add(ts, now, torch.as_tensor(res), torch.as_tensor(vals), (0, 1),
                   torch.as_tensor(valid), tc, pre_refreshed=True)
    return js, ts


def _assert_reads_equal(mod_j, mod_t, js, ts, jc, tc, now, where):
    probe = np.array([0, 17, 4_242, 5, 123, 4_999, -1, 16_383], np.int32)
    got = mod_t.estimate(ts, now, torch.as_tensor(probe), tc).numpy()
    want = np.asarray(mod_j.estimate(js, jnp.int32(now), jnp.asarray(probe), jc))
    np.testing.assert_array_equal(got, want, err_msg=f"{where}: estimate")
    for plane in (0, 1, JGS.RT_PLANE):
        got = mod_t.estimate_plane_mxu(ts, now, torch.as_tensor(probe), plane, tc).numpy()
        want = np.asarray(mod_j.estimate_plane_mxu(None, js, jnp.int32(now), jnp.asarray(probe), plane, jc))
        np.testing.assert_array_equal(got, want, err_msg=f"{where}: estimate_plane_mxu {plane}")


#: tick times: two ticks in one bucket, then bucket by bucket past a full
#: window (every landing, every slack rotation), a skip of two buckets
NOWS = [1_000, 1_030, 1_130, 1_260, 1_390, 1_420, 1_555, 1_790, 1_801, 2_420, 2_999]


@pytest.mark.parametrize("kind", ["salsa", "gsketch"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sketch_matches_reference_tick_by_tick(kind, shape):
    mod_j, mod_t = (JSA, SA) if kind == "salsa" else (JGS, GS)
    jc, tc = _cfgs(shape)
    js, ts = mod_j.init_sketch(jc), mod_t.init_sketch(tc, "cpu")
    _assert_leaves_equal(js, ts, "init")
    rng = np.random.default_rng(7)
    levels = set()
    for i, now in enumerate(NOWS):
        js, ts = _step_both(mod_j, mod_t, js, ts, jc, tc, now, rng, heavy=i < 6)
        _assert_leaves_equal(js, ts, f"tick {i} at {now}")
        _assert_reads_equal(mod_j, mod_t, js, ts, jc, tc, now, f"tick {i}")
        if kind == "salsa":
            levels |= set(torch.unique(SA.unpack_levels(ts.lvlmap, tc.width // 4)).tolist())
            np.testing.assert_array_equal(
                SA.level_histogram(ts, tc).numpy(), np.asarray(JSA.level_histogram(js, jc))
            )
    if kind == "salsa":
        # landed words escalated to each of the three levels along the way
        assert levels == {0, 1, 2}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_salsa_sweep_after_an_idle_gap(shape):
    """Writes, an idle gap longer than the window (the lazy-expiry
    overestimate stays in ``run``), then ``sweep_expired``; and writes
    resuming after it."""
    jc, tc = _cfgs(shape)
    js, ts = JSA.init_sketch(jc), SA.init_sketch(tc, "cpu")
    rng = np.random.default_rng(11)
    for now in (5_000, 5_120, 5_260):
        js, ts = _step_both(JSA, SA, js, ts, jc, tc, now, rng, heavy=True)
    gap = 5_260 + 10 * jc.interval_ms
    _assert_reads_equal(JSA, SA, js, ts, jc, tc, gap, "before the sweep")
    assert int(ts.run.sum()) > 0  # lazily expired contents still counted
    js, ts = JSA.sweep_expired(js, jnp.int32(gap), jc), SA.sweep_expired(ts, gap, tc)
    _assert_leaves_equal(js, ts, "after the sweep")
    assert int(ts.run.sum()) == 0
    for now in (gap, gap + 130, gap + 520):
        js, ts = _step_both(JSA, SA, js, ts, jc, tc, now, rng, heavy=False)
        _assert_leaves_equal(js, ts, f"resumed at {now}")
        _assert_reads_equal(JSA, SA, js, ts, jc, tc, now, f"resumed at {now}")


@pytest.mark.parametrize("kind", ["salsa", "gsketch"])
def test_sketch_across_the_int32_clock_wrap(kind):
    """Engine ms crossing 2^31 - 1 -> -2^31: the window ids (now_ms read as
    uint32) stay continuous in both packages."""
    mod_j, mod_t = (JSA, SA) if kind == "salsa" else (JGS, GS)
    jc, tc = _cfgs("slack")
    js, ts = mod_j.init_sketch(jc), mod_t.init_sketch(tc, "cpu")
    rng = np.random.default_rng(3)
    top = 2**31 - 1
    for now in (top - 250, top - 120, top, -(2**31), -(2**31) + 90, -(2**31) + 260):
        js, ts = _step_both(mod_j, mod_t, js, ts, jc, tc, now, rng, heavy=True)
        _assert_leaves_equal(js, ts, f"at {now}")
        _assert_reads_equal(mod_j, mod_t, js, ts, jc, tc, now, f"at {now}")


def test_packed_word_arithmetic_matches_reference():
    """pack/unpack of the width bitmap, _decode and _land_words on random
    words at every level, deltas that fit, escalate by one level and two,
    and a level-2 sum past the clamp."""
    rng = np.random.default_rng(5)
    shape = (3, 6, 64)
    lvl = rng.integers(0, 3, shape).astype(np.int32)
    words = rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)
    packed = np.asarray(JSA.pack_levels(jnp.asarray(lvl)))
    np.testing.assert_array_equal(SA.pack_levels(torch.as_tensor(lvl)).numpy(), packed)
    np.testing.assert_array_equal(SA.unpack_levels(torch.as_tensor(packed.copy()), 64).numpy(), lvl)
    np.testing.assert_array_equal(
        SA._decode(torch.as_tensor(words), torch.as_tensor(lvl)).numpy(),
        np.asarray(JSA._decode(jnp.asarray(words), jnp.asarray(lvl))),
    )
    # stored words consistent with their levels (lanes within each width)
    words = np.where(lvl == 2, np.abs(words) % 1_000_000, words & 0x7F7F7F7F).astype(np.int32)
    upd = rng.choice([0, 1, 200, 300, 70_000, 2**29], size=shape[:-1] + (256,),
                     p=[0.5, 0.3, 0.08, 0.06, 0.04, 0.02]).astype(np.int32)
    for cap2 in (2**30, 1_000):
        got = SA._land_words(torch.as_tensor(words), torch.as_tensor(lvl), torch.as_tensor(upd), cap2)
        want = JSA._land_words(jnp.asarray(words), jnp.asarray(lvl), jnp.asarray(upd), cap2)
        for g, w, name in zip(got, want, ("words", "lvl", "dec_before", "dec_after")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"cap2={cap2}: {name}")


def test_depth_gather_and_histogram_match_reference():
    """The flat [depth * width] gather (the read every estimate takes) and
    the depth histogram (``add``'s landing), with columns out of range."""
    from sentinel_tpu.ops import tables as JT

    rng = np.random.default_rng(9)
    tab = rng.integers(0, 2**24, (DEPTH, WIDTH)).astype(np.int32)
    cols = rng.integers(-3, WIDTH + 3, (50, DEPTH)).astype(np.int32)
    np.testing.assert_array_equal(
        T.depth_gather_1col(torch.as_tensor(tab), torch.as_tensor(cols), WIDTH).numpy(),
        np.asarray(JT.depth_gather_1col(None, jnp.asarray(tab), jnp.asarray(cols), WIDTH)),
    )
    vals = rng.integers(0, 9, (50, 3)).astype(np.int32)
    valid = rng.random(50) < 0.8
    np.testing.assert_array_equal(
        GS.depth_histogram(torch.as_tensor(cols), torch.as_tensor(vals), torch.as_tensor(valid),
                           DEPTH, WIDTH).numpy(),
        np.asarray(JT.depth_histogram(None, jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(valid),
                                      DEPTH, WIDTH)),
    )


def test_impl_for_and_hbm_bytes():
    from sentinel_tpu_torch.core.config import small_engine_config

    assert impl_for(small_engine_config(sketch_stats=True)) is SA
    assert impl_for(small_engine_config(sketch_stats=True, sketch_salsa=False)) is GS
    for shape in SHAPES:
        jc, tc = _cfgs(shape)
        assert SA.hbm_bytes(tc) == JSA.hbm_bytes(jc)
        st = SA.init_sketch(tc, "cpu")
        assert SA.hbm_bytes(tc) == sum(x.numel() * x.element_size() for x in st)
    with pytest.raises(ValueError):
        SA.init_sketch(GS.SketchConfig(2, 500, 2, 100), "cpu")
