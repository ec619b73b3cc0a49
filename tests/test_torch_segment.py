"""ops/segment.py: every function of the port against the JAX package's,
on the same seeded sorted batches.  Compacted outputs are compared on live
slots only: the JAX package compacts through an unstable sort whose dead
slots hold junk, and the port's dead slots hold other junk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.ops import segment as JSG
from sentinel_tpu_torch.ops import segment as SG


def _sorted_keys(rng, n, space, aux=3):
    k1 = rng.integers(0, space, n).astype(np.int32)
    k2 = rng.integers(0, aux, n).astype(np.int32)
    order = np.lexsort((k2, k1))
    return k1[order], k2[order]


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _ctx_pair(keys, U, payloads=()):
    with jax.disable_jit():
        jctx, jcomp = JSG.build([_j(k) for k in keys], U, [_j(p) for p in payloads])
        jctx = jax.tree.map(np.asarray, jctx)
        jcomp = [np.asarray(c) for c in jcomp]
    tctx, tcomp = SG.build([_t(k) for k in keys], U, [_t(p) for p in payloads])
    return jctx, jcomp, tctx, tcomp


# (n, key space, U): U below the live count (overflow), U above n, U == n
CASES = [(700, 40, 96), (700, 400, 600), (96, 30, 128), (300, 3, 300), (1, 1, 4)]


@pytest.mark.parametrize("n,space,U", CASES)
def test_build_heads_structure_and_payloads(n, space, U):
    rng = np.random.default_rng(n + space)
    k1, k2 = _sorted_keys(rng, n, space)
    pay_i = rng.integers(-5, 1000, n).astype(np.int32)
    pay_f = rng.random(n).astype(np.float32)
    jctx, jcomp, tctx, tcomp = _ctx_pair([k1, k2], U, [pay_i, pay_f])
    np.testing.assert_array_equal(tctx.head.numpy(), jctx.head)
    np.testing.assert_array_equal(tctx.sid.numpy(), jctx.sid)
    assert int(tctx.n_seg) == int(jctx.n_seg)
    assert bool(tctx.ok) == bool(jctx.ok)
    assert tctx.U == U
    live = jctx.live
    np.testing.assert_array_equal(tctx.live.numpy(), live)
    np.testing.assert_array_equal(tctx.seg_end.numpy()[live], jctx.seg_end[live])
    for t, j in zip(tcomp, jcomp):
        assert t.shape == (U,)
        np.testing.assert_array_equal(t.numpy()[live], j[live])
    if (n, space, U) == (700, 40, 96):
        assert not bool(tctx.ok)  # this case overflows
    # heads_from_keys alone, and build_from_head on its result
    with jax.disable_jit():
        jh = np.asarray(JSG.heads_from_keys(_j(k1), _j(k2)))
    th = SG.heads_from_keys(_t(k1), _t(k2))
    np.testing.assert_array_equal(th.numpy(), jh)
    tctx2, _ = SG.build_from_head(th, U)
    np.testing.assert_array_equal(tctx2.seg_end.numpy()[live], jctx.seg_end[live])


@pytest.mark.parametrize("n,space,U", CASES[:3])
def test_compact_expand_and_seg_min(n, space, U):
    rng = np.random.default_rng(3 * n)
    k1, k2 = _sorted_keys(rng, n, space)
    jctx, _, tctx, _ = _ctx_pair([k1, k2], U)
    live = jctx.live
    with jax.disable_jit():
        jc = np.asarray(JSG.compact(jctx_j := jax.tree.map(jnp.asarray, jctx), _j(k1 * 3), fill=-7))
        jc2 = np.asarray(JSG.compact(jctx_j, _j(np.stack([k1, k2], 1)), fill=-7))
        seg_vals = np.arange(U * 2, dtype=np.int32).reshape(U, 2)
        je = np.asarray(JSG.expand(jctx_j, _j(seg_vals)))
        v = (rng.random(n) * 50).astype(np.float32)
    jm = np.asarray(jax.jit(JSG.seg_min_f32, static_argnums=2)(jctx_j, _j(v), 3.0e38))
    np.testing.assert_array_equal(SG.compact(tctx, _t(k1 * 3), fill=-7).numpy(), jc)
    np.testing.assert_array_equal(SG.compact(tctx, _t(np.stack([k1, k2], 1)), fill=-7).numpy(), jc2)
    # expand clamps the items past the capacity to slot U-1, as JAX's gather does
    np.testing.assert_array_equal(SG.expand(tctx, _t(seg_vals)).numpy(), je)
    np.testing.assert_array_equal(SG.seg_min_f32(tctx, _t(v), 3.0e38).numpy()[live], jm[live])


@pytest.mark.parametrize("maxes", [(1, 255), (255, 40_000), ((1 << 24) - 1, 1)])
def test_cum_cols_sums_from_ce_and_seg_sums(maxes):
    rng = np.random.default_rng(sum(maxes) % 1000)
    n, U = 900, 512
    k1, k2 = _sorted_keys(rng, n, 60)
    planes = [rng.integers(0, m + 1, n).astype(np.int32) for m in maxes]
    jctx, _, tctx, _ = _ctx_pair([k1, k2], U)
    live = jctx.live
    with jax.disable_jit():
        jrows, jsplit = JSG.cum_cols([_j(p) for p in planes], list(maxes))
        jsums = JSG.seg_sums(jax.tree.map(jnp.asarray, jctx), [_j(p) for p in planes], list(maxes))
    trows, tsplit = SG.cum_cols([_t(p) for p in planes], list(maxes))
    assert tsplit == jsplit
    for t, j in zip(trows, jrows):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    tsums = SG.seg_sums(tctx, [_t(p) for p in planes], list(maxes))
    ce = [r[tctx.seg_end.long()] for r in trows]
    tsums2 = SG.sums_from_ce(tctx, ce, tsplit)
    # the oracle: per-segment sums of each plane
    sid = np.asarray(jctx.sid)
    for p, (tp, jp, tp2) in enumerate(zip(tsums, jsums, tsums2)):
        assert [(w, d) for _a, w, d in tp] == [(w, d) for _a, w, d in jp]
        for (ta, _w, _d), (ja, _w2, _d2), (ta2, _w3, _d3) in zip(tp, jp, tp2):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
            np.testing.assert_array_equal(ta2.numpy(), np.asarray(ja))
        total = sum(a.numpy().astype(np.int64) * w for a, w, _d in tp)
        want = np.bincount(sid, weights=planes[p].astype(np.float64), minlength=U)[:U]
        np.testing.assert_array_equal(total[live], want[live].astype(np.int64))


@pytest.mark.parametrize("n", [1, 300, 2049])
def test_seg_excl_cumsum_and_wide(n):
    rng = np.random.default_rng(n)
    head = rng.random(n) < 0.1
    head[0] = True
    v = rng.integers(0, (2**31 - 1) // n + 1, (3, n)).astype(np.int32)
    w = rng.integers(0, 1 << 24, n).astype(np.int32)
    # jitted: the eager associative scans cost seconds per call on the CPU
    jv = np.asarray(jax.jit(JSG.seg_excl_cumsum)(_j(head), _j(v)))
    jv1 = np.asarray(jax.jit(JSG.seg_excl_cumsum)(_j(head), _j(v[0])))
    jw = np.asarray(jax.jit(JSG.seg_excl_cumsum_wide)(_j(head), _j(w)))
    jb = np.asarray(
        jax.jit(JSG.block_min_inclusive, static_argnums=2)(_j(head), _j(w.astype(np.float32)), 3.0e38)
    )
    np.testing.assert_array_equal(SG.seg_excl_cumsum(_t(head), _t(v)).numpy(), jv)
    np.testing.assert_array_equal(SG.seg_excl_cumsum(_t(head), _t(v[0])).numpy(), jv1)
    np.testing.assert_array_equal(SG.seg_excl_cumsum_wide(_t(head), _t(w)).numpy(), jw)
    np.testing.assert_array_equal(
        SG.block_min_inclusive(_t(head), _t(w.astype(np.float32)), 3.0e38).numpy(), jb
    )


def test_sort_batch_and_unsort_round_trip():
    rng = np.random.default_rng(11)
    n = 500
    k1 = rng.integers(0, 20, n).astype(np.int32)
    k2 = rng.integers(0, 4, n).astype(np.int32)
    pay = rng.integers(0, 10**6, n).astype(np.int32)
    with jax.disable_jit():
        jperm, (jk1, jpay) = JSG.sort_batch([_j(k1), _j(k2)], [_j(k1), _j(pay)])
        (jback,) = JSG.unsort(jperm, [jpay])
    tperm, (tk1, tpay) = SG.sort_batch([_t(k1), _t(k2)], [_t(k1), _t(pay)])
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))  # stable: one answer
    np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(tperm.numpy(), np.lexsort((k2, k1)))
    (tback,) = SG.unsort(tperm, [tpay])
    np.testing.assert_array_equal(tback.numpy(), np.asarray(jback))
    np.testing.assert_array_equal(tback.numpy(), pay)
