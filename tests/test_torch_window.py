"""The port's window, rowmin, rank, degrade and rtq modules against their
JAX counterparts, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.ops import degrade as JD
from sentinel_tpu.ops import rank as JRK
from sentinel_tpu.ops import rowmin as JRM
from sentinel_tpu.ops import rtq as JRQ
from sentinel_tpu.ops import window as JW
from sentinel_tpu_torch.ops import degrade as D
from sentinel_tpu_torch.ops import rank as RK
from sentinel_tpu_torch.ops import rowmin as RM
from sentinel_tpu_torch.ops import rtq as RQ
from sentinel_tpu_torch.ops import window as W


def _eq_window(j, t):
    for name in W.WindowState._fields:
        a = np.asarray(getattr(j, name))
        b = getattr(t, name).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 500), (6, 100)])
def test_window_ring_matches_jax(shape):
    """refresh / add_dense / min_into_row / the running sums across bucket
    rotations, idle gaps longer than the window, and reads between."""
    nb, wms = shape
    cfg_j, cfg_t = JW.WindowConfig(nb, wms), W.WindowConfig(nb, wms)
    rows = 24
    rng = np.random.default_rng(nb)
    with jax.disable_jit():
        js = JW.init_window(rows, cfg_j)
    ts = W.init_window(rows, cfg_t, "cpu")
    now = 1_000
    for step in range(14):
        now += int(rng.choice([0, 37, wms, wms + 3, 3 * nb * wms + 11]))
        hist = rng.integers(0, 5, (rows, W.NUM_EVENTS)).astype(np.int32)
        rt = (rng.integers(0, 400, rows) / 8.0).astype(np.float32)
        mins = (rng.integers(1, 400, rows) / 8.0).astype(np.float32)
        present = rng.random(rows) < 0.5
        entry_min = np.float32(rng.integers(1, 400) / 8.0)
        with jax.disable_jit():
            js = JW.add_dense(js, jnp.int32(now), jnp.asarray(hist), jnp.asarray(rt), cfg_j,
                              row_min=(jnp.asarray(mins), jnp.asarray(present)))
            js = JW.min_into_row(js, jnp.int32(now), 0, jnp.float32(entry_min), cfg_j)
            jmask = np.asarray(JW.valid_mask(js, jnp.int32(now), cfg_j))
            jcounts = np.asarray(JW.window_counts(js, jnp.int32(now), cfg_j))
        ts = W.add_dense(ts, now, torch.as_tensor(hist), torch.as_tensor(rt), cfg_t,
                         row_min=(torch.as_tensor(mins), torch.as_tensor(present)))
        ts = W.min_into_row(ts, now, 0, torch.tensor(entry_min), cfg_t)
        _eq_window(js, ts)
        np.testing.assert_array_equal(W.valid_mask(ts, now, cfg_t).numpy(), jmask)
        np.testing.assert_array_equal(W.window_counts(ts, now, cfg_t).numpy(), jcounts)
        # the running sums equal the exact masked read after a refresh
        np.testing.assert_array_equal(W.window_counts_run(ts).numpy(), jcounts)
    assert W.wid_of(2**31 + 5, 500) == int(JW.wid_of(jnp.asarray(2**31 + 5, jnp.uint32).astype(jnp.int32), 500))


def test_rowmin_heads_and_combine_match_jax():
    rng = np.random.default_rng(5)
    n = 300
    rows = rng.integers(-3, 40, n).astype(np.int32)
    vals = (rng.integers(-8, 800, n) / 8.0).astype(np.float32)
    valid = rng.random(n) < 0.9
    jr, jv = JRM.min_heads(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(valid), 32)
    tr, tv = RM.min_heads(torch.as_tensor(rows), torch.as_tensor(vals), torch.as_tensor(valid), 32)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # land the heads (a plain sum per row) and decode
    hist = np.zeros((32, 3), np.float32)
    for r, v in zip(np.asarray(jr), np.asarray(jv)):
        if r >= 0:
            hist[r] += v
    jm, jp = JRM.combine(jnp.asarray(hist))
    tm, tp = RM.combine(torch.as_tensor(hist))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # and the decoded minimum is the true per-row minimum of the valid values
    ok = valid & (rows >= 0) & (rows < 32) & (vals > 0)
    for r in range(32):
        sel = ok & (rows == r)
        assert tp[r].item() == bool(sel.any())
        if sel.any():
            assert tm[r].item() == vals[sel].min()


@pytest.mark.parametrize("n", [7, 300])
def test_grouped_exclusive_cumsum_matches_both_jax_variants(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 9, n).astype(np.int32)
    vals = [rng.integers(0, 4, n).astype(np.float32), np.ones(n, np.float32)]
    elig = rng.random(n) < 0.7
    got = RK.grouped_exclusive_cumsum(torch.as_tensor(keys), [torch.as_tensor(v) for v in vals], torch.as_tensor(elig))
    with jax.disable_jit():
        ref = JRK.grouped_exclusive_cumsum(jnp.asarray(keys), [jnp.asarray(v) for v in vals], jnp.asarray(elig))
        ref_small = JRK.grouped_exclusive_cumsum_small(
            jnp.asarray(keys), [jnp.asarray(v) for v in vals], jnp.asarray(elig), 9
        )
    for g, r, s in zip(got, ref, ref_small):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(s))


def test_breaker_columns_and_rtq_match_jax():
    rng = np.random.default_rng(11)
    D1, nb = 9, 2
    counts = rng.integers(0, 5, (D1, nb, 3)).astype(np.int32)
    epochs = rng.integers(-3, 4, (D1, nb)).astype(np.int32)
    wms = rng.integers(0, 700, D1).astype(np.int32)
    for now in (0, 999, 1500, 2**20 + 7):
        jc, je, ji = JD.refresh_columns(jnp.asarray(counts), jnp.asarray(epochs), jnp.asarray(wms), jnp.int32(now))
        tc, te, ti = D.refresh_columns(torch.as_tensor(counts), torch.as_tensor(epochs), torch.as_tensor(wms), now)
        for a, b in ((jc, tc), (je, te), (ji, ti)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        js = JD.window_sums(jc, je, jnp.asarray(wms), jnp.int32(now))
        np.testing.assert_array_equal(D.window_sums(tc, te, torch.as_tensor(wms), now).numpy(), np.asarray(js))
    rcfg_j, rcfg_t = JRQ.RtqConfig(2, 500, 5000.0), RQ.RtqConfig(2, 500, 5000.0)
    jq, tq = JRQ.init_rtq(rcfg_j), RQ.init_rtq(rcfg_t, "cpu")
    for now in (1000, 1200, 1700, 4000):
        rt = (rng.integers(0, 40000, 64) / 8.0).astype(np.float32)
        ok = rng.random(64) < 0.8
        with jax.disable_jit():
            jq = JRQ.add(jq, jnp.int32(now), jnp.asarray(rt), jnp.asarray(ok), rcfg_j)
        tq = RQ.add(tq, now, torch.as_tensor(rt), torch.as_tensor(ok), rcfg_t)
        np.testing.assert_array_equal(tq.counts.numpy(), np.asarray(jq.counts))
        np.testing.assert_array_equal(tq.epochs.numpy(), np.asarray(jq.epochs))
