"""The probe kernels' plain versions against their references.

``probe_hist_planes`` is held against the JAX package's own Pallas kernel,
``benchmarks/pallas_histogram.py`` ``pallas_histogram`` in interpret mode.
The other Pallas probes define their kernels inside a ``main()`` that runs
a TPU timing loop, so they cannot be called; their oracle is what those
files themselves assert against — the numpy ``np.add.at`` reference of
``benchmarks/probe_fused_hist.py`` / ``probe_fused_hist2.py`` (for the
count and 5-plane probes of ``probe_pallas_floor.py``: the same reference
with one count plane / five valued planes and that file's drop rule),
transcribed here.

Everything is held to EXACT equality: the sums are of integer-valued data
below 2^24, where float32 addition is exact in any order.  On the CPU the
wrappers run their plain versions; the CUDA kernels are held against the
plain versions by the tests marked ``cuda`` (and by ``chip_smoke.py``).
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu_torch.probes import kernels as PK

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_pallas_histogram():
    spec = importlib.util.spec_from_file_location(
        "_bench_pallas_histogram", ROOT / "benchmarks" / "pallas_histogram.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.pallas_histogram


def _ref_planes(ids, vals, n, n_lo):
    """[P, n_hi * n_lo] int64: np.add.at over the in-range ids, one plane a
    column of vals (the reference of probe_fused_hist.py:141-151)."""
    n_hi = -(-n // n_lo)
    ref = np.zeros((vals.shape[1], n_hi * n_lo), np.int64)
    ok = (ids >= 0) & (ids < n)
    for p in range(vals.shape[1]):
        np.add.at(ref[p], ids[ok], vals[ok, p])
    return ref


def _t(x):
    return torch.as_tensor(x)


def test_hist_planes_equals_the_pallas_histogram_in_interpret_mode():
    pallas_histogram = _load_pallas_histogram()
    rng = np.random.default_rng(11)
    N, B, P = 256, 512, 4
    idx = rng.integers(-3, N + 3, B).astype(np.int32)
    vals = rng.integers(0, 100, (B, P)).astype(np.float32)
    want = np.asarray(
        pallas_histogram(jnp.asarray(idx), jnp.asarray(vals), N, n_tile=128, chunk=128, interpret=True)
    )
    got = PK.probe_hist_planes(_t(idx), _t(vals), N)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, P)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the interpret run drops the out-of-range ids
    np.testing.assert_array_equal(want, _ref_planes(idx, vals.astype(np.int64), N, N).T[:N])


@pytest.mark.parametrize("n,n_lo", [(16392, 512), (16392, 128), (16384, 128), (300, 128), (32777, 128), (5, 8)])
def test_hist_count_equals_the_numpy_reference(n, n_lo):
    rng = np.random.default_rng(n + n_lo)
    ids = rng.integers(-2, n + 3, 4000).astype(np.int32)
    ids[:4] = [-1, n, 2**30, n - 1]
    got = PK.probe_hist_count(_t(ids), n, n_lo)
    n_hi = -(-n // n_lo)
    assert tuple(got.shape) == (n_hi, n_lo) and got.dtype == torch.float32
    want = _ref_planes(ids, np.ones((ids.size, 1), np.int64), n, n_lo)[0]
    np.testing.assert_array_equal(got.numpy().reshape(-1).astype(np.int64), want)
    assert got.sum().item() == ((ids >= 0) & (ids < n)).sum()


@pytest.mark.parametrize("n,n_lo,dtype", [(16392, 128, np.int32), (300, 128, np.int32), (1000, 256, np.float32)])
def test_hist_planes_padded_layout_equals_the_numpy_reference(n, n_lo, dtype):
    """The 5-plane probe's layout: planes-major [5, n_hi, n_lo]."""
    rng = np.random.default_rng(n)
    ids = rng.integers(-2, n + 3, 3000).astype(np.int32)
    vals = rng.integers(0, 200, (3000, 5)).astype(dtype)
    got = PK.probe_hist_planes(_t(ids), _t(vals), n, n_lo)
    assert tuple(got.shape) == (5, -(-n // n_lo), n_lo)
    want = _ref_planes(ids, vals.astype(np.int64), n, n_lo)
    np.testing.assert_array_equal(got.numpy().reshape(5, -1).astype(np.int64), want)


@pytest.mark.parametrize("n,n_lo", [(16640, 128), (16640, 256), (16640, 512), (333, 128)])
def test_hist_stat5_equals_the_numpy_reference(n, n_lo):
    """Three count planes, RT low byte, RT high byte; ids in [0, n + 200)
    as the probe draws them, so some drop."""
    rng = np.random.default_rng(n_lo)
    N = 6000
    ids = rng.integers(0, n + 200, N).astype(np.int32)
    cnts = rng.integers(0, 2, (N, 3), dtype=np.int32)
    rt = rng.integers(0, 40000, N, dtype=np.int32)
    got = PK.probe_hist_stat5(_t(ids), _t(cnts), _t(rt), n, n_lo)
    assert tuple(got.shape) == (5, -(-n // n_lo), n_lo)
    vals = np.concatenate([cnts, (rt & 0xFF)[:, None], ((rt >> 8) & 0xFF)[:, None]], axis=1).astype(np.int64)
    np.testing.assert_array_equal(got.numpy().reshape(5, -1).astype(np.int64), _ref_planes(ids, vals, n, n_lo))


def test_copy_adds_one_in_any_shape():
    x = np.random.default_rng(0).integers(0, 16384, (64, 1, 2048), dtype=np.int32)
    for blocks in (0, 1, 4, 64):
        np.testing.assert_array_equal(PK.probe_copy(_t(x), blocks).numpy(), x + 1)


def test_edge_cases_of_the_plain_versions():
    one = _t(np.array([7], np.int32))
    assert PK.probe_hist_count(one, 8, 8).reshape(-1).tolist() == [0.0] * 7 + [1.0]
    hot = _t(np.full(1000, 3, np.int32))  # every id equal: the hottest row
    assert PK.probe_hist_count(hot, 4, 2).reshape(-1).tolist() == [0.0, 0.0, 0.0, 1000.0]
    none = _t(np.array([-1, 9, 2**30], np.int32))
    assert PK.probe_hist_count(none, 9, 4).sum().item() == 0
    assert tuple(PK.probe_hist_planes(none, torch.ones((3, 2)), 9).shape) == (9, 2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ids = _t(np.zeros(4, np.int32))
    with pytest.raises(ValueError):
        PK.probe_hist_count(ids.to(torch.int64), 4, 2)
    with pytest.raises(ValueError):
        PK.probe_hist_planes(ids, torch.zeros((3, 2)), 4)
    with pytest.raises(ValueError):
        PK.probe_hist_planes(ids, torch.zeros((4, 2), dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        PK.probe_hist_stat5(ids, torch.zeros((4, 2), dtype=torch.int32), ids, 4, 2)
    with pytest.raises(ValueError):
        PK.probe_copy(ids.to(torch.float32))
    with pytest.raises(ValueError):
        PK.probe_hist_count(ids, 4, 0)


def test_the_probe_mains_raise_without_a_card():
    from sentinel_tpu_torch.probes import floor, hist

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    for mod in (floor, hist):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()


def test_probe_data_is_the_reference_probes_data():
    """The probes draw what the TPU probes drew: default_rng(0), the same
    calls in the same order."""
    from sentinel_tpu_torch.probes import floor, hist

    ids, vals = floor.data("cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(ids.numpy(), rng.integers(0, 16384, 131072, dtype=np.int32))
    np.testing.assert_array_equal(vals.numpy(), rng.integers(0, 200, (131072, 5), dtype=np.int32))
    ids, cnts, rt = hist.stat_data("cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(ids.numpy(), rng.integers(0, 16640 + 200, 3 * 131072).astype(np.int32))
    np.testing.assert_array_equal(cnts.numpy(), rng.integers(0, 2, (3 * 131072, 3), dtype=np.int32))
    np.testing.assert_array_equal(rt.numpy(), rng.integers(0, 40000, 3 * 131072, dtype=np.int32))
    assert int(ids.max()) >= 16640  # some ids drop
    # the stat landing as scatter_many jobs gives the probe kernel's sums
    sub = slice(0, 20000)
    fused, split = hist.stat_jobs(ids[sub].contiguous(), cnts[sub].contiguous(), rt[sub].contiguous())
    from sentinel_tpu_torch.ops import fused as FU

    got = PK.probe_hist_stat5(ids[sub].contiguous(), cnts[sub].contiguous(), rt[sub].contiguous(), 16640, 128)
    got = got.reshape(5, -1)[:, :16640]
    (f4,) = FU.scatter_many(fused)
    c3, r1 = FU.scatter_many(split)
    assert torch.equal(f4[:, :3], got[:3].T) and torch.equal(c3, got[:3].T)
    assert torch.equal(f4[:, 3], got[3] + 256.0 * got[4]) and torch.equal(r1[:, 0], f4[:, 3])


# -- the kernels themselves: on the card only ---------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _edge_ids(n, N, rng):
    ids = rng.integers(-2, n + 3, N).astype(np.int32)
    ids[: min(N, 3)] = [-1, n, 2**30][: min(N, 3)]
    return ids


@pytest.mark.cuda
def test_probe_copy_kernel_equals_plain():
    _card()
    x = torch.as_tensor(np.random.default_rng(1).integers(-5, 2**31 - 1, 131072 + 37, dtype=np.int32)).cuda()
    for blocks in (0, 1, 4, 64):
        assert torch.equal(PK.probe_copy(x, blocks), PK.probe_copy_plain(x))
    torch.cuda.synchronize()


def _copy_cases(device="cpu"):
    """name -> (x, out), sliced on ``device``: a 4-byte-misaligned view,
    sizes off a multiple of 4 and below 4, an ``out`` not aligned as ``x``
    is, int32 wrap."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.integers(-(2**31), 2**31 - 1, 131072 + 11, dtype=np.int32)).to(device)
    x[1] = 2**31 - 1
    buf = torch.zeros(131072 + 16, dtype=torch.int32, device=device)
    return {
        "x[1:]": (x[1:], None),
        "x[3:131074]": (x[3:131074], None),
        "n % 4 = 3": (x[: 4 * 1000 + 3], None),
        "n = 3": (x[:3], None),
        "n = 1": (x[1:2], None),
        "n = 0": (x[:0], None),
        "out misaligned": (x[: 131072 + 5], buf[2 : 131072 + 7]),
        "x and out misaligned alike": (x[1:131074], buf[1:131074]),
    }


COPY_CASES = list(_copy_cases())


@pytest.mark.parametrize("case", COPY_CASES)
def test_copy_adds_one_on_views_and_ragged_sizes(case):
    x, out = _copy_cases()[case]
    want = x.numpy().astype(np.int64) + 1
    want = np.where(want > 2**31 - 1, want - 2**32, want)  # int32 wrap
    np.testing.assert_array_equal(PK.probe_copy(x, 4, out=out).numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", COPY_CASES)
def test_probe_copy_kernel_on_views_and_ragged_sizes(case):
    """16-byte accesses with a scalar head and tail: exact for every grid
    of the P3 series, on views that keep their offsets on the card."""
    _card()
    x, out = _copy_cases("cuda")[case]
    for blocks in (0, 1, 4, 64, 512):
        got = PK.probe_copy(x, blocks, out=None if out is None else out.fill_(7))
        assert torch.equal(got, PK.probe_copy_plain(x)), blocks
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_probe_hist_count_kernel_equals_plain():
    _card()
    rng = np.random.default_rng(2)
    for n, n_lo in [(16392, 128), (32777, 128), (16384, 512)]:
        for N in (1, 2049, 131072):
            ids = torch.as_tensor(_edge_ids(n, N, rng)).cuda()
            for ipb in (1, 256, 4096):
                assert torch.equal(PK.probe_hist_count(ids, n, n_lo, ipb), PK.probe_hist_count_plain(ids, n, n_lo))
    hot = torch.full((131072,), 5, dtype=torch.int32, device="cuda")
    assert torch.equal(PK.probe_hist_count(hot, 16392, 128), PK.probe_hist_count_plain(hot, 16392, 128))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_probe_hist_planes_kernel_equals_plain():
    _card()
    rng = np.random.default_rng(3)
    for N in (1, 2049, 131072):
        ids = torch.as_tensor(_edge_ids(8192, N, rng)).cuda()
        vf = torch.as_tensor(rng.integers(0, 100, (N, 4)).astype(np.float32)).cuda()
        vi = torch.as_tensor(rng.integers(0, 200, (N, 5), dtype=np.int32)).cuda()
        assert torch.equal(PK.probe_hist_planes(ids, vf, 8192), PK.probe_hist_planes_plain(ids, vf, 8192))
        assert torch.equal(PK.probe_hist_planes(ids, vi, 8000, 128, 1024), PK.probe_hist_planes_plain(ids, vi, 8000, 128))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_probe_hist_stat5_kernel_equals_plain():
    _card()
    rng = np.random.default_rng(4)
    for N in (1, 2049, 393216):
        ids = torch.as_tensor(rng.integers(0, 16840, N).astype(np.int32)).cuda()
        cnts = torch.as_tensor(rng.integers(0, 2, (N, 3), dtype=np.int32)).cuda()
        rt = torch.as_tensor(rng.integers(0, 40000, N, dtype=np.int32)).cuda()
        for n_lo in (128, 256, 512):
            assert torch.equal(
                PK.probe_hist_stat5(ids, cnts, rt, 16640, n_lo), PK.probe_hist_stat5_plain(ids, cnts, rt, 16640, n_lo)
            )
    torch.cuda.synchronize()


# -- the valued histograms' launch plan (pure Python) -------------------------------

#: (n, planes, n_lo): the probes' shapes, edge shapes, a table larger than one
#: cluster's shared memory (100,000 x 5 planes: 2 MB) and one larger than all
#: the clusters' that fill the card (2,000,000 x 4: 32 MB)
PLAN_SHAPES = [
    (8192, 4, None), (16392, 5, 128), (16640, 5, 128), (16640, 5, 256), (16640, 5, 512),
    (1, 4, None), (1, 5, 1), (5, 5, 8), (16392, 5, 128), (32777, 5, 128), (8000, 5, 128), (9, 3, None),
    (100_000, 5, 128), (2_000_000, 4, None),
]


@pytest.mark.parametrize("n,planes,n_lo", PLAN_SHAPES)
@pytest.mark.parametrize("sms,max_clusters", [(132, 7), (132, None), (114, None), (132, 2), (1, None)])
def test_hist_plan_owns_every_row_once_within_shared_memory(n, planes, n_lo, sms, max_clusters):
    plan = PK.hist_plan(n, planes, n_lo, sms, max_clusters)
    cluster = PK.CLUSTER
    rows = n if n_lo is None else -(-n // n_lo) * n_lo
    assert plan.rows == rows and plan.planes == planes
    assert 1 <= plan.cluster <= PK.MAX_CLUSTER and plan.threads == PK.HIST_THREADS
    assert plan.rows_per_block >= 4 and plan.rows_per_block % 4 == 0
    queues = PK.HIST_THREADS // 32 * PK.QUEUE_BYTES_A_WARP
    assert plan.smem_bytes == 8 * cluster * plan.rows_per_block * planes + queues <= 232_448
    owned = np.zeros(rows, np.int64)
    for c in range(plan.clusters):
        lo_c = plan.block_rows(c, 0)[0]
        assert lo_c < rows  # no cluster without a row
        for b in range(plan.cluster):
            lo, hi = plan.block_rows(c, b)
            assert lo <= hi
            owned[lo:hi] += 1
    np.testing.assert_array_equal(owned, np.ones(rows, np.int64))
    # as many clusters as fill the SMs, more only when a block's shared memory
    # holds no more rows
    assert plan.clusters == -(-rows // (cluster * plan.rows_per_block))
    if plan.clusters > max(1, min(sms // cluster, max_clusters or sms)):
        assert 8 * cluster * (plan.rows_per_block + 4) * planes + queues > PK.MAX_SMEM_BYTES
    if 4 * rows * planes > 232_448:
        assert plan.clusters > 1


def test_hist_plan_of_an_empty_table_launches_nothing():
    assert PK.hist_plan(0, 5, 128).clusters == 0
    assert PK.hist_plan(0, 4).clusters == 0
    with pytest.raises(ValueError):
        PK.hist_plan(10, 2_000)  # rows of 2,000 planes: not 4 rows a block
    with pytest.raises(ValueError):
        PK.hist_plan(10, 4, None, 132, 0)


def _plain_by_plan(ids, values, n, n_lo, plan):
    """The plain version computed cluster slice by cluster slice and written
    block by block, as the kernel cuts the table."""
    P = values.shape[1]
    flat = torch.full((P, plan.rows), float("nan"))
    for c in range(plan.clusters):
        lo = plan.block_rows(c, 0)[0]
        hi = min(lo + plan.cluster * plan.rows_per_block, n)
        span = max(hi - lo, 0)
        local = torch.where((ids >= lo) & (ids < lo + span), ids - lo, -1).to(torch.int32)
        part = PK.probe_hist_planes_plain(local, values, span)  # [span, P]
        for b in range(plan.cluster):
            r0, r1 = plan.block_rows(c, b)
            flat[:, r0:r1] = 0.0
            k1 = min(r1, lo + span)
            if k1 > r0:
                flat[:, r0:k1] = part[r0 - lo:k1 - lo].T
    if n_lo is None:
        return flat.T.contiguous()
    return flat.view(P, -1, n_lo)


@pytest.mark.parametrize("n,n_lo,planes,dtype", [
    (8192, None, 4, np.float32), (16392, 128, 5, np.int32), (32777, 128, 5, np.int32), (5, 8, 5, np.int32),
    (1, None, 3, np.float32), (100_000, 128, 5, np.int32),
])
def test_the_plain_version_cut_as_the_plan_cuts_it_is_the_plain_version(n, n_lo, planes, dtype):
    rng = np.random.default_rng(n + planes)
    N = 5000
    ids = rng.integers(-2, n + 3, N).astype(np.int32)
    plan = PK.hist_plan(n, planes, n_lo)
    # ids on every block's first and last row
    edges = [r for c in range(plan.clusters) for b in range(plan.cluster)
             for lo, hi in [plan.block_rows(c, b)] if hi > lo for r in (lo, hi - 1) if r < n]
    ids[: len(edges)] = np.array(edges[:N], np.int32)
    vals = rng.integers(0, 200, (N, planes)).astype(dtype)
    got = _plain_by_plan(_t(ids), _t(vals), n, n_lo, plan)
    want = PK.probe_hist_planes_plain(_t(ids), _t(vals), n, n_lo)
    assert got.shape == want.shape and torch.equal(got, want)


def test_items_per_block_below_one_is_refused():
    ids = _t(np.zeros(4, np.int32))
    with pytest.raises(ValueError):
        PK._hist_launch("probe_hist_planes", None, ids, PK.hist_plan(4, 2), 0)


@pytest.mark.cuda
def test_cluster_histograms_on_every_slice_boundary_equal_plain():
    _card()
    rng = np.random.default_rng(6)
    for n, n_lo in [(16640, 128), (16392, 128), (32777, 128), (8192, None), (5, 8), (100_000, 128)]:
        plan = PK.card_plan(torch.device("cuda"), n, 5, n_lo)
        edges = np.array([r for c in range(plan.clusters) for b in range(plan.cluster)
                          for lo, hi in [plan.block_rows(c, b)] if hi > lo for r in (lo, hi - 1) if r < n], np.int32)
        ids = np.concatenate([edges, edges, rng.integers(-2, n + 3, 4099).astype(np.int32)])
        N = ids.size
        ids = torch.as_tensor(ids).cuda()
        vals = torch.as_tensor(rng.integers(0, 200, (N, 5), dtype=np.int32)).cuda()
        cnts = torch.as_tensor(rng.integers(0, 2, (N, 3), dtype=np.int32)).cuda()
        rt = torch.as_tensor(rng.integers(0, 40000, N, dtype=np.int32)).cuda()
        for ipb in (1, 256, 4096):
            assert torch.equal(PK.probe_hist_planes(ids, vals, n, n_lo, ipb), PK.probe_hist_planes_plain(ids, vals, n, n_lo))
            if n_lo is not None:
                assert torch.equal(PK.probe_hist_stat5(ids, cnts, rt, n, n_lo, ipb),
                                   PK.probe_hist_stat5_plain(ids, cnts, rt, n, n_lo))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cluster_histograms_overwrite_a_nan_filled_out_in_one_launch():
    _card()
    rng = np.random.default_rng(7)
    for N in (0, 1, 131072 + 37):
        ids = torch.as_tensor(rng.integers(0, 16840, N).astype(np.int32)).cuda()
        cnts = torch.as_tensor(rng.integers(0, 2, (N, 3), dtype=np.int32)).cuda()
        rt = torch.as_tensor(rng.integers(0, 40000, N, dtype=np.int32)).cuda()
        vf = torch.as_tensor(rng.integers(0, 100, (N, 4)).astype(np.float32)).cuda()
        for n_lo in (128, 512):
            out = torch.full((5,) + PK.padded_shape(16640, n_lo), float("nan"), device="cuda")
            PK.reset_launches()
            got = PK.probe_hist_stat5(ids, cnts, rt, 16640, n_lo, out=out)
            assert got.data_ptr() == out.data_ptr() and PK.LAUNCHES["probe_hist_stat5"] == 1
            assert torch.equal(got, PK.probe_hist_stat5_plain(ids, cnts, rt, 16640, n_lo))
        out = torch.full((8192, 4), float("nan"), device="cuda")
        PK.reset_launches()
        got = PK.probe_hist_planes(ids, vf, 8192, out=out)
        assert PK.LAUNCHES["probe_hist_planes"] == 1
        assert torch.equal(got, PK.probe_hist_planes_plain(ids, vf, 8192))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,n_lo", [(16392, 512), (16392, 128), (16384, 128), (16384, 512), (32777, 128),
                                    (5, 8), (100_000, 128)])
@pytest.mark.parametrize("sms,max_clusters", [(132, None), (132, 2), (1, None)])
def test_count_plan_owns_every_row_once_in_int_cells(n, n_lo, sms, max_clusters):
    """The count's plan: one plane of 4-byte int cells and no queue in a
    block's shared memory, every row (padding included) owned once."""
    plan = PK.hist_plan(n, 1, n_lo, sms, max_clusters, counts=True)
    rows = -(-n // n_lo) * n_lo
    assert plan.rows == rows and plan.planes == 1 and plan.rows_per_block % 4 == 0
    assert plan.threads == PK.COUNT_THREADS
    cap = PK.MAX_SMEM_BYTES // (PK.COUNT_CELL_BYTES * plan.cluster) // 4 * 4
    if rows <= PK.COUNT_MAX_CLUSTERS * plan.cluster * cap:  # every id read by at most 4 clusters
        assert plan.clusters <= PK.COUNT_MAX_CLUSTERS
    assert plan.smem_bytes == PK.COUNT_CELL_BYTES * plan.cluster * plan.rows_per_block <= PK.MAX_SMEM_BYTES
    owned = np.zeros(rows, np.int64)
    for c in range(plan.clusters):
        for b in range(plan.cluster):
            lo, hi = plan.block_rows(c, b)
            owned[lo:hi] += 1
    np.testing.assert_array_equal(owned, np.ones(rows, np.int64))
    assert plan.clusters == -(-rows // (plan.cluster * plan.rows_per_block))


@pytest.mark.cuda
def test_probe_hist_count_is_one_cluster_launch_at_the_count_shapes():
    """At the five COUNT_SHAPES (131,072 ids, as probes/floor.py draws them
    and with ids outside [0, n)): one launch a call, no memset — an out
    filled with NaN comes back whole, the padding cells 0."""
    _card()
    from sentinel_tpu_torch.probes import floor as FL

    ids, _vals = FL.data("cuda")
    edge = torch.as_tensor(_edge_ids(16392, ids.shape[0], np.random.default_rng(8))).cuda()
    for n, n_lo in FL.COUNT_SHAPES:
        for x in (ids, edge):
            out = torch.full(PK.padded_shape(n, n_lo), float("nan"), device="cuda")
            PK.reset_launches()
            got = PK.probe_hist_count(x, n, n_lo, out=out)
            assert got.data_ptr() == out.data_ptr() and PK.LAUNCHES["probe_hist_count"] == 1
            want = PK.probe_hist_count_plain(x, n, n_lo)
            assert torch.equal(got, want) and not got.reshape(-1)[n:].any()
            assert int(got.sum()) == int(((x >= 0) & (x < n)).sum())
    torch.cuda.synchronize()
