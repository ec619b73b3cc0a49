"""scatter_many / gather_many: the port's plain versions against the JAX
package's Pallas kernels (interpret mode, as tests/test_fused.py runs
them) and against numpy, exactly; and the CUDA kernels against the plain
versions on the card (marked ``cuda``; skipped without one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.ops import fused as JFU
from sentinel_tpu_torch.ops import fused as FU


def _np_scatter(n, rows, vals, digits):
    """numpy oracle: [n, P] sums of value mod 256**d, ids outside [0, n) drop."""
    R = rows.shape[0]
    P = len(digits)
    out = np.zeros((n, P), np.int64)
    for r in range(R):
        v = vals[r] if vals.ndim == 3 else vals
        for i, k in enumerate(rows[r]):
            if 0 <= k < n:
                for p in range(P):
                    out[k, p] += int(v[p, i]) & ((1 << (8 * digits[p])) - 1)
    return out.astype(np.float32)


def _jobs(rng, N):
    """(name, n, rows, values, digits): out-of-range ids (-1, n, 2**30),
    values at and above 256**digits, per-row values, N not a tile multiple."""
    def ids(R, n):
        x = rng.integers(-2, n + 2, (R, N)).astype(np.int32)
        x[:, :3] = [-1, n, 2**30]
        return x

    return [
        ("stat", 300, ids(3, 300), rng.integers(0, 300, (3, N)).astype(np.int32), (1, 1, 2)),
        ("cb", 40, ids(2, 40), rng.integers(0, 2, (2, 3, N)).astype(np.int32), (1, 1, 1)),
        ("wide", 17, ids(1, 17), rng.integers(0, 1 << 20, (2, N)).astype(np.int32), (3, 2)),
    ]


@pytest.mark.parametrize("N", [96, 131])
def test_scatter_many_plain_matches_pallas_and_numpy(N):
    rng = np.random.default_rng(N)
    jobs = _jobs(rng, N)
    got = FU.scatter_many(
        [FU.Job(nm, n, torch.as_tensor(r), torch.as_tensor(v), d) for nm, n, r, v, d in jobs]
    )
    with jax.disable_jit():
        ref = JFU.scatter_many(
            [JFU.Job(nm, n, jnp.asarray(r), jnp.asarray(v), d) for nm, n, r, v, d in jobs]
        )
    for (nm, n, r, v, d), g, w in zip(jobs, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=nm)
        np.testing.assert_array_equal(g.numpy(), _np_scatter(n, r, v, d), err_msg=nm)


def test_scatter_many_empty_job_and_cpu_dispatch():
    FU.reset_launches()
    rows = torch.tensor([[0, 1, -1, 5]], dtype=torch.int32)
    vals = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    empty, small = FU.scatter_many(
        [FU.Job("empty", 0, rows, vals, (1,)), FU.Job("small", 2, rows, vals, (1,))]
    )
    assert empty.shape == (0, 1)
    np.testing.assert_array_equal(small.numpy(), [[1.0], [2.0]])
    # CPU tensors take the plain version: no kernel launch is counted
    assert FU.LAUNCHES == {"scatter_many": 0, "gather_many": 0}


@pytest.mark.parametrize("N", [96, 131])
def test_gather_many_plain_matches_pallas_and_numpy(N):
    rng = np.random.default_rng(7 + N)
    n = 300
    table = rng.integers(0, (1 << 24) - 1, (n, 3)).astype(np.int32)
    table[:5, 1] = rng.integers(1 << 24, 1 << 30, 5)  # above 256**3: truncates
    ids = rng.integers(-2, n + 2, N).astype(np.int32)
    ids[:3] = [-1, n, 2**30]
    (got,) = FU.gather_many([FU.GatherJob("t", torch.as_tensor(ids), torch.as_tensor(table), (3, 3, 3))])
    with jax.disable_jit():
        (ref,) = JFU.gather_many([JFU.GatherJob("t", jnp.asarray(ids), jnp.asarray(table), (3, 3, 3))])
    ok = (ids >= 0) & (ids < n)
    want = np.where(ok[:, None], table[np.clip(ids, 0, n - 1)] & 0xFFFFFF, 0).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_reject_mixed_or_malformed_jobs():
    ids = torch.zeros(4, dtype=torch.int32)
    meta = torch.zeros((4, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):  # not all on the CPU, not all on one CUDA device
        FU.gather_many([FU.GatherJob("mixed", ids, meta, (1,))])
    with pytest.raises(ValueError):
        FU.scatter_many([FU.Job("mixed", 4, ids[None, :], meta.T, (1,))])
    with pytest.raises(ValueError):
        FU.scatter_many([FU.Job("bad", 4, ids[None, :], torch.zeros((2, 4), dtype=torch.int32), (1,))])
    with pytest.raises(ValueError):
        FU.gather_many([FU.GatherJob("bad", ids, torch.zeros((4, 2), dtype=torch.int32), (1,))])


def test_scatter_descriptors_point_each_unit_at_its_own_rows_and_values():
    """The launch plan (built on the host, the same for any device): one
    descriptor per job with its rows / values pointers, element strides
    that put row-vector r at its own rows and values, the job's output
    offset, and (n, P, R, shared-memory flag, dtypes, masks).  Operands
    the kernel reads in place are not copied; others become int32 copies."""
    N = 8
    shared = torch.zeros((2, N), dtype=torch.int32)
    per_row = torch.zeros((3, 2, N), dtype=torch.uint8)
    rows_a = torch.zeros((1, N), dtype=torch.int32)
    rows_b = torch.zeros((3, N), dtype=torch.int16)  # read in place
    rows_c = torch.zeros((N, 2), dtype=torch.int64).T  # a transposed view
    vals_c = torch.zeros((1, N), dtype=torch.float32)  # converted to an int32 copy
    jobs = [FU.Job("a", 100_000, rows_a, shared, (1, 4)), FU.Job("b", 10, rows_b, per_row, (2, 3)),
            FU.Job("c", 7, rows_c, vals_c, (1,))]
    plan = FU._plan(jobs)
    keep = FU._bind(plan, jobs)
    assert plan.desc.shape == (3, 11) and plan.offsets == (0, 200_000, 200_020) and plan.total == 200_027
    assert plan.shapes == ((100_000, 2), (10, 2), (7, 1)) and plan.launches == 2
    desc = plan.desc
    np.testing.assert_array_equal(desc[:, 0], [rows_a.data_ptr(), rows_b.data_ptr(), rows_c.data_ptr()])
    np.testing.assert_array_equal(desc[:2, 1], [shared.data_ptr(), per_row.data_ptr()])
    assert keep[2][1].dtype == torch.int32 and desc[2, 1] == keep[2][1].data_ptr() != vals_c.data_ptr()
    np.testing.assert_array_equal(desc[:, 2], [0, 200_000, 200_020])
    words = desc[:, 3:].view(np.int32)
    # n, P, R, shared memory, rows / values dtype, rows strides (r, n),
    # values strides (r, p, n), unused, masks
    np.testing.assert_array_equal(words[0], [100_000, 2, 1, 0, 0, 0, N, 1, 0, N, 1, 0, 0xFF, -1, 0, 0])
    np.testing.assert_array_equal(words[1], [10, 2, 3, 1, 4, 2, N, 1, 2 * N, N, 1, 0, 0xFFFF, 0xFFFFFF, 0, 0])
    np.testing.assert_array_equal(words[2], [7, 1, 2, 1, 1, 0, 1, 2, 0, N, 1, 0, 0xFF, 0, 0, 0])
    # row-vector r of job b reads its own row and its own [P, N] values
    for r in range(3):
        assert rows_b[r].data_ptr() == desc[1, 0] + 2 * r * words[1, 6]
        assert per_row[r].data_ptr() == desc[1, 1] + r * words[1, 8]
    # and job c's row-vector r, item i, at r * rs_r + i * rs_n (int64)
    for r, i in ((0, 3), (1, 5)):
        assert rows_c[r, i:].data_ptr() == desc[2, 0] + 8 * (r * words[2, 6] + i * words[2, 7])


def test_a_second_call_with_the_same_signature_reuses_the_plan():
    """The plan is cached per signature; a call with new operands of the
    same shapes, strides and dtypes reuses it and points every job at the
    new operands."""
    def jobs_of(rows, vals):
        return [FU.Job("x", 50, rows, vals, (2, 2)), FU.Job("y", 9, rows[:1], vals[0][None, :], (1,))]

    rows, vals = torch.zeros((4, 16), dtype=torch.int32), torch.zeros((2, 16), dtype=torch.int32)
    first = jobs_of(rows, vals)
    plan = FU._plan_for(first)
    FU._bind(plan, first)
    assert plan.desc[0, 0] == rows.data_ptr() and plan.desc[1, 1] == vals.data_ptr()
    rows2, vals2 = torch.ones_like(rows), torch.ones_like(vals)
    second = jobs_of(rows2, vals2)
    assert FU._plan_for(second) is plan
    FU._bind(plan, second)
    np.testing.assert_array_equal(plan.desc[:, 0], [rows2.data_ptr(), rows2.data_ptr()])
    np.testing.assert_array_equal(plan.desc[:, 1], [vals2.data_ptr(), vals2.data_ptr()])


@pytest.mark.parametrize("change", ["shape", "stride", "dtype", "digits", "n"])
def test_a_different_signature_makes_a_new_plan(change):
    rows, vals = torch.zeros((2, 16), dtype=torch.int32), torch.zeros((1, 16), dtype=torch.int32)
    plan = FU._plan_for([FU.Job("x", 50, rows, vals, (2,))])
    other = {
        "shape": FU.Job("x", 50, torch.zeros((3, 16), dtype=torch.int32), vals, (2,)),
        "stride": FU.Job("x", 50, torch.zeros((16, 2), dtype=torch.int32).T, vals, (2,)),
        "dtype": FU.Job("x", 50, rows.to(torch.int64), vals, (2,)),
        "digits": FU.Job("x", 50, rows, vals, (3,)),
        "n": FU.Job("x", 51, rows, vals, (2,)),
    }[change]
    new = FU._plan_for([other])
    assert new is not plan and FU._plan_for([other]) is new


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(3)
    N = 2048 + 37
    jobs = _jobs(rng, N)
    # more row-vectors than the first version's 48 a launch: still one
    # scatter launch and one conversion
    many = rng.integers(-1, 5001, (53, N)).astype(np.int32)
    jobs.append(("many", 5000, many, rng.integers(0, 300, (2, N)).astype(np.int32), (1, 2)))
    cuda_jobs = [
        FU.Job(nm, n, torch.as_tensor(r).cuda(), torch.as_tensor(v).cuda(), d) for nm, n, r, v, d in jobs
    ]
    FU.reset_launches()
    got = FU.scatter_many(cuda_jobs)
    want = FU.scatter_many_plain(cuda_jobs)
    assert FU.LAUNCHES["scatter_many"] == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    table = torch.as_tensor(rng.integers(0, 1 << 30, (5000, 3)).astype(np.int32)).cuda()
    ids = torch.as_tensor(rng.integers(-3, 5003, N).astype(np.int32)).cuda()
    gjobs = [FU.GatherJob(f"t{i}", ids, table[: 500 * i + 1], (i % 4 + 1,) * 3) for i in range(FU._MAX_GATHER_JOBS + 1)]
    got = FU.gather_many(gjobs)
    want = FU.gather_many_plain(gjobs)
    assert FU.LAUNCHES["gather_many"] == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _scatter_cases(rng):
    """name -> job list, each an edge of the two-launch scatter."""
    ids = lambda lo, hi, shape: torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32)).cuda()
    N = 2048
    # digits 4: all-ones mask, values of both signs; the cells' running
    # sums return to 0 on the way (+x then -x, then +y)
    one_row = torch.zeros((1, N), dtype=torch.int32, device="cuda")
    signed = torch.as_tensor(np.tile([5, -5, 7, -7, 3], N // 5 + 1)[:N].astype(np.int32)).cuda()
    back_to_zero = torch.as_tensor(np.tile([9, -9], N // 2).astype(np.int32)).cuda()
    return {
        # more row-vectors than the first version's 48 a launch
        "many units": [FU.Job("many", 5000, ids(-1, 5001, (200, N)), ids(0, 300, (2, N)), (1, 2))],
        # every item on one row: the warp-aggregation case, in global memory
        # and in a shared-memory table
        "one hot row": [FU.Job("hot", 100_000, one_row + 7, ids(0, 256, (2, N)), (1, 1)),
                        FU.Job("hot_small", 40, one_row + 3, ids(0, 1 << 12, (3, N)), (3, 3, 3))],
        "returns to zero": [FU.Job("ret", 100_000, one_row + 11, torch.stack([signed, back_to_zero]), (4, 4)),
                            FU.Job("ret_small", 16, ids(0, 4, (1, N)), torch.stack([back_to_zero] * 2), (4, 4)),
                            FU.Job("spread", 100_000, ids(0, 3, (2, N)), signed[None, :], (4,))],
        "one item and an empty job": [FU.Job("one", 30, ids(0, 30, (2, 1)), ids(0, 9, (2, 1)), (1, 1)),
                                      FU.Job("empty", 0, ids(-1, 3, (1, 1)), ids(0, 9, (1, 1)), (1,))],
        # past the 16 jobs one launch carries: one more launch
        "many jobs": [FU.Job(f"j{i}", 50 + i, ids(-1, 60, (1, 300)), ids(0, 200, (1, 300)), (1,))
                      for i in range(20)],
        # operands read where they lie: transposed int64 rows, uint8 and
        # permuted values, an expanded row
        "strided operands": [
            FU.Job("t", 70_000, torch.as_tensor(rng.integers(-1, 70_001, (N, 3))).cuda().T,
                   ids(0, 1 << 16, (N, 2)).T, (2, 1)),
            FU.Job("u8", 900, ids(-1, 901, (4, N)),
                   torch.as_tensor(rng.integers(0, 256, (3, 4, N)).astype(np.uint8)).cuda().permute(1, 0, 2), (1, 1, 1)),
            FU.Job("bcast", 64, ids(0, 64, (1, 1)).expand(2, N), ids(0, 9, (1, N)), (1,)),
        ],
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["many units", "one hot row", "returns to zero", "one item and an empty job",
                                  "many jobs", "strided operands"])
def test_scatter_many_edges_match_plain_on_the_card(case):
    """The two-launch scatter against its plain version: exact, with the
    launches it should make, and the accumulator left all-zero."""
    _card()
    jobs = _scatter_cases(np.random.default_rng(11))[case]
    FU.reset_launches()
    got = FU.scatter_many(jobs)
    want = FU.scatter_many_plain(jobs)
    assert FU.LAUNCHES["scatter_many"] == (3 if case == "many jobs" else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the scratch is all zero again: a second call gives the same result
    for g, w in zip(FU.scatter_many(jobs), want):
        assert torch.equal(g, w)
    for acc, touched in FU._SCRATCH.values():
        assert not acc.any() and not touched.any()


# -- gather_many's column form -----------------------------------------------------

CAP = (1 << 24) - 1


def _flow_state(rng, n, key):
    """The flow read's three sources as the tick's state holds them: the
    window's [n, 5] run table (pass in column 0), concurrency, and the
    occupy pool's tokens (.5 ties, values over the cap) with their epochs,
    half of them at ``key``."""
    run = rng.integers(0, 1 << 20, (n, 5)).astype(np.int32)
    run[:4, 0] = [CAP, CAP + 1, 1 << 30, 2**31 - 1]  # at and over the cap
    conc = rng.integers(0, 1 << 16, n).astype(np.int32)
    conc[4:6] = [CAP + 7, 1 << 28]
    tokens = (rng.integers(0, 2000, n) / 2.0).astype(np.float32)  # every other value a .5 tie
    tokens[6:12] = [0.5, 1.5, 2.5, 3.5, float(1 << 25), float(CAP + 1)]
    epoch = np.where(rng.random(n) < 0.5, key, key - 1).astype(np.int32)
    epoch[6:12] = key  # the ties and the values over the cap count
    return run, conc, tokens, epoch


def _flow_ids(rng, n, N):
    ids = rng.integers(-2, n + 2, N).astype(np.int32)
    ids[:3] = [-1, n, 2**30]
    ids[3:15] = np.arange(12)  # the rows with the edge values
    return ids


@pytest.mark.parametrize("cur_wid", [2**31 - 1, 4_321])
@pytest.mark.parametrize("N", [96, 131])
def test_gather_columns_plain_matches_pallas_on_the_reference_table(N, cur_wid):
    """The column form (a strided run[:, 0] view, concurrency, guarded
    float tokens) against the JAX gather_many on the table the reference
    builds: stack(run pass, concurrency, round(where(epoch == cur_wid + 1,
    tokens, 0))) clamped to 2^24 - 1, where cur_wid + 1 wraps in int32."""
    rng = np.random.default_rng(N + cur_wid % 97)
    n = 300
    key = int(np.array([cur_wid], np.int32).astype(np.int64)[0] + 1)
    key = key - 2**32 if key >= 2**31 else key  # int32 wrap, as the port passes it
    run, conc, tokens, epoch = _flow_state(rng, n, key)
    ids = _flow_ids(rng, n, N)
    with jax.disable_jit():
        nxt = jnp.int32(cur_wid) + 1  # wraps in int32
        pool = jnp.where(jnp.asarray(epoch) == nxt, jnp.asarray(tokens), 0.0)
        tab = jnp.stack([jnp.asarray(run)[:, 0], jnp.asarray(conc), jnp.round(pool).astype(jnp.int32)], axis=1)
        (ref,) = JFU.gather_many([JFU.GatherJob("wsum", jnp.asarray(ids), jnp.minimum(tab, CAP), (3, 3, 3))])
    t_run = torch.as_tensor(run)
    cols = (FU.GatherColumn(t_run[:, 0], CAP), FU.GatherColumn(torch.as_tensor(conc), CAP),
            FU.GatherColumn(torch.as_tensor(tokens), CAP, torch.as_tensor(epoch), key))
    assert cols[0].src.stride() == (5,)  # read where it lies, no copy
    (got,) = FU.gather_many([FU.GatherJob("wsum", torch.as_tensor(ids), cols, (3, 3, 3))])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the guard went both ways, and the ties rounded half to even
    ok = (ids >= 0) & (ids < n)
    assert (ok & (epoch[np.clip(ids, 0, n - 1)] == key)).any() and (ok & (epoch[np.clip(ids, 0, n - 1)] != key)).any()
    np.testing.assert_array_equal(got.numpy()[9:15, 2], [0.0, 2.0, 2.0, 4.0, CAP, CAP])  # ids 3.. read rows 0..


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_gather_columns_of_a_table_equal_the_table_form(P):
    rng = np.random.default_rng(P)
    buf = torch.as_tensor(rng.integers(0, 1 << 30, (500, P + 2)).astype(np.int32))
    ids = torch.as_tensor(_flow_ids(rng, 500, 257))
    digits = tuple(range(1, P + 1))
    for table in (buf[:, :P].contiguous(), buf[:, 1 : P + 1]):  # contiguous, and a view at row stride P + 2
        cols = tuple(FU.GatherColumn(table[:, p]) for p in range(P))
        (want,) = FU.gather_many([FU.GatherJob("t", ids, table, digits)])
        (got,) = FU.gather_many([FU.GatherJob("c", ids, cols, digits)])
        assert torch.equal(got, want)


def test_gather_columns_refuse_what_the_kernel_does_not_take():
    ids = torch.zeros(4, dtype=torch.int32)
    i32, f32 = torch.zeros(8, dtype=torch.int32), torch.zeros(8)
    bad = {
        "int64 column": (FU.GatherColumn(i32.to(torch.int64)),),
        "2-D column": (FU.GatherColumn(i32.reshape(4, 2)),),
        "rows differ": (FU.GatherColumn(i32), FU.GatherColumn(f32[:7])),
        "float guard": (FU.GatherColumn(f32, CAP, f32, 0),),
        "guard rows": (FU.GatherColumn(f32, CAP, i32[:5], 0),),
        "cap past int32": (FU.GatherColumn(i32, 2**31),),
        "key past int32": (FU.GatherColumn(f32, CAP, i32, 2**31),),
        "five planes": tuple(FU.GatherColumn(i32) for _ in range(5)),
    }
    for name, cols in bad.items():
        with pytest.raises(ValueError):
            FU.gather_many([FU.GatherJob(name, ids, cols, (1,) * len(cols))])


def test_gather_descriptors_point_each_plane_at_its_column():
    """The gather plan (built on the host, the same for any device): per job
    the ids and output pointers, each plane's source and guard pointers,
    element strides, flags (float), cap, digit mask; the call binds
    the pointers and the guard's key (a plane without a guard has a null
    guard pointer).  Outputs start on 16-byte
    boundaries."""
    n, N = 40, 10
    run = torch.zeros((n, 5), dtype=torch.int32)
    conc = torch.zeros(n, dtype=torch.int32)
    tokens, epoch = torch.zeros(n), torch.zeros(n, dtype=torch.int32)
    table = torch.zeros((n, 2), dtype=torch.int32)
    ids = torch.zeros(N, dtype=torch.int32)
    jobs = [FU.GatherJob("cols", ids, (FU.GatherColumn(run[:, 2], CAP), FU.GatherColumn(conc),
                                       FU.GatherColumn(tokens, 77, epoch, -(2**31))), (3, 2, 4)),
            FU.GatherJob("table", ids, table, (1, 1))]
    plan = FU._gather_plan(jobs)
    out = torch.empty(plan.total)
    keep = FU._gather_bind(plan, jobs, out)
    assert plan.offsets == (0, 32) and plan.shapes == ((N, 3), (N, 2)) and plan.total == 52 and plan.launches == 1
    d = plan.desc
    assert d.shape == (2, FU._GATHER_SLOTS)
    np.testing.assert_array_equal(d[0, :6], [ids.data_ptr(), out.data_ptr(), run[:, 2].data_ptr(),
                                             conc.data_ptr(), tokens.data_ptr(), 0])
    np.testing.assert_array_equal(d[0, 6:10], [0, 0, epoch.data_ptr(), 0])
    np.testing.assert_array_equal(d[1, 1:4], [out.data_ptr() + 4 * 32, table.data_ptr(), table.data_ptr() + 4])
    w = d[:, 10:].view(np.int32)
    # n, P, strides, guard strides, flags, caps, masks, keys
    np.testing.assert_array_equal(w[0], [n, 3, 5, 1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                                         CAP, 2**31 - 1, 77, 0, 0xFFFFFF, 0xFFFF, -1, 0, 0, 0, -(2**31), 0])
    np.testing.assert_array_equal(w[1, :8], [n, 2, 2, 2, 0, 0, 0, 0])
    assert keep[0][0] is ids


def test_a_new_key_binds_into_the_same_gather_plan():
    """The key changes every window: the plan is cached per signature
    (shapes, strides, dtypes, caps, digits) and the call writes the key."""
    n = 16
    tokens, epoch, ids = torch.zeros(n), torch.zeros(n, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)

    def jobs(key, cap=CAP):
        return [FU.GatherJob("p", ids, (FU.GatherColumn(tokens, cap, epoch, key),), (3,))]

    plan = FU._gather_plan_for(jobs(5))
    assert FU._gather_plan_for(jobs(6)) is plan
    FU._gather_bind(plan, jobs(6), torch.empty(plan.total))
    assert plan.desc[0, 10:].view(np.int32)[FU._GW_KEY] == 6
    assert FU._gather_plan_for(jobs(6, cap=9)) is not plan


def test_gather_of_no_items_and_an_empty_table():
    ids = torch.zeros(0, dtype=torch.int32)
    (a,) = FU.gather_many([FU.GatherJob("none", ids, torch.zeros((5, 3), dtype=torch.int32), (1, 1, 1))])
    assert a.shape == (0, 3)
    (b,) = FU.gather_many([FU.GatherJob("empty", torch.tensor([-1, 0, 3], dtype=torch.int32),
                                        (FU.GatherColumn(torch.zeros(0)),), (2,))])
    np.testing.assert_array_equal(b.numpy(), [[0.0], [0.0], [0.0]])
    assert FU._gather_plan([FU.GatherJob("none", ids, torch.zeros((5, 3), dtype=torch.int32), (1, 1, 1))]).launches == 0


def _gather_cases(rng):
    """name -> gather job list on the card: the flow read's columns (a
    strided view, a guard with its key at the int32 wrap, .5 ties, values
    over the cap), unguarded float columns, N off the 4 items a thread,
    N = 1, misaligned ids."""
    n = 5000
    key = -(2**31)
    run, conc, tokens, epoch = (torch.as_tensor(a).cuda() for a in _flow_state(rng, n, key))
    cols = (FU.GatherColumn(run[:, 0], CAP), FU.GatherColumn(conc, CAP), FU.GatherColumn(tokens, CAP, epoch, key))
    plain_float = (FU.GatherColumn(tokens, 1000), FU.GatherColumn(run[:, 3]))
    cases = {}
    for N in (8192, 2048 + 37, 4 * 33 + 1, 3, 1):
        ids = torch.as_tensor(_flow_ids(rng, n, max(N, 15))[:N]).cuda()
        cases[f"N={N}"] = [FU.GatherJob("flow", ids, cols, (3, 3, 3)), FU.GatherJob("f", ids, plain_float, (2, 4))]
    ids = torch.as_tensor(_flow_ids(rng, n, 2050)).cuda()
    cases["misaligned ids"] = [FU.GatherJob("flow", ids[1:], cols, (3, 3, 3))]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["N=8192", "N=2085", "N=133", "N=3", "N=1", "misaligned ids"])
def test_gather_columns_match_plain_on_the_card(case):
    _card()
    jobs = _gather_cases(np.random.default_rng(5))[case]
    FU.reset_launches()
    got = FU.gather_many(jobs)
    want = FU.gather_many_plain(jobs)
    assert FU.LAUNCHES["gather_many"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_gather_of_no_items_and_many_jobs_on_the_card():
    """N = 0 launches nothing; more jobs than one launch carries take one
    launch a chunk."""
    _card()
    rng = np.random.default_rng(6)
    FU.reset_launches()
    (none,) = FU.gather_many([FU.GatherJob("none", torch.zeros(0, dtype=torch.int32, device="cuda"),
                                           torch.zeros((5, 3), dtype=torch.int32, device="cuda"), (1, 1, 1))])
    assert none.shape == (0, 3) and FU.LAUNCHES["gather_many"] == 0
    jobs = _gather_cases(rng)["N=2085"][:1] * (2 * FU._MAX_GATHER_JOBS + 1)
    got = FU.gather_many(jobs)
    assert FU.LAUNCHES["gather_many"] == 3
    for g, w in zip(got, FU.gather_many_plain(jobs)):
        assert torch.equal(g, w)
