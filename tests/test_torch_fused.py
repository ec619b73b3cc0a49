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
