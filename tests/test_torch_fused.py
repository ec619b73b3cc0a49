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
    descriptor per row-vector with its own rows / values pointers, the
    job's output offset, and (n, P, shared-memory flag, masks)."""
    N = 8
    shared = torch.zeros((2, N), dtype=torch.int32)
    per_row = torch.zeros((3, 2, N), dtype=torch.int32)
    rows_a = torch.zeros((1, N), dtype=torch.int32)
    rows_b = torch.zeros((3, N), dtype=torch.int16)  # converted to int32 copies
    jobs = [FU.Job("a", 100_000, rows_a, shared, (1, 4)), FU.Job("b", 10, rows_b, per_row, (2, 3))]
    keep, desc, offs, total = FU._scatter_plan(jobs)
    assert desc.shape == (4, 7) and offs == [0, 200_000] and total == 200_020
    rb = keep[2]
    assert rb.dtype == torch.int32
    np.testing.assert_array_equal(desc[:, 0], [rows_a.data_ptr()] + [rb.data_ptr() + 4 * N * r for r in range(3)])
    np.testing.assert_array_equal(desc[:, 1], [shared.data_ptr()] + [per_row.data_ptr() + 4 * 2 * N * r for r in range(3)])
    np.testing.assert_array_equal(desc[:, 2], [0, 200_000, 200_000, 200_000])
    words = desc[:, 3:].view(np.int32)
    np.testing.assert_array_equal(words[0], [100_000, 2, 0, 0, 0xFF, -1, 0, 0])  # too big for shared memory
    np.testing.assert_array_equal(words[1], [10, 2, 1, 0, 0xFFFF, 0xFFFFFF, 0, 0])


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(3)
    N = 2048 + 37
    jobs = _jobs(rng, N)
    # more row-vectors than one launch carries: the wrapper launches per chunk
    many = rng.integers(-1, 5001, (FU._MAX_UNITS + 5, N)).astype(np.int32)
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
