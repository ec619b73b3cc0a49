"""The tick's two hand-written kernels: effect scatters and the flow read.

PyTorch counterpart of ``sentinel_tpu/ops/fused.py``.  The JAX package ran
these as Pallas megakernels on the TPU; here they are CUDA C++ kernels for
Hopper (``csrc/fused.cu``, built at first use by ``ops/_build.py``):

- ``scatter_many`` (replaces ``sentinel_tpu/ops/fused.py:186``): several
  scatter-add histograms in one launch over a shared item axis.  Each
  ``Job(n, rows[R, N], values[P, N] or [R, P, N], digits)`` sums into an
  ``[n, P]`` table; ids outside ``[0, n)`` drop; plane p counts each value
  modulo ``256**digits[p]`` (the TPU's digit truncation, kept so inputs
  outside the contract still give what the TPU gives).  Output float32,
  integer-exact while cell totals stay below 2^24.
- ``gather_many`` (replaces ``sentinel_tpu/ops/fused.py:374``): per-item
  reads from nonnegative int tables; out-of-range ids read 0; a value reads
  modulo ``256**digits``.  Output float32 ``[N, P]`` per job.

Dispatch: a wrapper takes its plain PyTorch version ONLY when the tensors
it was given lie on the CPU (the tests).  A CUDA tensor launches the
kernel or raises — there is no fallback.  Each wrapper adds one to
``LAUNCHES[name]`` per kernel launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

#: kernel launches per wrapper since the last reset (plain integers)
LAUNCHES = {"scatter_many": 0, "gather_many": 0}

#: kernel limits (csrc/fused.cu): planes per job, and the units / gather
#: jobs one launch carries (a longer list takes one launch per chunk)
_MAXP = 4
_MAX_UNITS = 48
_MAX_GATHER_JOBS = 8
#: tables up to this many int32 cells accumulate in shared memory (48 KB,
#: the dynamic shared-memory size a block may use without opting in)
_PRIV_CELLS = 12288


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Job(NamedTuple):
    """One scatter destination.

    rows:   int32 [R, N] — R row-vectors per item; ids outside [0, n) drop.
    values: int32 [P, N] planes shared by every row-vector, or [R, P, N].
    digits: per-plane base-256 digit counts (value counts mod 256**d).
    n:      logical table rows.
    """

    name: str
    n: int
    rows: torch.Tensor
    values: torch.Tensor
    digits: tuple


class GatherJob(NamedTuple):
    """One gather source: ids int32 [N], table int32 [n, P], digits per plane."""

    name: str
    ids: torch.Tensor
    table: torch.Tensor
    digits: tuple


def _mask(d: int) -> int:
    """256**d - 1 as an int32 bit pattern (all ones for d >= 4)."""
    return -1 if d >= 4 else (1 << (8 * d)) - 1


def _masked(v: torch.Tensor, d: int) -> torch.Tensor:
    return v if d >= 4 else v & ((1 << (8 * d)) - 1)


def _check_jobs(jobs: Sequence[Job]) -> int:
    N = jobs[0].rows.shape[-1]
    for j in jobs:
        if j.rows.dim() != 2 or j.rows.shape[-1] != N or j.values.shape[-1] != N:
            raise ValueError(f"job {j.name}: rows must be [R, N] and values [.., N] with one N")
        if j.values.dim() not in (2, 3) or len(j.digits) != j.values.shape[-2]:
            raise ValueError(f"job {j.name}: digits/planes mismatch")
        if j.values.dim() == 3 and j.values.shape[0] != j.rows.shape[0]:
            raise ValueError(f"job {j.name}: per-row values need R row-vectors")
        if j.values.shape[-2] > _MAXP:
            raise ValueError(f"job {j.name}: at most {_MAXP} planes")
    return N


# -- scatter_many -------------------------------------------------------------


def scatter_many_plain(jobs: Sequence[Job]) -> List[torch.Tensor]:
    """The plain PyTorch version of scatter_many: one int32 ``index_add_``
    per (row-vector, job) into a table with one spare row that catches
    the dropped ids, then a float32 view."""
    _check_jobs(jobs)
    out = []
    for j in jobs:
        R = j.rows.shape[0]
        P = j.values.shape[-2]
        acc = torch.zeros((j.n + 1, P), dtype=torch.int32, device=j.rows.device)
        for r in range(R):
            k = j.rows[r]
            safe = torch.where((k >= 0) & (k < j.n), k, j.n).to(torch.int64)
            v = j.values[r] if j.values.dim() == 3 else j.values
            planes = torch.stack(
                [_masked(v[p].to(torch.int32), j.digits[p]) for p in range(P)], dim=1
            )
            acc.index_add_(0, safe, planes)
        out.append(acc[: j.n].to(torch.float32))
    return out


def _descriptors(n_desc: int):
    """Descriptors of csrc/fused.cu, zeroed: int64 [n_desc, 7] — three
    pointers per row — and the int32 [n_desc, 8] view of its last 4 slots."""
    desc = np.zeros((n_desc, 7), dtype=np.int64)
    return desc, desc[:, 3:].view(np.int32)


def _scatter_plan(jobs: Sequence[Job]):
    """(int32 operands to keep alive, unit descriptors, per-job output
    offsets, output cells) for one call.  A unit is one row-vector of one
    job, with its own rows and values pointers."""
    N = jobs[0].rows.shape[-1]
    desc, words = _descriptors(sum(j.rows.shape[0] for j in jobs))
    keep, offs = [], []
    u = ooff = 0
    for j in jobs:
        rows = j.rows.to(torch.int32).contiguous()
        vals = j.values.to(torch.int32).contiguous()
        keep += [rows, vals]
        R, P = rows.shape[0], vals.shape[-2]
        r = np.arange(R, dtype=np.int64)
        sl = slice(u, u + R)
        desc[sl, 0] = rows.data_ptr() + 4 * N * r
        desc[sl, 1] = vals.data_ptr() + (4 * P * N * r if vals.dim() == 3 else 0)
        desc[sl, 2] = ooff
        words[sl, 0] = j.n
        words[sl, 1] = P
        words[sl, 2] = 1 if 0 < j.n * P <= _PRIV_CELLS else 0
        words[sl, 4 : 4 + P] = [_mask(d) for d in j.digits]
        offs.append(ooff)
        u += R
        ooff += j.n * P
    return keep, desc, offs, ooff


def _scatter_cuda(jobs: Sequence[Job]) -> List[torch.Tensor]:
    from sentinel_tpu_torch.ops import _build

    lib = _build.load_library()
    N = jobs[0].rows.shape[-1]
    dev = jobs[0].rows.device
    keep, desc, offs, total = _scatter_plan(jobs)
    out = torch.empty((max(total, 1),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.sentinel_scatter_many(
            desc.ctypes.data_as(ctypes.c_void_p),
            len(desc),
            int(N),
            ctypes.c_void_p(out.data_ptr()),
            int(out.numel()),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"scatter_many kernel launch failed (CUDA error {err})")
    LAUNCHES["scatter_many"] += -(-len(desc) // _MAX_UNITS)
    f = out.view(torch.float32)
    return [
        f[o : o + j.n * j.values.shape[-2]].view(j.n, j.values.shape[-2])
        for j, o in zip(jobs, offs)
    ]


def scatter_many(jobs: Sequence[Job]) -> List[torch.Tensor]:
    """Every job's scatter-add in one kernel launch (one per chunk of
    ``_MAX_UNITS`` row-vectors); one float32 [n, P] histogram per job.
    CPU tensors take the plain version."""
    _check_jobs(jobs)
    if all(j.rows.device.type == "cpu" and j.values.device.type == "cpu" for j in jobs):
        return scatter_many_plain(jobs)
    if len({t.device for j in jobs for t in (j.rows, j.values)}) != 1 or jobs[0].rows.device.type != "cuda":
        raise ValueError("scatter_many: every job's tensors must lie on one CUDA device (or all on the CPU)")
    return _scatter_cuda(jobs)


# -- gather_many --------------------------------------------------------------


def _check_gather(jobs: Sequence[GatherJob]) -> int:
    N = jobs[0].ids.shape[0]
    for j in jobs:
        if j.ids.dim() != 1 or j.ids.shape[0] != N:
            raise ValueError(f"gather job {j.name}: ids must be [N] with one N")
        if j.table.dim() != 2 or len(j.digits) != j.table.shape[1]:
            raise ValueError(f"gather job {j.name}: table must be [n, P] with P digits")
        if j.table.shape[1] > _MAXP:
            raise ValueError(f"gather job {j.name}: at most {_MAXP} planes")
    return N


def gather_many_plain(jobs: Sequence[GatherJob]) -> List[torch.Tensor]:
    """The plain PyTorch version of gather_many: clipped index, digit mask,
    zero for out-of-range ids."""
    _check_gather(jobs)
    out = []
    for j in jobs:
        n, P = j.table.shape
        ok = (j.ids >= 0) & (j.ids < n)
        g = j.table.to(torch.int32)[torch.clamp(j.ids, 0, max(n - 1, 0)).to(torch.int64)]
        g = torch.stack([_masked(g[:, p], j.digits[p]) for p in range(P)], dim=1)
        out.append(torch.where(ok[:, None], g, 0).to(torch.float32))
    return out


def _gather_cuda(jobs: Sequence[GatherJob]) -> List[torch.Tensor]:
    from sentinel_tpu_torch.ops import _build

    lib = _build.load_library()
    N = jobs[0].ids.shape[0]
    dev = jobs[0].ids.device
    desc, words = _descriptors(len(jobs))
    keep, outs = [], []  # keep: int32 copies alive through the launch
    for i, j in enumerate(jobs):
        ids = j.ids.to(torch.int32).contiguous()
        tab = j.table.to(torch.int32).contiguous()
        n, P = tab.shape
        o = torch.empty((N, P), dtype=torch.float32, device=dev)
        keep += [ids, tab]
        outs.append(o)
        desc[i, :3] = (ids.data_ptr(), tab.data_ptr(), o.data_ptr())
        words[i, : 2 + P] = [n, P] + [_mask(d) for d in j.digits]
    with torch.cuda.device(dev):
        err = lib.sentinel_gather_many(
            desc.ctypes.data_as(ctypes.c_void_p),
            len(jobs),
            int(N),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"gather_many kernel launch failed (CUDA error {err})")
    LAUNCHES["gather_many"] += -(-len(jobs) // _MAX_GATHER_JOBS)
    return outs


def gather_many(jobs: Sequence[GatherJob]) -> List[torch.Tensor]:
    """Per-item gathers from several tables in one kernel launch (one per
    chunk of ``_MAX_GATHER_JOBS`` jobs); one float32 [N, P] per job.  CPU
    tensors take the plain version."""
    _check_gather(jobs)
    if all(j.ids.device.type == "cpu" and j.table.device.type == "cpu" for j in jobs):
        return gather_many_plain(jobs)
    if len({t.device for j in jobs for t in (j.ids, j.table)}) != 1 or jobs[0].ids.device.type != "cuda":
        raise ValueError("gather_many: every job's tensors must lie on one CUDA device (or all on the CPU)")
    return _gather_cuda(jobs)
