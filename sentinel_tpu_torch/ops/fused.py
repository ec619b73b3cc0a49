"""The tick's two hand-written kernels: effect scatters and the flow read.

PyTorch counterpart of ``sentinel_tpu/ops/fused.py``.  The JAX package ran
these as Pallas megakernels on the TPU; here they are CUDA C++ kernels for
Hopper (``csrc/fused.cu``, built at first use by ``ops/_build.py``):

- ``scatter_many`` (replaces ``sentinel_tpu/ops/fused.py:186``): several
  scatter-add histograms over a shared item axis in two launches (zero
  the output while summing, then convert the touched cells).  Each
  ``Job(n, rows[R, N], values[P, N] or [R, P, N], digits)`` sums into an
  ``[n, P]`` table; ids outside ``[0, n)`` drop; plane p counts each value
  modulo ``256**digits[p]`` (the TPU's digit truncation, kept so inputs
  outside the contract still give what the TPU gives).  Output float32,
  integer-exact while cell totals stay below 2^24.  The host side is
  planned: everything but the operands' addresses is computed once per
  job signature (``ScatterPlan``).
- ``gather_many`` (replaces ``sentinel_tpu/ops/fused.py:374``): per-item
  reads of up to 4 planes, one launch a call; out-of-range ids read 0; a
  value reads modulo ``256**digits``.  Each plane is a column read where it
  lies (``GatherColumn``: int32 or float32 at any element stride, a cap, a
  float column rounded half to even, an optional int32 guard that must
  equal a key), or a column of a 2-D int32 table.  Output float32 ``[N, P]``
  per job.  Its host side is planned like the scatter's (``GatherPlan``).

Dispatch: a wrapper takes its plain PyTorch version ONLY when the tensors
it was given lie on the CPU (the tests).  A CUDA tensor launches the
kernel or raises — there is no fallback.  Each wrapper adds one to
``LAUNCHES[name]`` per kernel launch, and nowhere else.

A row-sharded tick (parallel/spmd.py) runs both kernels on the rank's
rows through these same contracts: ``on_shard`` rebases a scatter job to
the rank's span (ids outside ``[0, n)`` drop, so the other ranks' rows
drop), and ``gather_on_shard`` a gather job (out-of-range ids read 0, so
one all-reduce SUM of the ranks' reads is the whole read).
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from sentinel_tpu_torch.parallel import collectives as CL

#: kernel launches per wrapper since the last reset (plain integers)
LAUNCHES = {"scatter_many": 0, "gather_many": 0}

#: kernel limits (csrc/fused.cu): planes per job, the jobs one scatter
#: launch carries and the gather jobs one launch carries (a longer list
#: takes one launch per chunk)
_MAXP = 4
_MAX_JOBS = 16
_MAX_GATHER_JOBS = 8
#: tables up to this many int32 cells accumulate in shared memory (48 KB,
#: the dynamic shared-memory size a block may use without opting in)
_PRIV_CELLS = 12288
#: operand dtypes the scatter kernel reads where they lie (csrc/fused.cu
#: DT_*); any other dtype is converted to an int32 copy first
_DTYPES = {torch.int32: 0, torch.int64: 1, torch.uint8: 2, torch.bool: 2, torch.int8: 3, torch.int16: 4}
#: eight-byte slots of one scatter job descriptor (csrc/fused.cu)
_DESC_SLOTS = 11


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


class GatherColumn(NamedTuple):
    """One plane of a gather job, read where it lies.

    src:   int32 or float32 [n] at any element stride (a column of a 2-D
           state table reads in place).  A float value rounds half to even
           into int32 (``torch.round`` then ``.to(torch.int32)``).
    cap:   the value is capped at ``cap`` (a signed minimum) before the
           digit mask.
    guard: None, or int32 [n]: the value counts only where ``guard ==
           key`` and reads 0 elsewhere.
    key:   the int32 the guard is held to.
    """

    src: torch.Tensor
    cap: int = 2**31 - 1
    guard: Optional[torch.Tensor] = None
    key: int = 0


class GatherJob(NamedTuple):
    """One gather: ids int32 [N]; ``table`` either an int32 [n, P] table (P
    columns at its row stride) or a sequence of P ``GatherColumn``s of n
    rows; digits per plane."""

    name: str
    ids: torch.Tensor
    table: Union[torch.Tensor, Sequence[GatherColumn]]
    digits: tuple


def on_shard(job: Job, total: int) -> Job:
    """``job`` as one rank of a row-sharded table lands it (under a shard
    context, parallel/collectives.scope; the job itself off one): its rows
    rebased to the rank's span of an axis of ``total`` rows and ``n`` cut
    to the rank's part of ``[0, n)``.  The job contract drops every id
    outside ``[0, n)``, so the other ranks' rows drop by themselves."""
    ctx = CL.current()
    if ctx is None:
        return job
    lo, _hi = ctx.span(total)
    return job._replace(n=ctx.clip(job.n, total), rows=job.rows - lo)


def gather_on_shard(job: GatherJob, total: int) -> GatherJob:
    """``job`` reading a rank's slice of a row-sharded table: its ids
    rebased to the rank's span (ids another rank holds read 0, so an
    all-reduce SUM of every rank's result is the single-device read)."""
    ctx = CL.current()
    if ctx is None:
        return job
    lo, _hi = ctx.span(total)
    return job._replace(ids=job.ids - lo)


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


def _descriptors(n_desc: int, slots: int = 7):
    """Descriptors of csrc/fused.cu, zeroed: int64 [n_desc, slots] — three
    eight-byte slots (pointers, or the scatter's output offset) per row —
    and the int32 view of the rest."""
    desc = np.zeros((n_desc, slots), dtype=np.int64)
    return desc, desc[:, 3:].view(np.int32)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """The tensor the kernel reads: ``t`` itself where its dtype is one the
    kernel reads (any strides), else an int32 copy."""
    return t if t.dtype in _DTYPES else t.to(torch.int32)


def _signature(jobs: Sequence[Job]) -> tuple:
    """What a plan depends on: every job's n, digits, and its operands'
    shapes, strides, dtypes and devices — not their addresses."""
    return tuple(
        (j.n, j.digits, j.rows.shape, j.rows.stride(), j.rows.dtype, j.rows.device,
         j.values.shape, j.values.stride(), j.values.dtype, j.values.device)
        for j in jobs
    )


class ScatterPlan(NamedTuple):
    """The static part of one scatter_many call, made once per signature.

    desc:    int64 [jobs, 11] descriptors (csrc/fused.cu); a call writes
             only slots 0 and 1, its operands' addresses; ``desc_ptr`` is
             the array's address.
    offsets: each job's first output cell; ``shapes`` its [n, P];
             ``total`` the output's cells.
    N:       items; ``launches`` a call's kernel launches.
    """

    desc: np.ndarray
    desc_ptr: int
    offsets: tuple
    shapes: tuple
    total: int
    N: int
    launches: int


def _plan(jobs: Sequence[Job]) -> ScatterPlan:
    """Check the jobs and lay out their descriptors and output: job j's
    row-vector r reads rows at ``rows + r * rs_r`` and values at ``vals +
    r * vs_r`` (``vs_r`` 0 for values shared by every row-vector), item i
    at ``+ i * rs_n`` / plane p, item i at ``+ p * vs_p + i * vs_n``, in
    elements; its table starts at output cell ``offsets[j]``."""
    N = _check_jobs(jobs)
    if len({t.device for j in jobs for t in (j.rows, j.values)}) != 1:
        raise ValueError("scatter_many: every job's tensors must lie on one CUDA device (or all on the CPU)")
    desc, words = _descriptors(len(jobs), _DESC_SLOTS)
    offsets, shapes = [], []
    off = 0
    for i, j in enumerate(jobs):
        rows, vals = _operand(j.rows), _operand(j.values)
        R, P = rows.shape[0], vals.shape[-2]
        vs = vals.stride() if vals.dim() == 3 else (0, *vals.stride())
        strides = (*rows.stride(), *vs)
        if max(strides + (N, j.n * P), default=0) >= 2**31:
            raise ValueError(f"job {j.name}: strides, items and cells must stay below 2^31")
        desc[i, 2] = off
        words[i, :11] = [j.n, P, R, 1 if 0 < j.n * P <= _PRIV_CELLS else 0,
                         _DTYPES[rows.dtype], _DTYPES[vals.dtype], *strides]
        words[i, 12 : 12 + P] = [_mask(d) for d in j.digits]
        offsets.append(off)
        shapes.append((j.n, P))
        off += j.n * P
    # a scatter launch per chunk of _MAX_JOBS jobs (the first one also
    # zeroes the output; a chunk without row-vectors has none), then one
    # conversion
    launches = 0
    if off:
        launches = 1 + sum(1 for c in range(0, len(jobs), _MAX_JOBS)
                           if c == 0 or any(j.rows.shape[0] for j in jobs[c : c + _MAX_JOBS]))
    return ScatterPlan(desc, desc.ctypes.data, tuple(offsets), tuple(shapes), off, N, launches)


def _bind(plan: ScatterPlan, jobs: Sequence[Job]) -> list:
    """Point the plan's descriptors at this call's operands; returns the
    operands (kept alive through the launch)."""
    keep = [(_operand(j.rows), _operand(j.values)) for j in jobs]
    plan.desc[:, :2] = [(r.data_ptr(), v.data_ptr()) for r, v in keep]
    return keep


#: plans by job signature; scratch by (device, stream)
_PLANS: dict = {}
_MAX_PLANS = 256
_SCRATCH: dict = {}
_lock = threading.Lock()


def _scratch(dev: torch.device, stream: int, cells: int):
    """(acc, touched): the int32 accumulator and its one-bit-a-cell bitmap
    for launches on ``stream``, at least ``cells`` cells.  Both are all zero
    between calls — the conversion launch zeroes what the scatter touched —
    so they are zeroed only when made."""
    s = _SCRATCH.get((dev, stream))
    if s is None or s[0].numel() < cells:
        n = -(-max(cells, 2 * s[0].numel() if s is not None else 0) // 32) * 32  # whole bitmap words
        s = (torch.zeros(n, dtype=torch.int32, device=dev),
             torch.zeros(n // 32, dtype=torch.int32, device=dev))
        _SCRATCH[(dev, stream)] = s
    return s


def _plan_for(jobs: Sequence[Job]) -> ScatterPlan:
    """The cached plan of the jobs' signature (made, and the jobs checked,
    on its first call)."""
    key = _signature(jobs)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _plan(jobs)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = plan
    return plan


def _scatter_cuda(plan: ScatterPlan, jobs: Sequence[Job]) -> List[torch.Tensor]:
    from sentinel_tpu_torch.ops import _build

    dev = jobs[0].rows.device
    # padded to whole float4s: the kernels write the output 16 bytes at a time
    out = torch.empty((-(-plan.total // 4) * 4,), dtype=torch.float32, device=dev)
    if plan.total:
        lib = _build.load_library()
        stream = torch._C._cuda_getCurrentRawStream(dev.index)  # the handle, without a Stream object
        acc, touched = _scratch(dev, stream, plan.total)
        with _lock:  # the descriptors are the plan's: one call fills them at a time
            keep = _bind(plan, jobs)
            err = lib.sentinel_scatter_many(
                plan.desc_ptr, len(jobs), plan.N, out.data_ptr(), plan.total,
                acc.data_ptr(), touched.data_ptr(), dev.index, stream,
            )
        if err != 0:
            _SCRATCH.pop((dev, stream), None)  # a failed launch may leave it dirty
            raise RuntimeError(f"scatter_many kernel launch failed (CUDA error {err})")
        LAUNCHES["scatter_many"] += plan.launches
    return [out.as_strided(shape, (shape[1], 1), off) for shape, off in zip(plan.shapes, plan.offsets)]


def scatter_many(jobs: Sequence[Job]) -> List[torch.Tensor]:
    """Every job's scatter-add, one float32 [n, P] histogram per job, in two
    kernel launches (one more per ``_MAX_JOBS`` jobs past the first
    ``_MAX_JOBS``).  CPU tensors take the plain version."""
    if not jobs[0].rows.is_cuda:
        if any(t.device.type != "cpu" for j in jobs for t in (j.rows, j.values)):
            raise ValueError("scatter_many: every job's tensors must lie on one CUDA device (or all on the CPU)")
        return scatter_many_plain(jobs)
    return _scatter_cuda(_plan_for(jobs), jobs)


# -- gather_many --------------------------------------------------------------


def _columns(j: GatherJob) -> tuple:
    """(n, columns) of a job: a table's columns are int32 views of it (a
    table of another dtype becomes an int32 copy first)."""
    if isinstance(j.table, torch.Tensor):
        if j.table.dim() != 2:
            raise ValueError(f"gather job {j.name}: a table must be [n, P]")
        tab = j.table if j.table.dtype == torch.int32 else j.table.to(torch.int32)
        return tab.shape[0], tuple(GatherColumn(tab[:, p]) for p in range(tab.shape[1]))
    cols = tuple(j.table)
    return (cols[0].src.shape[0] if cols else 0), cols


def _gather_tensors(j: GatherJob) -> list:
    _n, cols = _columns(j)
    return [j.ids] + [c.src for c in cols] + [c.guard for c in cols if c.guard is not None]


def _check_gather(jobs: Sequence[GatherJob]) -> int:
    N = jobs[0].ids.shape[0]
    for j in jobs:
        if j.ids.dim() != 1 or j.ids.shape[0] != N:
            raise ValueError(f"gather job {j.name}: ids must be [N] with one N")
        n, cols = _columns(j)
        if len(j.digits) != len(cols) or len(cols) > _MAXP:
            raise ValueError(f"gather job {j.name}: one digit count a plane, at most {_MAXP} planes")
        for c in cols:
            if c.src.dim() != 1 or c.src.shape[0] != n or c.src.dtype not in (torch.int32, torch.float32):
                raise ValueError(f"gather job {j.name}: every column must be int32 or float32 [n] with one n")
            if c.guard is not None and (c.guard.shape != c.src.shape or c.guard.dtype != torch.int32):
                raise ValueError(f"gather job {j.name}: a guard must be int32 [n]")
            if not (-(2**31) <= c.cap < 2**31 and -(2**31) <= c.key < 2**31):
                raise ValueError(f"gather job {j.name}: cap and key must be int32")
    return N


def _plane(c: GatherColumn, safe: torch.Tensor, ok: torch.Tensor, d: int) -> torch.Tensor:
    v = c.src[safe]
    if c.guard is not None:
        v = torch.where(c.guard[safe] == c.key, v, 0)
    if v.is_floating_point():
        v = torch.round(v).to(torch.int32)
    return torch.where(ok, _masked(torch.clamp_max(v, c.cap), d), 0)


def gather_many_plain(jobs: Sequence[GatherJob]) -> List[torch.Tensor]:
    """The plain PyTorch version of gather_many: each plane gathered at the
    clipped ids, guarded, rounded, capped and digit-masked, zero for
    out-of-range ids."""
    N = _check_gather(jobs)
    out = []
    for j in jobs:
        n, cols = _columns(j)
        if n == 0 or not cols:
            out.append(torch.zeros((N, len(cols)), dtype=torch.float32, device=j.ids.device))
            continue
        ok = (j.ids >= 0) & (j.ids < n)
        safe = torch.clamp(j.ids, 0, n - 1).to(torch.int64)
        out.append(torch.stack([_plane(c, safe, ok, d) for c, d in zip(cols, j.digits)], dim=1).to(torch.float32))
    return out


#: eight-byte slots of one gather job descriptor (csrc/fused.cu
#: GATHER_SLOTS): ids, out, src[4], guard[4] pointers, then 26 int32 words
_GATHER_SLOTS = 23
#: int32 word offsets in a gather descriptor: n, P, then four per field
_GW_STRIDE, _GW_GSTRIDE, _GW_FLAGS, _GW_CAP, _GW_MASK, _GW_KEY = 2, 6, 10, 14, 18, 22


class GatherPlan(NamedTuple):
    """The static part of one gather_many call, made once per signature.

    desc:    int64 [jobs, 23] descriptors (csrc/fused.cu); a call writes
             only the pointers and the guards' keys; ``desc_ptr`` is its
             address.
    offsets: each job's first output float (a multiple of 4, so every
             job's output is 16-byte aligned); ``shapes`` its [N, P];
             ``total`` the output's floats.
    N:       items; ``launches`` a call's kernel launches.
    """

    desc: np.ndarray
    desc_ptr: int
    offsets: tuple
    shapes: tuple
    total: int
    N: int
    launches: int


def _gather_signature(jobs: Sequence[GatherJob]) -> tuple:
    """What a gather plan depends on: shapes, strides, dtypes and devices
    of every operand, caps and digits — not addresses or keys."""
    def sig(t):
        return None if t is None else (t.shape, t.stride(), t.dtype, t.device)

    return tuple(
        (sig(j.ids), j.digits, sig(j.table) if isinstance(j.table, torch.Tensor)
         else tuple((sig(c.src), c.cap, sig(c.guard)) for c in j.table))
        for j in jobs
    )


def _gather_plan(jobs: Sequence[GatherJob]) -> GatherPlan:
    """Check the jobs and lay out their descriptors and output: job j's
    plane p reads ``src[p] + id * stride[p]`` (and its guard at ``id *
    gstride[p]``), in elements; its [N, P] output starts at float
    ``offsets[j]``."""
    N = _check_gather(jobs)
    if len({t.device for j in jobs for t in _gather_tensors(j)}) != 1:
        raise ValueError("gather_many: every job's tensors must lie on one CUDA device (or all on the CPU)")
    desc = np.zeros((len(jobs), _GATHER_SLOTS), dtype=np.int64)
    words = desc[:, 2 + 2 * _MAXP :].view(np.int32)
    offsets, shapes = [], []
    off = 0
    for i, j in enumerate(jobs):
        n, cols = _columns(j)
        P = len(cols)
        strides = [c.src.stride(0) for c in cols] + [c.guard.stride(0) for c in cols if c.guard is not None]
        if max(strides, default=0) >= 2**31:
            raise ValueError(f"gather job {j.name}: strides must stay below 2^31")
        words[i, :2] = [n, P]
        for p, (c, d) in enumerate(zip(cols, j.digits)):
            words[i, _GW_STRIDE + p] = c.src.stride(0)
            words[i, _GW_GSTRIDE + p] = 0 if c.guard is None else c.guard.stride(0)
            words[i, _GW_FLAGS + p] = 1 if c.src.dtype == torch.float32 else 0
            words[i, _GW_CAP + p] = c.cap
            words[i, _GW_MASK + p] = _mask(d)
        offsets.append(off)
        shapes.append((N, P))
        off += -(-N * P // 4) * 4
    launches = -(-len(jobs) // _MAX_GATHER_JOBS) if N and off else 0
    return GatherPlan(desc, desc.ctypes.data, tuple(offsets), tuple(shapes), off, N, launches)


def _gather_bind(plan: GatherPlan, jobs: Sequence[GatherJob], out: torch.Tensor) -> list:
    """Point the plan's descriptors at this call's operands and ``out``
    and write the guards' keys; returns the operands (kept alive through
    the launch)."""
    keep = []
    desc = plan.desc
    words = desc[:, 2 + 2 * _MAXP :].view(np.int32)
    base = out.data_ptr()
    for i, (j, off) in enumerate(zip(jobs, plan.offsets)):
        ids = j.ids if j.ids.dtype == torch.int32 and j.ids.stride(0) == 1 else j.ids.to(torch.int32).contiguous()
        desc[i, :2] = (ids.data_ptr(), base + 4 * off)
        if isinstance(j.table, torch.Tensor):  # column p starts p elements into the row
            tab = j.table if j.table.dtype == torch.int32 else j.table.to(torch.int32)
            keep.append((ids, tab))
            p0, step = tab.data_ptr(), 4 * tab.stride(1)
            desc[i, 2 : 2 + tab.shape[1]] = [p0 + step * p for p in range(tab.shape[1])]
            continue
        keep.append((ids, j.table))
        desc[i, 2 : 2 + len(j.table)] = [c.src.data_ptr() for c in j.table]
        for p, c in enumerate(j.table):
            if c.guard is not None:
                desc[i, 2 + _MAXP + p] = c.guard.data_ptr()
                words[i, _GW_KEY + p] = c.key
    return keep


_GATHER_PLANS: dict = {}


def _gather_plan_for(jobs: Sequence[GatherJob]) -> GatherPlan:
    """The cached plan of the jobs' signature (made, and the jobs checked,
    on its first call)."""
    key = _gather_signature(jobs)
    plan = _GATHER_PLANS.get(key)
    if plan is None:
        plan = _gather_plan(jobs)
        if len(_GATHER_PLANS) >= _MAX_PLANS:
            _GATHER_PLANS.clear()
        _GATHER_PLANS[key] = plan
    return plan


def _gather_cuda(plan: GatherPlan, jobs: Sequence[GatherJob]) -> List[torch.Tensor]:
    from sentinel_tpu_torch.ops import _build

    dev = jobs[0].ids.device
    out = torch.empty((plan.total,), dtype=torch.float32, device=dev)
    if plan.launches:
        lib = _build.load_library()
        stream = torch._C._cuda_getCurrentRawStream(dev.index)  # the handle, without a Stream object
        with _lock:  # the descriptors are the plan's: one call fills them at a time
            keep = _gather_bind(plan, jobs, out)
            err = lib.sentinel_gather_many(plan.desc_ptr, len(jobs), plan.N, dev.index, stream)
        if err != 0:
            raise RuntimeError(f"gather_many kernel launch failed (CUDA error {err})")
        LAUNCHES["gather_many"] += plan.launches
    return [out.as_strided(shape, (shape[1], 1), off) for shape, off in zip(plan.shapes, plan.offsets)]


def gather_many(jobs: Sequence[GatherJob]) -> List[torch.Tensor]:
    """Per-item gathers of every job in one kernel launch (one per chunk of
    ``_MAX_GATHER_JOBS`` jobs; none for N = 0); one float32 [N, P] per
    job.  CPU tensors take the plain version."""
    if not jobs[0].ids.is_cuda:
        if any(t.device.type != "cpu" for j in jobs for t in _gather_tensors(j)):
            raise ValueError("gather_many: every job's tensors must lie on one CUDA device (or all on the CPU)")
        return gather_many_plain(jobs)
    return _gather_cuda(_gather_plan_for(jobs), jobs)
