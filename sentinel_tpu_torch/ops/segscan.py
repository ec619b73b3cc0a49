"""Segmented scans of the segment path: two hand-written kernels.

PyTorch counterpart of ``sentinel_tpu/ops/segscan.py``.  The JAX package
ran these as Pallas kernels on the TPU; here they are CUDA C++ kernels for
Hopper (``csrc/segscan.cu``, built at first use by ``ops/_build.py``):

- ``seg_excl_cumsum`` (replaces ``seg_excl_cumsum_pl``,
  ``sentinel_tpu/ops/segscan.py:81``): segmented EXCLUSIVE prefix sums of
  int32 ``[V, N]`` (or ``[N]``) values; heads reset the sum; position 0
  starts a segment.  Exact while each row's total stays below 2^31.  The
  segment check phase ranks flow quota, pacing cost, occupy and probe
  elections with it.
- ``seg_excl_cumsum_wide`` (replaces ``seg_excl_cumsum_wide_pl``,
  ``segscan.py:215``): values up to 2^24 whose totals may pass 2^31 — the
  reference's two 12-bit lanes, scanned and recombined as ``hi * 4096 +
  lo`` in float32 inside the same kernel (a wide row).
- ``seg_excl_cumsum_many``: narrow and wide rows that share their heads,
  in ONE launch (the segment check's ranks).
- ``seg_incl_min`` (replaces ``seg_incl_min_pl``, ``segscan.py:165``):
  segmented INCLUSIVE running minimum of float32 ``[N]``; heads reset it;
  results never exceed the identity 3.0e38.  The counterpart of the
  Pallas function; the tick reaches B4's work through ``seg_build``.
- ``seg_build`` (B4's route on the main path): one side of the tick's
  segment build (``engine_seg.prepare_completions`` /
  ``prepare_acquire``) in one launch — heads, sid, the live count, the
  slots of each segment's last item, every key at it and, on the
  completion side, the stat digit cumsums and the per-segment RT minimum
  (B4's work, inside the same tile) — where the plain version dispatches
  ~50-80 PyTorch operations.

Dispatch: a wrapper takes its plain PyTorch version ONLY when the tensors
it was given lie on the CPU (the tests).  A CUDA tensor launches the
kernel or raises — there is no fallback.  Each wrapper adds one to
``LAUNCHES[name]`` per call that launches its kernel (a row longer than
one 2,048-item tile takes a second, carry pass in the same call), and
nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from sentinel_tpu_torch.ops import segment as SG

#: kernel launches per wrapper since the last reset (plain integers)
LAUNCHES = {"seg_excl_cumsum": 0, "seg_incl_min": 0, "seg_build": 0}
#: guards LAUNCHES: every launching thread counts
_lock = threading.Lock()

#: the min identity (the TPU kernel's carry and the engine's RT-absent value)
BIG = 3.0e38


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _dispatch(name: str, *ts: torch.Tensor) -> bool:
    """True for the kernel (every tensor on one CUDA device), False for the
    plain version (every tensor on the CPU); raises otherwise."""
    if all(t.device.type == "cpu" for t in ts):
        return False
    if len({t.device for t in ts}) != 1 or ts[0].device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on one CUDA device (or all on the CPU)")
    return True


def _check_head(name: str, head: torch.Tensor, n: int) -> None:
    if head.dim() != 1 or head.shape[0] != n or head.dtype != torch.bool:
        raise ValueError(f"{name}: head must be bool [N] with N = {n}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _launch(name: str, fn_name: str, head, N: int, V: int, *args) -> None:
    """One kernel call: ``fn(head, *args, agg, agg_flag, N, stream)``; the
    carry pass's scratch (one pair per tile of the kernel's size) exists
    only for rows longer than a tile."""
    from sentinel_tpu_torch.ops import _build

    lib = _build.load_library()
    dev = head.device
    n_tiles = -(-N // lib.sentinel_seg_scan_tile())
    agg = flag = None
    if n_tiles > 1:
        agg = torch.empty((V, n_tiles), dtype=torch.int64, device=dev)
        flag = torch.empty((V, n_tiles), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = getattr(lib, fn_name)(
            _ptr(head), *args, _ptr(agg), _ptr(flag), int(N),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")
    with _lock:
        LAUNCHES[name] += 1


# -- B3: segmented exclusive prefix sum -----------------------------------------


def _rows(name: str, values, N: int):
    if values is None:
        return None
    if values.dim() != 2 or values.shape[1] != N:
        raise ValueError(f"{name}: rows must be [V, N] with N = {N}")
    return values


def seg_excl_cumsum_many_plain(head, narrow=None, wide=None):
    """The plain version of seg_excl_cumsum_many: ``segment.seg_excl_cumsum``
    on the narrow rows, ``segment.seg_excl_cumsum_wide`` on each wide row."""
    n_out = None if narrow is None else SG.seg_excl_cumsum(head, narrow)
    w_out = None
    if wide is not None:
        w_out = torch.zeros(wide.shape, dtype=torch.float32, device=wide.device)
        for r in range(wide.shape[0]):
            w_out[r] = SG.seg_excl_cumsum_wide(head, wide[r])
    return n_out, w_out


def seg_excl_cumsum_many(head: torch.Tensor, narrow=None, wide=None):
    """Segmented exclusive prefix sums of several rows that share one head
    vector, in ONE kernel launch: (int32 [Vn, N] of the narrow int [Vn, N]
    rows, whose row totals stay below 2^31; float32 [Vw, N] of the wide int
    [Vw, N] rows, values up to 2^24 whose totals may pass 2^31 — the bits of
    ``segment.seg_excl_cumsum_wide``).  Either may be None."""
    if narrow is None and wide is None:
        raise ValueError("seg_excl_cumsum_many: no rows")
    N = head.shape[0] if head.dim() == 1 else -1
    narrow = _rows("seg_excl_cumsum_many", narrow, N)
    wide = _rows("seg_excl_cumsum_many", wide, N)
    _check_head("seg_excl_cumsum_many", head, N)
    given = [t for t in (narrow, wide) if t is not None]
    if not _dispatch("seg_excl_cumsum", head, *given):
        return seg_excl_cumsum_many_plain(head, narrow, wide)
    return _excl_cuda(head, narrow, wide)


def _excl_cuda(head, narrow, wide):
    """seg_excl_cumsum_many's launch (checked arguments on one CUDA device)."""
    N = head.shape[0]
    dev = head.device
    Vn = 0 if narrow is None else narrow.shape[0]
    Vw = 0 if wide is None else wide.shape[0]
    n_out = None if narrow is None else torch.empty((Vn, N), dtype=torch.int32, device=dev)
    w_out = None if wide is None else torch.empty((Vw, N), dtype=torch.float32, device=dev)
    if N == 0 or Vn + Vw == 0:
        return (None if n_out is None else n_out.zero_()), (None if w_out is None else w_out.zero_())
    narrow = None if not Vn else narrow.to(torch.int32).contiguous()
    wide = None if not Vw else wide.to(torch.int32).contiguous()
    _launch("seg_excl_cumsum", "sentinel_seg_excl_cumsum", head.contiguous(), N, Vn + Vw,
            _ptr(narrow), _ptr(n_out if Vn else None), int(Vn), _ptr(wide), _ptr(w_out if Vw else None), int(Vw))
    return n_out, w_out


def seg_excl_cumsum_plain(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The plain version: ``segment.seg_excl_cumsum`` (cumsum minus the
    running maximum of the segment bases; ``torch.cummax``)."""
    return SG.seg_excl_cumsum(head, values)


def seg_excl_cumsum(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Segmented exclusive prefix sums: head bool [N], values int [V, N] or
    [N]; int32 out of the same shape.  One kernel launch for all rows."""
    if values.dim() not in (1, 2):
        raise ValueError("seg_excl_cumsum: values must be [N] or [V, N]")
    v = values[None, :] if values.dim() == 1 else values
    _check_head("seg_excl_cumsum", head, v.shape[1])
    if not _dispatch("seg_excl_cumsum", head, v):
        return seg_excl_cumsum_plain(head, values)
    out, _ = _excl_cuda(head, v, None)
    return out.reshape(values.shape)


def seg_excl_cumsum_wide(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """seg_excl_cumsum for values <= 2^24 whose totals may pass 2^31 (a
    wide row of ``seg_excl_cumsum_many``); the bits equal
    ``segment.seg_excl_cumsum_wide``.  Values [N], float32 [N] out."""
    if values.dim() != 1:
        raise ValueError("seg_excl_cumsum_wide: values must be [N]")
    _check_head("seg_excl_cumsum_wide", head, values.shape[0])
    if not _dispatch("seg_excl_cumsum", head, values):
        return SG.seg_excl_cumsum_wide(head, values)
    _, out = _excl_cuda(head, None, values[None, :])
    return out[0]


# -- B4: segmented inclusive running minimum ------------------------------------


def seg_incl_min_plain(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The plain version: a true segmented running minimum over the whole
    row (log-step doubling, carry across any length), capped at the
    identity 3.0e38 as the kernel is.  (The JAX wrapper's ``fill`` only
    pads a row to whole tiles; nothing here pads.)"""
    m = SG.seg_running_min(head, values.to(torch.float32), BIG)
    return torch.clamp_max(m, BIG)


def seg_incl_min(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Within-segment inclusive running minimum, float32 [N] -> [N]."""
    if values.dim() != 1:
        raise ValueError("seg_incl_min: values must be [N]")
    N = values.shape[0]
    _check_head("seg_incl_min", head, N)
    if not _dispatch("seg_incl_min", head, values):
        return seg_incl_min_plain(head, values)
    if N == 0:
        return torch.zeros((0,), dtype=torch.float32, device=values.device)
    v = values.to(torch.float32).contiguous()
    out = torch.empty((N,), dtype=torch.float32, device=v.device)
    _launch("seg_incl_min", "sentinel_seg_incl_min", head.contiguous(), N, 1, _ptr(v), _ptr(out))
    return out


# -- seg_build: one side of the tick's segment build ----------------------------------


class SegStats(NamedTuple):
    """The completion side's batch-known stat planes ([N] each) and the
    engine's limits on them."""

    success: torch.Tensor  # int32
    error: torch.Tensor  # int32
    rt: torch.Tensor  # float32 ms
    trash_row: int  # padding items: no stats, no RT
    max_count: int  # cfg.max_batch_count
    max_rt: int  # cfg.statistic_max_rt


class SegBuild(NamedTuple):
    """One side's segment build: the structure and each live segment's
    values at its last item ([U] each; dead slots as the plain version's
    gathers at ``seg_end`` 0 leave them)."""

    ctx: SG.SegCtx
    keys: list  # int32 [U] each: every key column
    ce: list  # completion side: int32 [U] digit cumsums of (success, error, rt_q)
    split: list  # completion side: (plane, weight) of each ce column (host)
    min_rt: Optional[torch.Tensor]  # completion side: float32 [U], BIG on dead slots
    res_sorted: Optional[torch.Tensor]  # acquire side: bool scalar, key 0 nondecreasing


def _stat_maxes(stats: SegStats) -> list:
    return [stats.max_count, stats.max_count, int(stats.max_rt) * 8]


def seg_build_plain(keys: Sequence[torch.Tensor], U: int, stats: Optional[SegStats] = None) -> SegBuild:
    """The plain version: the engine's segment build as the JAX package's
    ``prepare_completions`` (``stats`` given) and ``prepare_acquire``
    (``stats`` None) do it, operation for operation."""
    if stats is None:
        ctx, carried = SG.build(keys, U, payloads=keys)
        return SegBuild(ctx, carried, [], [], None, torch.all(keys[0][1:] >= keys[0][:-1]))
    valid = keys[0] != stats.trash_row
    succ_w = torch.where(valid, stats.success, 0)
    err_w = torch.where(valid, stats.error, 0)
    rt1 = torch.where(valid, stats.rt, 0.0)
    rt_q = torch.round(torch.clamp_max(rt1, float(stats.max_rt)) * 8.0).to(torch.int32)
    C_rows, split = SG.cum_cols([succ_w, err_w, rt_q], _stat_maxes(stats))
    head = SG.heads_from_keys(*keys)
    inc_min = seg_incl_min_plain(head, torch.where(valid & (rt1 > 0), rt1, BIG))
    ctx, carried = SG.build_from_head(head, U, payloads=list(C_rows) + [inc_min] + list(keys))
    nC = len(C_rows)
    return SegBuild(ctx, carried[nC + 1:], carried[:nC], split, torch.where(ctx.live, carried[nC], BIG), None)


@functools.lru_cache(maxsize=64)
def _digit_columns(maxes: tuple):
    """(ctypes plane array, ctypes shift array, count, split) of the digit
    columns ``segment.cum_cols`` makes for planes with these maxima: a plane
    up to 255 as it is (shift -1), a wider one as its base-256 digits."""
    planes, shifts, split = [], [], []
    for p, m in enumerate(maxes):
        if m <= 255:
            planes.append(p)
            shifts.append(-1)
            split.append((p, 1))
        else:
            for k in range(max(1, (int(m).bit_length() + 7) // 8)):
                planes.append(p)
                shifts.append(8 * k)
                split.append((p, 1 << (8 * k)))
    n = len(planes)
    return (ctypes.c_int * n)(*planes), (ctypes.c_int * n)(*shifts), n, split


def seg_build(keys: Sequence[torch.Tensor], U: int, stats: Optional[SegStats] = None) -> SegBuild:
    """One side of the tick's segment build over a batch sorted by ``keys``
    (1-5 int32 [N] columns, resource first): with ``stats`` the completion
    side (digit cumsums and RT minima), without it the acquire side
    (``res_sorted``).  One kernel launch for N up to a tile (2,048 items),
    two for a longer batch; the outputs equal ``seg_build_plain``'s, bit for
    bit, every slot included."""
    keys = list(keys)
    if not 1 <= len(keys) <= 5 or keys[0].dim() != 1 or keys[0].shape[0] < 1:
        raise ValueError("seg_build: 1-5 key columns of shape [N], N >= 1")
    N = keys[0].shape[0]
    given = keys + ([] if stats is None else [stats.success, stats.error, stats.rt])
    if any(t.shape != (N,) for t in given):
        raise ValueError(f"seg_build: every column must be [N] with N = {N}")
    if not _dispatch("seg_build", *given):
        return seg_build_plain(keys, U, stats)
    return _build_cuda(keys, int(U), stats)


def _build_cuda(keys, U: int, stats):
    """seg_build's launch (checked arguments on one CUDA device)."""
    from sentinel_tpu_torch.ops import _build

    lib = _build.load_library()
    N = keys[0].shape[0]
    dev = keys[0].device
    I32 = torch.int32
    ks = [k.to(I32).contiguous() for k in keys]
    head = torch.empty((N,), dtype=torch.bool, device=dev)
    sid = torch.empty((N,), dtype=I32, device=dev)
    n_seg = torch.empty((), dtype=I32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    seg_end = torch.empty((U,), dtype=I32, device=dev)
    live = torch.empty((U,), dtype=torch.bool, device=dev)
    key_u = torch.empty((len(ks), U), dtype=I32, device=dev)
    ce = min_rt = res_sorted = None
    if stats is None:
        planes = shifts = None
        ncols, split, st = 0, [], (None, None, None)
        res_sorted = torch.empty((), dtype=torch.bool, device=dev)
    else:
        planes, shifts, ncols, split = _digit_columns(tuple(_stat_maxes(stats)))
        if ncols > 12:
            raise ValueError(f"seg_build: {ncols} digit columns, the kernel takes up to 12")
        st = (stats.success.to(I32).contiguous(), stats.error.to(I32).contiguous(),
              stats.rt.to(torch.float32).contiguous())
        ce = torch.empty((ncols, U), dtype=I32, device=dev)
        min_rt = torch.empty((U,), dtype=torch.float32, device=dev)
    n_tiles = -(-N // lib.sentinel_seg_scan_tile())
    agg = torch.empty((n_tiles, ncols + 2), dtype=I32, device=dev) if n_tiles > 1 else None
    key_ptrs = (ctypes.c_void_p * len(ks))(*[k.data_ptr() for k in ks])
    trash = 0 if stats is None else int(stats.trash_row)
    rt_max = 0.0 if stats is None else float(stats.max_rt)
    with torch.cuda.device(dev):
        err = lib.sentinel_seg_build(
            key_ptrs, len(ks), *(_ptr(t) for t in st), trash, ctypes.c_float(rt_max), planes, shifts, ncols,
            int(N), U, _ptr(head), _ptr(sid), _ptr(n_seg), _ptr(ok), _ptr(seg_end), _ptr(live), _ptr(key_u),
            _ptr(ce), _ptr(min_rt), _ptr(res_sorted), _ptr(agg),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"seg_build kernel launch failed (CUDA error {err})")
    with _lock:
        LAUNCHES["seg_build"] += 1
    ctx = SG.SegCtx(head=head, sid=sid, n_seg=n_seg, ok=ok, seg_end=seg_end, live=live)
    return SegBuild(ctx, list(key_u), [] if ce is None else list(ce), split, min_rt, res_sorted)
