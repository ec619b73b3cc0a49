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
  results never exceed the identity 3.0e38.  The completion phase's
  per-segment RT minimum.

Dispatch: a wrapper takes its plain PyTorch version ONLY when the tensors
it was given lie on the CPU (the tests).  A CUDA tensor launches the
kernel or raises — there is no fallback.  Each wrapper adds one to
``LAUNCHES[name]`` per call that launches its kernel (a row longer than
one 2,048-item tile takes a second, carry pass in the same call), and
nowhere else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from sentinel_tpu_torch.ops import segment as SG

#: kernel launches per wrapper since the last reset (plain integers)
LAUNCHES = {"seg_excl_cumsum": 0, "seg_incl_min": 0}
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
