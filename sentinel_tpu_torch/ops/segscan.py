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
  ``segscan.py:215``): values up to 2^24 whose totals may pass 2^31 — two
  12-bit lanes through ``seg_excl_cumsum``, recombined as ``hi * 4096 +
  lo`` in float32 (one rounding).
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

import torch

from sentinel_tpu_torch.ops import segment as SG

#: kernel launches per wrapper since the last reset (plain integers)
LAUNCHES = {"seg_excl_cumsum": 0, "seg_incl_min": 0}

#: the min identity (the TPU kernel's carry and the engine's RT-absent value)
BIG = 3.0e38


def reset_launches() -> None:
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


def _launch(name: str, fn_name: str, head, v, out, V: int, N: int, scratch_dtype) -> None:
    from sentinel_tpu_torch.ops import _build

    lib = _build.load_library()
    dev = v.device
    # the carry pass's scratch holds one pair per tile of the kernel's size
    n_tiles = -(-N // lib.sentinel_seg_scan_tile())
    agg = flag = None
    if n_tiles > 1:
        agg = torch.empty((V, n_tiles), dtype=scratch_dtype, device=dev)
        flag = torch.empty((V, n_tiles), dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = getattr(lib, fn_name)(
            ptr(head), ptr(v), ptr(out), ptr(agg), ptr(flag), int(V), int(N),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")
    LAUNCHES[name] += 1


# -- B3: segmented exclusive prefix sum -----------------------------------------


def seg_excl_cumsum_plain(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The plain version: ``segment.seg_excl_cumsum`` (cumsum minus the
    running maximum of the segment bases; ``torch.cummax``)."""
    return SG.seg_excl_cumsum(head, values)


def seg_excl_cumsum(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Segmented exclusive prefix sums: head bool [N], values int [V, N] or
    [N]; int32 out of the same shape.  One kernel launch for all rows."""
    squeeze = values.dim() == 1
    v = values[None, :] if squeeze else values
    if v.dim() != 2:
        raise ValueError("seg_excl_cumsum: values must be [N] or [V, N]")
    V, N = v.shape
    _check_head("seg_excl_cumsum", head, N)
    if not _dispatch("seg_excl_cumsum", head, v):
        return seg_excl_cumsum_plain(head, values)
    if V == 0 or N == 0:
        return torch.zeros(values.shape, dtype=torch.int32, device=values.device)
    v = v.to(torch.int32).contiguous()
    out = torch.empty((V, N), dtype=torch.int32, device=v.device)
    _launch("seg_excl_cumsum", "sentinel_seg_excl_cumsum", head.contiguous(), v, out, V, N, torch.int32)
    return out[0] if squeeze else out


def wide_lanes(values: torch.Tensor) -> torch.Tensor:
    """[2, N] int32 (lo, hi) 12-bit lanes of values up to 2^24."""
    v = values.to(torch.int32)
    return torch.stack([v & 0xFFF, v >> 12])


def wide_recombine(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """hi * 4096 + lo in float32: hi * 4096 is exact, so one rounding."""
    return hi.to(torch.float32) * 4096.0 + lo.to(torch.float32)


def seg_excl_cumsum_wide(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """seg_excl_cumsum for values <= 2^24 whose totals may pass 2^31: the
    split and the recombination are tensor ops around one B3 launch; the
    bits equal ``segment.seg_excl_cumsum_wide``."""
    r = seg_excl_cumsum(head, wide_lanes(values))
    return wide_recombine(r[0], r[1])


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
    _launch("seg_incl_min", "sentinel_seg_incl_min", head.contiguous(), v, out, 1, N, torch.float32)
    return out
