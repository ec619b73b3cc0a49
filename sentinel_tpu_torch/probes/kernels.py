"""The four probe kernels: a copy and three atomics-based histograms.

PyTorch counterparts of the Pallas probe kernels the JAX package kept under
``benchmarks/`` to measure its launch floor and its scatter floor; here they
are CUDA C++ kernels for Hopper (``csrc/probes.cu``, built at first use by
``ops/_build.py``), each beside its plain PyTorch version (``*_plain``):

- ``probe_copy`` (replaces ``benchmarks/probe_pallas_floor.py:49`` and
  ``benchmarks/probe_pallas_floor2.py:45`` ``copy_call``): ``x + 1`` on
  int32, with the number of blocks the launch uses as a parameter — the
  counterpart of the TPU grid's step count and its "parallel" flag.
- ``probe_hist_count`` (replaces ``probe_pallas_floor.py:68`` ``sc_call``
  and ``:151`` ``sc_call2``): a count histogram of ids into the padded
  shape ``[n_hi, n_lo]``, row ``k`` at ``[k // n_lo, k % n_lo]``.
- ``probe_hist_planes`` (replaces ``benchmarks/pallas_histogram.py:44``
  ``pallas_histogram`` and ``probe_pallas_floor.py:106`` ``sc5_call``):
  ``hist[k, p] = sum of values[i, p] over items with ids[i] == k``, as an
  ``[n, P]`` table (``n_lo=None``) or planes-major ``[P, n_hi, n_lo]``.
- ``probe_hist_stat5`` (replaces ``benchmarks/probe_fused_hist.py:78``
  ``make_fused(TB).run`` and ``benchmarks/probe_fused_hist2.py:59``
  ``make(TB, n_lo, mode).run``): five planes into ``[5, n_hi, n_lo]`` —
  three count planes, then the low and the high byte of ``rt``; the byte
  split happens in the kernel.

ids outside ``[0, n)`` drop.  Outputs are float32.  The sums are of
integer-valued data and must stay below 2^24: float32 addition is then
exact and independent of order, so each kernel EQUALS its plain version
bit for bit (the tests and ``chip_smoke.py`` hold them to exact equality).

Dispatch, as in ``ops/fused.py``: a wrapper takes its plain version ONLY
when the tensors it was given lie on the CPU.  A CUDA tensor launches the
kernel or raises — there is no fallback.  Each wrapper adds one to
``LAUNCHES[name]`` per kernel launch, and nowhere else.  ``out=`` lets a
caller that captures launches into a CUDA graph bring its own buffer.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: kernel launches per wrapper since the last reset (plain integers)
LAUNCHES = {"probe_copy": 0, "probe_hist_count": 0, "probe_hist_planes": 0, "probe_hist_stat5": 0}

#: items a histogram block takes unless the caller sweeps it (one a thread)
ITEMS_PER_BLOCK = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def padded_shape(n: int, n_lo: int) -> tuple:
    """(n_hi, n_lo) of the padded output: n_hi = ceil(n / n_lo)."""
    if n < 0 or n_lo < 1:
        raise ValueError(f"need n >= 0 and n_lo >= 1, got n={n}, n_lo={n_lo}")
    return -(-n // n_lo), n_lo


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device; anything else raises."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError("probe kernels: every tensor must lie on one CUDA device (or all on the CPU)")
    return False


def _check_ids(ids: torch.Tensor) -> None:
    if ids.dim() != 1 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous int32 [N] tensor")


def _out(out: Optional[torch.Tensor], shape, dtype, like: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=dtype, device=like.device)
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype or out.device != like.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {dtype} tensor of shape {tuple(shape)} on {like.device}")
    return out


def _launch(name: str, fn, dev, *args) -> None:
    """Call one C entry point on the current stream of ``dev``; raise on a
    CUDA error; count the launch."""
    with torch.cuda.device(dev):
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _lib():
    from sentinel_tpu_torch.ops import _build

    return _build.load_library()


def _drop(ids: torch.Tensor, n: int, spare: int) -> torch.Tensor:
    """int64 ids with everything outside [0, n) sent to the spare cell."""
    return torch.where((ids >= 0) & (ids < n), ids, spare).to(torch.int64)


# -- probe_copy ---------------------------------------------------------------------


def probe_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def probe_copy(x: torch.Tensor, blocks: int = 0, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + 1`` for an int32 tensor of any shape.  ``blocks``: how many
    256-thread blocks share the items (grid-stride); 0 = one thread an
    item, as many blocks as that takes."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("probe_copy takes a contiguous int32 tensor")
    if _on_cpu(x):
        return probe_copy_plain(x)
    y = _out(out, x.shape, torch.int32, x)
    _launch("probe_copy", _lib().sentinel_probe_copy, x.device, _ptr(x), _ptr(y), x.numel(), int(blocks))
    return y


# -- probe_hist_count ---------------------------------------------------------------


def probe_hist_count_plain(ids: torch.Tensor, n: int, n_lo: int) -> torch.Tensor:
    _check_ids(ids)
    n_hi, n_lo = padded_shape(n, n_lo)
    cells = n_hi * n_lo
    acc = torch.zeros(cells + 1, dtype=torch.float32, device=ids.device)
    acc.index_add_(0, _drop(ids, n, cells), torch.ones(ids.shape[0], dtype=torch.float32, device=ids.device))
    return acc[:cells].view(n_hi, n_lo)


def probe_hist_count(
    ids: torch.Tensor, n: int, n_lo: int, items_per_block: int = ITEMS_PER_BLOCK,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """float32 ``[n_hi, n_lo]``: how many items carry each id."""
    _check_ids(ids)
    n_hi, n_lo = padded_shape(n, n_lo)
    if _on_cpu(ids):
        return probe_hist_count_plain(ids, n, n_lo)
    o = _out(out, (n_hi, n_lo), torch.float32, ids)
    _launch("probe_hist_count", _lib().sentinel_probe_hist_count, ids.device,
            _ptr(ids), ids.shape[0], int(n), _ptr(o), o.numel(), int(items_per_block))
    return o


# -- probe_hist_planes --------------------------------------------------------------


def _check_values(ids: torch.Tensor, values: torch.Tensor) -> None:
    _check_ids(ids)
    if values.dim() != 2 or values.shape[0] != ids.shape[0] or values.shape[1] < 1:
        raise ValueError("values must be [N, P] with the ids' N and P >= 1")
    if values.dtype not in (torch.float32, torch.int32) or not values.is_contiguous():
        raise ValueError("values must be contiguous float32 or int32")


def probe_hist_planes_plain(ids: torch.Tensor, values: torch.Tensor, n: int, n_lo: Optional[int] = None) -> torch.Tensor:
    _check_values(ids, values)
    P = values.shape[1]
    rows = n if n_lo is None else padded_shape(n, n_lo)[0] * n_lo
    acc = torch.zeros((rows + 1, P), dtype=torch.float32, device=ids.device)
    acc.index_add_(0, _drop(ids, n, rows), values.to(torch.float32))
    if n_lo is None:
        return acc[:n]
    return acc[:rows].T.contiguous().view(P, rows // n_lo, n_lo)


def probe_hist_planes(
    ids: torch.Tensor, values: torch.Tensor, n: int, n_lo: Optional[int] = None,
    items_per_block: int = ITEMS_PER_BLOCK, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """float32 ``[n, P]`` (``n_lo=None``) or ``[P, n_hi, n_lo]``: the sum of
    each value plane over the items of each id."""
    _check_values(ids, values)
    P = values.shape[1]
    if n_lo is None:
        shape, stride = (n, P), 0
    else:
        n_hi, n_lo = padded_shape(n, n_lo)
        shape, stride = (P, n_hi, n_lo), n_hi * n_lo
    if _on_cpu(ids, values):
        return probe_hist_planes_plain(ids, values, n, n_lo)
    o = _out(out, shape, torch.float32, ids)
    _launch("probe_hist_planes", _lib().sentinel_probe_hist_planes, ids.device,
            _ptr(ids), _ptr(values), int(values.dtype == torch.float32), ids.shape[0], P, int(n),
            _ptr(o), o.numel(), stride, int(items_per_block))
    return o


# -- probe_hist_stat5 ---------------------------------------------------------------


def _check_stat5(ids, cnts, rt) -> None:
    _check_ids(ids)
    N = ids.shape[0]
    if tuple(cnts.shape) != (N, 3) or cnts.dtype != torch.int32 or not cnts.is_contiguous():
        raise ValueError("cnts must be a contiguous int32 [N, 3] tensor")
    if tuple(rt.shape) != (N,) or rt.dtype != torch.int32 or not rt.is_contiguous():
        raise ValueError("rt must be a contiguous int32 [N] tensor")


def probe_hist_stat5_plain(ids: torch.Tensor, cnts: torch.Tensor, rt: torch.Tensor, n: int, n_lo: int) -> torch.Tensor:
    _check_stat5(ids, cnts, rt)
    vals = torch.cat([cnts, (rt & 0xFF)[:, None], ((rt >> 8) & 0xFF)[:, None]], dim=1)
    return probe_hist_planes_plain(ids, vals, n, n_lo)


def probe_hist_stat5(
    ids: torch.Tensor, cnts: torch.Tensor, rt: torch.Tensor, n: int, n_lo: int,
    items_per_block: int = ITEMS_PER_BLOCK, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """float32 ``[5, n_hi, n_lo]``: the three count planes of ``cnts``, then
    ``rt & 0xFF`` and ``(rt >> 8) & 0xFF``, summed over the items of each id."""
    _check_stat5(ids, cnts, rt)
    n_hi, n_lo = padded_shape(n, n_lo)
    if _on_cpu(ids, cnts, rt):
        return probe_hist_stat5_plain(ids, cnts, rt, n, n_lo)
    o = _out(out, (5, n_hi, n_lo), torch.float32, ids)
    _launch("probe_hist_stat5", _lib().sentinel_probe_hist_stat5, ids.device,
            _ptr(ids), _ptr(cnts), _ptr(rt), ids.shape[0], int(n), _ptr(o), n_hi * n_lo, int(items_per_block))
    return o
