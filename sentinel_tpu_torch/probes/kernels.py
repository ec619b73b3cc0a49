"""The four probe kernels: a copy, a count histogram and two valued
histograms.

PyTorch counterparts of the Pallas probe kernels the JAX package kept under
``benchmarks/`` to measure its launch floor and its scatter floor; here they
are CUDA C++ kernels for Hopper (``csrc/probes.cu``, built at first use by
``ops/_build.py``), each beside its plain PyTorch version (``*_plain``):

- ``probe_copy`` (replaces ``benchmarks/probe_pallas_floor.py:49`` and
  ``benchmarks/probe_pallas_floor2.py:45`` ``copy_call``): ``x + 1`` on
  int32 by 16-byte loads and stores, with the number of blocks the launch
  uses as a parameter — the counterpart of the TPU grid's step count and
  its "parallel" flag.
- ``probe_hist_count`` (replaces ``probe_pallas_floor.py:68`` ``sc_call``
  and ``:151`` ``sc_call2``): a count histogram of ids into the padded
  shape ``[n_hi, n_lo]``, row ``k`` at ``[k // n_lo, k % n_lo]``.  The
  valued histograms' cluster template specialised for a count: no value
  loads, int32 cells alone in shared memory, each cell written once as
  float32 (its first version was a memset, then one float ``atomicAdd``
  an id into L2: two launches).
- ``probe_hist_planes`` (replaces ``benchmarks/pallas_histogram.py:44``
  ``pallas_histogram`` and ``probe_pallas_floor.py:106`` ``sc5_call``):
  ``hist[k, p] = sum of values[i, p] over items with ids[i] == k``, as an
  ``[n, P]`` table (``n_lo=None``) or planes-major ``[P, n_hi, n_lo]``.
- ``probe_hist_stat5`` (replaces ``benchmarks/probe_fused_hist.py:78``
  ``make_fused(TB).run`` and ``benchmarks/probe_fused_hist2.py:59``
  ``make(TB, n_lo, mode).run``): five planes into ``[5, n_hi, n_lo]`` —
  three count planes, then the low and the high byte of ``rt``; the byte
  split happens in the kernel.

The histograms are bound by bytes (4 B an id and 4 B a value
plane read, the table written once: 8.2 MB at the stat-landing shape) and
were bound by atomics in their first version (a memset, then one float
``atomicAdd`` into L2 per nonzero value).  They are now one template, the
Hopper counterpart of the TPU kernels' output kept resident in VMEM and
written once: ONE launch a call, no memset, no global atomic.  Each
thread-block cluster owns a slice of the table's rows; every block of it
keeps a copy of the slice in shared memory, reads its share of all the
ids and adds the values of the items in the slice into its copy by
shared-memory integer atomics; after a cluster barrier each block sums
its rows over the cluster's copies (distributed shared memory) and
writes them once (padding rows included, so ``out=`` may hold anything).
An integer value below 2^24 adds to an int32 cell, any other value to a
float32 cell beside it; the count keeps the int32 cells alone
(``hist_plan(..., counts=True)``).  ``hist_plan`` cuts the table (pure
Python; the tests hold it);
``items_per_block`` sets how many ids a block takes at a time from its
cluster's items (interleaved chunks, rounded up to a power of two times
4), not the work a thread does.

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
import functools
import threading
from dataclasses import dataclass
from typing import Optional

import torch

#: kernel launches per wrapper since the last reset (plain integers)
LAUNCHES = {"probe_copy": 0, "probe_hist_count": 0, "probe_hist_planes": 0, "probe_hist_stat5": 0}
#: guards LAUNCHES and _CARD: every launching thread counts
_lock = threading.Lock()

#: items a thread of probe_copy takes a grid-stride step (csrc/probes.cu
#: COPY_ITEMS: two 16-byte accesses)
COPY_ITEMS = 8
#: items a histogram block takes at a time unless the caller sweeps it
ITEMS_PER_BLOCK = 256
#: threads a block of the valued histograms
HIST_THREADS = 1024
#: blocks a cluster of the valued histograms (above 8 is Hopper's non-portable
#: size; 16 measured faster than 8 at the stat landing on an H100)
CLUSTER = 16
#: the largest cluster the kernel takes (csrc/probes.cu HIST_MAX_CLUSTER)
MAX_CLUSTER = 16
#: dynamic shared memory a block of the valued histograms may take: Hopper's
#: 227 KB a block less 256 B for its static shared variables
MAX_SMEM_BYTES = 232_448 - 256
#: shared memory a cell of the valued histograms takes: an int32 and a float32
CELL_BYTES = 8
#: shared memory a cell of the count takes: an int32
COUNT_CELL_BYTES = 4
#: threads a block of the count, and the most clusters it launches: every
#: cluster reads all the ids, so past a few clusters the extra reads cost
#: more than spreading the rows saves (``python3 chip_smoke.py
#: --count-plans``, 16 / 8 / 4 / 2 / 1-block clusters, 1-66 of them and 256 /
#: 512 / 1,024 threads at the five count shapes, put 4 clusters of 16 x 512
#: threads first or within 2 % of the first on an NVIDIA H100 80GB HBM3 at
#: 700 W)
COUNT_THREADS = 512
COUNT_MAX_CLUSTERS = 4
#: shared memory a warp of the valued histograms keeps for its queue of
#: matched items (256 (item, cell) pairs; csrc/probes.cu HIST_QUEUE)
QUEUE_BYTES_A_WARP = 8 * 256
#: SMs of an H100 SXM: the plan's default when no card is asked
H100_SMS = 132


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def padded_shape(n: int, n_lo: int) -> tuple:
    """(n_hi, n_lo) of the padded output: n_hi = ceil(n / n_lo)."""
    if n < 0 or n_lo < 1:
        raise ValueError(f"need n >= 0 and n_lo >= 1, got n={n}, n_lo={n_lo}")
    return -(-n // n_lo), n_lo


@dataclass(frozen=True)
class HistPlan:
    """One valued-histogram launch: ``clusters`` clusters of ``cluster``
    blocks of ``threads`` threads.  Cluster ``c`` adds the items whose id
    is one of its blocks' rows (below ``n``); block ``b`` of it writes the
    rows ``block_rows(c, b)``, every plane.  ``smem_bytes``: a block's copy
    of its cluster's rows (int and float cells) and its warps' queues.
    ``rows`` is ``n`` for an ``[n, P]`` table and ``n_hi * n_lo`` (padding
    included) for ``[P, n_hi, n_lo]``."""

    rows: int
    planes: int
    cluster: int
    clusters: int
    rows_per_block: int
    smem_bytes: int
    threads: int

    def block_rows(self, c: int, b: int) -> tuple:
        """[lo, hi) of the rows block ``b`` of cluster ``c`` owns (empty
        past the table's end)."""
        lo = (c * self.cluster + b) * self.rows_per_block
        return min(lo, self.rows), min(lo + self.rows_per_block, self.rows)


@functools.lru_cache(maxsize=256)
def hist_plan(n: int, planes: int, n_lo: Optional[int] = None, sms: int = H100_SMS,
              max_clusters: Optional[int] = None, counts: bool = False) -> HistPlan:
    """Cut a histogram's table for one launch of ``CLUSTER``-block
    clusters: as many clusters as the card runs at once (``max_clusters``;
    at most one block an SM of its ``sms``), more only when the table does
    not fit their shared memory.  Each block owns a multiple of 4 rows
    (16-byte stores), as many as its copy of the cluster's slice in
    ``MAX_SMEM_BYTES`` beside its warps' queues allows (``counts``: the
    count's copy, ``COUNT_CELL_BYTES`` a cell and no queue, in at most
    ``COUNT_MAX_CLUSTERS`` clusters of ``COUNT_THREADS`` threads).  No
    clusters for an empty table."""
    if n < 0 or planes < 1 or sms < 1 or (max_clusters is not None and max_clusters < 1):
        raise ValueError(f"no plan for n={n}, planes={planes}, sms={sms}, max_clusters={max_clusters}")
    cluster, threads = CLUSTER, COUNT_THREADS if counts else HIST_THREADS
    if counts:
        max_clusters = min(max_clusters or COUNT_MAX_CLUSTERS, COUNT_MAX_CLUSTERS)
    rows = n if n_lo is None else n_lo * padded_shape(n, n_lo)[0]
    cell = COUNT_CELL_BYTES if counts else CELL_BYTES
    queue = 0 if counts else threads // 32 * QUEUE_BYTES_A_WARP
    cap = (MAX_SMEM_BYTES - queue) // (cell * cluster * planes) // 4 * 4
    if cap < 4:
        raise ValueError(f"{planes} planes do not fit 4 rows a block in shared memory")
    if rows == 0:
        return HistPlan(0, planes, cluster, 0, 4, 4 * cell * cluster * planes + queue, threads)
    blocks = max(1, min(sms // cluster, max_clusters or sms)) * cluster
    rpb = min(cap, 4 * _ceil(_ceil(rows, blocks), 4))
    clusters = _ceil(rows, cluster * rpb)
    return HistPlan(rows, planes, cluster, clusters, rpb, cell * cluster * rpb * planes + queue, threads)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


#: what the plan asks of each card, asked once: SMs by device, concurrent
#: clusters by (device, cluster, threads)
_CARD = {}


def _sms(dev: torch.device) -> int:
    with _lock:
        if dev not in _CARD:
            _CARD[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        return _CARD[dev]


def _max_clusters(dev: torch.device, cluster: int, threads: int) -> int:
    """The clusters of this shape the card runs at once (asked once)."""
    key = (dev, cluster, threads)
    with _lock:
        n = _CARD.get(key)
    if n is None:  # asked outside the lock (the first ask builds the library); a racing ask gets the same answer
        got = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = _lib().sentinel_probe_hist_max_clusters(cluster, threads, ctypes.byref(got))
        if err != 0 or got.value < 1:
            raise RuntimeError(f"no {cluster}-block cluster of {threads} threads fits the card (CUDA error {err})")
        with _lock:
            n = _CARD.setdefault(key, got.value)
    return n


def card_plan(dev: torch.device, n: int, planes: int, n_lo: Optional[int] = None, counts: bool = False) -> HistPlan:
    """The plan the wrappers launch on the card ``dev``."""
    return hist_plan(n, planes, n_lo, _sms(dev), _max_clusters(dev, CLUSTER, HIST_THREADS), counts)


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
    with _lock:
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
    """``x + 1`` for an int32 tensor of any shape, 16 bytes an access
    (a scalar head and tail where ``x`` or ``out`` is not 16-byte aligned
    or the size is not a multiple of 4).  ``blocks``: how many 256-thread
    blocks share the items (grid-stride); 0 = as many as one step of every
    thread (``COPY_ITEMS`` items) covers."""
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
    """float32 ``[n_hi, n_lo]``: how many items carry each id (exact below
    2^24 a cell).  One launch (none for an empty table); the padding cells
    are written 0, so ``out=`` may hold anything."""
    _check_ids(ids)
    n_hi, n_lo = padded_shape(n, n_lo)
    if _on_cpu(ids):
        return probe_hist_count_plain(ids, n, n_lo)
    o = _out(out, (n_hi, n_lo), torch.float32, ids)
    plan = card_plan(ids.device, int(n), 1, n_lo, counts=True)
    _hist_launch("probe_hist_count", _lib().sentinel_probe_hist_count, ids, plan, items_per_block,
                 _ptr(ids), ids.shape[0], int(n), _ptr(o), n_hi * n_lo)
    return o


# -- the valued histograms ----------------------------------------------------------


def _hist_launch(name: str, fn, ids: torch.Tensor, plan: HistPlan, items_per_block: int, *args) -> None:
    """One cluster launch of ``plan`` (none when the table is empty)."""
    if items_per_block < 1:
        raise ValueError(f"items_per_block must be >= 1, got {items_per_block}")
    if plan.clusters:
        _launch(name, fn, ids.device, *args, int(items_per_block), plan.cluster, plan.clusters,
                plan.rows_per_block, plan.smem_bytes, plan.threads)


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
    each value plane over the items of each id.  One launch (none for an
    empty table)."""
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
    plan = card_plan(ids.device, int(n), P, n_lo)
    _hist_launch("probe_hist_planes", _lib().sentinel_probe_hist_planes, ids, plan, items_per_block,
                 _ptr(ids), _ptr(values), int(values.dtype == torch.float32), ids.shape[0], P, int(n),
                 _ptr(o), stride)
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
    ``rt & 0xFF`` and ``(rt >> 8) & 0xFF``, summed over the items of each id.
    One launch (none for an empty table)."""
    _check_stat5(ids, cnts, rt)
    n_hi, n_lo = padded_shape(n, n_lo)
    if _on_cpu(ids, cnts, rt):
        return probe_hist_stat5_plain(ids, cnts, rt, n, n_lo)
    o = _out(out, (5, n_hi, n_lo), torch.float32, ids)
    plan = card_plan(ids.device, int(n), 5, n_lo)
    _hist_launch("probe_hist_stat5", _lib().sentinel_probe_hist_stat5, ids, plan, items_per_block,
                 _ptr(ids), _ptr(cnts), _ptr(rt), ids.shape[0], int(n), _ptr(o), n_hi * n_lo)
    return o
