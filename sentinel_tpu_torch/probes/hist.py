"""What a scatter costs on this card at the stat-landing shape.

Counterpart of the JAX package's ``benchmarks/pallas_histogram.py``,
``benchmarks/probe_fused_hist.py`` and ``benchmarks/probe_fused_hist2.py``,
with the same data (``np.random.default_rng(0)``):

- the valued histogram at B = 131,072 items, N = 8,192 rows, P = 4 planes
  of integers 0..99 (``probe_hist_planes``);
- the fused count + RT-byte histogram at the stat-landing shape: 393,216
  fanned items (3 x 131,072) with ids in [0, 16840) into 16,640 node rows,
  three count planes in {0, 1} and an RT in [0, 40000) split into its two
  low bytes (``probe_hist_stat5``), at the padded widths n_lo = 128, 256,
  512 and a sweep of items a block.

The two kernels (``probe_hist_planes`` replaces
``benchmarks/pallas_histogram.py:44`` ``pallas_histogram``,
``probe_hist_stat5`` replaces ``benchmarks/probe_fused_hist.py:78`` and
``benchmarks/probe_fused_hist2.py:59``) are bound by bytes on this card
(8.2 MB at the stat-landing shape, 2.4 us at 3.35 TB/s) and by the launch
(2.4-2.7 us).  They are no longer simple atomics kernels behind a memset:
each call is ONE launch of thread-block clusters that hold the table's
row slices in shared memory, add there and write every row once
(``kernels.py``, ``csrc/probes.cu``); ``items_per_block`` sets the chunks
of ids a block takes at a time.

Each is timed against (i) the one PyTorch call that computes the same
function — ``index_add_`` of the [N, P] values into an [n + 1, P] table
whose spare row takes the dropped ids (the byte split and the index are
set-up) — and (ii) the port's own scatter kernel ``ops.fused.scatter_many``
on the same items: one job of four 2-digit planes, and the split form
(counts at 1 digit + RT at 2 digits), the counterparts of the probes'
"current path" rows.  All of them must give the same sums.

Device ms a launch: CUDA events around K = 24 launches queued behind a
sleep; the launches run back to back on the same operands, so the 50 MB
L2 holds them.  Host microseconds a launch beside it.

    python3 -m sentinel_tpu_torch.probes.hist
"""

from __future__ import annotations

import numpy as np
import torch

from sentinel_tpu_torch.ops import fused as FU
from sentinel_tpu_torch.probes import kernels as PK
from sentinel_tpu_torch.probes import timing as TM

K = 24
#: the valued histogram's shape
P1_B, P1_N, P1_P = 131072, 8192, 4
#: the stat-landing shape
N3, N_ROWS = 3 * 131072, 16640
N_LO = (128, 256, 512)
ITEMS_PER_BLOCK = (128, 256, 1024, 4096)


def planes_data(device="cuda"):
    """(idx int32 [B] in [0, N), values float32 [B, P] of integers 0..99)."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, P1_N, P1_B).astype(np.int32)
    vals = rng.integers(0, 100, (P1_B, P1_P)).astype(np.float32)
    return torch.as_tensor(idx).to(device), torch.as_tensor(vals).to(device)


def stat_data(device="cuda"):
    """(ids int32 [N3] in [0, 16840), cnts int32 [N3, 3] in {0, 1}, rt int32
    [N3] in [0, 40000))."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, N_ROWS + 200, N3).astype(np.int32)
    cnts = rng.integers(0, 2, (N3, 3), dtype=np.int32)
    rt = rng.integers(0, 40000, N3, dtype=np.int32)
    return tuple(torch.as_tensor(x).to(device) for x in (ids, cnts, rt))


def index_add_call(ids: torch.Tensor, values: torch.Tensor, n: int):
    """(call, table): ``call()`` zeroes the [n + 1, P] float32 table and adds
    every item's values at its id (dropped ids at row n) in one
    ``index_add_``; the index and the float values are built here, once."""
    idx = torch.where((ids >= 0) & (ids < n), ids, n).to(torch.int64)
    vals = values.to(torch.float32).contiguous()
    table = torch.zeros((n + 1, values.shape[1]), dtype=torch.float32, device=ids.device)

    def call():
        table.zero_()
        table.index_add_(0, idx, vals)

    return call, table


def stat_jobs(ids, cnts, rt):
    """The stat landing as scatter_many jobs: (one job of four 2-digit
    planes, the split form: counts at 1 digit + RT at 2 digits)."""
    rows = ids[None, :]
    vals4 = torch.cat([cnts.T, rt[None, :]]).contiguous()
    fused = [FU.Job("stat", N_ROWS, rows, vals4, (2, 2, 2, 2))]
    split = [
        FU.Job("cnt", N_ROWS, rows, cnts.T.contiguous(), (1, 1, 1)),
        FU.Job("rt", N_ROWS, rows, rt[None, :].contiguous(), (2,)),
    ]
    return fused, split


def _same(what, a, b):
    if a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"{what}: the sums differ")


def run() -> list:
    """The table's rows, each ``dict(name, device_ms, host_us, wall_ms)`` a
    launch."""
    TM.require_card()
    rows = []

    def row(name, t):
        rows.append(dict(name=name, **t))

    # -- the valued histogram: B = 131,072 into [8192, 4] ------------------
    idx, vals = planes_data()
    out = torch.empty((P1_N, P1_P), dtype=torch.float32, device=idx.device)
    for ipb in ITEMS_PER_BLOCK:
        row(f"probe_hist_planes B={P1_B} N={P1_N} P={P1_P} items_per_block={ipb}",
            TM.eager(lambda ipb=ipb: PK.probe_hist_planes(idx, vals, P1_N, None, ipb, out=out), K))
    lib, table = index_add_call(idx, vals, P1_N)
    row(f"index_add_ B={P1_B} N={P1_N} P={P1_P}", TM.eager(lib, K))
    job = [FU.Job("hist", P1_N, idx[None, :], vals.to(torch.int32).T.contiguous(), (1,) * P1_P)]
    row(f"scatter_many B={P1_B} N={P1_N} P={P1_P} (1 digit a plane)", TM.eager(lambda: FU.scatter_many(job), K))
    want = PK.probe_hist_planes(idx, vals, P1_N)
    _same("valued histogram vs index_add_", want, table[:P1_N])
    _same("valued histogram vs scatter_many", want, FU.scatter_many(job)[0])

    # -- the stat landing: 393,216 items into 16,640 rows, 5 planes ----------
    ids, cnts, rt = stat_data()
    for n_lo in N_LO:
        out5 = torch.empty((5,) + PK.padded_shape(N_ROWS, n_lo), dtype=torch.float32, device=ids.device)
        for ipb in ITEMS_PER_BLOCK:
            row(f"probe_hist_stat5 N={N3} rows={N_ROWS} n_lo={n_lo} items_per_block={ipb}",
                TM.eager(lambda n_lo=n_lo, ipb=ipb, o=out5: PK.probe_hist_stat5(ids, cnts, rt, N_ROWS, n_lo, ipb, out=o), K))
    vals5 = torch.cat([cnts, (rt & 0xFF)[:, None], ((rt >> 8) & 0xFF)[:, None]], dim=1)
    lib, table = index_add_call(ids, vals5, N_ROWS)
    row(f"index_add_ N={N3} rows={N_ROWS} P=5", TM.eager(lib, K))
    fused, split = stat_jobs(ids, cnts, rt)
    row(f"scatter_many N={N3} rows={N_ROWS} one job, 4 planes of 2 digits", TM.eager(lambda: FU.scatter_many(fused), K))
    row(f"scatter_many N={N3} rows={N_ROWS} counts (1 digit) + RT (2 digits)", TM.eager(lambda: FU.scatter_many(split), K))
    got = PK.probe_hist_stat5(ids, cnts, rt, N_ROWS, N_LO[0]).reshape(5, -1)[:, :N_ROWS]
    _same("stat landing vs index_add_", got.T, table[:N_ROWS])
    (f4,) = FU.scatter_many(fused)
    c3, r1 = FU.scatter_many(split)
    _same("stat landing vs scatter_many (counts)", got[:3].T, f4[:, :3])
    _same("stat landing vs scatter_many (RT)", got[3] + 256.0 * got[4], f4[:, 3])
    _same("stat landing vs split scatter_many (counts)", got[:3].T, c3)
    _same("stat landing vs split scatter_many (RT)", got[3] + 256.0 * got[4], r1[:, 0])
    return rows


def format_rows(rows) -> list:
    return [
        f"{r['name']:74s} device {r['device_ms']:.5f} ms, host {r['host_us']:.2f} us, wall {r['wall_ms']:.5f} ms"
        for r in rows
    ]


def main() -> None:
    TM.require_card()
    print(f"{TM.card_line()}; K = {K} launches a row; per launch; all sums equal")
    for line in format_rows(run()):
        print(line)


if __name__ == "__main__":
    main()
