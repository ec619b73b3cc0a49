"""Table primitives for the engine — the plain indexed branch.

The PyTorch counterpart of the ``use_mxu_tables=False`` branch of
``sentinel_tpu/ops/tables.py``.  The port has no one-hot table strategy:
on the card every table read is an indexed gather.  The fused path's
effect scatters ride the scatter kernel (ops/fused.py); the plain path's
(``fused_effects=False``, or no ``use_mxu_tables``) are the indexed
scatters here — ``index_add_`` and ``scatter_reduce_`` into a copy of the
table with one spare row that takes every dropped id, so the values stay
exact (integer payloads to 65,535 an item and beyond: the sums are int32).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sentinel_tpu_torch.parallel import collectives as CL


def _local_span(table_rows: int, n: int):
    """(shard ctx, lo) of a sharded call on a table of ``table_rows`` local
    rows over a global axis of ``n`` — (None, 0) off a shard."""
    ctx = CL.current()
    if ctx is None:
        return None, 0
    if table_rows * ctx.world != n:
        raise ValueError(f"a sharded table of {table_rows} rows a rank is not an axis of {n} over {ctx.world}")
    return ctx, table_rows * ctx.rank


def big_gather(
    table: torch.Tensor, idx: torch.Tensor, n: int, max_int: Optional[int] = None,
    sharded: bool = False,
) -> torch.Tensor:
    """table[idx] with zeros for ids outside [0, n).

    ``max_int``: for NONNEGATIVE int tables, the largest cell value the
    caller vouches for.  The reference then reads base-256 digit planes, as
    many as ``max_int`` needs, so a larger cell reads modulo 256**digits;
    kept here so a caller that saturates first and one that does not both
    get what the reference gives."""
    if sharded:
        ctx, lo = _local_span(table.shape[0], n)
        if ctx is not None:
            return CL.all_reduce(big_gather(table, idx - lo, table.shape[0], max_int))
    safe = torch.clamp(idx, 0, n - 1).to(torch.int64)
    out = table[safe]
    if max_int is not None and not table.dtype.is_floating_point and table.dtype != torch.bool:
        digits = max(1, (int(max_int).bit_length() + 7) // 8)
        if digits < 4:
            out = out & ((1 << (8 * digits)) - 1)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok.reshape(ok.shape + (1,) * (out.dim() - 1)), out, 0)


def depth_gather_1col(
    tab: torch.Tensor,  # [depth, width] — one table column per depth
    cols: torch.Tensor,  # int32 [N, depth]
    width: int,
    max_int: Optional[int] = None,
    sharded: bool = False,
) -> torch.Tensor:
    """float32 [depth, N] = tab[d, cols[:, d]] for every depth at once,
    zeros for columns outside [0, width): ONE gather on the flat
    [depth * width] id space (column + d * width).  The sketch tier's read
    (the reference's ``depth_gather_1col``; its MXU branch is a one-hot
    contraction, this is the indexed gather).  ``max_int`` as in
    ``big_gather``: an int cell reads modulo the digit planes it needs.
    ``sharded``: ``tab`` is the rank's width slice — the shard-local read
    plus one all-reduce of the [depth, N] result."""
    if sharded:
        ctx, lo = _local_span(tab.shape[1], width)
        if ctx is not None:
            # The flat [depth * width] read below would destroy the width
            # sharding: under the reference's mesh XLA all-gathers the full
            # [depth, width] slice of the salsa running sums before it
            # (sentinel_tpu/ops/tables.py:245-252, pinned there as 2 x
            # s32[2,512] a tick at the CI config, 2 x 512 KiB a device a tick
            # at the 1M tier, under an implicit-reshard rationale).  The port
            # takes the shard-local fix that comment names: each rank reads
            # its own width slice at the rebased columns (0 where another
            # rank holds the column) and ONE all-reduce sums the [depth, N]
            # result (pinned in analysis/spmd/collectives.json as f32[2, N]);
            # no all-gather passes through here, and a NEW one anywhere
            # fails the collective-ledger pass.
            return CL.all_reduce(depth_gather_1col(tab, cols - lo, tab.shape[1], max_int))
    depth = tab.shape[0]
    n = cols.shape[0]
    ok = (cols >= 0) & (cols < width)
    off = torch.arange(depth, dtype=torch.int64, device=cols.device)[None, :] * width
    flat_idx = (torch.where(ok, cols, 0).to(torch.int64) + off).T.reshape(-1)
    g = tab.reshape(depth * width)[flat_idx]
    if max_int is not None and not tab.dtype.is_floating_point:
        digits = max(1, (int(max_int).bit_length() + 7) // 8)
        if digits < 4:
            g = g & ((1 << (8 * digits)) - 1)
    return torch.where(ok.T.reshape(-1), g.to(torch.float32), 0.0).reshape(depth, n)


def lane_gather_1col(table: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 table[idx] for a ONE-COLUMN table, zeros for ids outside
    [0, n)."""
    ok = (idx >= 0) & (idx < n)
    safe = torch.clamp(idx, 0, n - 1).to(torch.int64)
    return torch.where(ok, table[safe].to(torch.float32), 0.0)


def lane_gather_1col_int(table: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``lane_gather_1col`` for small-int tables (slot ids, modes): the
    values are float32-exact (< 2^24), so a plain cast restores them."""
    return lane_gather_1col(table, idx, n).to(torch.int32)


def lane_gather_multi(
    tables: Sequence[torch.Tensor], idx: torch.Tensor, n: int
) -> list:
    """Up to four 1-column tables read at the same index: float32
    table[idx] per table, zeros for ids outside [0, n)."""
    assert 1 <= len(tables) <= 4
    ok = (idx >= 0) & (idx < n)
    safe = torch.clamp(idx, 0, n - 1).to(torch.int64)
    return [torch.where(ok, t[safe].to(torch.float32), 0.0) for t in tables]


def pack_fields(fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """[S, F] f32 matrix from per-slot field vectors (bool/int/float)."""
    return torch.stack([f.to(torch.float32) for f in fields], dim=1)


def small_gather_fields(packed: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[N, F] = packed[clip(slots)] — all of a slot's fields in one gather."""
    S = packed.shape[0]
    return packed[torch.clamp(slots, 0, S - 1).to(torch.int64)]


def small_gather_int(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Exact int gather from a small per-slot table (slots clipped)."""
    S = table.shape[0]
    return table[torch.clamp(slots, 0, S - 1).to(torch.int64)]


def small_scatter_or(
    table: torch.Tensor, slots: torch.Tensor, flag: torch.Tensor
) -> torch.Tensor:
    """Boolean OR-scatter into [S] (0/1 semantics); out-of-range slots drop."""
    S = table.shape[0]
    ok = (slots >= 0) & (slots < S)
    hist = torch.zeros((S + 1,), dtype=torch.int32, device=table.device)
    hist.index_add_(
        0, torch.where(ok, slots, S).to(torch.int64), flag.to(torch.int32)
    )
    return (table.to(torch.bool) | (hist[:S] > 0)).to(table.dtype)


# ---------------------------------------------------------------------------
# scatters (the plain effects path)
# ---------------------------------------------------------------------------


def _with_drop_row(table: torch.Tensor, idx: torch.Tensor, n: int):
    """(a copy of ``table`` with one spare row, the int64 row of every id:
    itself inside [0, n), the spare row outside)."""
    rows = table.shape[0]
    pad = torch.zeros((1,) + tuple(table.shape[1:]), dtype=table.dtype, device=table.device)
    ok = (idx >= 0) & (idx < n)
    return torch.cat([table, pad]), torch.where(ok, idx, rows).to(torch.int64)


def big_scatter_add(
    table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor, n: int,
    sharded: bool = False,
) -> torch.Tensor:
    """``table.at[idx].add(values)`` dropping ids outside [0, n): a fresh
    tensor, the caller's table is left as it was.  ``sharded``: ``table``
    is the rank's slice; only its own ids land."""
    if sharded:
        ctx, lo = _local_span(table.shape[0], n)
        if ctx is not None:
            idx, n = idx - lo, table.shape[0]
    out, rows = _with_drop_row(table, idx, n)
    out.index_add_(0, rows, values.to(table.dtype))
    return out[: table.shape[0]]


def histogram(idx: torch.Tensor, values: torch.Tensor, n: int, sharded: bool = False) -> torch.Tensor:
    """Dense [n, ...planes] sum of ``values`` grouped by id (ids outside
    [0, n) drop): float32 for float values, int32 otherwise.  ``sharded``:
    the rank's [n / world, ...] part of it, from its own ids only."""
    dt = torch.float32 if values.dtype.is_floating_point else torch.int32
    ctx = CL.current() if sharded else None
    rows = n if ctx is None else n // ctx.world
    zeros = torch.zeros((rows,) + tuple(values.shape[1:]), dtype=dt, device=values.device)
    return big_scatter_add(zeros, idx, values, n, sharded=sharded)


def small_scatter_add(
    table: torch.Tensor, slots: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``table [S, ...planes] .at[slots].add(values)``; out-of-range slots
    drop."""
    return big_scatter_add(table, slots, values, table.shape[0])


def small_scatter_max(
    table: torch.Tensor, slots: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``table [S]`` = elementwise max with the per-slot max of ``values``
    [N]; out-of-range slots drop, and a slot no value names keeps its
    entry (the table takes part in the max)."""
    out, rows = _with_drop_row(table, slots, table.shape[0])
    out.scatter_reduce_(0, rows, values.to(table.dtype), reduce="amax", include_self=True)
    return out[: table.shape[0]]
