"""Table primitives for the engine — the plain indexed branch.

The PyTorch counterpart of the ``use_mxu_tables=False`` branch of
``sentinel_tpu/ops/tables.py``.  The port has no one-hot table strategy:
on the card every table read is an indexed gather, and the effect
scatters ride the scatter kernel (ops/fused.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def big_gather(
    table: torch.Tensor, idx: torch.Tensor, n: int, max_int: Optional[int] = None
) -> torch.Tensor:
    """table[idx] with zeros for ids outside [0, n).

    ``max_int``: for NONNEGATIVE int tables, the largest cell value the
    caller vouches for.  The reference then reads base-256 digit planes, as
    many as ``max_int`` needs, so a larger cell reads modulo 256**digits;
    kept here so a caller that saturates first and one that does not both
    get what the reference gives."""
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
) -> torch.Tensor:
    """float32 [depth, N] = tab[d, cols[:, d]] for every depth at once,
    zeros for columns outside [0, width): ONE gather on the flat
    [depth * width] id space (column + d * width).  The sketch tier's read
    (the reference's ``depth_gather_1col``; its MXU branch is a one-hot
    contraction, this is the indexed gather).  ``max_int`` as in
    ``big_gather``: an int cell reads modulo the digit planes it needs."""
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
