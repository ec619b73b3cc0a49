"""Table primitives for the engine — the plain indexed branch.

The PyTorch counterpart of the ``use_mxu_tables=False`` branch of
``sentinel_tpu/ops/tables.py``.  The port has no one-hot table strategy:
on the card every table read is an indexed gather, and the effect
scatters ride the scatter kernel (ops/fused.py).
"""

from __future__ import annotations

from typing import Sequence

import torch


def big_gather(table: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """table[idx] with zeros for ids outside [0, n)."""
    safe = torch.clamp(idx, 0, n - 1).to(torch.int64)
    out = table[safe]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok.reshape(ok.shape + (1,) * (out.dim() - 1)), out, 0)


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
