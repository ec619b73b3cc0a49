"""Exact per-row minimum through a sum-scatter — the windowed minRt plane.

The PyTorch counterpart of ``sentinel_tpu/ops/rowmin.py``.  A scatter-MIN
cannot ride the scatter kernel (it only sums), so duplicates are reduced
BEFORE scattering:

  1. one sort on the composite key ``(row << 32) | value_bits`` —
     positive-float bit patterns are order-preserving, so after the sort
     each row's FIRST item holds that row's minimum;
  2. segment heads (row != previous row) are unique per row, so a
     sum-scatter of the head values IS the per-row min.  The value rides
     as two 16-bit halves plus a presence flag.

Bit-exact with a scatter-min for positive values (absent/invalid values
drop; rows with no item report absent).  The arithmetic stays in int64
and masks to 32 bits: torch has no uint32 shift on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: int32 bit pattern above any valid positive float's bits
_ABSENT = 0x7F000000


def min_heads(
    rows: torch.Tensor,  # int32 [N] — target row per item (out-of-range drops)
    values: torch.Tensor,  # float32 [N] — POSITIVE values (rt ms)
    valid: torch.Tensor,  # bool [N]
    n_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(head_rows int32 [N], head_vals int32 [N, 3]) — per row at most ONE
    item survives (its min), as (bits >> 16, bits & 0xFFFF, 1); every
    other item carries row -1."""
    ok = valid & (rows >= 0) & (rows < n_rows) & (values > 0)
    key = torch.where(ok, rows, n_rows).to(torch.int64)
    bits = torch.where(ok, values.view(torch.int32), _ABSENT).to(torch.int64)
    # both halves are nonnegative: one int64 sort orders (row, bits)
    sk64, _ = torch.sort((key << 32) | bits)
    sk = sk64 >> 32
    sv = sk64 & 0xFFFFFFFF
    first = torch.ones((1,), dtype=torch.bool, device=rows.device)
    head = torch.cat([first, sk[1:] != sk[:-1]]) & (sk < n_rows)
    u = torch.where(head, sv, 0)
    hvals = torch.stack([u >> 16, u & 0xFFFF, head.to(torch.int64)], dim=1)
    return torch.where(head, sk, -1).to(torch.int32), hvals.to(torch.int32)


def combine(hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mins f32 [n], present bool [n]) from the landed [n, 3] head sums."""
    h = torch.round(hist).to(torch.int64)
    present = h[:, 2] > 0
    bits = (((h[:, 0] & 0xFFFFFFFF) << 16) | (h[:, 1] & 0xFFFFFFFF)) & 0xFFFFFFFF
    bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits).to(torch.int32)
    return bits.view(torch.float32), present
