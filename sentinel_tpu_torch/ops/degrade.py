"""Circuit breakers as a vectorized state machine.

The PyTorch counterpart of ``sentinel_tpu/ops/degrade.py``
(AbstractCircuitBreaker.java:33-136 per DegradeRule, one row each):

    cb_state    : int32 [D+1]          (0 CLOSED, 1 OPEN, 2 HALF_OPEN)
    cb_retry_ms : int32 [D+1]          next-probe deadline for OPEN rules
    cb_counts   : int32 [D+1, nb, 3]   (TOTAL, ERROR, SLOW) ring buckets
    cb_epochs   : int32 [D+1, nb]      per-rule epochs (per-rule bucket ms)
"""

from __future__ import annotations

from typing import Tuple

import torch

CB_CLOSED = 0
CB_OPEN = 1
CB_HALF_OPEN = 2

CBE_TOTAL = 0
CBE_ERROR = 1
CBE_SLOW = 2

# DegradeRule grades (RuleConstant)
GRADE_SLOW_RATIO = 0
GRADE_ERROR_RATIO = 1
GRADE_ERROR_COUNT = 2


def _wid(window_ms: torch.Tensor, now_ms: int) -> torch.Tensor:
    """Per-rule bucket id: floor(now / window) in int32 (floor division,
    as jnp's ``//``, also for a negative clock)."""
    wms = torch.clamp_min(window_ms, 1)
    return torch.div(torch.full_like(wms, now_ms), wms, rounding_mode="floor")


def refresh_columns(
    counts: torch.Tensor,  # int32 [D+1, nb, 3]
    epochs: torch.Tensor,  # int32 [D+1, nb]
    window_ms: torch.Tensor,  # int32 [D+1]
    now_ms: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero each rule's current bucket if stale. Returns (counts, epochs, cur_idx)."""
    nb = counts.shape[1]
    wid = _wid(window_ms, now_ms)
    idx = torch.remainder(wid, nb)
    # an explicit compare: F.one_hot may range-check its input on the host
    onehot = (idx[:, None] == torch.arange(nb, device=idx.device)).to(torch.int32)
    cur_epoch = torch.sum(epochs * onehot, dim=1, dtype=torch.int32)
    stale = (cur_epoch != wid).to(torch.int32)
    keep = 1 - onehot * stale[:, None]
    counts = counts * keep[:, :, None]
    epochs = torch.where((onehot == 1) & (stale[:, None] == 1), wid[:, None], epochs)
    return counts, epochs, idx


def window_sums(
    counts: torch.Tensor, epochs: torch.Tensor, window_ms: torch.Tensor, now_ms: int
) -> torch.Tensor:
    """int32 [D+1, 3] — windowed totals per rule."""
    nb = counts.shape[1]
    wid = _wid(window_ms, now_ms)
    valid = (epochs > (wid[:, None] - nb)) & (epochs <= wid[:, None])
    return torch.sum(counts * valid[:, :, None], dim=1, dtype=torch.int32)


def trip_condition(
    sums: torch.Tensor,  # int32 [D+1, 3]
    grade: torch.Tensor,  # int32 [D+1]
    count: torch.Tensor,  # float32 [D+1]
    slow_ratio: torch.Tensor,  # float32 [D+1]
    min_request: torch.Tensor,  # int32 [D+1]
) -> torch.Tensor:
    """bool [D+1] — should a CLOSED breaker trip OPEN now?"""
    total = sums[:, CBE_TOTAL].to(torch.float32)
    err = sums[:, CBE_ERROR].to(torch.float32)
    slow = sums[:, CBE_SLOW].to(torch.float32)
    enough = total >= min_request.to(torch.float32)
    safe_total = torch.clamp_min(total, 1.0)
    trip_slow = (grade == GRADE_SLOW_RATIO) & enough & (slow / safe_total > slow_ratio)
    trip_eratio = (grade == GRADE_ERROR_RATIO) & enough & (err / safe_total > count)
    trip_ecount = (grade == GRADE_ERROR_COUNT) & enough & (err >= count)
    return trip_slow | trip_eratio | trip_ecount
