"""Vectorized sliding-window statistics — the LeapArray as tensors.

The PyTorch counterpart of ``sentinel_tpu/ops/window.py``.  The reference
keeps one lock-free ring of buckets per resource
(slots/statistic/base/LeapArray.java:41): the bucket index is
``(timeMs / windowLengthInMs) % sampleCount`` and a deprecated bucket is
reset lazily when next written.  Here ALL resources share one ring:

    counts : int32  [rows, nbp, NE]  (PASS, BLOCK, EXCEPTION, SUCCESS, OCCUPIED)
    rt_sum : float32[rows, nbp]
    rt_min : float32[rows, nbp]
    epochs : int32  [nbp]            window id held by each column

plus O(1) running window sums (``run``, ``run_rt``, ``run_rt_min``) kept
at write time and corrected at rotation (``rot_wid`` = wid of the last
batched expiry).  Reads of the ``*_run`` family are exact whenever a
refresh ran at the read's ``now_ms`` — the tick contract: completions
refresh before any check reads.

``now_ms`` is a host integer (the tick's timestamp).  Window ids and the
current column are therefore host integers too, so every column access is
plain slicing; the only device-side decisions (is the column fresh, is an
expiry due) are computed as masks and applied with ``torch.where`` — no
host sync.  The big bucket tensors are updated IN PLACE (one column per
write): this is the counterpart of the JAX tick's donated state and saves
a copy of the whole ring per tick.  The O(rows) running sums are replaced
by new tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Event enum — mirrors MetricEvent.java:21
EV_PASS = 0
EV_BLOCK = 1
EV_EXCEPTION = 2
EV_SUCCESS = 3
EV_OCCUPIED = 4
NUM_EVENTS = 5

#: rt_min initial value (statistic_max_rt, SentinelConfig.java:63)
RT_MIN_INIT = 5000.0

#: epoch of a column whose contents already left the running sums but whose
#: storage has not been zeroed yet
PURGED = -(1 << 30)


def i32(x: int) -> int:
    """A Python int wrapped to the int32 range (two's complement)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: out-of-range values saturate and
    NaN reads 0.  (torch's cast is the C++ one: the card's conversion
    instruction saturates, the CPU's gives -2^31 — so a value past
    2^31 - 1, such as latestPassedTime at the int32 clock wrap, would read
    differently on the two devices.)"""
    inside = torch.nan_to_num(x, nan=0.0).clamp_min(-float(2**31)).to(torch.int32)
    return torch.where(x >= float(2**31), 2**31 - 1, inside)


class WindowConfig(NamedTuple):
    sample_count: int  # number of logical buckets (nb)
    window_ms: int  # bucket length
    slack_frac: float = 0.0

    @property
    def interval_ms(self) -> int:
        return self.sample_count * self.window_ms

    @property
    def slack_buckets(self) -> int:
        import math

        if self.slack_frac <= 0.0:
            return 1
        return max(1, math.ceil(self.slack_frac * self.sample_count))

    @property
    def phys_buckets(self) -> int:
        return self.sample_count + self.slack_buckets - 1


class WindowState(NamedTuple):
    counts: torch.Tensor  # int32 [rows, nbp, NUM_EVENTS]
    rt_sum: torch.Tensor  # float32 [rows, nbp]
    rt_min: torch.Tensor  # float32 [rows, nbp]
    epochs: torch.Tensor  # int32 [nbp]
    run: torch.Tensor  # int32 [rows, NUM_EVENTS]
    run_rt: torch.Tensor  # float32 [rows]
    run_rt_min: torch.Tensor  # float32 [rows]
    rot_wid: torch.Tensor  # int32 []


def init_window(rows: int, cfg: WindowConfig, device) -> WindowState:
    nbp = cfg.phys_buckets
    i32_, f32 = torch.int32, torch.float32
    return WindowState(
        counts=torch.zeros((rows, nbp, NUM_EVENTS), dtype=i32_, device=device),
        rt_sum=torch.zeros((rows, nbp), dtype=f32, device=device),
        rt_min=torch.full((rows, nbp), RT_MIN_INIT, dtype=f32, device=device),
        epochs=torch.full((nbp,), -(cfg.sample_count + 1), dtype=i32_, device=device),
        run=torch.zeros((rows, NUM_EVENTS), dtype=i32_, device=device),
        run_rt=torch.zeros((rows,), dtype=f32, device=device),
        run_rt_min=torch.full((rows,), RT_MIN_INIT, dtype=f32, device=device),
        rot_wid=torch.tensor(-(cfg.sample_count + 1), dtype=i32_, device=device),
    )


def wid_of(now_ms: int, window_ms: int) -> int:
    """Window id of an engine-ms timestamp: ``now_ms`` read as UNSIGNED
    32-bit (continuous across the int32 clock wrap), result as int32."""
    return i32((int(now_ms) & 0xFFFFFFFF) // int(window_ms))


def current_index(now_ms: int, cfg: WindowConfig) -> int:
    return ((int(now_ms) & 0xFFFFFFFF) // cfg.window_ms) % cfg.phys_buckets


def refresh(state: WindowState, now_ms: int, cfg: WindowConfig) -> WindowState:
    """Rotate: batched expiry of the running sums + lazy reset of the
    current column (LeapArray.java:149-248 for all rows at once).

    The JAX reference gates the expiry reduction with ``lax.cond``; here
    both branches are computed and selected with ``torch.where`` so the
    host never waits on the device to learn whether an expiry is due."""
    nb = cfg.sample_count
    nbp = cfg.phys_buckets
    g = cfg.slack_buckets
    wid = wid_of(now_ms, cfg.window_ms)
    idx = current_index(now_ms, cfg)
    epochs = state.epochs

    cur_epoch = epochs[idx]
    fresh = cur_epoch == wid
    cur_unpurged = ~fresh & (cur_epoch != PURGED)
    due = ((wid - state.rot_wid) >= g) | cur_unpurged

    cur_onehot = torch.arange(nbp, device=epochs.device) == idx
    age = wid - epochs
    unpurged = epochs != PURGED
    live = (age >= 0) & (age < nb) & unpurged
    doomed = (~live | (cur_onehot & ~fresh)) & unpurged
    gone = torch.sum(
        state.counts * doomed.to(torch.int32)[None, :, None], dim=1, dtype=torch.int32
    )
    gone_rt = torch.sum(state.rt_sum * doomed.to(torch.float32)[None, :], dim=1)
    survivors = live & ~doomed
    new_min = torch.amin(
        torch.where(survivors[None, :], state.rt_min, RT_MIN_INIT), dim=1
    )
    run = torch.where(due, state.run - gone, state.run)
    run_rt = torch.where(due, state.run_rt - gone_rt, state.run_rt)
    run_rt_min = torch.where(due, new_min, state.run_rt_min)
    # reuse keeps epoch == wid, reset stamps it — identical either way.
    # (A masked select, not ``epochs[idx] = wid``: writing a host scalar
    # into a CUDA tensor is a synchronizing copy.)
    epochs = torch.where(cur_onehot, wid, torch.where(due & doomed, PURGED, epochs))
    rot_wid = torch.where(due, wid, state.rot_wid).to(torch.int32)

    # lazy reset of the cursor's column, in place
    state.counts[:, idx, :] *= fresh.to(torch.int32)
    state.rt_sum[:, idx] *= fresh.to(torch.float32)
    state.rt_min[:, idx] = torch.where(fresh, state.rt_min[:, idx], RT_MIN_INIT)
    return state._replace(
        epochs=epochs,
        run=run,
        run_rt=run_rt,
        run_rt_min=run_rt_min,
        rot_wid=rot_wid,
    )


def add_batch(
    state: WindowState,
    now_ms: int,
    rows: torch.Tensor,  # int32 [B] — row per event
    deltas: torch.Tensor,  # int32 [B, NUM_EVENTS]
    cfg: WindowConfig,
    refreshed: bool = False,
) -> WindowState:
    """Scatter a micro-batch of event counts into the current bucket
    column (the token column's landing).

    Duplicate rows accumulate (the batched LongAdder.add on the current
    WindowWrap); every delta also lands in the running sums.  Rows outside
    ``[0, rows)`` are dropped, as the reference's ``mode="drop"`` scatters
    drop them (an out-of-range index would be a device-side assert on the
    card).  The reference's RT operand (its plain engine path, ROADMAP.md
    item A8) is not ported.  The bucket column is updated in place, the
    running sums are new tensors.  ``refreshed=True`` skips the refresh:
    the caller already refreshed at this ``now_ms`` (a second refresh there
    changes nothing)."""
    if not refreshed:
        state = refresh(state, now_ms, cfg)
    idx = current_index(now_ms, cfg)
    keep = (rows >= 0) & (rows < state.run.shape[0])
    r = torch.where(keep, rows, 0).to(torch.int64)
    d = torch.where(keep[:, None], deltas.to(state.counts.dtype), 0)
    state.counts[:, idx, :].index_add_(0, r, d)
    return state._replace(run=state.run.index_add(0, r, d))


def add_dense(
    state: WindowState,
    now_ms: int,
    count_hist: torch.Tensor,  # int32 [rows, NUM_EVENTS] — dense per-row deltas
    rt_hist: Optional[torch.Tensor],  # float32 [rows] or None
    cfg: WindowConfig,
    row_min=None,  # optional (mins f32 [rows], present bool [rows])
    refreshed: bool = False,
) -> WindowState:
    """Land a dense per-row delta in the current bucket column (in place)
    and in the running sums.  ``refreshed=True`` skips the refresh: the
    caller already refreshed at this ``now_ms`` (a second refresh at the
    same ``now_ms`` changes nothing, and at full width its expiry pass
    reads the whole ring)."""
    if not refreshed:
        state = refresh(state, now_ms, cfg)
    idx = current_index(now_ms, cfg)
    ch = count_hist.to(state.counts.dtype)
    state.counts[:, idx, :] += ch
    run = state.run + ch
    run_rt = state.run_rt
    if rt_hist is not None:
        state.rt_sum[:, idx] += rt_hist
        run_rt = state.run_rt + rt_hist
    run_rt_min = state.run_rt_min
    if row_min is not None:
        mins, present = row_min
        filled = torch.where(present, mins, RT_MIN_INIT)
        state.rt_min[:, idx] = torch.minimum(state.rt_min[:, idx], filled)
        run_rt_min = torch.minimum(run_rt_min, filled)
    return state._replace(run=run, run_rt=run_rt, run_rt_min=run_rt_min)


def min_into_row(
    state: WindowState, now_ms: int, row: int, value: torch.Tensor, cfg: WindowConfig
) -> WindowState:
    """Scatter-min a scalar into ONE fixed row's current bucket (in place)."""
    idx = current_index(now_ms, cfg)
    state.rt_min[row, idx] = torch.minimum(state.rt_min[row, idx], value)
    run_rt_min = state.run_rt_min.clone()
    run_rt_min[row] = torch.minimum(run_rt_min[row], value)
    return state._replace(run_rt_min=run_rt_min)


def valid_mask(state: WindowState, now_ms: int, cfg: WindowConfig) -> torch.Tensor:
    """bool [nbp] — which columns fall inside [now - interval, now]."""
    age = wid_of(now_ms, cfg.window_ms) - state.epochs
    return (age >= 0) & (age < cfg.sample_count) & (state.epochs != PURGED)


def window_counts(state: WindowState, now_ms: int, cfg: WindowConfig) -> torch.Tensor:
    """int32 [rows, NUM_EVENTS] — exact masked sum over valid buckets."""
    mask = valid_mask(state, now_ms, cfg).to(torch.int32)
    return torch.sum(state.counts * mask[None, :, None], dim=1, dtype=torch.int32)


def window_rt(state: WindowState, now_ms: int, cfg: WindowConfig):
    """(rt_total f32 [rows], rt_min f32 [rows]) over valid buckets."""
    mask = valid_mask(state, now_ms, cfg)
    rt_total = torch.sum(state.rt_sum * mask.to(torch.float32)[None, :], dim=1)
    rt_min = torch.amin(torch.where(mask[None, :], state.rt_min, RT_MIN_INIT), dim=1)
    return rt_total, rt_min


def gather_window_counts(
    state: WindowState, now_ms: int, rows: torch.Tensor, cfg: WindowConfig
) -> torch.Tensor:
    """int32 [B, NUM_EVENTS] — the exact masked windowed totals of the
    selected rows only (a [B, nbp, NE] gather + reduction)."""
    mask = valid_mask(state, now_ms, cfg).to(torch.int32)
    vals = state.counts[rows.to(torch.int64)]  # [B, nbp, NE]
    return torch.sum(vals * mask[None, :, None], dim=1, dtype=torch.int32)


def gather_window_rt(state: WindowState, now_ms: int, rows: torch.Tensor, cfg: WindowConfig):
    """(rt_total f32 [B], rt_min f32 [B]) for the selected rows."""
    mask = valid_mask(state, now_ms, cfg)
    r = rows.to(torch.int64)
    rt_total = torch.sum(state.rt_sum[r] * mask.to(torch.float32)[None, :], dim=1)
    rt_min = torch.amin(torch.where(mask[None, :], state.rt_min[r], RT_MIN_INIT), dim=1)
    return rt_total, rt_min


# -- O(1) running-sum reads (the tick hot path) ------------------------------


def window_counts_run(state: WindowState) -> torch.Tensor:
    return state.run


def window_event_run(state: WindowState, event: int) -> torch.Tensor:
    return state.run[:, event]


def gather_window_event_run(state: WindowState, rows: torch.Tensor, event: int) -> torch.Tensor:
    """int32 [B] — one event's windowed totals at ``rows``: a single gather
    from the running sums."""
    return state.run[rows.to(torch.int64), event]
