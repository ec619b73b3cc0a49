"""Cluster token decision column — the token server's batched decision.

The port of ``sentinel_tpu/ops/token_col.py``.  Protocol v2 coalesces
BATCH frames from many connections into one decision batch
(cluster/token_service.TokenColumnBatcher); this module answers it: every
cluster flow owns one row ("slot") of a shared sliding-window state
(ops/window.py — the epoch-validated O(1) running sums of the engine
tier), and one call decides B entries against their per-flow global
thresholds with a refresh, a gather, a rebased prefix sum and a
scatter-add.

Within-batch ordering: entries arrive PRESORTED by slot (host presort,
native batch_sort3), and ``heads[i]`` is the index of the first entry of
entry *i*'s slot run.  An exclusive prefix sum of requested units,
rebased at each head, charges every entry with the units requested by
SAME-slot entries ahead of it in the batch — so one coalesced batch
admits exactly what sequential requests would have.  The prefix charges
*requested* (not granted) units: a denied all-or-nothing entry still
reserves its ask against later same-slot entries of the SAME batch (the
fail-closed direction, bounded by one batch).

Decision semantics per entry (the engine's ``used + units <= threshold``):

  all-or-nothing (partial=False): granted = units if avail >= units else 0
  partial-grant  (partial=True):  granted = clip(floor(avail), 0, units)
  forced         (forced=True):   granted = units unconditionally — the
      occupy-ahead emulation: a prioritized over-limit ask charges its
      units against the CURRENT bucket and the host answers SHOULD_WAIT
      with the time to the next bucket.

Granted units land in the window as EV_PASS, denied as EV_BLOCK, so the
window IS the budget ledger — replenishment is bucket expiry.  The
reference has no Pallas kernel here: this stays plain PyTorch on the
state's device, about ninety launches a call (the window refresh is half
of them), with no host sync inside (``now_ms`` is a host integer, as
everywhere in the port).  The prefix is
an int32 ``cumsum`` (``dtype=torch.int32``: torch's default for an int32
input is int64) over asks clipped at 2^20, so it cannot overflow at the
frame ceiling of 2,048 entries.

Slot-sharded (parallel/spmd.token_col_partition_specs, under a shard
context): the rank holds a slice of the slots' windows and limits; the
ledger and limit reads are the rank's own slots plus ONE all-reduce SUM of
both (float32 [2, B]: the other ranks add zeros, so the values are the
single-device ones), and the landing writes the rank's own slots.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.parallel import collectives as CL

#: decision window: DEFAULT_SAMPLE_COUNT buckets over one
#: DEFAULT_INTERVAL_MS accounting interval (cluster/constants.py values,
#: restated literally to keep ops/ free of cluster imports)
DEFAULT_CFG = W.WindowConfig(sample_count=10, window_ms=100)

#: ceiling on one entry's ask inside the prefix sum
UNIT_CLIP = 1 << 20


class TokenColState(NamedTuple):
    win: W.WindowState  # per-slot pass/block ledger
    limits: torch.Tensor  # float32 [slots] — global threshold per flow slot


def init_state(slots: int, device, cfg: W.WindowConfig = DEFAULT_CFG) -> TokenColState:
    return TokenColState(
        win=W.init_window(slots, cfg, device),
        limits=torch.zeros((slots,), dtype=torch.float32, device=device),
    )


def decide_batch(
    state: TokenColState,
    now_ms: int,  # host-stamped batch time
    slots: torch.Tensor,  # int32 [B] — flow slot per entry (slot-sorted)
    units: torch.Tensor,  # int32 [B] — requested units (0 = padding)
    heads: torch.Tensor,  # int32 [B] — index of entry's slot-run head
    partial: torch.Tensor,  # bool [B] — partial-grant vs all-or-nothing
    forced: torch.Tensor,  # bool [B] — unconditional charge (occupy-ahead)
    cfg: W.WindowConfig = DEFAULT_CFG,
) -> Tuple[torch.Tensor, torch.Tensor, TokenColState]:
    """(granted int32 [B], observed float32 [B], updated ledger state).

    ``observed`` is the window usage each entry was decided against (used +
    same-batch prefix) — the deny provenance the protocol v3 _T_PROV block
    ships back to clients.  The window's bucket column is updated in place
    (the state is consumed, as a tick consumes the engine state)."""
    # rotate once up front so the running sums are exact at this now_ms;
    # the ledger read is then a single [B] gather
    win = W.refresh(state.win, now_ms, cfg)
    if CL.current() is None:
        used = W.gather_window_event_run(win, slots, W.EV_PASS).to(torch.float32)
        limit = state.limits[slots.to(torch.int64)]
    else:
        r, held = W.shard_rows(win, slots)
        both = torch.stack([win.run[r, W.EV_PASS].to(torch.float32), state.limits[r]])
        used, limit = CL.all_reduce(torch.where(held, both, 0.0))
    units = torch.clamp_max(units, UNIT_CLIP)
    # exclusive prefix of requested units, rebased per slot run
    ex = torch.cumsum(units, 0, dtype=torch.int32) - units
    prefix = ex - ex[heads.to(torch.int64)]
    observed = used + prefix.to(torch.float32)
    avail = limit - observed
    units_f = units.to(torch.float32)
    grant_partial = torch.minimum(torch.clamp_min(torch.floor(avail), 0.0), units_f)
    grant_strict = torch.where(avail >= units_f, units_f, 0.0)
    granted = W.f32_to_i32(torch.where(partial, grant_partial, grant_strict))
    granted = torch.where(forced, units, granted)
    deltas = torch.zeros((slots.shape[0], W.NUM_EVENTS), dtype=torch.int32, device=slots.device)
    deltas[:, W.EV_PASS] = granted
    deltas[:, W.EV_BLOCK] = units - granted
    win = W.add_batch(win, now_ms, slots, deltas, cfg, refreshed=True)
    return granted, observed, TokenColState(win=win, limits=state.limits)


def ms_to_next_bucket(now_ms: int, cfg: W.WindowConfig = DEFAULT_CFG) -> int:
    """Host helper: ms until the next bucket boundary — the SHOULD_WAIT
    horizon for the occupy-ahead emulation.  Always in [1, window_ms]."""
    return int(cfg.window_ms - (now_ms % cfg.window_ms))


def set_limits(state: TokenColState, limits: torch.Tensor) -> TokenColState:
    """Replace the per-slot thresholds (rule push / census reprojection)
    without disturbing the standing window ledger."""
    return TokenColState(win=state.win, limits=limits.to(torch.float32))
