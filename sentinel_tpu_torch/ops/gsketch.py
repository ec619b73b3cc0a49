"""Global per-resource statistics sketch — observability beyond capacity.

PyTorch counterpart of ``sentinel_tpu/ops/gsketch.py``, the seed tier
behind ``sketch_salsa=False`` (the default tier is ``sketch/salsa.py``).
The exact per-row windows are kept small (ruled + hot resources); the
long tail of resources lives in a windowed count-min sketch:

    counts : int32 [nbp, depth, width, PLANES]
    epochs : int32 [nbp]

Each tick adds every valid event (pass/block on acquire; success /
exception / rt on completion) into the current time bucket at the
resource's hashed column per depth (ops/param.cms_cell).  Reads take the
min over depth of the windowed column sums: a count-min overestimate with
eps = e/width, delta = e^-depth.  The bucket arithmetic is ops/window.py's:
``now_ms`` is read as UNSIGNED 32-bit (in Python ints, masked), so the
window id stays continuous across the int32 clock wrap, and the ring
carries ``slack_buckets - 1`` extra physical columns so it shares the
salsa tier's cursor arithmetic.

``now_ms`` is a host integer, as everywhere in the port; the current
bucket's column is a host index, and its update is in place (the tick
consumes its state).  The reference's MXU one-hot reads
(``estimate_plane_mxu`` through ``tables.depth_gather_1col``) are indexed
gathers here; the name is kept so readers find it.

Plane layout: [EV_PASS, EV_BLOCK, EV_EXCEPTION, EV_SUCCESS, EV_OCCUPIED,
RT_Q] — the window event enum plus quantized RT (1/8 ms units).

Width-sharded (parallel/spmd.py, under a shard context): ``counts`` is the
rank's slice of the width axis; columns stay global.  The refresh and the
landing are local, a histogram lands the rank's own columns, and a read
gathers the rank's own columns and all-reduces the SUM (one rank holds
each column; the min over depth comes after).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from sentinel_tpu_torch.obs import profile as PROF
from sentinel_tpu_torch.ops import tables as T
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops.param import cms_cell
from sentinel_tpu_torch.parallel import collectives as CL

PLANES = W.NUM_EVENTS + 1  # + quantized RT sum
RT_PLANE = W.NUM_EVENTS
RT_SCALE = 8.0  # 1/8 ms resolution

I32 = torch.int32
#: the enforcement read caps the windowed estimate here (exact in float32)
EST_CAP = (1 << 24) - 1


class SketchConfig(NamedTuple):
    sample_count: int
    window_ms: int
    depth: int
    width: int
    # slack fraction (arXiv 1703.01166) — consumed by the salsa tier's
    # batched expiry; see ops/window.WindowConfig.slack_frac
    slack_frac: float = 0.0

    @property
    def interval_ms(self) -> int:
        return self.sample_count * self.window_ms

    @property
    def slack_buckets(self) -> int:
        """Buckets between batched expiries (g) — 1 means no slack."""
        if self.slack_frac <= 0.0:
            return 1
        return max(1, math.ceil(self.slack_frac * self.sample_count))

    @property
    def phys_buckets(self) -> int:
        """Physical ring columns (nb + g - 1)."""
        return self.sample_count + self.slack_buckets - 1


class SketchState(NamedTuple):
    counts: torch.Tensor  # int32 [nbp, depth, width, PLANES]
    epochs: torch.Tensor  # int32 [nbp]


def init_sketch(cfg: SketchConfig, device) -> SketchState:
    nbp = cfg.phys_buckets
    state = SketchState(
        counts=torch.zeros((nbp, cfg.depth, cfg.width, PLANES), dtype=I32, device=device),
        epochs=torch.full((nbp,), -(cfg.sample_count + 1), dtype=I32, device=device),
    )
    # memory ledger (obs/profile.py): the count-min tier under the same
    # "sketch" pool the salsa tier reports to
    PROF.LEDGER.track("sketch", "gsketch.init_sketch", state)
    return state


def _wid(now_ms: int, cfg: SketchConfig) -> int:
    """Window id of ``now_ms`` read as uint32, as an int32 (ops/window)."""
    return W.wid_of(now_ms, cfg.window_ms)


def _index(now_ms: int, cfg: SketchConfig) -> int:
    return ((int(now_ms) & 0xFFFFFFFF) // cfg.window_ms) % cfg.phys_buckets


def _valid(epochs: torch.Tensor, wid: int, cfg: SketchConfig) -> torch.Tensor:
    """bool [nbp] — wraparound-safe modular window membership (int32
    arithmetic, wrapping as the reference's)."""
    age = wid - epochs
    return (age >= 0) & (age < cfg.sample_count)


def refresh(state: SketchState, now_ms: int, cfg: SketchConfig) -> SketchState:
    """Zero the current column if it belongs to an older window (in place)
    and stamp its epoch."""
    wid = _wid(now_ms, cfg)
    idx = _index(now_ms, cfg)
    keep = (state.epochs[idx] == wid).to(I32)
    state.counts[idx] *= keep
    # a masked select, not ``epochs[idx] = wid`` (a host scalar written into
    # a CUDA tensor is a synchronizing copy)
    cur = torch.arange(cfg.phys_buckets, device=state.epochs.device) == idx
    return state._replace(epochs=torch.where(cur, wid, state.epochs).to(I32))


def depth_histogram(
    cols: torch.Tensor,  # int32 [N, depth]
    values: torch.Tensor,  # int32 [N, P]
    valid: torch.Tensor,  # bool [N]
    depth: int,
    width: int,
    sharded: bool = False,
) -> torch.Tensor:
    """Dense int32 [depth, width, P] histogram of a CMS batch: every valid
    event lands its value row at one column per depth (the reference's
    ``tables.depth_histogram``, its native branch).  ``sharded``: the
    rank's [depth, width / world, P] slice, from its own columns only."""
    ctx = CL.current() if sharded else None
    if ctx is not None:
        lo, hi = ctx.span(width)
        cols, width = cols - lo, hi - lo
    n, p = values.shape
    ok = valid[:, None] & (cols >= 0) & (cols < width)
    off = torch.arange(depth, dtype=I32, device=cols.device)[None, :] * width
    flat = torch.where(ok, cols + off, depth * width).T.reshape(-1).to(torch.int64)
    vals = torch.where(ok.T.reshape(-1)[:, None], values.to(I32).repeat(depth, 1), 0)
    hist = torch.zeros((depth * width + 1, p), dtype=I32, device=cols.device)
    hist.index_add_(0, flat, vals)
    return hist[: depth * width].reshape(depth, width, p)


def add(
    state: SketchState,
    now_ms: int,
    res: torch.Tensor,  # int32 [N] resource ids (any id space)
    values: torch.Tensor,  # int32 [N, len(plane_idx)] deltas for the named planes
    plane_idx: Tuple[int, ...],
    valid: torch.Tensor,  # bool [N]
    cfg: SketchConfig,
    pre_refreshed: bool = False,
) -> SketchState:
    """Batched event ingest into the named planes.  ``pre_refreshed``: the
    caller already refreshed at this ``now_ms`` (the tick lands completions
    before acquires)."""
    if not pre_refreshed:
        state = refresh(state, now_ms, cfg)
    cols = cms_cell(res, cfg.depth, cfg.width)
    upd = depth_histogram(cols, values, valid, cfg.depth, cfg.width, sharded=True)
    return add_dense(state, now_ms, upd, plane_idx, cfg, pre_refreshed=True)


def add_dense(
    state: SketchState,
    now_ms: int,
    upd: torch.Tensor,  # int32 [depth, width, len(plane_idx)] — precomputed histogram
    plane_idx: Tuple[int, ...],
    cfg: SketchConfig,
    pre_refreshed: bool = False,
) -> SketchState:
    """Land a precomputed per-cell delta (the scatter kernel's ``sketch{d}``
    jobs) into the current bucket, in place."""
    if not pre_refreshed:
        state = refresh(state, now_ms, cfg)
    idx = _index(now_ms, cfg)
    for i, p in enumerate(plane_idx):  # host indices: an index list would be uploaded
        state.counts[idx, :, :, p] += upd[:, :, i].to(I32)
    return state


def estimate_plane_mxu(
    state: SketchState, now_ms: int, res: torch.Tensor, plane: int, cfg: SketchConfig, cols=None
) -> torch.Tensor:
    """float32 [N]: the windowed min-over-depth estimate of ONE plane, the
    enforcement read (the reference's MXU variant; here one indexed gather
    of every depth's cell, then the min over depth).  Cells read capped at
    2^24 - 1.  ``cols``: ``res``'s hashed columns, where the caller has
    them."""
    valid = _valid(state.epochs, _wid(now_ms, cfg), cfg)
    windowed = torch.sum(
        state.counts[:, :, :, plane] * valid.to(I32)[:, None, None], dim=0, dtype=I32
    )  # [depth, width]
    if cols is None:
        cols = cms_cell(res, cfg.depth, cfg.width)
    g = T.depth_gather_1col(
        torch.clamp_max(windowed, EST_CAP), cols, cfg.width, max_int=EST_CAP, sharded=True
    )
    return torch.amin(g, dim=0)


def estimate(state: SketchState, now_ms: int, res: torch.Tensor, cfg: SketchConfig) -> torch.Tensor:
    """int32 [N, PLANES]: windowed min-over-depth estimates per resource."""
    valid = _valid(state.epochs, _wid(now_ms, cfg), cfg)
    windowed = torch.sum(
        state.counts * valid.to(I32)[:, None, None, None], dim=0, dtype=I32
    )  # [depth, width, PLANES]
    cols = cms_cell(res, cfg.depth, cfg.width)
    if CL.current() is not None:
        return torch.amin(sharded_depth_read(windowed, cols, cfg.width, col_axis=1), dim=0)
    cols = cols.to(torch.int64)
    per_depth = torch.stack([windowed[d][cols[:, d]] for d in range(cfg.depth)])
    return torch.amin(per_depth, dim=0)


def sharded_depth_read(tab: torch.Tensor, cols: torch.Tensor, width: int, col_axis: int) -> torch.Tensor:
    """[depth, N, ...]: each depth's cell of the rank's width slice ``tab``
    (its column axis at ``col_axis``, counting the depth axis) at the
    global ``cols`` [N, depth], zeros where another rank holds the
    column, then one all-reduce SUM."""
    lo, hi = CL.current().span(width)
    loc = cols - lo
    held = (loc >= 0) & (loc < hi - lo)
    c = torch.clamp(loc, 0, hi - lo - 1).to(torch.int64)
    out = torch.stack([
        tab[d].index_select(col_axis - 1, c[:, d]).movedim(col_axis - 1, 0) for d in range(tab.shape[0])
    ])
    mask = held.T.reshape(held.shape[1], held.shape[0], *([1] * (out.dim() - 2)))
    return CL.all_reduce(torch.where(mask, out, 0))
