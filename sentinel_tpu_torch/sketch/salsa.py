"""SALSA-style self-adjusting windowed count-min sketch — the sketch tier's
default storage.

PyTorch counterpart of ``sentinel_tpu/sketch/salsa.py``; the layout, the
arithmetic and the names are the reference's.

STORAGE — self-adjusting counters (arXiv 2102.12531): logical columns
start as int8 cells, FOUR packed into each int32 word.  When a cell
saturates its width, the word's cells merge with their neighbours (sums:
the count-min overestimate direction) and the word re-packs one level
wider:

    level 0   4 x int8   (cell cap 255)
    level 1   2 x int16  (cell cap 65535) — lanes {0,1} / {2,3} merge
    level 2   1 x int32  (clamped, see _cap2) — all four lanes merge

A per-word 2-bit level rides a packed width bitmap (16 words per int32).
The CURRENT bucket accumulates unpacked in ``cur``; the packing runs once
per bucket, when ``refresh`` lands the finished ``cur`` into its ring
column.  ``run`` holds the decoded window total per logical column,
maintained incrementally (arXiv 1604.02450): adds land their delta, and
expired buckets subtract their decoded contents exactly once, at a batched
rotation every ``slack_buckets`` buckets (arXiv 1703.01166).  Every
estimate is >= the true windowed count, so tail-rule enforcement built on
it fails CLOSED.

Device-side branches: the reference's ``refresh`` runs the expiry and the
landing under two ``lax.cond``s on device state (the bucket id moved, an
expiry is due).  Here both sides of each are computed and selected with
``torch.where`` — no host sync — and only the landed ring column is
written, in place, at a DEVICE index (``index_copy_``), never at a Python
index read back from the card.  The ring tensors (``words``, ``lvlmap``)
are updated in place, like the engine's window rings: a refresh consumes
the state it is given.

Width-sharded (parallel/spmd.py, under a shard context): ``words``,
``lvlmap``, ``run`` and ``cur`` are the rank's slices of their width axes
(each word's four cells and each bitmap int32's sixteen words stay on one
rank), so the refresh, the packing and the landing are local.  The read
(``estimate_plane_mxu``) is the shard-local fix the reference's own
comment names for its one implicit reshard (``sentinel_tpu/ops/
tables.py:245-252``): a partial gather of the rank's own columns plus an
all-reduce of the [depth, N] result, instead of an all-gather of the
[depth, width] running sums before the gather.

Integer arithmetic is int32 and wraps as the reference's: shifts of packed
words are arithmetic on int32 in both frameworks, and every lane read is
masked (``& 0xFF``, ``& 0xFFFF``) in the reference's order.  ``now_ms``
is a host integer; window ids read it as unsigned 32-bit (ops/gsketch).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sentinel_tpu_torch.obs import profile as PROF
from sentinel_tpu_torch.ops import tables as T
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops.gsketch import (
    EST_CAP,
    PLANES,
    RT_PLANE,  # noqa: F401  (re-exported, as the reference's module does)
    RT_SCALE,  # noqa: F401
    SketchConfig,
    _wid,
    depth_histogram,
)
from sentinel_tpu_torch.ops.param import cms_cell
from sentinel_tpu_torch.parallel import collectives as CL

I32 = torch.int32

#: words per packed int32 of the width bitmap (2 bits per word level)
_BMP = 16


def _cap2(cfg: SketchConfig) -> int:
    """Level-2 cell clamp: ``run`` sums at most phys_buckets decoded
    buckets, each cell <= cap2, so the running sums cannot wrap."""
    return ((1 << 31) - 1) // max(cfg.phys_buckets, 2)


class SalsaState(NamedTuple):
    words: torch.Tensor  # int32 [nbp, depth, PLANES, Wp]  packed counter words
    lvlmap: torch.Tensor  # int32 [nbp, depth, PLANES, Wp // 16]  2-bit width bitmap
    run: torch.Tensor  # int32 [depth, PLANES, W]  O(1) running window sums
    epochs: torch.Tensor  # int32 [nbp]  window id per bucket column
    rot_wid: torch.Tensor  # int32 []  wid of the last batched expiry
    cur: torch.Tensor  # int32 [depth, PLANES, W]  UNPACKED current bucket
    cur_wid: torch.Tensor  # int32 []  wid the cur buffer belongs to


def _wp(cfg: SketchConfig) -> int:
    if cfg.width % (4 * _BMP):
        raise ValueError(
            f"salsa sketch width must be a multiple of {4 * _BMP} "
            f"(4 int8 lanes/word, {_BMP} words/bitmap-int32); got {cfg.width}"
        )
    return cfg.width // 4


def init_sketch(cfg: SketchConfig, device) -> SalsaState:
    wp = _wp(cfg)
    nbp = cfg.phys_buckets
    empty = -(cfg.sample_count + 1)
    state = SalsaState(
        words=torch.zeros((nbp, cfg.depth, PLANES, wp), dtype=I32, device=device),
        lvlmap=torch.zeros((nbp, cfg.depth, PLANES, wp // _BMP), dtype=I32, device=device),
        run=torch.zeros((cfg.depth, PLANES, cfg.width), dtype=I32, device=device),
        epochs=torch.full((nbp,), empty, dtype=I32, device=device),
        rot_wid=torch.full((), empty, dtype=I32, device=device),
        cur=torch.zeros((cfg.depth, PLANES, cfg.width), dtype=I32, device=device),
        cur_wid=torch.full((), empty, dtype=I32, device=device),
    )
    # memory ledger (obs/profile.py): the measured live counterpart of the
    # static hbm_bytes(cfg) claim — the two must agree within 10%
    PROF.LEDGER.track("sketch", "salsa.init_sketch", state)
    return state


def _index_of(wid: torch.Tensor, cfg: SketchConfig) -> torch.Tensor:
    """Ring column of a window id (an int32 device tensor), read as uint32:
    an int64 0-d device tensor."""
    return (wid.to(torch.int64) & 0xFFFFFFFF) % cfg.phys_buckets


#: shift amounts by (step, lanes, device), made once (an arange on the
#: device, no upload)
_SHIFTS: dict = {}


def _shifts(step: int, n: int, device) -> torch.Tensor:
    key = (step, n, device)
    s = _SHIFTS.get(key)
    if s is None:
        s = _SHIFTS[key] = torch.arange(0, step * n, step, dtype=I32, device=device)
    return s


# -- width bitmap ------------------------------------------------------------


def pack_levels(lvl: torch.Tensor) -> torch.Tensor:
    """int32 levels [..., Wp] in {0,1,2} -> packed bitmap [..., Wp//16]
    (2-bit fields, word k at bits [2k, 2k+2)).  The fields are disjoint, so
    their int32 sum (wrapping into the sign bit for word 15) is the
    reference's OR-fold."""
    g = lvl.reshape(lvl.shape[:-1] + (-1, _BMP)).to(I32)
    return torch.sum(g << _shifts(2, _BMP, lvl.device), dim=-1, dtype=I32)


def unpack_levels(packed: torch.Tensor, wp: int) -> torch.Tensor:
    """Packed bitmap [..., Wp//16] -> int32 levels [..., Wp]."""
    lanes = (packed[..., None] >> _shifts(2, _BMP, packed.device)) & 3
    return lanes.reshape(packed.shape[:-1] + (wp,))


# -- packed-word arithmetic --------------------------------------------------


def _lanes8(words: torch.Tensor) -> torch.Tensor:
    return (words[..., None] >> _shifts(8, 4, words.device)) & 0xFF


def _lanes16(words: torch.Tensor) -> torch.Tensor:
    return (words[..., None] >> _shifts(16, 2, words.device)) & 0xFFFF


def _decode(words: torch.Tensor, lvl: torch.Tensor) -> torch.Tensor:
    """words/lvl int32 [..., Wp] -> logical column values int32 [..., 4*Wp].
    Merged cells report the SHARED counter for every logical column they
    cover (an upper bound per column)."""
    b0 = _lanes8(words)
    b1 = torch.repeat_interleave(_lanes16(words), 2, dim=-1)  # {0,1} <- half0, {2,3} <- half1
    b2 = words[..., None].expand(words.shape + (4,))
    lv = lvl[..., None]
    out = torch.where(lv == 0, b0, torch.where(lv == 1, b1, b2))
    return out.reshape(out.shape[:-2] + (out.shape[-2] * 4,))


def _land_words(words: torch.Tensor, lvl: torch.Tensor, upd: torch.Tensor, cap2: int):
    """Add logical deltas ``upd`` [..., W] (>= 0) into packed words
    [..., Wp], escalating word levels on saturation (the self-adjusting
    merge).  Returns (words', lvl', decoded_before, decoded_after)."""
    u = upd.reshape(upd.shape[:-1] + (-1, 4))  # [..., Wp, 4]
    dec_before = _decode(words, lvl)
    # stored sums at each coarser granularity, from the STORED representation
    l0 = _lanes8(words)
    l1 = _lanes16(words)
    s1 = torch.where(lvl[..., None] == 0, l0[..., 0::2] + l0[..., 1::2], l1)  # [..., Wp, 2]
    s2 = torch.where(
        lvl == 0,
        torch.sum(l0, dim=-1, dtype=I32),
        torch.where(lvl == 1, torch.sum(l1, dim=-1, dtype=I32), words),
    )
    u1 = u[..., 0::2] + u[..., 1::2]
    u2 = torch.sum(u, dim=-1, dtype=I32)
    t0 = l0 + u  # candidate int8 lanes (meaningful only at level 0)
    t1 = s1 + u1
    t2 = torch.clamp_max(s2 + u2, cap2)
    fit0 = (lvl == 0) & torch.all(t0 <= 255, dim=-1)
    fit1 = ~fit0 & (lvl <= 1) & torch.all(t1 <= 65535, dim=-1)
    new_lvl = torch.where(fit0, 0, torch.where(fit1, 1, 2)).to(I32)
    w0 = t0[..., 0] | (t0[..., 1] << 8) | (t0[..., 2] << 16) | (t0[..., 3] << 24)
    w1 = t1[..., 0] | (t1[..., 1] << 16)
    new_words = torch.where(new_lvl == 0, w0, torch.where(new_lvl == 1, w1, t2))
    nl = new_lvl[..., None]
    da = torch.where(
        nl == 0, t0, torch.where(nl == 1, torch.repeat_interleave(t1, 2, dim=-1), t2[..., None])
    )
    return new_words, new_lvl, dec_before, da.reshape(dec_before.shape)


# -- window maintenance ------------------------------------------------------


def refresh(state: SalsaState, now_ms: int, cfg: SketchConfig) -> SalsaState:
    """Rotate: batched expiry of the running sums + landing of the finished
    bucket into the packed ring.

    The expiry (decode every column, subtract every expired bucket from
    ``run`` in one masked pass) is due when the bucket id advanced
    ``slack_buckets`` past the last expiry, or when the landing cursor
    reaches a column whose contents are still in ``run``.  The landing
    packs ``cur`` into an empty column when the bucket id moved.  Both are
    computed every call and selected on the device; the landing column is
    written in place at its device index."""
    wp = state.words.shape[-1]  # the rank's words on a shard
    nb = cfg.sample_count
    nbp = cfg.phys_buckets
    g = cfg.slack_buckets
    dev = state.epochs.device
    wid = _wid(now_ms, cfg)
    land = state.cur_wid != wid
    land_idx = _index_of(state.cur_wid, cfg).reshape(1)
    tgt_epoch = state.epochs.index_select(0, land_idx)[0]
    due = ((wid - state.rot_wid) >= g) | (land & (tgt_epoch != W.PURGED))
    land_onehot = torch.arange(nbp, device=dev) == land_idx

    # the expiry, selected where due
    epochs = state.epochs
    age = wid - epochs
    unpurged = epochs != W.PURGED
    live = (age >= 0) & (age < nb) & unpurged
    doomed = (~live | (land_onehot & land)) & unpurged
    dec = _decode(state.words, unpack_levels(state.lvlmap, wp))  # [nbp, depth, P, W]
    gone = torch.sum(dec * doomed.to(I32)[:, None, None, None], dim=0, dtype=I32)
    run = torch.where(due, state.run - gone, state.run)
    epochs = torch.where(due & doomed, W.PURGED, epochs)
    rot_wid = torch.where(due, wid, state.rot_wid).to(I32)

    # the landing, selected where the bucket id moved: pack the finished
    # bucket into an empty column (the target is purged by construction)
    col_w = state.words.index_select(0, land_idx)[0]
    col_l = state.lvlmap.index_select(0, land_idx)[0]
    nw, nl, _, dec_a = _land_words(
        torch.zeros_like(col_w), torch.zeros((cfg.depth, PLANES, wp), dtype=I32, device=dev),
        state.cur, _cap2(cfg),
    )
    state.words.index_copy_(0, land_idx, torch.where(land, nw, col_w)[None])
    state.lvlmap.index_copy_(0, land_idx, torch.where(land, pack_levels(nl), col_l)[None])
    run = torch.where(land, run + (dec_a - state.cur), run)
    epochs = torch.where(land & land_onehot, state.cur_wid, epochs).to(I32)
    cur = torch.where(land, 0, state.cur).to(I32)
    return SalsaState(
        words=state.words,
        lvlmap=state.lvlmap,
        run=run,
        epochs=epochs,
        rot_wid=rot_wid,
        cur=cur,
        cur_wid=torch.full((), wid, dtype=I32, device=dev),
    )


def sweep_expired(state: SalsaState, now_ms: int, cfg: SketchConfig) -> SalsaState:
    """Eagerly purge EVERY expired bucket from the running sums and zero
    their storage (for callers after a known idle gap, and tests)."""
    wp = state.words.shape[-1]
    wid = _wid(now_ms, cfg)
    age = wid - state.epochs
    live = (age >= 0) & (age < cfg.sample_count) & (state.epochs != W.PURGED)
    # PURGED columns already left run — zero their storage, subtract nothing
    doomed = ~live & (state.epochs != W.PURGED)
    dec = _decode(state.words, unpack_levels(state.lvlmap, wp))
    gone = torch.sum(dec * doomed.to(I32)[:, None, None, None], dim=0, dtype=I32)
    keep = live.to(I32)[:, None, None, None]
    # the unpacked current bucket expires with its wid like any column
    cage = wid - state.cur_wid
    cur_live = (cage >= 0) & (cage < cfg.sample_count)
    ckeep = cur_live.to(I32)
    return SalsaState(
        words=state.words * keep,
        lvlmap=state.lvlmap * keep,
        run=state.run - gone - (1 - ckeep) * state.cur,
        epochs=torch.where(live, state.epochs, W.PURGED).to(I32),
        rot_wid=torch.full((), wid, dtype=I32, device=state.epochs.device),
        cur=state.cur * ckeep,
        cur_wid=torch.where(cur_live, state.cur_wid, wid).to(I32),
    )


# -- writes ------------------------------------------------------------------


def add_dense(
    state: SalsaState,
    now_ms: int,
    upd: torch.Tensor,  # int32 [depth, width, len(plane_idx)] logical histogram
    plane_idx: Tuple[int, ...],
    cfg: SketchConfig,
    pre_refreshed: bool = False,
) -> SalsaState:
    """Land a precomputed histogram into the current bucket accumulator: a
    clamped vector add on the UNPACKED ``cur``, mirrored into the running
    sums.  ``pre_refreshed``: see ops/gsketch.add."""
    if not pre_refreshed:
        state = refresh(state, now_ms, cfg)
    # the named planes' columns, zeros elsewhere: one stack (an index list
    # would be uploaded, a synchronizing copy)
    zero = torch.zeros((cfg.depth, state.cur.shape[-1]), dtype=I32, device=state.cur.device)
    cols = dict(zip(plane_idx, upd.to(I32).unbind(dim=2)))
    u_full = torch.stack([cols.get(p, zero) for p in range(PLANES)], dim=1)
    new_cur = torch.clamp_max(state.cur + u_full, _cap2(cfg))
    return state._replace(cur=new_cur, run=state.run + (new_cur - state.cur))


def add(
    state: SalsaState,
    now_ms: int,
    res: torch.Tensor,  # int32 [N] resource ids (any id space)
    values: torch.Tensor,  # int32 [N, len(plane_idx)]
    plane_idx: Tuple[int, ...],
    valid: torch.Tensor,  # bool [N]
    cfg: SketchConfig,
    pre_refreshed: bool = False,
) -> SalsaState:
    """Batched event ingest: one flat histogram at logical width across all
    depths, landed by ``add_dense``."""
    if not pre_refreshed:
        state = refresh(state, now_ms, cfg)
    cols = cms_cell(res, cfg.depth, cfg.width)
    upd = depth_histogram(cols, values, valid, cfg.depth, cfg.width, sharded=True)
    return add_dense(state, now_ms, upd, plane_idx, cfg, pre_refreshed=True)


# -- reads -------------------------------------------------------------------


def estimate_plane_mxu(
    state: SalsaState, now_ms: int, res: torch.Tensor, plane: int, cfg: SketchConfig, cols=None
) -> torch.Tensor:
    """float32 [N]: min-over-depth windowed estimate of ONE plane, read
    from the running sums — one indexed gather of every depth's cell
    (capped at 2^24 - 1), then the min over depth.  The name is the
    reference's (its MXU one-hot read); ``now_ms`` is unused, as there.
    ``cols``: ``res``'s hashed columns, where the caller has them."""
    if cols is None:
        cols = cms_cell(res, cfg.depth, cfg.width)
    # on a shard: the rank's own columns, then ONE all-reduce of the
    # [depth, N] cells, where the reference's partitioner all-gathers the
    # [depth, width] running sums (sentinel_tpu/ops/tables.py:245-252, its
    # ``implicit-reshard`` rationale; the port's copy of that comment is at
    # ops/tables.depth_gather_1col's sharded read)
    g = T.depth_gather_1col(
        torch.clamp_max(state.run[:, plane, :], EST_CAP), cols, cfg.width, max_int=EST_CAP, sharded=True
    )  # [depth, N]
    return torch.amin(g, dim=0)


def estimate(state: SalsaState, now_ms: int, res: torch.Tensor, cfg: SketchConfig) -> torch.Tensor:
    """int32 [N, PLANES]: min-over-depth windowed estimates per resource
    (plain gathers from the running sums)."""
    cols = cms_cell(res, cfg.depth, cfg.width)
    if CL.current() is not None:
        from sentinel_tpu_torch.ops.gsketch import sharded_depth_read

        return torch.amin(sharded_depth_read(state.run, cols, cfg.width, col_axis=2), dim=0)
    cols = cols.to(torch.int64)
    per_depth = torch.stack([state.run[d][:, cols[:, d]].T for d in range(cfg.depth)])
    return torch.amin(per_depth, dim=0)


# -- introspection -----------------------------------------------------------


def level_histogram(state: SalsaState, cfg: SketchConfig) -> torch.Tensor:
    """int32 [3]: how many counter words sit at each width level across the
    whole sketch (the hot-set manager's merged-word gauge).  The unpacked
    current bucket reports the levels it WILL land at, in place of its
    (stale until landing) ring column.  On a shard: the rank's words,
    all-reduced."""
    wp = state.words.shape[-1]
    lvl = unpack_levels(state.lvlmap, wp)
    u = state.cur.reshape(cfg.depth, PLANES, wp, 4)
    u1 = u[..., 0::2] + u[..., 1::2]
    fit0 = torch.all(u <= 255, dim=-1)
    fit1 = ~fit0 & torch.all(u1 <= 65535, dim=-1)
    vlvl = torch.where(fit0, 0, torch.where(fit1, 1, 2)).to(I32)
    lvl.index_copy_(0, _index_of(state.cur_wid, cfg).reshape(1), vlvl[None])
    out = torch.stack([torch.sum(lvl == k) for k in range(3)]).to(I32)
    return out if CL.current() is None else CL.all_reduce(out)


def hbm_bytes(cfg: SketchConfig) -> int:
    """Persistent device bytes of a SalsaState at this config (words +
    bitmap + running sums + unpacked current bucket + epochs + watermarks)."""
    wp = cfg.width // 4
    nbp, d = cfg.phys_buckets, cfg.depth
    return 4 * (
        nbp * d * PLANES * wp
        + nbp * d * PLANES * (wp // _BMP)
        + d * PLANES * cfg.width
        + d * PLANES * cfg.width
        + nbp
        + 2
    )
