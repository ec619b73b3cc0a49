"""The decision engine: one tick per micro-batch.

PyTorch counterpart of ``sentinel_tpu/ops/engine.py``.  The effects path
is chosen as the reference chooses it (``_use_fused``): the fused path
runs when ``fused_effects`` AND ``use_mxu_tables`` are both set — the
per-item fused path (``seg_effects=False``) and the segment-compacted
path (``seg_effects=True``; ops/engine_seg.py), with or without its
per-tick fallback to the per-item path (``seg_fallback``).  Any other
config runs the plain path, the reference's default: per-item indexed
scatters and gathers (ops/tables.py), no kernel, counts exact to 65,535
an item.  A tick ingests

    AcquireBatch  — entry attempts   (SphU.entry side)
    CompleteBatch — exits            (Entry.exit + Tracer side)

as fixed-shape tensors and returns a verdict per attempt.  Checks run in
the reference slot order (Authority → System → ParamFlow → Flow →
Degrade); the first
failing check sets the verdict code.  Within-tick contention is resolved
by grouped prefix sums (ops/rank.py).  Every effect scatter of a phase
rides one call of the scatter kernel (ops/fused.scatter_many; one launch
up to 48 row-vectors, which the default widths stay under), and the
flow check's windowed (pass, concurrency, borrow) read rides the gather
kernel (ops/fused.gather_many), which reads the three columns where they
lie in the state (``flow_read_job``).

No host sync inside the tick.  The JAX tick decides several things on the
device with ``lax.cond``/``lax.switch`` (the stat fan width, the occupy
fold, the probe elections); here both branches are computed and selected
with ``torch.where``, and the stat fan always takes its widest form —
trash rows drop, so the results are identical.  ``now_ms`` is a host
integer; the only readback is the caller's read of the wire buffer.

State updates: the big window rings are updated IN PLACE (the counterpart
of the JAX tick's donated state) — a tick consumes the state it is given;
clone it first (``clone_state``) to keep the old one.

The segment path builds each side's segment structure once, lands both
effect phases per segment (ops/engine_seg.py), and — with single-lane
rules (``*_rules_per_resource == 1``) — runs the segment check phase,
whose ranks are segmented scans of the presorted batch.  With
``seg_fallback=False`` items past the compacted capacity ``seg_u`` fail
closed and are counted in the wire's ``seg_dropped``.  With
``seg_fallback=True`` (the reference's accelerator default) each of the
three phases — completions, the single-lane check phase, acquire effects
— takes the per-item branch when its side's live segments exceed
``seg_u``, so every tick is exact and nothing is dropped.  Each effects
phase is split into its scatters, which give small deltas
(``CompletionDeltas``, ``AcquireDeltas``), and ONE landing into the
state, so the choice never copies or rewrites the state: the caller may
pass the host's exact answer (``seg_fits``) and run one branch a side,
or pass nothing and run both, selected with ``torch.where`` on the
device's ``ctx.ok`` (no host sync either way).

The hot-parameter stage (``param``; ops/param.py) limits per argument
value over hashed (rule, value) rows: its reads are plain gathers, its
writes are extra jobs of the scatter kernel — ``prel{d}`` (THREAD-grade
release) among the completion scatters and ``param{d}`` (admitted counts
and THREAD concurrency) among the acquire scatters; on the segment path
they are separate scatter_many launches on the item axis, because
(rule, value-hash) rows are not segment-constant.

At the tick's tail, after the effects, come the three observability
planes the reference's serving config turns on: the device telemetry row
(``device_telemetry``: ``_device_stats``, float32 [N_STATS]), the top-K
per-resource timeline rows (``timeline_k``: ``_device_res_stats``,
float32 [K, TL_COLS]) and the explain records of up to ``explain_k``
blocked rows (``_device_explain``, 4 uint32 words each, packed wire only).
All three are plain PyTorch over tensors the tick already holds — the
reference computes them with XLA ops outside any Pallas kernel — and none
of them reads anything back to the host.

The sketch tier (``sketch_stats``): resources past the exact row space
(sketch ids, ``>= node_rows``) are counted in a windowed count-min sketch,
``state.gs`` — SALSA's self-adjusting counters by default
(sketch/salsa.py), the seed count-min tier with ``sketch_salsa=False``
(ops/gsketch.py).  Both phases land the sketch as ``sketch{d}`` jobs of the
scatter kernel, one per depth row, beside the stat job; the ``tail_flow``
stage enforces approximate QPS rules on sketch ids from the sketch's
windowed pass estimate against depth-hashed thresholds (``rules.tail``);
and the tick's tail emits the hot-set candidates, the batch's top-K
sketched ids by estimate (``TickOutput.hot``, the wire's hot block), for
the client's promotion loop (sketch/hotset.py).  The sketch's reads are
indexed gathers, never the reference's one-hot contractions.

The plain path differs from the fused one only where the reference's
does: the completion phase lands raw RT sums (``use_mxu_tables=False``)
instead of 1/8 ms quanta; the system check ranks in float32 (monotone,
inexact past 2^24, where an int32 total of 65,535-unit counts could wrap);
the flow check reads its (pass, concurrency, borrow) triple with plain
gathers, uncapped; and the RateLimiter's latestPassedTime advance and the
occupy booking come from indexed scatters.  Its scatters produce the same
``CompletionDeltas`` / ``AcquireDeltas`` the fused ones do, sized to the
whole node table, and land through the same landings.

Row-sharded (parallel/spmd.make_sharded_tick, under a shard context):
the state is the rank's shard — its slice of the node rows, of the
sketch's width, and a copy of everything else — while batches and rules
stay whole.  Every effect lands only the rank's own rows (``_rows_job``,
``_width_job``, the plain path's ``sharded`` histograms); every read of a
row-sharded table reads the rank's own rows and all-reduces over the
mesh's group (the ENTRY row: ``_entry_row``; the flow check's triple; the
explain records' pass runs; the sketch's estimates); and the timeline's
top-K merges each rank's top K in rank order with a stable sort
(``_device_res_stats``), so every rank computes the same verdicts and
planes.  Off a shard every helper is the single-device code.

Features: {nodes, occupy, flow, tail_flow, degrade, authority, system,
warmup, param}.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import torch

from sentinel_tpu_torch.core import rule_tensors as RT
from sentinel_tpu_torch.core.config import EngineConfig
from sentinel_tpu_torch.core.errors import (
    BLOCK_AUTHORITY,
    BLOCK_DEGRADE,
    BLOCK_FLOW,
    BLOCK_PARAM,
    BLOCK_SYSTEM,
    PASS,
    PASS_WAIT,
)
from sentinel_tpu_torch.core.rules import (
    CONTROL_DEFAULT,
    CONTROL_RATE_LIMITER,
    CONTROL_WARM_UP,
    CONTROL_WARM_UP_RATE_LIMITER,
    GRADE_QPS,
    GRADE_THREAD,
    STRATEGY_DIRECT,
    STRATEGY_RELATE,
)
from sentinel_tpu_torch.obs.explain import FX as EXPLAIN_FX
from sentinel_tpu_torch.obs.explain import FX_MAX as _EXPLAIN_FX_MAX
from sentinel_tpu_torch.obs.explain import FX_UNKNOWN as EXPLAIN_UNKNOWN
from sentinel_tpu_torch.obs import profile as PROF
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.ops import degrade as D
from sentinel_tpu_torch.ops import engine_seg as ES
from sentinel_tpu_torch.ops import fused as FU
from sentinel_tpu_torch.ops import gsketch as GS
from sentinel_tpu_torch.ops import param as PM
from sentinel_tpu_torch.ops import rowmin as RM
from sentinel_tpu_torch.ops import rtq as RQ
from sentinel_tpu_torch.ops import tables as T
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.ops.rank import grouped_exclusive_cumsum
from sentinel_tpu_torch.parallel import collectives as CL
from sentinel_tpu_torch.sketch import impl_for as _sketch

I32, F32 = torch.int32, torch.float32

#: every tick stage this engine runs
ALL_FEATURES = frozenset(
    {"authority", "system", "param", "flow", "degrade", "warmup", "nodes", "occupy", "tail_flow"}
)


def _fan(x: torch.Tensor, K: int) -> torch.Tensor:
    """Per-item -> per-(item, rule-lane) fan-out (repeat each item K times)."""
    return x if K == 1 else torch.repeat_interleave(x, K, dim=0)


# -- the shard's rows (parallel/spmd.py) --------------------------------------


def _local_rows(cfg: EngineConfig) -> int:
    """Node rows the state holds: all of them, or the rank's slice."""
    ctx = CL.current()
    return cfg.node_rows if ctx is None else cfg.node_rows // ctx.world


def _rows_job(cfg: EngineConfig, job: FU.Job) -> FU.Job:
    """A scatter job on the node-row axis as the rank lands it."""
    return FU.on_shard(job, cfg.node_rows)


def _width_job(cfg: EngineConfig, job: FU.Job) -> FU.Job:
    """A scatter job on the sketch's width axis as the rank lands it."""
    return FU.on_shard(job, cfg.sketch_width)


def _entry_row(cfg: EngineConfig, tables) -> list:
    """Each row-sharded table's ENTRY row (views off a shard; on one, the
    owner's values through one all-reduce per dtype)."""
    erow = cfg.entry_node_row
    if CL.current() is None:
        return [t[erow] for t in tables]
    return CL.row_values(tables, erow, cfg.node_rows)


def _entry_local(cfg: EngineConfig) -> Optional[int]:
    """The ENTRY row's index in the state's rows, or None where another
    rank holds it."""
    ctx = CL.current()
    erow = cfg.entry_node_row
    if ctx is None:
        return erow
    lo, hi = ctx.span(cfg.node_rows)
    return erow - lo if lo <= erow < hi else None


def _read_node_rows(cfg: EngineConfig, tables, node: torch.Tensor) -> torch.Tensor:
    """float32 [len(tables), N]: row-sharded [rows] tables read at the
    global node rows ``node`` (inside [0, node_rows)), on a shard as the
    rank's own rows plus ONE all-reduce SUM (exact: one rank holds each
    row, the rest add zeros)."""
    ctx = CL.current()
    lo, hi = ctx.span(cfg.node_rows)
    loc = node - lo
    held = (loc >= 0) & (loc < hi - lo)
    c = torch.clamp(loc, 0, hi - lo - 1).to(torch.int64)
    vals = torch.stack([t[c].to(F32) for t in tables])
    return CL.all_reduce(torch.where(held[None, :], vals, 0.0))


class EngineState(NamedTuple):
    win_sec: W.WindowState  # [node_rows] second window (2 x 500 ms default)
    win_min: W.WindowState  # [node_rows] minute window (60 x 1 s default)
    concurrency: torch.Tensor  # int32 [node_rows] curThreadNum per node
    latest_passed_ms: torch.Tensor  # float32 [F+1] RateLimiter latestPassedTime
    warmup_tokens: torch.Tensor  # float32 [F+1] WarmUpController.storedTokens
    warmup_last_s: torch.Tensor  # int32 [F+1] lastFilledTime (seconds)
    warm_acc: torch.Tensor  # float32 [F+1] admitted counts of the current second
    occ_tokens: torch.Tensor  # float32 [node_rows] occupy-ahead borrow pool
    occ_epoch: torch.Tensor  # int32 [node_rows]
    cb_state: torch.Tensor  # int32 [D+1]
    cb_retry_ms: torch.Tensor  # int32 [D+1]
    cb_counts: torch.Tensor  # int32 [D+1, nbc, 3]
    cb_epochs: torch.Tensor  # int32 [D+1, nbc]
    # hashed (rule, value) param store (ops/param.py)
    pcms: torch.Tensor  # int32 [depth, Q, nbp]
    pcms_epochs: torch.Tensor  # int32 [nbp]
    pconc: torch.Tensor  # int32 [depth, Q]
    # the global sketch (sketch/salsa.SalsaState, or ops/gsketch.SketchState
    # with sketch_salsa=False); a [1, 1, 1, PLANES] gsketch placeholder
    # while sketch_stats is off
    gs: object
    rtq: RQ.RtqState  # ENTRY-node RT quantile histogram


class RuleSet(NamedTuple):
    flow: RT.FlowRuleTensors
    degrade: RT.DegradeRuleTensors
    param: RT.ParamRuleTensors
    auth: RT.AuthorityTensors
    system: RT.SystemTensors
    tail: RT.TailFlowTensors  # sketch-tail QPS thresholds


class AcquireBatch(NamedTuple):
    """Entry attempts. Padding items carry res == trash_row."""

    res: torch.Tensor  # int32 [B] resource id == cluster-node row
    count: torch.Tensor  # [B] tokens to acquire
    prio: torch.Tensor  # [B] prioritized flag
    origin_id: torch.Tensor  # int32 [B] interned origin (-1 none)
    origin_node: torch.Tensor  # int32 [B] origin stat row (trash if none)
    ctx_node: torch.Tensor  # int32 [B] context DefaultNode row (trash if none)
    ctx_name: torch.Tensor  # int32 [B] interned context name (-1 default)
    inbound: torch.Tensor  # [B] 1 = entrance context
    param_hash: torch.Tensor  # int32 [B, param_dims]
    pre_verdict: torch.Tensor  # [B] host-decided verdict override (0 = none)


class CompleteBatch(NamedTuple):
    """Exits. Padding items carry res == trash_row."""

    res: torch.Tensor  # int32 [B2]
    origin_node: torch.Tensor  # int32 [B2]
    ctx_node: torch.Tensor  # int32 [B2]
    inbound: torch.Tensor  # [B2]
    rt: torch.Tensor  # float32 [B2] response time ms
    success: torch.Tensor  # [B2]
    error: torch.Tensor  # [B2]
    param_hash: torch.Tensor  # int32 [B2, param_dims]


class TickOutput(NamedTuple):
    verdict: Optional[torch.Tensor]  # int8 [B] (None under packed_wire)
    wait_ms: torch.Tensor  # int32 [B] pacing delay for PASS_WAIT
    wire: Optional[torch.Tensor] = None  # int32 [words]: the packed wire
    # int32 scalar: items failed closed past the segment capacity (0 off the
    # segment path)
    seg_dropped: Optional[torch.Tensor] = None
    # the device telemetry row (cfg.device_telemetry): float32 [N_STATS]
    # (see _device_stats); None when off or when it rides the packed wire
    stats: Optional[torch.Tensor] = None
    # the per-resource timeline rows (timeline_k(cfg) > 0): float32
    # [K, TL_COLS] (see _device_res_stats); None when off or packed
    res_stats: Optional[torch.Tensor] = None
    # the hot-set candidates (hotset_k(cfg) > 0): float32 [K, 2] (sketch id,
    # windowed pass estimate; see _device_hot_candidates); None when off or
    # packed
    hot: Optional[torch.Tensor] = None


# -- device-resident telemetry (TickOutput.stats) ---------------------------
#
# One float32 row per tick: the verdict mix by block reason, admitted and
# blocked token sums, segment occupancy, the system ceiling's use, and the
# global ENTRY node's sliding-window sums — read from the O(1) running sums
# the windows keep, so the row costs a handful of small reductions.  The
# slots are the reference's (sentinel_tpu/ops/engine.py:228-251).

STAT_VALID = 0  # non-padding items in the acquire batch
STAT_PASS = 1  # verdict mix over valid items (first-fail slot order)
STAT_PASS_WAIT = 2
STAT_BLOCK_AUTHORITY = 3
STAT_BLOCK_SYSTEM = 4
STAT_BLOCK_PARAM = 5
STAT_BLOCK_FLOW = 6
STAT_BLOCK_DEGRADE = 7
STAT_FORCED = 8  # host-injected pre_verdicts (cluster token denials)
STAT_PASS_TOKENS = 9  # admitted token sum (count column)
STAT_BLOCK_TOKENS = 10
STAT_SEG_DROPPED = 11  # fail-closed seg-overflow items (0 off the seg path)
STAT_SEG_LIVE = 12  # live compacted segments this tick (0 off the seg path)
STAT_WIN_PASS = 13  # ENTRY-node sliding-window sums (post-tick)
STAT_WIN_BLOCK = 14
STAT_WIN_SUCCESS = 15
STAT_WIN_EXCEPTION = 16
STAT_WIN_RT_SUM = 17
STAT_WIN_RT_MIN = 18  # W.RT_MIN_INIT when no completions in window
STAT_ENTRY_CONC = 19  # global inbound concurrency
STAT_CEIL_QPS = 20  # active SystemTensors qps ceiling (-1 = unset)
STAT_CEIL_THREAD = 21  # active SystemTensors max_thread ceiling
STAT_CEIL_UTIL = 22  # windowed ENTRY pass / qps ceiling (0 when unset)
N_STATS = 24  # slot 23 reserved; 96 bytes per tick

#: verdict codes in the row's order (slots STAT_PASS .. STAT_BLOCK_DEGRADE)
_STAT_VERDICTS = (
    PASS, PASS_WAIT, BLOCK_AUTHORITY, BLOCK_SYSTEM, BLOCK_PARAM, BLOCK_FLOW, BLOCK_DEGRADE,
)


def _device_stats(
    cfg: EngineConfig, state, rules, acq, verdict, valid, forced, seg_dropped, seg_live,
) -> torch.Tensor:
    """The TickOutput.stats row (the STAT_* slots), float32 [N_STATS].

    Runs AFTER the acquire effects landed, so the window sums include this
    tick.  Integer slots are int32 sums cast to float32, as the reference's
    are; the qps and max_thread ceilings stay 0-d device tensors."""
    dev = verdict.device
    win = state.win_sec
    erow = cfg.entry_node_row
    if CL.current() is None:
        run = win.run[erow]
        conc_e, run_rt_e, run_rt_min_e = (
            t[erow : erow + 1] for t in (state.concurrency, win.run_rt, win.run_rt_min)
        )
    else:
        run, conc_e, run_rt_e, run_rt_min_e = _entry_row(
            cfg, (win.run, state.concurrency, win.run_rt, win.run_rt_min)
        )
        conc_e, run_rt_e, run_rt_min_e = (t.reshape(1) for t in (conc_e, run_rt_e, run_rt_min_e))
    # one compare of every valid verdict against the codes 0..6
    codes = torch.arange(PASS_WAIT + 1, dtype=I32, device=dev)
    onehot = torch.where(valid, verdict.to(I32), -1)[None, :] == codes[:, None]
    n_code = onehot.sum(dim=1, dtype=I32)
    admitted = onehot[PASS] | onehot[PASS_WAIT]
    cnt = acq.count
    sums = torch.stack(
        [
            valid.to(I32),
            forced.to(I32),
            torch.where(admitted, cnt, 0),
            torch.where(valid & ~admitted, cnt, 0),
        ]
    ).sum(dim=1, dtype=I32)
    ints = torch.cat(
        [sums[0:1]]
        + [n_code[c : c + 1] for c in _STAT_VERDICTS]
        + [
            sums[1:4],
            seg_dropped.reshape(1).to(I32),
            seg_live.reshape(1).to(I32),
            run[W.EV_PASS : W.EV_PASS + 1],
            run[W.EV_BLOCK : W.EV_BLOCK + 1],
            run[W.EV_SUCCESS : W.EV_SUCCESS + 1],
            run[W.EV_EXCEPTION : W.EV_EXCEPTION + 1],
            conc_e,
        ]
    ).to(F32)
    win_pass = ints[STAT_WIN_PASS : STAT_WIN_PASS + 1]
    qps = rules.system.qps.to(F32).reshape(1)
    util = torch.where(qps > 0, win_pass / torch.clamp_min(qps, 1.0), 0.0)
    return torch.cat(
        [
            ints[:STAT_WIN_RT_SUM],
            run_rt_e,
            run_rt_min_e,
            ints[STAT_WIN_RT_SUM:],  # STAT_ENTRY_CONC
            qps,
            rules.system.max_thread.to(F32).reshape(1),
            util,
            torch.zeros((1,), dtype=F32, device=dev),
        ]
    )


# -- per-resource timeline rows (TickOutput.res_stats) ----------------------
#
# The top-K resource rows by windowed pass+block, with their CURRENT
# second-window bucket's cumulative stats; the host's write-behind fold
# (obs/timeline.py) keeps the last read per (row, bucket) and lands exact
# per-second records once the engine clock leaves the second.

TL_RID = 0  # resource row id (registry maps it back to the name)
TL_PASS = 1  # current-bucket cumulative counts (token-weighted)
TL_BLOCK = 2
TL_SUCCESS = 3
TL_EXCEPTION = 4
TL_RT_SUM = 5  # current-bucket RT sum (ms)
TL_RT_MIN = 6  # current-bucket RT min (W.RT_MIN_INIT = none)
TL_CONC = 7  # live concurrency (gauge, not bucketed)
TL_COLS = 8


def timeline_k(cfg: EngineConfig) -> int:
    """Effective top-K row count (0 = res_stats emission off), clamped to
    the resource-row space [1, max_resources)."""
    if not cfg.device_telemetry or cfg.timeline_k <= 0:
        return 0
    return min(int(cfg.timeline_k), cfg.max_resources - 1)


def _device_res_stats(cfg: EngineConfig, state, now_ms: int) -> torch.Tensor:
    """The TickOutput.res_stats matrix (the TL_* columns), float32
    [K, TL_COLS].

    Rows [1, max_resources) are ranked by windowed pass+block (row 0, the
    ENTRY node, is the stats row's).  ``lax.top_k`` puts the lower row
    first on a tie and ``torch.topk`` promises no order among ties; a
    stable descending sort keeps the reference's order.  Stale buckets (no
    write since the window wrapped) read 0, and RT_MIN_INIT for the
    minimum — LeapArray's isWindowDeprecated, batched."""
    K = timeline_k(cfg)
    win = state.win_sec
    wid = W.wid_of(now_ms, cfg.second_window_ms)
    bidx = W.current_index(now_ms, _sec_cfg(cfg))
    if CL.current() is not None:
        return _sharded_res_stats(cfg, state, K, wid, bidx)
    r = win.run[1 : cfg.max_resources]
    score = r[:, W.EV_PASS] + r[:, W.EV_BLOCK]
    rows = torch.sort(score, descending=True, stable=True).indices[:K] + 1
    fresh = win.epochs[bidx] == wid
    c = torch.where(fresh, win.counts[:, bidx].index_select(0, rows), 0)  # [K, NE]
    rt_sum = torch.where(fresh, win.rt_sum[:, bidx].index_select(0, rows), 0.0)
    rt_min = torch.where(fresh, win.rt_min[:, bidx].index_select(0, rows), W.RT_MIN_INIT)
    ints = torch.cat(
        [
            rows.to(I32)[:, None],
            c[:, W.EV_PASS : W.EV_BLOCK + 1],
            c[:, W.EV_SUCCESS : W.EV_SUCCESS + 1],
            c[:, W.EV_EXCEPTION : W.EV_EXCEPTION + 1],
            state.concurrency.index_select(0, rows)[:, None],
        ],
        dim=1,
    ).to(F32)
    return torch.cat([ints[:, :TL_RT_SUM], rt_sum[:, None], rt_min[:, None], ints[:, TL_RT_SUM:]], dim=1)


def _sharded_res_stats(cfg: EngineConfig, state, K: int, wid: int, bidx: int) -> torch.Tensor:
    """``_device_res_stats`` on a shard: each rank ranks its own rows of
    [1, max_resources) (a stable descending sort, its top K, padded to K
    with score -1, below every real score), every rank's top K with its
    row's columns rides ONE all-gather in rank order — rows ascending —
    and a stable descending sort of that keeps ``lax.top_k``'s order: the
    lower global row first on a tie.  The global top K lies inside the
    union of the ranks' top K."""
    ctx = CL.current()
    win = state.win_sec
    lo, hi = ctx.span(cfg.node_rows)
    dev = win.run.device
    a, b = max(1, lo), min(cfg.max_resources, hi)
    fresh = win.epochs[bidx] == wid
    if b > a:
        r = win.run[a - lo : b - lo]
        score = r[:, W.EV_PASS] + r[:, W.EV_BLOCK]
        loc = torch.sort(score, descending=True, stable=True).indices[:K] + (a - lo)
        score = win.run[loc, W.EV_PASS] + win.run[loc, W.EV_BLOCK]
    else:
        loc = torch.zeros((0,), dtype=torch.int64, device=dev)
        score = torch.zeros((0,), dtype=I32, device=dev)
    c = torch.where(fresh, win.counts[:, bidx].index_select(0, loc), 0)  # [k, NE]
    rt_sum = torch.where(fresh, win.rt_sum[:, bidx].index_select(0, loc), 0.0)
    rt_min = torch.where(fresh, win.rt_min[:, bidx].index_select(0, loc), W.RT_MIN_INIT)
    mine = torch.cat(
        [
            score.to(I32)[:, None],
            (loc + lo).to(I32)[:, None],
            c[:, W.EV_PASS : W.EV_BLOCK + 1],
            c[:, W.EV_SUCCESS : W.EV_SUCCESS + 1],
            c[:, W.EV_EXCEPTION : W.EV_EXCEPTION + 1],
            state.concurrency.index_select(0, loc)[:, None],
            torch.stack([rt_sum, rt_min], dim=1).contiguous().view(I32),
        ],
        dim=1,
    )
    pad = torch.zeros((K - mine.shape[0], mine.shape[1]), dtype=I32, device=dev)
    pad[:, 0] = -1
    every = CL.all_gather(torch.cat([mine, pad]))  # [world * K, 9], rank order
    top = every.index_select(0, torch.sort(every[:, 0], descending=True, stable=True).indices[:K])
    ints = top[:, 1:7].to(F32)
    rts = top[:, 7:9].contiguous().view(F32)
    return torch.cat([ints[:, :TL_RT_SUM], rts, ints[:, TL_RT_SUM:]], dim=1)


def sketch_config(cfg: EngineConfig) -> GS.SketchConfig:
    """The sketch tier's bucket grid and shape (cfg.sketch_shape)."""
    nb, wms = cfg.sketch_shape
    return GS.SketchConfig(
        sample_count=nb,
        window_ms=wms,
        depth=cfg.sketch_depth,
        width=cfg.sketch_width,
        slack_frac=cfg.sketch_slack_frac,
    )


def hotset_k(cfg: EngineConfig) -> int:
    """Effective hot-candidate row count (0 = TickOutput.hot off)."""
    if not cfg.sketch_stats or cfg.hotset_k <= 0:
        return 0
    return int(cfg.hotset_k)


def _device_hot_candidates(cfg: EngineConfig, state, acq, valid, now_ms: int) -> torch.Tensor:
    """TickOutput.hot: float32 [K, 2] (sketch id, windowed pass estimate)
    of the batch's top-K sketched items.

    Runs after the acquire effects, so the estimate includes this tick.
    Only ids the batch carried can surface (a sketch cannot be inverted
    back to ids); the host manager folds successive ticks.  Items that are
    padding or exact rows score -1.  ``lax.top_k`` puts the lower row first
    on a tie; a stable descending sort keeps that order.  Ids stay exact in
    float32 (node_rows + sketch_capacity < 2^24, checked by the config)."""
    K = min(hotset_k(cfg), acq.res.shape[0])
    est = _sketch(cfg).estimate_plane_mxu(state.gs, now_ms, acq.res, W.EV_PASS, sketch_config(cfg))
    score = torch.where(valid & (acq.res >= cfg.node_rows), est, -1.0)
    v, i = torch.sort(score, descending=True, stable=True)
    return torch.stack([acq.res.index_select(0, i[:K]).to(F32), v[:K]], dim=1)


# -- explain records (the wire's explain section) ---------------------------


def explain_k(cfg: EngineConfig) -> int:
    """Effective explain-record row count (0 = the wire's explain block
    off).  Provenance rides ONLY the packed wire."""
    if not cfg.packed_wire or cfg.explain_k <= 0:
        return 0
    return int(cfg.explain_k)


def _explain_fx(x: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    """float32 -> x256 fixed-point uint32 word (int64 in [0, 2^32));
    EXPLAIN_UNKNOWN where not known.  FX_MAX is exact in float32, so the
    truncation to int64 is the reference's cast to uint32."""
    v = torch.clamp(x * EXPLAIN_FX, 0.0, _EXPLAIN_FX_MAX)
    return torch.where(known, v.to(torch.int64), EXPLAIN_UNKNOWN)


def _device_explain(cfg: EngineConfig, state, rules, acq, verdict, valid, forced, fslots, now_ms: int):
    """Provenance records for up to explain_k BLOCKED rows of this tick:
    (n_blocked int64 scalar, records int64 [K, 4] of uint32 words).

    Per record (obs/explain.py owns the host decode):
      w0  resource id
      w1  verdict kind (bits 0..2) | sketch-tier flag (bit 3) | forced
          flag (bit 4) | blamed rule slot + 1 in bits 16..31 (0 = n/a)
      w2  observed value, x256 fixed point (EXPLAIN_UNKNOWN = n/a)
      w3  threshold, same encoding
    The records are the first K blocked rows in batch order: the rank key
    ``b - row`` is unique wherever it is positive, and every record past
    the blocked rows is zeroed, so ``torch.topk``'s order among the zero
    keys never shows.  The blamed slot is the resource's FIRST rule lane.

    The reference attributes kind by kind (flow, degrade, param, system,
    authority), each a chain of selects; here every kind's (slot, observed,
    threshold) is read for every record at once — K-row gathers of state
    the tick already holds — and one gather by the record's kind picks its
    own, which keeps the launches few.  A forced row (a host pre_verdict)
    blames no rule.  A flow block on a sketch id (the sketch tier) blames
    no slot: its threshold is the max over depth of its hashed tail cells
    (unknown where none is ruled), its observed value the sketch's
    windowed pass estimate."""
    b = acq.res.shape[0]
    dev = acq.res.device
    i64 = torch.int64
    K = min(explain_k(cfg), b)
    Fn, Dn, Pn = cfg.max_flow_rules, cfg.max_degrade_rules, cfg.max_param_rules
    is_blocked = valid & (verdict >= BLOCK_FLOW) & (verdict <= BLOCK_AUTHORITY)
    n_blocked = is_blocked.sum()
    score = torch.where(is_blocked, torch.arange(b, 0, -1, dtype=I32, device=dev), 0)
    score_v, rows = torch.topk(score, K)
    live = score_v > 0

    # the per-item columns a record reads, gathered once: resource, verdict,
    # forced flag, and the flow check's first slot lane (exact tier)
    if fslots is not None:
        slot_col = fslots.view(b, cfg.flow_rules_per_resource)[:, 0]
    else:
        slot_col = torch.full((b,), Fn, dtype=I32, device=dev)
    res, kind, frc, slot_f = torch.stack(
        [acq.res, verdict.to(I32), forced.to(I32), slot_col]
    ).index_select(1, rows)
    # the record's kind: 0 for a dead record, else its block code, which
    # indexes the per-kind rows below (BLOCK_FLOW = 1 .. BLOCK_AUTHORITY = 5)
    kind = torch.where(live, kind, 0).to(i64)
    att = frc == 0
    exact = res < cfg.node_rows
    res_r = torch.clamp_max(res, cfg.max_resources)
    slot_d = rules.degrade.res_cbs[:, 0].index_select(0, res_r)
    slot_p = rules.param.res_params[:, 0].index_select(0, res_r)
    slot_dc = torch.clamp_max(slot_d, Dn)
    run_pass = W.window_event_run(state.win_sec, W.EV_PASS)
    qps = rules.system.qps.to(F32)
    zero = torch.zeros((K,), dtype=I32, device=dev)
    if CL.current() is None:
        flow_obs = run_pass.index_select(0, torch.clamp_max(res, cfg.node_rows - 1))
        entry_pass = run_pass[cfg.entry_node_row]
    else:
        flow_obs = T.big_gather(run_pass, torch.clamp_max(res, cfg.node_rows - 1), cfg.node_rows, sharded=True)
        (entry_pass,) = _entry_row(cfg, (run_pass,))
    flow_thr = rules.flow.count.index_select(0, torch.clamp_max(slot_f, Fn))
    tail_ok = tail_thr_ok = torch.zeros((K,), dtype=torch.bool, device=dev)
    if cfg.sketch_stats:
        # the sketch tier: the threshold from the depth-hashed cells, the
        # observed value from the windowed pass estimate (both K-row reads;
        # the estimate is an integer below 2^24, exact as int32)
        t_cols = PM.cms_cell(res, cfg.sketch_depth, cfg.sketch_width)
        thr_t = tail_thresholds(cfg, rules, t_cols, ~exact)
        obs_t = _sketch(cfg).estimate_plane_mxu(
            state.gs, now_ms, res, W.EV_PASS, sketch_config(cfg), cols=t_cols
        )
        flow_obs = torch.where(exact, flow_obs, obs_t.to(I32))
        flow_thr = torch.where(exact, flow_thr, thr_t)
        tail_ok = (kind == BLOCK_FLOW) & ~exact & att
        tail_thr_ok = tail_ok & (thr_t < RT.TAIL_UNRULED / 2)
    # per kind (none, flow, degrade, param, system, authority): the blamed
    # slot and the observed value, as the reference reads them — flow: the
    # node's windowed pass run; degrade: the breaker's state (0 closed /
    # 1 open / 2 half-open); param: unknown (the offending hashed value is
    # not recoverable); system: the ENTRY node's windowed pass run;
    # authority: the rule mode (1 white / 2 black) ...
    slot_obs = torch.stack(
        [
            zero, zero,
            slot_f, flow_obs,
            slot_d, state.cb_state.index_select(0, slot_dc),
            slot_p, zero,
            zero, entry_pass.expand(K),
            zero, rules.auth.mode.index_select(0, res_r),
        ]
    ).view(6, 2, K)
    # ... and the threshold: the flow rule's count, the degrade rule's
    # count, the param rule's window budget, the qps ceiling
    zero_f = zero.to(F32)
    thr_k = torch.stack(
        [
            zero_f,
            flow_thr,
            rules.degrade.count.index_select(0, slot_dc),
            rules.param.threshold.index_select(0, torch.clamp_max(slot_p, Pn)),
            qps.expand(K),
            zero_f,
        ]
    )
    slot, obs = torch.gather(slot_obs, 0, kind.view(1, 1, K).expand(1, 2, K))[0]
    thr = torch.gather(thr_k, 0, kind[None])[0]
    # whether the kind's slot / observed / threshold apply to the record
    f_ok = (slot_f < Fn) & exact
    base = torch.stack([f_ok, f_ok, slot_d < Dn, slot_p < Pn, att, att])
    ok = torch.gather(base, 0, kind[None])[0] & att
    low = kind <= BLOCK_PARAM
    slot_ok = ok & low
    obs_ok = (ok & (kind != BLOCK_PARAM)) | tail_ok
    thr_ok = (ok & (low | ((kind == BLOCK_SYSTEM) & (qps >= 0)))) | tail_thr_ok

    slot_w = torch.clamp_max(torch.where(slot_ok, slot + 1, 0), 0xFFFF).to(i64)
    w1 = kind | (((kind == BLOCK_FLOW) & ~exact).to(i64) << 3) | (frc.to(i64) << 4) | (slot_w << 16)
    fx = _explain_fx(
        torch.stack([obs.to(F32), thr], dim=1), torch.stack([obs_ok, thr_ok], dim=1)
    )  # [K, 2]
    words = torch.cat([res.to(i64)[:, None], w1[:, None], fx], dim=1)
    return n_blocked, torch.where(live[:, None], words, 0)


def _use_fused(cfg: EngineConfig) -> bool:
    """The fused effects path runs only on the one-hot table config, as in
    the reference (``fused_effects and use_mxu_tables``); every other
    config takes the plain path.  The reference's third operand, its
    ``SENTINEL_NO_PALLAS`` switch, has no counterpart: the port hides no
    kernel behind an environment variable."""
    return bool(cfg.fused_effects and cfg.use_mxu_tables)


def check_supported(cfg: EngineConfig, features: frozenset = ALL_FEATURES) -> None:
    """Raise for a tick stage this engine does not know — it never silently
    ignores one."""
    extra = set(features) - ALL_FEATURES
    if extra:
        raise ValueError(f"unknown tick features {sorted(extra)}")


def _sec_cfg(cfg: EngineConfig) -> W.WindowConfig:
    return W.WindowConfig(cfg.second_sample_count, cfg.second_window_ms)


def _min_cfg(cfg: EngineConfig) -> W.WindowConfig:
    return W.WindowConfig(cfg.minute_sample_count, cfg.minute_window_ms)


def rtq_config(cfg: EngineConfig) -> RQ.RtqConfig:
    return RQ.RtqConfig(
        sample_count=cfg.second_sample_count,
        window_ms=cfg.second_window_ms,
        max_rt=float(cfg.statistic_max_rt),
    )


def init_state(cfg: EngineConfig, device) -> EngineState:
    state = _init_state(cfg, device)
    # memory ledger (obs/profile.py): the window rings + breaker / param /
    # rtq state are the "windows" pool; the global sketch is accounted by
    # its own init (salsa / gsketch), so its leaves are subtracted
    PROF.LEDGER.set(
        "windows",
        "engine.init_state",
        PROF.tree_nbytes(state) - PROF.tree_nbytes(state.gs),
    )
    return state


def _init_state(cfg: EngineConfig, device) -> EngineState:
    rows = cfg.node_rows
    min_rows = rows if cfg.enable_minute_window else 1
    F = cfg.max_flow_rules
    Dn = cfg.max_degrade_rules

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return EngineState(
        win_sec=W.init_window(rows, _sec_cfg(cfg), device),
        win_min=W.init_window(min_rows, _min_cfg(cfg), device),
        concurrency=full((rows,), 0, I32),
        latest_passed_ms=full((F + 1,), -1.0e9, F32),
        warmup_tokens=full((F + 1,), 0.0, F32),
        warmup_last_s=full((F + 1,), -1, I32),
        warm_acc=full((F + 1,), 0.0, F32),
        occ_tokens=full((rows,), 0.0, F32),
        occ_epoch=full((rows,), -1, I32),
        cb_state=full((Dn + 1,), 0, I32),
        cb_retry_ms=full((Dn + 1,), 0, I32),
        cb_counts=full((Dn + 1, cfg.cb_sample_count, 3), 0, I32),
        cb_epochs=full((Dn + 1, cfg.cb_sample_count), -10, I32),
        pcms=full((cfg.param_depth, cfg.param_width, cfg.param_sample_count), 0, I32),
        pcms_epochs=full((cfg.param_sample_count,), -(cfg.param_sample_count + 1), I32),
        pconc=full((cfg.param_depth, cfg.param_width), 0, I32),
        gs=_sketch(cfg).init_sketch(sketch_config(cfg), device)
        if cfg.sketch_stats
        else GS.SketchState(counts=full((1, 1, 1, GS.PLANES), 0, I32), epochs=full((1,), -2, I32)),
        rtq=RQ.init_rtq(rtq_config(cfg), device),
    )


def clone_state(state):
    """A deep copy of a (nested) state NamedTuple of tensors."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    return type(state)(*[clone_state(x) for x in state])


def compile_ruleset(
    cfg: EngineConfig,
    registry,
    flow_rules=(),
    degrade_rules=(),
    param_rules=(),
    authority_rules=(),
    system_rules=(),
    device="cuda",
    param_lanes=None,
) -> RuleSet:
    """Host-side: compile rule objects into a RuleSet on ``device``.

    ``param_lanes``: optional resource -> ordered param_idx list from
    rule_tensors.param_lanes — pass the host client's map so the engine's
    lanes and the client's hashed lanes agree.

    QPS flow rules whose resource resolves to a SKETCH id (the exact row
    space exhausted, promotion failed) compile into the tail threshold
    tables; other grades, behaviours, strategies or an origin-scoped
    limitApp on a sketch id cannot be enforced there and are dropped with a
    warning.  A cluster-mode param rule compiles as an ordinary param rule,
    as in the reference: the client hands it here only while its cluster
    enforcement is degraded to local rules (runtime/client.py)."""
    flow_rules = list(flow_rules)
    param_rules = list(param_rules)
    tail = []
    exact_flow = []
    for r in flow_rules:
        rid = registry.resource_id(r.resource) if r.resource else None
        if rid is not None and rid >= cfg.node_rows:
            if (
                r.grade == GRADE_QPS
                and r.control_behavior == CONTROL_DEFAULT
                and r.strategy == STRATEGY_DIRECT
                # the tail table has no origin dimension: an origin-scoped
                # rule compiled there would throttle EVERY origin
                and (r.limit_app or "default") == "default"
                and cfg.sketch_stats
            ):
                tail.append((rid, float(r.count)))
            else:
                import logging

                logging.getLogger(__name__).warning(
                    "flow rule on tail resource %r needs exact windows "
                    "(grade/behavior/strategy/limitApp unsupported in the "
                    "tail) and will NOT be enforced; free exact rows or "
                    "simplify it",
                    r.resource,
                )
        else:
            exact_flow.append(r)
    rs = RuleSet(
        flow=RT.to_device(RT.compile_flow_rules(exact_flow, cfg, registry), device),
        degrade=RT.to_device(
            RT.compile_degrade_rules(list(degrade_rules), cfg, registry), device
        ),
        param=RT.to_device(
            RT.compile_param_rules(param_rules, cfg, registry, lanes=param_lanes), device
        ),
        auth=RT.to_device(
            RT.compile_authority_rules(list(authority_rules), cfg, registry), device
        ),
        system=RT.to_device(RT.compile_system_rules(list(system_rules), cfg), device),
        tail=RT.to_device(RT.compile_tail_flow_rules(tail, cfg), device),
    )
    # memory ledger: compiled rule tensors are the "rules" pool (the latest
    # compile at this site replaces the previous claim)
    PROF.LEDGER.track("rules", "engine.compile_ruleset", rs)
    return rs


def empty_acquire(cfg: EngineConfig, device, b: Optional[int] = None) -> AcquireBatch:
    b = b or cfg.batch_size
    trash = cfg.trash_row
    wd = WIRE.acquire_wire_dtypes(cfg)

    def z(f):
        return torch.zeros((b,), dtype=wd.get(f, I32), device=device)

    def full(v):
        return torch.full((b,), v, dtype=I32, device=device)

    return AcquireBatch(
        res=full(trash),
        count=z("count"),
        prio=z("prio"),
        origin_id=full(-1),
        origin_node=full(trash),
        ctx_node=full(trash),
        ctx_name=full(-1),
        inbound=z("inbound"),
        param_hash=torch.zeros((b, cfg.param_dims), dtype=I32, device=device),
        pre_verdict=z("pre_verdict"),
    )


def empty_complete(cfg: EngineConfig, device, b: Optional[int] = None) -> CompleteBatch:
    b = b or cfg.complete_batch_size
    trash = cfg.trash_row
    wd = WIRE.complete_wire_dtypes(cfg)

    def z(f):
        return torch.zeros((b,), dtype=wd.get(f, I32), device=device)

    def full(v):
        return torch.full((b,), v, dtype=I32, device=device)

    return CompleteBatch(
        res=full(trash),
        origin_node=full(trash),
        ctx_node=full(trash),
        inbound=z("inbound"),
        rt=torch.zeros((b,), dtype=F32, device=device),
        success=z("success"),
        error=z("error"),
        param_hash=torch.zeros((b, cfg.param_dims), dtype=I32, device=device),
    )


def _clean_rows(cfg: EngineConfig, x: torch.Tensor) -> torch.Tensor:
    """Trash-row lanes → a large out-of-range sentinel so scatters drop
    them (the trash row itself stays zero)."""
    return torch.where(x == cfg.trash_row, 2**30, x)


def _stat_rows(cfg: EngineConfig, res, ctx_node, origin_node, with_nodes: bool):
    if with_nodes:
        return torch.cat(
            [_clean_rows(cfg, res), _clean_rows(cfg, ctx_node), _clean_rows(cfg, origin_node)]
        )
    return _clean_rows(cfg, res)


def _isum(x: torch.Tensor) -> torch.Tensor:
    """int32 sum (wraps like the reference's int32 reductions)."""
    return torch.sum(x, dtype=I32)


def _scatter_with_stat_fan(
    cfg: EngineConfig, other_jobs, res, ctx_node, origin_node, stat_vals,
    stat_digits, with_nodes: bool,
):
    """scatter_many with the stat job first.  The JAX tick picks the fan
    width (1, 2 or 3 row-vectors) at runtime with ``lax.switch``; here the
    widest fan always runs — all-trash row-vectors drop every id, so the
    result is the same without a host decision."""
    if with_nodes:
        rows = torch.stack(
            [_clean_rows(cfg, res), _clean_rows(cfg, ctx_node), _clean_rows(cfg, origin_node)]
        )
    else:
        rows = _clean_rows(cfg, res)[None, :]
    return FU.scatter_many(
        [_rows_job(cfg, FU.Job("stat", cfg.max_nodes, rows, stat_vals, stat_digits))] + other_jobs
    )


# ---------------------------------------------------------------------------
# completions
# ---------------------------------------------------------------------------


def _completion_entry_stats(cfg: EngineConfig, comp: CompleteBatch, valid):
    """(inb, entry_deltas, entry_rt, entry_rt_min) — the global ENTRY-node
    reductions."""
    inb = valid & (comp.inbound > 0)
    z = torch.zeros((), dtype=I32, device=valid.device)
    deltas = [z] * W.NUM_EVENTS
    deltas[W.EV_SUCCESS] = _isum(torch.where(inb, comp.success, 0))
    deltas[W.EV_EXCEPTION] = _isum(torch.where(inb, comp.error, 0))
    entry_deltas = torch.stack(deltas)
    entry_rt = torch.sum(torch.where(inb, comp.rt, 0.0))
    # rt <= 0 means "no RT data" — a sub-ms completion must not collapse
    # the BBR capacity estimate to zero
    entry_rt_min = torch.amin(
        torch.where(inb & (comp.rt > 0), comp.rt, W.RT_MIN_INIT)
    )
    return inb, entry_deltas, entry_rt, entry_rt_min


def _lane_hash(param_hash: torch.Tensor, lane: torch.Tensor, dims: int) -> torch.Tensor:
    """Each row's hash in the lane its rule reads (param_hash [N, dims],
    lane [N]); 0 — "no argument" — where the rule has no lane."""
    picked = torch.gather(param_hash, 1, torch.clamp(lane, 0, dims - 1).to(torch.int64)[:, None])[:, 0]
    return torch.where(lane >= 0, picked, 0)


def _param_release_ctx(cfg: EngineConfig, rules: RuleSet, comp: CompleteBatch, valid):
    """(rel, prows_c, rel_cnt): which completion lanes release THREAD-grade
    param concurrency, their hashed (rule, value) rows, and the release
    counts (ParamFlowSlot.exit: decreaseThreadCount) — shared by both
    completion paths."""
    KPp = cfg.param_rules_per_resource
    res_lp = torch.clamp_max(comp.res, cfg.max_resources)
    pslots = T.big_gather(
        rules.param.res_params, res_lp, cfg.max_resources + 1, max_int=cfg.max_param_rules
    )
    pslots_f = pslots.reshape(-1)
    pgc = T.small_gather_fields(
        T.pack_fields([rules.param.enabled, rules.param.grade, rules.param.lane]), pslots_f
    )
    lane_c = pgc[:, 2].to(I32)
    ph_c = _lane_hash(_fan(comp.param_hash, KPp), lane_c, cfg.param_dims)
    rel = (
        (pgc[:, 0] > 0)
        & (pgc[:, 1].to(I32) == GRADE_THREAD)
        & (ph_c != 0)
        & _fan(valid, KPp)
    )
    prows_c = PM.pair_rows(pslots_f, ph_c, cfg.param_depth, cfg.param_width)
    return rel, prows_c, _fan(comp.success, KPp)


def sketch_jobs(cfg: EngineConfig, res, valid, vals, digits) -> list:
    """The sketch landing as scatter jobs ``sketch{d}``, one per depth row:
    each valid item's value planes at its hashed column of that row
    (ops/param.cms_cell); invalid items drop via row -1."""
    cols = PM.cms_cell(res, cfg.sketch_depth, cfg.sketch_width)
    return [
        _width_job(cfg, FU.Job(f"sketch{d}", cfg.sketch_width, torch.where(valid, cols[:, d], -1)[None, :], vals, digits))
        for d in range(cfg.sketch_depth)
    ]


def land_sketch(cfg: EngineConfig, state: EngineState, now_ms: int, upd, planes, pre_refreshed=False):
    """An int32 [depth, width, len(planes)] sketch delta into the current
    bucket (the completion phase refreshes; the acquire phase, at the same
    ``now_ms``, passes ``pre_refreshed=True``)."""
    return state._replace(
        gs=_sketch(cfg).add_dense(
            state.gs, now_ms, upd, planes, sketch_config(cfg), pre_refreshed=pre_refreshed
        )
    )


def param_release_jobs(cfg: EngineConfig, rules: RuleSet, comp: CompleteBatch, valid) -> list:
    """The THREAD-grade release as scatter jobs ``prel{d}``, one per depth
    row: the KPp rule lanes ride as row-vectors with per-lane release
    counts; lanes that release nothing drop via row -1."""
    b = comp.res.shape[0]
    KPp = cfg.param_rules_per_resource
    rel, prows_c, rel_cnt_f = _param_release_ctx(cfg, rules, comp, valid)
    pr = torch.where(rel[:, None], prows_c, -1).reshape(b, KPp, cfg.param_depth)
    rel_cnt = rel_cnt_f.reshape(b, KPp).T[:, None, :]  # [KPp, 1, B]
    return [
        FU.Job(f"prel{d}", cfg.param_width, pr[:, :, d].T, rel_cnt, (cfg.count_digits,))
        for d in range(cfg.param_depth)
    ]


def param_release_deltas(outs) -> torch.Tensor:
    """The ``prel{d}`` outputs as the int32 [depth, Q] decrement of pconc
    (the landing clamps the difference at zero)."""
    return torch.round(torch.stack([o[:, 0] for o in outs])).to(I32)


def param_effect_jobs(cfg: EngineConfig, acq: AcquireBatch, passed, param_ctx) -> list:
    """Admitted param counts and THREAD concurrency as scatter jobs
    ``param{d}``, one per depth row, two planes each.  The VALUES are
    masked, not the rows (pair_rows cells are always in range)."""
    _pcms, _epochs, _idx, prows, q_add, thread_add = param_ctx
    b = acq.res.shape[0]
    KP = cfg.param_rules_per_resource
    cd = cfg.count_digits
    adm = _fan(passed, KP)
    cnt_p = _fan(acq.count, KP)
    p_vals = torch.stack(
        [torch.where(q_add & adm, cnt_p, 0), torch.where(thread_add & adm, cnt_p, 0)]
    )  # [2, B*KP]
    p_vals_r = p_vals.reshape(2, b, KP).permute(2, 0, 1)  # [KP, 2, B]
    return [
        FU.Job(f"param{d}", cfg.param_width, prows[:, d].reshape(b, KP).T, p_vals_r, (cd, cd))
        for d in range(cfg.param_depth)
    ]


def param_effect_deltas(outs) -> torch.Tensor:
    """The ``param{d}`` outputs as int32 [depth, Q, 2] (admitted counts,
    THREAD concurrency)."""
    return torch.round(torch.stack(list(outs))).to(I32)


def land_param_effects(state: EngineState, param_ctx, upd) -> EngineState:
    """``param_effect_deltas`` into the current pcms bucket and pconc."""
    pcms, pcms_epochs, pcms_idx = param_ctx[:3]
    pcms[:, :, pcms_idx] += upd[:, :, 0]  # refresh returned a fresh tensor
    pconc = torch.clamp_min(state.pconc + upd[:, :, 1], 0)
    return state._replace(pcms=pcms, pcms_epochs=pcms_epochs, pconc=pconc)


def _degrade_completion_masks(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, comp: CompleteBatch,
    valid, now_ms: int,
):
    """Refresh CB columns and derive the per-lane event masks the exit path
    scatters (DegradeSlot.exit:60-75)."""
    KD = cfg.degrade_rules_per_resource
    res_l = torch.clamp_max(comp.res, cfg.max_resources)
    slots = T.big_gather(rules.degrade.res_cbs, res_l, cfg.max_resources + 1)
    slots_f = slots.reshape(-1)
    cb_counts, cb_epochs, cur_idx = D.refresh_columns(
        state.cb_counts, state.cb_epochs, rules.degrade.window_ms, now_ms
    )
    dg = T.small_gather_fields(
        T.pack_fields(
            [
                rules.degrade.enabled,
                rules.degrade.grade,
                rules.degrade.count,
                cur_idx,
                state.cb_state,
            ]
        ),
        slots_f,
    )
    enabled = dg[:, 0] > 0
    g_grade = dg[:, 1].to(I32)
    g_count = dg[:, 2]
    g_idx = dg[:, 3].to(I32)
    active = enabled & _fan(valid, KD)
    is_err = (_fan(comp.error, KD) > 0) & active
    is_slow = (g_grade == D.GRADE_SLOW_RATIO) & (_fan(comp.rt, KD) > g_count) & active
    half_open = dg[:, 4].to(I32) == D.CB_HALF_OPEN
    return slots_f, cb_counts, cb_epochs, active, is_err, is_slow, g_idx, half_open


def _cb_transitions(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, cb_counts, cb_epochs,
    seen, failed, now_ms: int,
):
    """Half-open probe resolution + CLOSED-breaker trip evaluation
    (AbstractCircuitBreaker.java:68-136)."""
    was_half = state.cb_state == D.CB_HALF_OPEN
    to_open = was_half & (seen > 0) & (failed > 0)
    to_close = was_half & (seen > 0) & (failed == 0)
    cb_state = torch.where(to_open, D.CB_OPEN, state.cb_state)
    cb_state = torch.where(to_close, D.CB_CLOSED, cb_state)
    retry_at = rules.degrade.retry_timeout_ms + now_ms
    cb_retry = torch.where(to_open, retry_at, state.cb_retry_ms)
    # closing resets the rule's stat window (fromHalfOpenToClose → resetStat)
    cb_counts = torch.where(to_close[:, None, None], 0, cb_counts)

    sums = D.window_sums(cb_counts, cb_epochs, rules.degrade.window_ms, now_ms)
    trip = D.trip_condition(
        sums,
        rules.degrade.grade,
        rules.degrade.count,
        rules.degrade.slow_ratio,
        rules.degrade.min_request,
    )
    newly_open = (cb_state == D.CB_CLOSED) & trip & rules.degrade.enabled
    cb_state = torch.where(newly_open, D.CB_OPEN, cb_state).to(I32)
    cb_retry = torch.where(newly_open, retry_at, cb_retry).to(I32)
    return cb_counts, cb_state, cb_retry


def _node_hist(cfg: EngineConfig, cols: dict, entry_deltas, device):
    """[node_rows, NUM_EVENTS] int32 histogram: int32 columns by event
    (``max_nodes`` rows from the fused scatters, ``node_rows`` from the
    plain ones), plus the ENTRY-row reduction."""
    hist = torch.zeros((_local_rows(cfg), W.NUM_EVENTS), dtype=I32, device=device)
    for ev, col in cols.items():
        hist[: col.shape[0], ev] = col
    erow = _entry_local(cfg)
    if erow is not None:
        hist[erow] += entry_deltas
    return hist


def _to_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """A per-row delta [m] padded with ``fill`` to the node table's ``n``
    rows (the fused scatters cover ``max_nodes``, the plain ``node_rows``)."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, torch.full((n - x.shape[0],), fill, dtype=x.dtype, device=x.device)])


class CompletionDeltas(NamedTuple):
    """What a completion phase's scatters hand the landing, in one form for
    both branches (per item, ``_completion_scatters_fused``; per segment,
    ``engine_seg.completion_scatters_seg``), so that ``seg_fallback`` can
    select between two of them on the device and land once."""

    succ: torch.Tensor  # int32 [max_nodes] successes per node row ([node_rows] plain)
    err: torch.Tensor  # int32 [max_nodes] exceptions per node row
    rt: torch.Tensor  # float32 [max_nodes] RT sums (ms)
    row_min: tuple  # (float32 [max_nodes] RT minima, bool [max_nodes] present)
    sketch: Optional[torch.Tensor]  # int32 [depth, width, 3] (sketch_stats)
    prel: Optional[torch.Tensor]  # int32 [depth, Q] THREAD-grade release ("param")
    cb: Optional[torch.Tensor]  # int32 [Dn, nbd, 3] breaker columns ("degrade")
    probe: Optional[torch.Tensor]  # int32 [Dn, 2] half-open probes seen / failed


def _completion_scatters_fused(
    cfg: EngineConfig, rules: RuleSet, comp: CompleteBatch, features: frozenset, dg,
) -> CompletionDeltas:
    """The exit path's scatters (StatisticSlot.exit:125-164,
    DegradeSlot.exit:60-75) per item, in ONE scatter_many launch: stat fan,
    per-row RT minimum heads, the sketch, THREAD-grade param release,
    breaker columns and half-open probe flags.  ``dg``: the breaker masks
    (``_degrade_completion_masks``) or None without "degrade"."""
    b = comp.res.shape[0]
    valid = comp.res != cfg.trash_row
    with_nodes = "nodes" in features

    succ_w = torch.where(valid, comp.success, 0)
    err_w = torch.where(valid, comp.error, 0)
    rt1 = torch.where(valid, comp.rt, 0.0)
    # RT quantized to 1/8 ms (round half to even, as the reference)
    rt_q = torch.round(torch.clamp_max(rt1, float(cfg.statistic_max_rt)) * 8.0).to(I32)

    vals3 = torch.stack([succ_w, err_w, rt_q])
    cd = cfg.count_digits
    digits3 = (cd, cd, cfg.rt_digits)

    # exact per-row windowed minRt (ops/rowmin.py): sorted min heads are
    # unique per row, so they land as one extra sum-scatter job
    RMIN = 3 if with_nodes else 1
    min_rows_flat = _stat_rows(cfg, comp.res, comp.ctx_node, comp.origin_node, with_nodes)
    min_rt_flat = rt1.repeat(RMIN) if with_nodes else rt1
    mh_rows, mh_vals = RM.min_heads(
        min_rows_flat, min_rt_flat, torch.ones_like(min_rows_flat, dtype=torch.bool),
        cfg.max_nodes,
    )
    jobs = [
        _rows_job(cfg, FU.Job(
            "rowmin",
            cfg.max_nodes,
            mh_rows.reshape(RMIN, b),
            mh_vals.T.reshape(3, RMIN, b).permute(1, 0, 2),
            (2, 2, 1),
        ))
    ]
    if cfg.sketch_stats:
        jobs += sketch_jobs(cfg, comp.res, valid, vals3, digits3)

    # THREAD-grade param release lanes (the gathers stay plain indexing;
    # only the concurrency scatter rides the kernel)
    with_param = "param" in features
    if with_param:
        jobs += param_release_jobs(cfg, rules, comp, valid)

    if dg is not None:
        KD = cfg.degrade_rules_per_resource
        slots_f, _cb_counts, _cb_epochs, active, is_err, is_slow, g_idx, half_open = dg
        nbd = cfg.cb_sample_count
        Dn = cfg.max_degrade_rules
        # pad slots (slot == Dn) drop via row -1
        flat = torch.where(slots_f < Dn, slots_f * nbd + g_idx, -1)
        cb_vals = torch.stack(
            [active.to(I32), is_err.to(I32), is_slow.to(I32)]
        )  # [3, B*KD]
        jobs.append(
            FU.Job(
                "cb",
                Dn * nbd,
                flat.reshape(b, KD).T,
                cb_vals.reshape(3, b, KD).permute(2, 0, 1),
                (1, 1, 1),
            )
        )
        probe_done = active & half_open
        probe_fail = probe_done & (is_err | is_slow)
        pr_vals = torch.stack([probe_done.to(I32), probe_fail.to(I32)])
        jobs.append(
            FU.Job(
                "probe",
                Dn,
                torch.where(slots_f < Dn, slots_f, -1).reshape(b, KD).T,
                pr_vals.reshape(2, b, KD).permute(2, 0, 1),
                (1, 1),
            )
        )

    outs = _scatter_with_stat_fan(
        cfg, jobs, comp.res, comp.ctx_node, comp.origin_node, vals3, digits3,
        with_nodes,
    )
    stat_out, min_out = outs[0], outs[1]
    oi = 2
    sketch = prel = cb = probe = None
    if cfg.sketch_stats:
        sketch = torch.round(torch.stack(outs[oi : oi + cfg.sketch_depth])).to(I32)  # [depth, width, 3]
        oi += cfg.sketch_depth
    if with_param:
        prel = param_release_deltas(outs[oi : oi + cfg.param_depth])
        oi += cfg.param_depth
    if dg is not None:
        cb = torch.round(outs[oi]).to(I32).reshape(cfg.max_degrade_rules, cfg.cb_sample_count, 3)
        probe = torch.round(outs[oi + 1]).to(I32)
    return CompletionDeltas(
        succ=torch.round(stat_out[:, 0]).to(I32),
        err=torch.round(stat_out[:, 1]).to(I32),
        rt=stat_out[:, 2] / 8.0,
        row_min=RM.combine(min_out),
        sketch=sketch,
        prel=prel,
        cb=cb,
        probe=probe,
    )


def _completion_scatters_plain(
    cfg: EngineConfig, rules: RuleSet, comp: CompleteBatch, features: frozenset, dg,
) -> CompletionDeltas:
    """The exit path's scatters on the plain path (the reference's
    ``_process_completions``): the same deltas as
    ``_completion_scatters_fused``, from indexed scatters over the whole
    node table (ops/tables.py).  The RT sums are the raw float sums —
    quantized to 1/8 ms, as the reference's one-hot histogram quantizes
    them, only under ``use_mxu_tables`` — and the per-row RT minimum is a
    scatter-min over the positive RTs.  Successes and errors are exact at
    any count (no digit envelope)."""
    valid = comp.res != cfg.trash_row
    with_nodes = "nodes" in features
    fan = 3 if with_nodes else 1
    n = cfg.node_rows
    rows = _stat_rows(cfg, comp.res, comp.ctx_node, comp.origin_node, with_nodes)
    succ_w = torch.where(valid, comp.success, 0).to(I32)
    err_w = torch.where(valid, comp.error, 0).to(I32)
    rt1 = torch.where(valid, comp.rt, 0.0)
    counts = T.histogram(rows, torch.stack([succ_w, err_w], dim=1).repeat(fan, 1), n, sharded=True)
    if cfg.use_mxu_tables:
        rt_q = torch.round(torch.clamp_max(rt1, float(cfg.statistic_max_rt)) * 8.0).to(I32)
        rt = T.histogram(rows, rt_q.repeat(fan), n, sharded=True).to(F32) / 8.0
    else:
        rt = T.histogram(rows, rt1.repeat(fan), n, sharded=True)
    rt_for_min = torch.where(rt1 > 0, rt1, W.RT_MIN_INIT).repeat(fan)
    ctx = CL.current()
    if ctx is not None:
        rows = CL.local_ids(ctx, rows, n)
        n = _local_rows(cfg)
    mins = T.small_scatter_max(
        torch.full((n,), -W.RT_MIN_INIT, dtype=F32, device=rt1.device), rows, -rt_for_min
    )
    mins = -mins
    sketch = prel = cb = probe = None
    if cfg.sketch_stats:
        rt_q = torch.round(torch.clamp_max(comp.rt, float(cfg.statistic_max_rt)) * GS.RT_SCALE).to(I32)
        vals = torch.stack([comp.success.to(I32), comp.error.to(I32), rt_q], dim=1)
        cols = PM.cms_cell(comp.res, cfg.sketch_depth, cfg.sketch_width)
        sketch = GS.depth_histogram(cols, vals, valid, cfg.sketch_depth, cfg.sketch_width, sharded=True)
    if "param" in features:
        rel, prows_c, rel_cnt = _param_release_ctx(cfg, rules, comp, valid)
        prel = torch.stack([
            T.histogram(torch.where(rel, prows_c[:, d], -1), rel_cnt.to(I32), cfg.param_width)
            for d in range(cfg.param_depth)
        ])
    if dg is not None:
        slots_f, _cb_counts, _cb_epochs, active, is_err, is_slow, g_idx, half_open = dg
        nbd = cfg.cb_sample_count
        Dn = cfg.max_degrade_rules
        # pad slots (slot == Dn) are never enabled, so they land nothing
        flat = torch.where(slots_f < Dn, slots_f * nbd + g_idx, -1)
        upd = torch.stack([active.to(I32), is_err.to(I32), is_slow.to(I32)], dim=1)
        cb = T.histogram(flat, upd, Dn * nbd).reshape(Dn, nbd, 3)
        probe_done = active & half_open
        probe_fail = probe_done & (is_err | is_slow)
        probe = T.histogram(
            torch.where(slots_f < Dn, slots_f, -1),
            torch.stack([probe_done.to(I32), probe_fail.to(I32)], dim=1),
            Dn,
        )
    return CompletionDeltas(
        succ=counts[:, 0], err=counts[:, 1], rt=rt,
        row_min=(mins, torch.ones((n,), dtype=torch.bool, device=mins.device)),
        sketch=sketch, prel=prel, cb=cb, probe=probe,
    )


def _land_completions(
    cfg: EngineConfig,
    state: EngineState,
    rules: RuleSet,
    comp: CompleteBatch,
    now_ms: int,
    d: CompletionDeltas,
    dg,
) -> EngineState:
    """Land one completion phase's deltas: the windows (the tick's ONE
    refresh per window), the ENTRY row's reductions, the RT quantiles, the
    sketch, concurrency, the param release and the breakers (refreshed
    columns from ``dg``, then the transitions)."""
    dev = comp.res.device
    valid = comp.res != cfg.trash_row
    sec_cfg, min_cfg = _sec_cfg(cfg), _min_cfg(cfg)
    erow = cfg.entry_node_row
    n = _local_rows(cfg)
    inb, entry_deltas, entry_rt, entry_rt_min = _completion_entry_stats(cfg, comp, valid)
    if d.prel is not None:
        state = state._replace(pconc=torch.clamp_min(state.pconc - d.prel, 0))

    hist = _node_hist(cfg, {W.EV_SUCCESS: d.succ, W.EV_EXCEPTION: d.err}, entry_deltas, dev)
    rt_hist = _to_rows(d.rt, n, 0.0)
    e_loc = _entry_local(cfg)
    if e_loc is not None:
        if rt_hist is d.rt:
            rt_hist = rt_hist.clone()  # written below: never the branch's own delta
        rt_hist[e_loc] += entry_rt
    mins_m, present_m = d.row_min
    row_min = (_to_rows(mins_m, n, W.RT_MIN_INIT), _to_rows(present_m, n, False))
    # the tick's ONE refresh per window: every later landing at this
    # now_ms passes refreshed=True
    win_sec = W.add_dense(state.win_sec, now_ms, hist, rt_hist, sec_cfg, row_min=row_min)
    win_sec = W.min_into_row(win_sec, now_ms, erow, entry_rt_min, sec_cfg)
    win_min = state.win_min
    if cfg.enable_minute_window:
        win_min = W.add_dense(state.win_min, now_ms, hist, rt_hist, min_cfg, row_min=row_min)
    state = state._replace(win_sec=win_sec, win_min=win_min)
    state = state._replace(
        rtq=RQ.add(state.rtq, now_ms, comp.rt, inb & (comp.rt > 0), rtq_config(cfg))
    )
    if d.sketch is not None:
        state = land_sketch(cfg, state, now_ms, d.sketch, (W.EV_SUCCESS, W.EV_EXCEPTION, GS.RT_PLANE))
    concurrency = torch.clamp_min(state.concurrency - hist[:, W.EV_SUCCESS], 0)

    if dg is None:
        return state._replace(concurrency=concurrency)

    _slots_f, cb_counts, cb_epochs = dg[:3]
    cb_counts[: cfg.max_degrade_rules] += d.cb  # refresh_columns returned a fresh tensor
    sf = torch.cat([d.probe, torch.zeros((1, 2), dtype=I32, device=dev)])  # pad row back to Dn + 1
    cb_counts, cb_state, cb_retry = _cb_transitions(
        cfg, state, rules, cb_counts, cb_epochs, sf[:, 0], sf[:, 1], now_ms
    )
    return state._replace(
        concurrency=concurrency,
        cb_counts=cb_counts,
        cb_epochs=cb_epochs,
        cb_state=cb_state,
        cb_retry_ms=cb_retry,
    )


# ---------------------------------------------------------------------------
# per-second syncs
# ---------------------------------------------------------------------------


def _fold_occupied(cfg: EngineConfig, state: EngineState, now_ms: int) -> EngineState:
    """Borrowed-ahead tokens whose target bucket has arrived land as PASS
    in the current column of their node row (OccupiableBucketLeapArray).
    The JAX tick gates this with ``lax.cond`` on any-due; landing a zero
    delta is the identity (the column was refreshed at this ``now_ms``
    already), so the fold always runs here."""
    cur_wid = W.wid_of(now_ms, cfg.second_window_ms)
    due = ((cur_wid - state.occ_epoch) >= 0) & (state.occ_tokens > 0)
    chargeable = due & ((cur_wid - state.occ_epoch) < cfg.second_sample_count)
    tok = torch.round(torch.where(chargeable, state.occ_tokens, 0.0)).to(I32)
    delta = torch.zeros((_local_rows(cfg), W.NUM_EVENTS), dtype=I32, device=tok.device)
    delta[:, W.EV_PASS] = tok
    win_sec = W.add_dense(state.win_sec, now_ms, delta, None, _sec_cfg(cfg), refreshed=True)
    win_min = state.win_min
    if cfg.enable_minute_window:
        win_min = W.add_dense(state.win_min, now_ms, delta, None, _min_cfg(cfg), refreshed=True)
    return state._replace(
        win_sec=win_sec,
        win_min=win_min,
        occ_tokens=torch.where(due, 0.0, state.occ_tokens),
    )


def _sync_warmup(cfg: EngineConfig, state: EngineState, rules: RuleSet, now_ms: int):
    """Per-second warm-up token refill over all flow rules
    (WarmUpController.syncToken/coolDownTokens)."""
    f = rules.flow
    cur_s = int(now_ms) // 1000  # floor division, as jnp's ``//``
    is_warm = (
        (f.behavior == CONTROL_WARM_UP) | (f.behavior == CONTROL_WARM_UP_RATE_LIMITER)
    ) & f.enabled
    elapsed = cur_s - state.warmup_last_s
    first = state.warmup_last_s < 0
    sync_time = (elapsed > 0) | first
    do_sync = is_warm & sync_time
    pass_qps = torch.where(elapsed == 1, state.warm_acc, 0.0)

    tokens = state.warmup_tokens
    refill_ok = (tokens < f.warning_token) | (
        pass_qps < f.count / torch.clamp_min(f.cold_factor, 1.0)
    )
    dt = torch.where(first, 1.0, torch.clamp_max(elapsed.to(F32), 1.0e6))
    grown = torch.minimum(tokens + dt * f.count, f.max_token)
    new_tokens = torch.where(refill_ok, grown, tokens)
    new_tokens = torch.where(first & is_warm, f.max_token, new_tokens)
    new_tokens = torch.clamp_min(new_tokens - pass_qps, 0.0)

    tokens = torch.where(do_sync, new_tokens, tokens)
    last_s = torch.where(sync_time, cur_s, state.warmup_last_s).to(I32)
    warm_acc = torch.where(sync_time, 0.0, state.warm_acc)
    return state._replace(warmup_tokens=tokens, warmup_last_s=last_s, warm_acc=warm_acc)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _check_authority(cfg: EngineConfig, rules: RuleSet, acq: AcquireBatch):
    """AuthoritySlot: origin allow/deny (AuthorityRuleChecker.java:28-54)."""
    res_l = torch.clamp_max(acq.res, cfg.max_resources)
    n = cfg.max_resources + 1
    mode = T.big_gather(rules.auth.mode, res_l, n)
    origins = T.big_gather(rules.auth.origins, res_l, n)
    listed = ((origins == acq.origin_id[:, None]) & (origins != RT.AUTH_EMPTY)).any(dim=1)
    return ((mode == 1) & ~listed) | ((mode == 2) & listed)


def _check_system(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, acq: AcquireBatch,
    now_ms: int, sys_load: float, sys_cpu: float, eligible,
):
    """SystemSlot: global inbound-only adaptive gate incl. the BBR check
    (SystemRuleManager.checkSystem / checkBbr)."""
    win = state.win_sec
    ec, ert, conc_e, counts_e, min_rt = _entry_row(
        cfg, (win.run, win.run_rt, state.concurrency, win.counts, win.run_rt_min)
    )
    e_pass = ec[W.EV_PASS].to(F32)
    e_succ = ec[W.EV_SUCCESS].to(F32)
    e_rt_avg = torch.where(e_succ > 0, ert / torch.clamp_min(e_succ, 1.0), 0.0)
    e_conc = conc_e.to(F32)
    mask = W.valid_mask(state.win_sec, now_ms, _sec_cfg(cfg))
    bucket_succ = counts_e[:, W.EV_SUCCESS]
    max_succ_qps = (
        torch.amax(torch.where(mask, bucket_succ, 0)).to(F32) * cfg.second_sample_count
    )

    inbound = (acq.inbound > 0) & eligible
    cnt = acq.count.to(F32)
    # single group (the ENTRY node): a plain exclusive prefix sum.  Fused
    # path: int32, exact (counts clamp to max_batch_count, so the total
    # stays < 2^31).  Plain path: counts run to 65,535 and an int32 total
    # could wrap negative and admit the batch; float32 is monotone under
    # positive addends — inexact past 2^24, but it never un-blocks
    vim_i = torch.where(inbound, acq.count, 0)
    if _use_fused(cfg):
        rank_q = (torch.cumsum(vim_i, dim=0, dtype=I32) - vim_i).to(F32)
    else:
        vim_f = vim_i.to(F32)
        rank_q = torch.cumsum(vim_f, dim=0) - vim_f
    rank_t = rank_q

    s = rules.system
    blk = (s.qps >= 0) & (e_pass + rank_q + cnt > s.qps)
    blk = blk | ((s.max_thread >= 0) & (e_conc + rank_t + 1 > s.max_thread))
    blk = blk | ((s.avg_rt >= 0) & (e_rt_avg > s.avg_rt))
    bbr_ok = (e_conc + rank_t + 1) <= torch.clamp_min(max_succ_qps * min_rt / 1000.0, 1.0)
    blk = blk | ((s.load >= 0) & (sys_load > s.load) & ~bbr_ok)
    blk = blk | ((s.cpu >= 0) & (sys_cpu > s.cpu))
    return blk & inbound


def fold_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement wrap, as
    the reference's int32 arithmetic wraps)."""
    lo = x & 0xFFFFFFFF
    return torch.where(lo >= (1 << 31), lo - (1 << 32), lo).to(I32)  # stlint: disable=dtype-overflow — the deliberate two's-complement wrap of the reference's int32 arithmetic


def param_verdicts(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, pcms, pcms_epochs,
    now_ms: int, slots, ph, cls, is_thread, thr, item_hash, item_thr, cnt,
    elig, key_mult: int, fused: bool = True,
):
    """The item-level half of the param check, shared by the per-item and
    the segment phases: hashed rows, windowed / concurrency estimates,
    per-value exception thresholds, the within-tick rank, and the
    over-threshold mask.  Every argument is per (item, rule lane) [N];
    ``item_hash`` / ``item_thr`` are [N, KI].  ``fused``: the flat table
    read of the fused path, else the plain path's class-table read (the
    same values).  Returns (prows, over)."""
    prows = PM.pair_rows(slots, ph, cfg.param_depth, cfg.param_width)  # [N, depth]
    wtab = PM.class_tables(pcms, pcms_epochs, rules.param.class_k, now_ms, cfg)
    est = (PM.estimate_fused if fused else PM.estimate)(cfg, wtab, prows, cls)
    # the reference reads pconc only when a THREAD-grade rule exists
    # (lax.cond); without one no lane is THREAD-grade, so the estimate is
    # never selected below and reading it always is the same
    conc_est = PM.conc_estimate(cfg, state.pconc, prows)
    # per-value exception items: hashes are raw int32 bits compared for
    # equality; hash 0 means "no item"
    is_item = (item_hash == ph[:, None]) & (item_hash != 0)
    thr = torch.where(
        is_item.any(dim=1), torch.amax(torch.where(is_item, item_thr, 0.0), dim=1), thr
    )
    # within-tick rank keyed by the exact (value, rule) pair — the int32
    # wrap of the mix only ever MERGES groups, which over-counts
    # conservatively
    key = fold_i32(ph.to(torch.int64) * key_mult + slots.to(torch.int64))
    (rank,) = grouped_exclusive_cumsum(key, [cnt], elig)
    over = torch.where(is_thread, conc_est, est) + rank + cnt > thr
    return prows, over


def _check_param(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, acq: AcquireBatch,
    now_ms: int, eligible,
):
    """ParamFlowSlot: per-parameter-value limiting over hashed rows
    (ParamFlowChecker.passLocalCheck:78-188 — QPS grade as a windowed
    budget, THREAD grade as per-value concurrency; paramIdx dispatch via
    per-resource hash lanes).

    Returns (blocked[B], pcms, pcms_epochs, cur_idx, prows, qps_add_mask,
    thread_add_mask)."""
    KP = cfg.param_rules_per_resource
    b = acq.res.shape[0]
    res_l = torch.clamp_max(acq.res, cfg.max_resources)
    slots = T.big_gather(
        rules.param.res_params, res_l, cfg.max_resources + 1, max_int=cfg.max_param_rules
    )
    slots_f = slots.reshape(-1)

    pcms, pcms_epochs, cur_idx = PM.refresh(state.pcms, state.pcms_epochs, now_ms, cfg)

    pg = T.small_gather_fields(
        T.pack_fields(
            [
                rules.param.enabled,
                rules.param.threshold,
                rules.param.grade,
                rules.param.cls,
                rules.param.lane,
            ]
        ),
        slots_f,
    )
    enabled = pg[:, 0] > 0
    grade = pg[:, 2].to(I32)
    cls = pg[:, 3].to(I32)
    lane = pg[:, 4].to(I32)
    # the rule's param_idx was lane-assigned at compile; pick that hash
    ph = _lane_hash(_fan(acq.param_hash, KP), lane, cfg.param_dims)
    applicable = enabled & (ph != 0)
    is_thread = grade == GRADE_THREAD
    cnt = _fan(acq.count, KP).to(F32)
    elig_f = _fan(eligible, KP) & applicable
    prows, over = param_verdicts(
        cfg, state, rules, pcms, pcms_epochs, now_ms, slots_f, ph, cls, is_thread,
        pg[:, 1], T.small_gather_int(rules.param.item_hash, slots_f),
        T.small_gather_fields(rules.param.item_threshold, slots_f), cnt, elig_f, KP + 1,
        fused=_use_fused(cfg),
    )
    blocked = (applicable & over & elig_f).reshape(b, KP).any(dim=1)
    return blocked, pcms, pcms_epochs, cur_idx, prows, applicable & ~is_thread, applicable & is_thread


def flow_read_job(state: EngineState, node_safe: torch.Tensor, cur_wid: int) -> FU.GatherJob:
    """The per-item flow check's one gather at each item's node row: the
    windowed pass total (``win_sec.run[:, EV_PASS]``, read at its stride),
    the concurrency, and the occupy borrow pool booked against the NEXT
    bucket (``occ_tokens`` rounded, counted only where ``occ_epoch`` is
    ``cur_wid + 1`` as the reference's int32 arithmetic wraps it), each
    capped at 2^24 - 1 and read as 3 digits.  No dense table is built."""
    cap = (1 << 24) - 1
    return FU.GatherJob("wsum", node_safe, (
        FU.GatherColumn(W.window_event_run(state.win_sec, W.EV_PASS), cap),
        FU.GatherColumn(state.concurrency, cap),
        FU.GatherColumn(state.occ_tokens, cap, state.occ_epoch, W.i32(cur_wid + 1)),
    ), (3, 3, 3))


def _check_flow(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, acq: AcquireBatch,
    now_ms: int, eligible, occupy: bool = True,
):
    """FlowSlot: per-resource QPS/thread limiting with the three traffic
    shapers (FlowRuleChecker.java:42-176) plus prioritized occupy-ahead
    (DefaultController.java:49-68).  Returns (blocked[B], wait_ms[B],
    occupying[B], occ_grant, slots_f, (rl_ok, cost))."""
    K = cfg.flow_rules_per_resource
    b = acq.res.shape[0]
    f = rules.flow

    res_l = torch.clamp_max(acq.res, cfg.max_resources)
    slots = T.big_gather(f.res_rules, res_l, cfg.max_resources + 1)  # [B, K]
    slots_f = slots.reshape(-1)

    fg = T.small_gather_fields(
        T.pack_fields(
            [
                f.enabled,  # 0
                f.limit_app,  # 1
                f.strategy,  # 2
                f.ref_node,  # 3
                f.ref_ctx,  # 4
                f.grade,  # 5
                f.count,  # 6
                f.behavior,  # 7
                f.max_queue_ms,  # 8
                f.warning_token,  # 9
                f.slope,  # 10
                state.warmup_tokens,  # 11
            ]
        ),
        slots_f,
    )
    # latestPassedTime is absolute engine-ms: gathered as an exact int
    latest_g = T.small_gather_int(
        W.f32_to_i32(torch.round(state.latest_passed_ms)), slots_f
    ).to(F32)
    enabled = fg[:, 0] > 0
    la = fg[:, 1].to(I32)
    origin = _fan(acq.origin_id, K)
    la_all = la.reshape(b, K)
    named = ((la_all >= 0) & (la_all == acq.origin_id[:, None])).any(dim=1)
    match = (
        (la == RT.LIMIT_ANY)
        | ((la >= 0) & (la == origin))
        | ((la == RT.LIMIT_OTHER) & (origin >= 0) & ~_fan(named, K))
    )
    applicable = enabled & match

    # node selection (FlowRuleChecker.selectNodeByRequesterAndStrategy:115)
    strategy = fg[:, 2].to(I32)
    ref_node = fg[:, 3].to(I32)
    ref_ctx = fg[:, 4].to(I32)
    direct_node = torch.where(la == RT.LIMIT_ANY, _fan(acq.res, K), _fan(acq.origin_node, K))
    chain_ok = (ref_ctx >= 0) & (ref_ctx == _fan(acq.ctx_name, K))
    chain_node = torch.where(chain_ok, _fan(acq.ctx_node, K), -1)
    node = torch.where(
        strategy == STRATEGY_DIRECT,
        direct_node,
        torch.where(strategy == STRATEGY_RELATE, ref_node, chain_node),
    )
    node_ok = (node >= 0) & (node != cfg.trash_row)
    applicable = applicable & node_ok
    node_safe = torch.where(node_ok, node, cfg.trash_row).to(I32)

    grade = fg[:, 5].to(I32)
    rcount = fg[:, 6]
    behavior = torch.where(grade == GRADE_QPS, fg[:, 7].to(I32), CONTROL_DEFAULT)
    cnt = _fan(acq.count, K).to(F32)

    # per-entry warm-up threshold (WarmUpController.canPass)
    rest = fg[:, 11]
    warning = fg[:, 9]
    above = torch.clamp_min(rest - warning, 0.0)
    warm_qps = torch.floor(
        1.0 / (above * fg[:, 10] + 1.0 / torch.clamp_min(rcount, 1e-9)) + 0.5
    )
    warm_qps = torch.where(rest >= warning, warm_qps, rcount)

    is_warm = (behavior == CONTROL_WARM_UP) | (behavior == CONTROL_WARM_UP_RATE_LIMITER)
    is_rl = (behavior == CONTROL_RATE_LIMITER) | (behavior == CONTROL_WARM_UP_RATE_LIMITER)
    pace_qps = torch.where(
        behavior == CONTROL_WARM_UP_RATE_LIMITER, warm_qps, torch.clamp_min(rcount, 1e-9)
    )
    cost = torch.where(
        is_rl,
        torch.clamp_max(torch.floor(1000.0 * cnt / pace_qps + 0.5), float((1 << 24) - 1)),
        0.0,
    )

    # within-tick ranks (key: decision node; RL keys by rule slot)
    key = torch.where(is_rl, cfg.node_rows + slots_f, node_safe)
    elig_f = _fan(eligible, K) & applicable
    rank_tok, rank_thr, rank_cost = grouped_exclusive_cumsum(
        key, [cnt, torch.ones_like(cnt), cost], elig_f
    )

    # the (windowed pass, concurrency, borrow pool) triple at each item's
    # node row: ONE gather kernel launch on the fused path (each capped at
    # 2^24 - 1), plain uncapped gathers on the plain path (the borrow pool
    # rounded under use_mxu_tables, as the reference's int table holds it)
    cur_wid = W.wid_of(now_ms, cfg.second_window_ms)
    sharded = CL.current() is not None
    if _use_fused(cfg):
        (both,) = FU.gather_many([FU.gather_on_shard(flow_read_job(state, node_safe, cur_wid), cfg.node_rows)])
        if sharded:
            both = CL.all_reduce(both)
        wp = both[:, 0]
        conc = both[:, 1]
        pool = both[:, 2]
    else:
        # a sketch id (>= node_rows) has no exact row: clamped into the
        # table, as the reference's gathers clamp an out-of-range index
        # (its item is not applicable, so what it reads never decides)
        node_l = torch.clamp(node_safe.to(torch.int64), 0, cfg.node_rows - 1)
        pool_dense = torch.where(state.occ_epoch == W.i32(cur_wid + 1), state.occ_tokens, 0.0)
        if cfg.use_mxu_tables:
            pool_dense = torch.round(pool_dense)
        if sharded:
            wp, conc, pool = _read_node_rows(
                cfg, (W.window_event_run(state.win_sec, W.EV_PASS), state.concurrency, pool_dense), node_l
            )
        else:
            wp = W.gather_window_event_run(state.win_sec, node_l, W.EV_PASS).to(F32)
            conc = state.concurrency[node_l].to(F32)
            pool = pool_dense[node_l]

    # DefaultController.canPass:31-49
    thr_eff = torch.where(is_warm, warm_qps, rcount)
    qps_block = wp + rank_tok + cnt > thr_eff
    thread_block = conc + rank_thr + cnt > rcount
    basic_block = torch.where(grade == GRADE_QPS, qps_block, thread_block)

    # RateLimiterController.canPass:50-105 (exact batched leaky bucket)
    now_f = float(now_ms)
    csum_incl = rank_cost + cost
    expected = torch.maximum(latest_g + csum_incl, now_f + csum_incl - cost)
    wait = expected - now_f
    rl_block = wait > fg[:, 8]

    entry_block = torch.where(is_rl, rl_block, basic_block) & applicable
    entry_block = entry_block | (
        (behavior == CONTROL_WARM_UP_RATE_LIMITER) & applicable & qps_block
    )
    blocked = (entry_block & elig_f).reshape(b, K).any(dim=1)

    # prioritized occupy-ahead (DefaultController.canPass:49-68)
    occupying = torch.zeros((b,), dtype=torch.bool, device=acq.res.device)
    occ_wait = torch.zeros((b,), dtype=F32, device=acq.res.device)
    occ_grant = None
    if occupy:
        cand = (
            (_fan(acq.prio, K) > 0)
            & (behavior == CONTROL_DEFAULT)
            & (grade == GRADE_QPS)
            & applicable
            & elig_f
            & qps_block
        )
        # the JAX tick skips this rank with lax.cond when no item is a
        # candidate; with no candidate every grant is False either way
        (rank_occ,) = grouped_exclusive_cumsum(node_safe, [cnt], cand)
        granted = cand & (pool + rank_occ + cnt <= rcount)  # maxOccupyRatio=1
        still_blocked = (entry_block & ~granted & elig_f).reshape(b, K).any(dim=1)
        occupying = (granted & elig_f).reshape(b, K).any(dim=1) & ~still_blocked
        blocked = still_blocked
        occ_wait_v = float(cfg.second_window_ms - (now_ms % cfg.second_window_ms))
        occ_wait = torch.where(occupying, occ_wait_v, 0.0)
        # book ONE lane per item (first granted)
        grant_mtx = (granted & elig_f).reshape(b, K)
        first_lane = grant_mtx & (torch.cumsum(grant_mtx.to(I32), dim=1) == 1)
        occ_grant = (first_lane.reshape(-1), node_safe, cnt)

    rl_ok = is_rl & applicable & ~entry_block & elig_f & ~_fan(blocked, K)
    wait_ms_entry = torch.where(rl_ok, torch.clamp_min(wait, 0.0), 0.0)
    wait_ms = torch.maximum(torch.amax(wait_ms_entry.reshape(b, K), dim=1), occ_wait)
    return blocked, wait_ms.to(I32), occupying, occ_grant, slots_f, (rl_ok, cost)


def _apply_latest(latest_passed_ms, T_s, n_s, now_ms: int):
    """Closed-form latestPassedTime advance from per-slot (cost, count)
    sums (the JAX engine's _apply_latest)."""
    mean_cost = T_s / torch.clamp_min(n_s, 1.0)
    cand = torch.maximum(latest_passed_ms + T_s, float(now_ms) + T_s - mean_cost)
    return torch.where(n_s > 0, cand, latest_passed_ms)


def tail_thresholds(cfg: EngineConfig, rules: RuleSet, cols, tail):
    """float32 [N]: each item's tail-rule threshold, the max over depth of
    its hashed cells (``rules.tail.thr`` at ``cols``, the items' int32
    [N, depth] hashed columns); TAIL_UNRULED where ``tail`` is False.  One
    gather across all depths (tables.depth_gather_1col)."""
    t = T.depth_gather_1col(rules.tail.thr, cols, cfg.sketch_width)
    return torch.amax(torch.where(tail[None, :], t, RT.TAIL_UNRULED), dim=0)


def _check_tail_flow(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, acq: AcquireBatch,
    now_ms: int, eligible,
):
    """Approximate QPS enforcement for SKETCH-TAIL resources (ids past the
    exact row space): the sketch's windowed pass estimate plus the
    within-tick rank against the depth-hashed thresholds
    (rule_tensors.TailFlowTensors; FlowRuleChecker.java:85 with bounded
    approximation).  The reference skips the stage with ``lax.cond`` when
    no tail rule exists or no item is eligible; then no item is ruled, so
    the always-run computation gives all-False too."""
    elig = eligible & (acq.res >= cfg.node_rows)
    cols = PM.cms_cell(acq.res, cfg.sketch_depth, cfg.sketch_width)
    thr = tail_thresholds(cfg, rules, cols, elig)
    ruled = elig & (thr < RT.TAIL_UNRULED / 2)
    est = _sketch(cfg).estimate_plane_mxu(
        state.gs, now_ms, acq.res, W.EV_PASS, sketch_config(cfg), cols=cols
    )
    cnt = acq.count.to(F32)
    # within-tick arrival rank keyed by the exact tail id (sort-based: the
    # id space is the sketch capacity)
    (rank,) = grouped_exclusive_cumsum(acq.res, [cnt], ruled)
    return ruled & (est + rank + cnt > thr)


def _check_degrade(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, acq: AcquireBatch,
    now_ms: int, eligible,
):
    """DegradeSlot entry: CB gate + half-open probe election
    (DegradeSlot.java:37-53).  Returns (blocked[B], new_cb_state).  The
    probe rank and the OPEN→HALF_OPEN flip always run (the JAX tick skips
    them with lax.cond when nothing is due; the results are the same)."""
    KD = cfg.degrade_rules_per_resource
    b = acq.res.shape[0]
    res_l = torch.clamp_max(acq.res, cfg.max_resources)
    slots = T.big_gather(rules.degrade.res_cbs, res_l, cfg.max_resources + 1)
    slots_f = slots.reshape(-1)
    dg = T.small_gather_fields(
        T.pack_fields([rules.degrade.enabled, state.cb_state]), slots_f
    )
    enabled = dg[:, 0] > 0
    st = dg[:, 1].to(I32)
    retry_due = now_ms >= T.small_gather_int(state.cb_retry_ms, slots_f)
    open_wait = (st == D.CB_OPEN) & ~retry_due
    open_due = (st == D.CB_OPEN) & retry_due
    half = st == D.CB_HALF_OPEN

    probe_cand = open_due & enabled & _fan(eligible, KD)
    slot_key = torch.clamp_max(slots_f, cfg.max_degrade_rules)
    (p_rank,) = grouped_exclusive_cumsum(
        slot_key, [torch.ones_like(slots_f, dtype=F32)], probe_cand
    )
    probe = probe_cand & (p_rank < 0.5)

    entry_block = enabled & (open_wait | (open_due & ~probe) | half)
    blocked = (entry_block & _fan(eligible, KD)).reshape(b, KD).any(dim=1)

    probe_ok = probe & ~_fan(blocked, KD)
    flip = T.small_scatter_or(
        torch.zeros((cfg.max_degrade_rules + 1,), dtype=I32, device=slots_f.device),
        slot_key,
        probe_ok,
    )
    cb_state = torch.where(
        (flip > 0) & (state.cb_state == D.CB_OPEN), D.CB_HALF_OPEN, state.cb_state
    ).to(I32)
    return blocked, cb_state


def _run_checks_plain(
    cfg: EngineConfig, state: EngineState, rules: RuleSet, acq: AcquireBatch,
    now_ms: int, sys_load: float, sys_cpu: float, valid, forced, features: frozenset,
):
    """The per-item check phase (Authority -> System -> ParamFlow -> Flow
    (+tail) -> Degrade, first-fail order).  Returns (auth_block, sys_block,
    param_block, param_state, flow_block, wait_ms, occupying, occ_grant,
    fslots, rl_info, degrade_block, cb_state), with param_state = (pcms,
    pcms_epochs, pcms_idx, prows, qps_add, thread_add) or None, and every
    *_block masked by its stage's eligibility."""
    b = acq.res.shape[0]
    zero_block = torch.zeros((b,), dtype=torch.bool, device=acq.res.device)

    if "authority" in features:
        auth_block = _check_authority(cfg, rules, acq) & valid & ~forced
    else:
        auth_block = zero_block
    eligible = valid & ~auth_block & ~forced

    if "system" in features:
        sys_block = _check_system(cfg, state, rules, acq, now_ms, sys_load, sys_cpu, eligible)
    else:
        sys_block = zero_block
    eligible = eligible & ~sys_block

    if "param" in features:
        param_block, *param_state = _check_param(cfg, state, rules, acq, now_ms, eligible)
        param_block = param_block & eligible
        param_state = tuple(param_state)
    else:
        param_block = zero_block
        param_state = None
    eligible = eligible & ~param_block

    if "flow" in features:
        flow_block, wait_ms, occupying, occ_grant, fslots, rl_info = _check_flow(
            cfg, state, rules, acq, now_ms, eligible, occupy="occupy" in features
        )
        flow_block = flow_block & eligible
        occupying = occupying & eligible
    else:
        flow_block = zero_block
        occupying = zero_block
        occ_grant = fslots = rl_info = None
        wait_ms = torch.zeros((b,), dtype=I32, device=acq.res.device)
    if "tail_flow" in features and cfg.sketch_stats:
        tail_block = _check_tail_flow(cfg, state, rules, acq, now_ms, eligible)
        flow_block = flow_block | (tail_block & eligible)
    eligible = eligible & ~flow_block

    if "degrade" in features:
        degrade_block, cb_state = _check_degrade(cfg, state, rules, acq, now_ms, eligible)
        degrade_block = degrade_block & eligible
    else:
        degrade_block = zero_block
        cb_state = state.cb_state
    return (
        auth_block, sys_block, param_block, param_state, flow_block, wait_ms,
        occupying, occ_grant, fslots, rl_info, degrade_block, cb_state,
    )


# ---------------------------------------------------------------------------
# acquire effects
# ---------------------------------------------------------------------------


def _acquire_entry_stats(cfg: EngineConfig, acq: AcquireBatch, valid, passed, occupying):
    """(pass_c, block_c, occ_c, entry_deltas) — the acquire-side stat
    planes and the ENTRY-node reductions (StatisticSlot.java:54-123)."""
    pass_c = torch.where(passed & ~occupying, acq.count, 0)
    block_c = torch.where(valid & ~passed, acq.count, 0)
    occ_c = torch.where(occupying, acq.count, 0)
    inb = valid & (acq.inbound > 0)
    z = torch.zeros((), dtype=I32, device=valid.device)
    deltas = [z] * W.NUM_EVENTS
    deltas[W.EV_PASS] = _isum(torch.where(inb & passed & ~occupying, acq.count, 0))
    deltas[W.EV_OCCUPIED] = _isum(torch.where(inb & occupying, acq.count, 0))
    deltas[W.EV_BLOCK] = _isum(torch.where(inb & ~passed, acq.count, 0))
    return pass_c, block_c, occ_c, torch.stack(deltas)


class AcquireDeltas(NamedTuple):
    """What an acquire effects phase's scatters hand the landing, in one
    form for both branches (per item, ``_acquire_scatters_fused``; per
    segment, ``engine_seg.acquire_scatters_seg``)."""

    pas: torch.Tensor  # int32 [max_nodes] admitted (not occupying) counts
    blk: torch.Tensor  # int32 [max_nodes] blocked counts
    occ: torch.Tensor  # int32 [max_nodes] occupy-ahead counts
    sketch: Optional[torch.Tensor]  # int32 [depth, width, 2] (sketch_stats)
    warm: Optional[torch.Tensor]  # float32 [F] warm-up drain ("warmup")
    latest: Optional[tuple]  # (float32 [F] cost sums, float32 [F] counts): RateLimiter
    occ_add: Optional[torch.Tensor]  # float32 [max_nodes] borrowed-ahead tokens
    param: Optional[torch.Tensor]  # int32 [depth, Q, 2] (param_effect_deltas)


def _acquire_scatters_fused(
    cfg: EngineConfig,
    acq: AcquireBatch,
    features: frozenset,
    passed,
    occupying,
    valid,
    fslots,  # [B*K] flow slots from _check_flow (None without "flow")
    occ_grant,  # (grant_lane, onodes, ocnt) or None
    rl_info,  # (rl_ok, cost) or None
    param_ctx,  # (pcms, pcms_epochs, pcms_idx, prows, q_add, thread_add) or None
) -> AcquireDeltas:
    """Acquire-side scatters per item, in ONE scatter_many launch: the stat
    fan, the sketch, the warm-up drain accounting, the RateLimiter (cost,
    count) sums, the occupy-ahead booking and the param-flow pass /
    concurrency counts."""
    b = acq.res.shape[0]
    with_nodes = "nodes" in features
    cd = cfg.count_digits

    pass_c, block_c, occ_c, _entry_deltas = _acquire_entry_stats(
        cfg, acq, valid, passed, occupying
    )
    jobs = []
    stat_vals = torch.stack([pass_c, block_c, occ_c])
    if cfg.sketch_stats:
        sk_vals = torch.stack([torch.where(passed, acq.count, 0), block_c])
        jobs += sketch_jobs(cfg, acq.res, valid, sk_vals, (cd, cd))

    slot_planes = []
    oi = 1 + len(jobs)
    f_idx = occ_idx = None
    if fslots is not None:
        K = cfg.flow_rules_per_resource
        F = cfg.max_flow_rules
        rows_f = torch.where(fslots < F, fslots, -1).reshape(b, K).T  # [K, B]
        planes, digits = [], []
        cnt_f = _fan(acq.count, K)
        if "warmup" in features:
            planes.append(torch.where(_fan(passed, K), cnt_f, 0).to(I32))
            digits.append(cd)
            slot_planes.append("warm")
        if rl_info is not None:
            rl_ok, cost = rl_info
            planes.append(torch.where(rl_ok, torch.round(cost).to(I32), 0))
            digits.append(3)
            planes.append(rl_ok.to(I32))
            digits.append(cd)
            slot_planes.append("latest")
        if planes:
            vals_f = torch.stack(planes).reshape(len(planes), b, K).permute(2, 0, 1)
            jobs.append(FU.Job("fslots", F, rows_f, vals_f, tuple(digits)))
            f_idx = oi
            oi += 1

    if occ_grant is not None:
        K = cfg.flow_rules_per_resource
        grant_lane, onodes, ocnt = occ_grant
        commit = grant_lane & _fan(occupying, K)
        occ_rows = torch.where(commit & (onodes < cfg.max_nodes), onodes, -1)
        occ_vals = torch.where(commit, torch.round(ocnt).to(I32), 0)
        jobs.append(
            _rows_job(cfg, FU.Job(
                "occ",
                cfg.max_nodes,
                occ_rows.reshape(b, K).T,
                occ_vals.reshape(b, K).T[:, None, :],
                (cd,),
            ))
        )
        occ_idx = oi
        oi += 1

    if param_ctx is not None:
        jobs += param_effect_jobs(cfg, acq, passed, param_ctx)

    outs = _scatter_with_stat_fan(
        cfg, jobs, acq.res, acq.ctx_node, acq.origin_node, stat_vals,
        (cd, cd, cd), with_nodes,
    )
    stat = torch.round(outs[0]).to(I32)
    sketch = warm = latest = occ_add = param = None
    if cfg.sketch_stats:
        sketch = torch.round(torch.stack(outs[1 : 1 + cfg.sketch_depth])).to(I32)
    if f_idx is not None:
        f_out = outs[f_idx]
        pi = 0
        if "warm" in slot_planes:
            warm = f_out[:, pi]
            pi += 1
        if "latest" in slot_planes:
            latest = (f_out[:, pi], f_out[:, pi + 1])
    if occ_idx is not None:
        occ_add = outs[occ_idx][:, 0]
    if param_ctx is not None:
        param = param_effect_deltas(outs[oi : oi + cfg.param_depth])
    return AcquireDeltas(
        pas=stat[:, 0], blk=stat[:, 1], occ=stat[:, 2], sketch=sketch, warm=warm,
        latest=latest, occ_add=occ_add, param=param,
    )


def _acquire_scatters_plain(
    cfg: EngineConfig,
    acq: AcquireBatch,
    features: frozenset,
    passed,
    occupying,
    valid,
    fslots,
    occ_grant,
    rl_info,
    param_ctx,
) -> AcquireDeltas:
    """Acquire-side scatters on the plain path (the reference's unfused
    tick, ``engine.py:2631-2860``), as indexed scatters over the whole
    node table: the stat fan, the sketch, the warm-up drain, the
    RateLimiter (cost, count) sums (the reference folds them into
    latestPassedTime at the end of its flow check; nothing reads it in
    between), the occupy-ahead booking and the param-flow pass /
    concurrency counts.  Exact at any count."""
    with_nodes = "nodes" in features
    fan = 3 if with_nodes else 1
    n = cfg.node_rows
    pass_c, block_c, occ_c, _entry_deltas = _acquire_entry_stats(cfg, acq, valid, passed, occupying)
    rows = _stat_rows(cfg, acq.res, acq.ctx_node, acq.origin_node, with_nodes)
    stat = T.histogram(rows, torch.stack([pass_c, block_c, occ_c], dim=1).to(I32).repeat(fan, 1), n, sharded=True)
    sketch = warm = latest = occ_add = param = None
    if cfg.sketch_stats:
        vals = torch.stack([torch.where(passed, acq.count, 0), block_c], dim=1).to(I32)
        cols = PM.cms_cell(acq.res, cfg.sketch_depth, cfg.sketch_width)
        sketch = GS.depth_histogram(cols, vals, valid, cfg.sketch_depth, cfg.sketch_width, sharded=True)
    if fslots is not None:
        K = cfg.flow_rules_per_resource
        F = cfg.max_flow_rules
        cnt_f = _fan(acq.count, K).to(F32)
        if "warmup" in features:
            # pad-slot lanes drop (row F is never read)
            adm = _fan(passed, K) & (fslots < F)
            warm = T.histogram(torch.where(adm, fslots, -1), torch.where(adm, cnt_f, 0.0), F)
        if rl_info is not None:
            rl_ok, cost = rl_info
            sums = T.histogram(
                torch.where(rl_ok, fslots, -1),
                torch.stack([torch.where(rl_ok, cost, 0.0), rl_ok.to(F32)], dim=1),
                F,
            )
            latest = (sums[:, 0], sums[:, 1])
    if occ_grant is not None:
        K = cfg.flow_rules_per_resource
        grant_lane, onodes, ocnt = occ_grant
        commit = grant_lane & _fan(occupying, K)
        occ_add = T.histogram(
            torch.where(commit, onodes, -1), torch.where(commit, torch.round(ocnt).to(I32), 0), n, sharded=True
        ).to(F32)
    if param_ctx is not None:
        _pcms, _epochs, _idx, prows, q_add, thread_add = param_ctx
        KP = cfg.param_rules_per_resource
        adm = _fan(passed, KP)
        cnt_p = _fan(acq.count, KP).to(I32)
        q_rows = torch.where((q_add & adm)[:, None], prows, -1)
        t_rows = torch.where((thread_add & adm)[:, None], prows, -1)
        param = torch.stack([
            torch.stack([
                T.histogram(q_rows[:, d], cnt_p, cfg.param_width),
                T.histogram(t_rows[:, d], cnt_p, cfg.param_width),
            ], dim=1)
            for d in range(cfg.param_depth)
        ])
    return AcquireDeltas(
        pas=stat[:, 0], blk=stat[:, 1], occ=stat[:, 2], sketch=sketch, warm=warm,
        latest=latest, occ_add=occ_add, param=param,
    )


def _land_acquire(
    cfg: EngineConfig,
    state: EngineState,
    acq: AcquireBatch,
    now_ms: int,
    d: AcquireDeltas,
    passed,
    occupying,
    valid,
    param_ctx,
) -> EngineState:
    """Land one acquire effects phase's deltas (StatisticSlot.java:54-123):
    the windows (refreshed by the completion phase at this ``now_ms``),
    concurrency, the sketch, the warm-up drain, latestPassedTime, the
    occupy-ahead pool and the param store."""
    dev = acq.res.device
    _p, _b, _o, entry_deltas = _acquire_entry_stats(cfg, acq, valid, passed, occupying)
    hist = _node_hist(cfg, {W.EV_PASS: d.pas, W.EV_BLOCK: d.blk, W.EV_OCCUPIED: d.occ}, entry_deltas, dev)
    win_sec = W.add_dense(state.win_sec, now_ms, hist, None, _sec_cfg(cfg), refreshed=True)
    win_min = state.win_min
    if cfg.enable_minute_window:
        win_min = W.add_dense(state.win_min, now_ms, hist, None, _min_cfg(cfg), refreshed=True)
    concurrency = state.concurrency + hist[:, W.EV_PASS] + hist[:, W.EV_OCCUPIED]
    state = state._replace(win_sec=win_sec, win_min=win_min, concurrency=concurrency)
    if d.sketch is not None:
        state = land_sketch(cfg, state, now_ms, d.sketch, (W.EV_PASS, W.EV_BLOCK), pre_refreshed=True)

    pad1 = torch.zeros((1,), dtype=F32, device=dev)
    if d.warm is not None:
        state = state._replace(warm_acc=state.warm_acc + torch.cat([d.warm, pad1]))
    if d.latest is not None:
        T_s = torch.cat([d.latest[0], pad1])
        n_s = torch.cat([d.latest[1], pad1])
        state = state._replace(
            latest_passed_ms=_apply_latest(state.latest_passed_ms, T_s, n_s, now_ms)
        )
    if d.occ_add is not None:
        add = _to_rows(d.occ_add, _local_rows(cfg), 0.0)
        nxt = W.i32(W.wid_of(now_ms, cfg.second_window_ms) + 1)  # wraps as the reference's int32
        pool_vec = torch.where(state.occ_epoch == nxt, state.occ_tokens, 0.0)
        state = state._replace(
            occ_tokens=pool_vec + add,
            occ_epoch=torch.where(add > 0, nxt, state.occ_epoch).to(I32),
        )
    if d.param is not None:
        state = land_param_effects(state, param_ctx, d.param)
    return state


def _branch(run: str, ctx, seg_fn, item_fn):
    """One phase of a segment-path tick: the segment branch (``run ==
    "seg"``), the per-item branch ("item"), or both, selected on the
    device's ``ctx.ok`` ("both": ``seg_fallback`` without a host hint)."""
    if run == "seg":
        return seg_fn()
    if run == "item":
        return item_fn()
    return _pick(ctx.ok, seg_fn(), item_fn())


def _pick(ok: torch.Tensor, a, b):
    """``seg_fallback``'s device-side select: ``a`` where the 0-d bool
    ``ok`` is True, else ``b``, leaf by leaf through (named) tuples; None
    and host scalars must agree on both sides."""
    if isinstance(a, torch.Tensor):
        return torch.where(ok, a, b)
    if isinstance(a, tuple):
        return type(a)(*[_pick(ok, x, y) for x, y in zip(a, b)]) if hasattr(a, "_fields") else tuple(
            _pick(ok, x, y) for x, y in zip(a, b)
        )
    assert a == b, (a, b)
    return a


# ---------------------------------------------------------------------------
# the tick
# ---------------------------------------------------------------------------


def tick(
    state: EngineState,
    rules: RuleSet,
    acq: AcquireBatch,
    comp: CompleteBatch,
    now_ms: int,  # engine epoch ms (int32 range)
    sys_load: float,  # host-sampled load average
    sys_cpu: float,  # host-sampled CPU usage [0, 1]
    cfg: EngineConfig,
    features: frozenset = ALL_FEATURES,
    seg_fits: Optional[Tuple[bool, bool]] = None,
) -> Tuple[EngineState, TickOutput]:
    """One engine tick: completions, then batched decisions, then effects.
    Consumes ``state`` (its window rings are updated in place).

    ``seg_fits`` (``seg_fallback=True`` only): the host's verdict on
    whether the completion and the acquire batch fit the segment capacity
    (``(completions_fit, acquires_fit)``, from an exact host count of the
    live segments on the engine's keys, ``runtime/presort.host_seg_count``).
    Given, the tick runs only the branch each side needs; None, it runs
    both branches of each side and selects on the device."""
    check_supported(cfg, features)
    b = acq.res.shape[0]
    dev = acq.res.device
    now_ms = W.i32(int(now_ms))
    sys_load, sys_cpu = float(sys_load), float(sys_cpu)
    # narrow uploads (ops/wire.py) widen before anything reads the batch;
    # every stage below sees int32 columns
    acq = WIRE.widen_acquire(acq)
    comp = WIRE.widen_complete(comp)

    # segment-compacted effects: the key-run structure of each side, once.
    # With seg_fallback each phase picks the segment branch when its side's
    # live segments fit seg_u and the per-item branch otherwise, as the JAX
    # tick's lax.cond on ctx.ok does: either the host says which
    # (seg_fits), or both branches compute their deltas and torch.where
    # selects on ctx.ok — the small per-branch outputs, never the state —
    # before ONE landing.  No host sync either way.
    fused = _use_fused(cfg)
    use_seg = cfg.seg_effects and fused
    fallback = use_seg and cfg.seg_fallback
    seg_dropped = torch.zeros((), dtype=I32, device=dev)
    ctx_c = carry_c = ctx_a = carry_a = None
    if use_seg:
        ctx_c, carry_c = ES.prepare_completions(cfg, comp, features)
        ctx_a, carry_a = ES.prepare_acquire(cfg, acq)
    # which branches run, per side: "seg", "item" or "both"
    if not use_seg:
        run_c = run_a = "item"
    elif not fallback:
        run_c = run_a = "seg"
    elif seg_fits is None:
        run_c = run_a = "both"
    else:
        run_c, run_a = ("seg" if fits else "item" for fits in seg_fits)

    # 1. exits first: they release concurrency and update breakers
    comp_valid = comp.res != cfg.trash_row
    dg = None
    if "degrade" in features:
        dg = _degrade_completion_masks(cfg, state, rules, comp, comp_valid, now_ms)
    d_comp = _branch(
        run_c, ctx_c,
        lambda: ES.completion_scatters_seg(cfg, rules, comp, features, ctx_c, carry_c, dg),
        lambda: (_completion_scatters_fused if fused else _completion_scatters_plain)(
            cfg, rules, comp, features, dg
        ),
    )
    state = _land_completions(cfg, state, rules, comp, now_ms, d_comp, dg)
    if run_c == "seg":
        seg_dropped = seg_dropped + ES.dropped_items(ctx_c, comp_valid)

    # 2. warm-up token sync and the occupy fold
    if "warmup" in features:
        state = _sync_warmup(cfg, state, rules, now_ms)
    if "occupy" in features and "flow" in features:
        state = _fold_occupied(cfg, state, now_ms)

    valid = acq.res != cfg.trash_row
    forced = valid & (acq.pre_verdict > 0)

    # 3. rule checks in reference slot order; with the segment path and
    #    single-lane rules, at the segment level (verdicts exact either way)
    seg_checks = (
        use_seg
        and cfg.flow_rules_per_resource == 1
        and cfg.degrade_rules_per_resource == 1
        and cfg.param_rules_per_resource == 1
    )
    checks = _branch(
        run_a if seg_checks else "item", ctx_a,
        lambda: ES.run_checks_seg(
            cfg, state, rules, acq, now_ms, sys_load, sys_cpu, valid, forced,
            ctx_a, carry_a, features,
        ),
        lambda: _run_checks_plain(
            cfg, state, rules, acq, now_ms, sys_load, sys_cpu, valid, forced, features
        ),
    )
    (
        auth_block, sys_block, param_block, param_ctx, flow_block, wait_ms,
        occupying, occ_grant, fslots, rl_info, degrade_block, cb_state,
    ) = checks
    state = state._replace(cb_state=cb_state)

    passed = valid & ~forced & ~(
        auth_block | sys_block | param_block | flow_block | degrade_block
    )
    # occupy grants only COMMIT for items that finally pass
    occupying = occupying & passed

    verdict = torch.full((b,), PASS, dtype=torch.int8, device=dev)
    verdict = torch.where(forced, acq.pre_verdict.to(torch.int8), verdict)
    verdict = torch.where(auth_block, BLOCK_AUTHORITY, verdict)
    verdict = torch.where(sys_block, BLOCK_SYSTEM, verdict)
    verdict = torch.where(param_block, BLOCK_PARAM, verdict)
    verdict = torch.where(flow_block, BLOCK_FLOW, verdict)
    verdict = torch.where(degrade_block, BLOCK_DEGRADE, verdict)
    verdict = torch.where(passed & (wait_ms > 0), PASS_WAIT, verdict).to(torch.int8)
    wait_ms = torch.where(passed, wait_ms, 0).to(I32)

    # 4. effects (StatisticSlot.java:54-123)
    eff = (passed, occupying, valid, fslots, occ_grant, rl_info, param_ctx)
    d_acq = _branch(
        run_a, ctx_a,
        lambda: ES.acquire_scatters_seg(cfg, acq, features, *eff, ctx_a, carry_a),
        lambda: (_acquire_scatters_fused if fused else _acquire_scatters_plain)(cfg, acq, features, *eff),
    )
    state = _land_acquire(cfg, state, acq, now_ms, d_acq, passed, occupying, valid, param_ctx)
    if run_a == "seg":
        seg_dropped = seg_dropped + ES.dropped_items(ctx_a, valid)

    # 5. the observability planes and the hot-set candidates, after the
    #    effects (the window sums and the sketch include this tick)
    stats = res_stats = hot = expl = None
    if cfg.device_telemetry:
        seg_live = ctx_a.n_seg if use_seg else torch.zeros((), dtype=I32, device=dev)
        stats = _device_stats(
            cfg, state, rules, acq, verdict, valid, forced, seg_dropped, seg_live
        )
        if timeline_k(cfg) > 0:
            res_stats = _device_res_stats(cfg, state, now_ms)
    if hotset_k(cfg) > 0:
        hot = _device_hot_candidates(cfg, state, acq, valid, now_ms)
    if explain_k(cfg) > 0:
        expl = _device_explain(cfg, state, rules, acq, verdict, valid, forced, fslots, now_ms)
    if cfg.packed_wire:
        return state, TickOutput(
            verdict=None,
            wait_ms=wait_ms,
            wire=WIRE.pack_tick_output(
                cfg, verdict, wait_ms, seg_dropped, stats, res_stats, expl, hot=hot
            ),
            seg_dropped=seg_dropped,
        )
    return state, TickOutput(
        verdict=verdict, wait_ms=wait_ms, seg_dropped=seg_dropped, stats=stats,
        res_stats=res_stats, hot=hot,
    )


class ScalarStage:
    """Pinned host slots for the adaptive controller's five-scalar uploads
    (``replace_system_columns``).  On the card a ``torch.tensor([...],
    device=...)`` from pageable memory, or a Python scalar written into a
    device tensor, synchronizes the host with the card; here the values
    are written into a pinned slot and copied ``non_blocking`` behind a
    CUDA event, and a slot is written again only once the event recorded
    behind its last copy has completed (it almost always has: the ring
    holds ``SLOTS`` of them; when none has, the ring grows by one slot,
    so the host never waits for the card under the client's engine lock,
    as the reference's asynchronous upload never does).  On the CPU the
    upload is a plain tensor."""

    SLOTS = 4

    def __init__(self, device):
        self.device = torch.device(device)
        self.n = len(RT.SystemTensors._fields)
        self._i = 0
        self._cuda = self.device.type == "cuda"
        self._bufs = [
            torch.empty((self.n,), dtype=F32, pin_memory=self._cuda) for _ in range(self.SLOTS)
        ]
        self._events: list = [None] * self.SLOTS
        #: uploads so far (each one host-to-device copy)
        self.uploads = 0

    def _free_slot(self) -> int:
        """The next slot whose last copy has run (its event completed);
        a new slot at the ring's end when none has."""
        for _ in range(len(self._bufs)):
            self._i = (self._i + 1) % len(self._bufs)
            ev = self._events[self._i]
            if ev is None or ev.query():
                return self._i
        self._bufs.append(torch.empty((self.n,), dtype=F32, pin_memory=self._cuda))
        self._events.append(None)
        self._i = len(self._bufs) - 1
        return self._i

    def upload(self, values) -> torch.Tensor:
        """float32 [n] on the device holding ``values`` (a fresh tensor:
        earlier uploads are never overwritten)."""
        self.uploads += 1
        if not self._cuda:
            return torch.tensor([float(v) for v in values], dtype=F32, device=self.device)
        buf = self._bufs[self._free_slot()]
        buf.copy_(torch.tensor([float(v) for v in values], dtype=F32))
        dst = torch.empty((self.n,), dtype=F32, device=self.device)
        dst.copy_(buf, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[self._i] = ev
        return dst


def replace_system_columns(ruleset: RuleSet, system: RT.SystemTensors, stage: ScalarStage) -> RuleSet:
    """Swap ONLY the system-threshold columns of a live ruleset — the
    adaptive controller's upload path (adaptive/controller.py).

    The SystemTensors leaves are ordinary tensor arguments of the tick,
    so publishing new VALUES (five scalars, same shapes and dtypes) is one
    small host-to-device copy and nothing else: the tick is not rebuilt,
    and every other leaf of the ruleset is the same tensor as before.
    ``stage``: the caller's ``ScalarStage`` on the ruleset's device; on
    the card the copy is asynchronous, with no host sync."""
    vals = stage.upload([getattr(system, f) for f in RT.SystemTensors._fields])
    return ruleset._replace(system=RT.SystemTensors(*vals.unbind(0)))


def _leaf_shapes(x) -> list:
    """The shapes of a (nested) state NamedTuple's tensors, in field order."""
    if isinstance(x, torch.Tensor):
        return [tuple(x.shape)]
    return [s for v in x for s in _leaf_shapes(v)]


def migrate_state(
    state: EngineState,
    old_cfg: EngineConfig,
    new_cfg: EngineConfig,
    now_ms: int,
) -> EngineState:
    """Carry engine state across a WINDOW-SHAPE change (the live analog of
    IntervalProperty/SampleCountProperty, node/IntervalProperty.java —
    which the reference handles by resetting node metrics; here the
    current windowed totals MIGRATE so admission budgets don't reopen).

    Only operating-point knobs may differ: the window shapes, the batch
    shapes (no state leaf is batch-shaped) and the sketch window shape;
    a capacity change raises ``ValueError``.  The old window's TOTALS land
    in the new grid's current bucket, so the new window first sees the
    whole old window (budgets stay conservative) and decays after one new
    interval.  ``gs`` and ``rtq`` keep their state when every leaf shape
    matches and otherwise restart fresh (a dashboard-only transient).
    The new state is built on the old state's device; leaves the reshape
    does not touch are carried over as they are (not copied)."""
    import dataclasses

    same_caps = dataclasses.replace(
        old_cfg,
        second_sample_count=new_cfg.second_sample_count,
        second_window_ms=new_cfg.second_window_ms,
        minute_sample_count=new_cfg.minute_sample_count,
        minute_window_ms=new_cfg.minute_window_ms,
        batch_size=new_cfg.batch_size,
        complete_batch_size=new_cfg.complete_batch_size,
        sketch_sample_count=new_cfg.sketch_sample_count,
        sketch_window_ms=new_cfg.sketch_window_ms,
        sketch_slack_frac=new_cfg.sketch_slack_frac,
    )
    if same_caps != new_cfg:
        raise ValueError(
            "migrate_state only supports operating-point changes "
            "(window/batch/sketch shapes)"
        )
    now = int(now_ms)
    out = init_state(new_cfg, state.concurrency.device)

    def carry(old_win, o_cfg: W.WindowConfig, n_cfg: W.WindowConfig, new_win):
        counts = W.window_counts(old_win, now, o_cfg).to(I32)  # [rows, NE]
        rt_tot, rt_min = W.window_rt(old_win, now, o_cfg)
        wid = W.wid_of(now, n_cfg.window_ms)
        idx = W.current_index(now, n_cfg)
        new_win.counts[:, idx, :] = counts
        new_win.rt_sum[:, idx] = rt_tot
        new_win.rt_min[:, idx] = rt_min
        # a fill, not ``epochs[idx] = wid``: a host scalar written into a
        # CUDA tensor is a synchronizing copy
        new_win.epochs.select(0, idx).fill_(wid)
        return new_win._replace(
            # running sums mirror the single carried bucket exactly
            run=counts,
            run_rt=rt_tot,
            run_rt_min=rt_min,
            rot_wid=torch.full((), wid, dtype=I32, device=counts.device),
        )

    win_sec = carry(state.win_sec, _sec_cfg(old_cfg), _sec_cfg(new_cfg), out.win_sec)
    win_min = out.win_min
    if new_cfg.enable_minute_window and old_cfg.enable_minute_window:
        win_min = carry(state.win_min, _min_cfg(old_cfg), _min_cfg(new_cfg), out.win_min)

    # gs is impl-polymorphic (SALSA's state or the count-min seed's), so
    # compare its type and leaf shapes
    gs = (
        state.gs
        if type(out.gs) is type(state.gs) and _leaf_shapes(out.gs) == _leaf_shapes(state.gs)
        else out.gs
    )
    rtq = state.rtq if out.rtq.counts.shape == state.rtq.counts.shape else out.rtq
    # occupy epochs are second-window ids: a changed bucket length
    # invalidates them, so pending borrowed-ahead grants drop
    same_bucket = old_cfg.second_window_ms == new_cfg.second_window_ms
    return out._replace(
        win_sec=win_sec,
        win_min=win_min,
        concurrency=state.concurrency,
        latest_passed_ms=state.latest_passed_ms,
        warmup_tokens=state.warmup_tokens,
        warmup_last_s=state.warmup_last_s,
        warm_acc=state.warm_acc,
        occ_tokens=state.occ_tokens if same_bucket else out.occ_tokens,
        occ_epoch=state.occ_epoch if same_bucket else out.occ_epoch,
        cb_state=state.cb_state,
        cb_retry_ms=state.cb_retry_ms,
        cb_counts=state.cb_counts,
        cb_epochs=state.cb_epochs,
        pcms=state.pcms,
        pcms_epochs=state.pcms_epochs,
        pconc=state.pconc,
        gs=gs,
        rtq=rtq,
    )


#: (cfg, features) -> bound tick: one binding per key, shared by every
#: client on that key (the reference's compiled-tick cache)
_TICK_CACHE: dict = {}
_TICK_CACHE_LOCK = threading.Lock()

#: distinct tick bindings this process made (a climbing count in steady
#: state means config churn)
_C_TICK_BUILDS = _OBS.counter(
    "sentinel_engine_tick_builds_total",
    "distinct (config, features) tick callables built (each = one XLA compile)",
)


def make_tick(cfg: EngineConfig, features: frozenset = ALL_FEATURES):
    """The tick bound to a config and a feature set (the JAX package's
    compiled-tick factory; PyTorch runs eagerly, so this only binds).

    Cached per ``(cfg, features)`` under a lock, as the reference caches
    its compiled ticks: a miss is a new binding — the port's "retrace" —
    journaled with its cause in the retrace observatory
    (``obs/profile.RETRACE``: the key diff against the previous binding,
    expected or a surprise) and counted in
    ``sentinel_engine_tick_builds_total``; a hit reaches nothing."""
    check_supported(cfg, features)
    key = (cfg, features)
    with _TICK_CACHE_LOCK:
        fn = _TICK_CACHE.get(key)
        if fn is None:

            def fn(state, rules, acq, comp, now_ms, sys_load, sys_cpu, seg_fits=None):
                return tick(state, rules, acq, comp, now_ms, sys_load, sys_cpu, cfg, features, seg_fits)

            _TICK_CACHE[key] = fn
            _C_TICK_BUILDS.inc()
            PROF.RETRACE.observe("engine.tick", cfg=cfg, features=features)
    return fn
