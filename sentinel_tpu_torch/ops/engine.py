"""The decision engine: one tick per micro-batch, the fused path.

PyTorch counterpart of ``sentinel_tpu/ops/engine.py`` under the
configuration ``fused_effects=True, seg_effects=False`` — the per-item
fused path.  A tick ingests

    AcquireBatch  — entry attempts   (SphU.entry side)
    CompleteBatch — exits            (Entry.exit + Tracer side)

as fixed-shape tensors and returns a verdict per attempt.  Checks run in
the reference slot order (Authority → System → Flow → Degrade); the first
failing check sets the verdict code.  Within-tick contention is resolved
by grouped prefix sums (ops/rank.py).  Every effect scatter of a phase
rides one call of the scatter kernel (ops/fused.scatter_many; one launch
up to 48 row-vectors, which the default widths stay under), and the
flow check's windowed (pass, concurrency, borrow) read rides the gather
kernel (ops/fused.gather_many).

No host sync inside the tick.  The JAX tick decides several things on the
device with ``lax.cond``/``lax.switch`` (the stat fan width, the occupy
fold, the probe elections); here both branches are computed and selected
with ``torch.where``, and the stat fan always takes its widest form —
trash rows drop, so the results are identical.  ``now_ms`` is a host
integer; the only readback is the caller's read of the wire buffer.

State updates: the big window rings are updated IN PLACE (the counterpart
of the JAX tick's donated state) — a tick consumes the state it is given;
clone it first (``clone_state``) to keep the old one.

Features: {nodes, occupy, flow, degrade, authority, system, warmup}.  The
``param`` and ``tail_flow`` stages, the segment-compacted path, the
sketch tier, device telemetry, the timeline rows and the explain records
are not ported yet and raise ``NotImplementedError`` (ROADMAP.md, Queue A).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sentinel_tpu_torch.core import rule_tensors as RT
from sentinel_tpu_torch.core.config import EngineConfig
from sentinel_tpu_torch.core.errors import (
    BLOCK_AUTHORITY,
    BLOCK_DEGRADE,
    BLOCK_FLOW,
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
    STRATEGY_DIRECT,
    STRATEGY_RELATE,
)
from sentinel_tpu_torch.ops import degrade as D
from sentinel_tpu_torch.ops import fused as FU
from sentinel_tpu_torch.ops import rowmin as RM
from sentinel_tpu_torch.ops import rtq as RQ
from sentinel_tpu_torch.ops import tables as T
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.ops.rank import grouped_exclusive_cumsum

I32, F32 = torch.int32, torch.float32

#: sketch planes of the (dummy) global sketch leaf: NUM_EVENTS + quantized RT
SKETCH_PLANES = W.NUM_EVENTS + 1

#: every tick stage this engine runs
ALL_FEATURES = frozenset(
    {"authority", "system", "flow", "degrade", "warmup", "nodes", "occupy"}
)
#: stages of the JAX engine that are not ported yet
_UNPORTED_FEATURES = {
    "param": "the param-flow stage (ROADMAP.md Queue A: param)",
    "tail_flow": "the sketch-tail flow stage (ROADMAP.md Queue A: the sketch tier)",
}


def _fan(x: torch.Tensor, K: int) -> torch.Tensor:
    """Per-item -> per-(item, rule-lane) fan-out (repeat each item K times)."""
    return x if K == 1 else torch.repeat_interleave(x, K, dim=0)


class SketchState(NamedTuple):
    """The global sketch leaf; a [1, 1, 1, PLANES] placeholder while the
    sketch tier is off (the only configuration this engine runs)."""

    counts: torch.Tensor  # int32 [1, 1, 1, SKETCH_PLANES]
    epochs: torch.Tensor  # int32 [1]


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
    # param store leaves: carried unchanged (the param stage is not ported)
    pcms: torch.Tensor  # int32 [depth, Q, nbp]
    pcms_epochs: torch.Tensor  # int32 [nbp]
    pconc: torch.Tensor  # int32 [depth, Q]
    gs: SketchState
    rtq: RQ.RtqState  # ENTRY-node RT quantile histogram


class RuleSet(NamedTuple):
    flow: RT.FlowRuleTensors
    degrade: RT.DegradeRuleTensors
    auth: RT.AuthorityTensors
    system: RT.SystemTensors


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


def check_supported(cfg: EngineConfig, features: frozenset = ALL_FEATURES) -> None:
    """Raise NotImplementedError for any flag or stage this engine does not
    carry — it never silently ignores one."""
    unported = []
    if not cfg.fused_effects:
        unported.append("fused_effects=False (the plain scatter path)")
    if cfg.seg_effects:
        unported.append("seg_effects (ROADMAP.md Queue A: the segment path)")
    if cfg.sketch_stats:
        unported.append("sketch_stats (ROADMAP.md Queue A: the sketch tier)")
    if cfg.device_telemetry:
        unported.append("device_telemetry (ROADMAP.md Queue A: telemetry, timeline, explain)")
    if cfg.timeline_k > 0:
        unported.append("timeline_k > 0 (ROADMAP.md Queue A: telemetry, timeline, explain)")
    if cfg.explain_k > 0:
        unported.append("explain_k > 0 (ROADMAP.md Queue A: telemetry, timeline, explain)")
    for f in sorted(set(features) & set(_UNPORTED_FEATURES)):
        unported.append(_UNPORTED_FEATURES[f])
    extra = set(features) - ALL_FEATURES - set(_UNPORTED_FEATURES)
    if extra:
        raise ValueError(f"unknown tick features {sorted(extra)}")
    if unported:
        raise NotImplementedError(
            "not ported to sentinel_tpu_torch yet: " + "; ".join(unported)
        )


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
        gs=SketchState(
            counts=full((1, 1, 1, SKETCH_PLANES), 0, I32),
            epochs=full((1,), -2, I32),
        ),
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
) -> RuleSet:
    """Host-side: compile rule objects into a RuleSet on ``device``.

    Flow rules whose resource has no exact row are dropped with a warning
    (the sketch tail is not ported); param rules raise."""
    flow_rules = list(flow_rules)
    if list(param_rules):
        raise NotImplementedError(
            "not ported to sentinel_tpu_torch yet: param-flow rules "
            "(ROADMAP.md Queue A: param)"
        )
    exact_flow = []
    for r in flow_rules:
        rid = registry.resource_id(r.resource) if r.resource else None
        if rid is not None and rid >= cfg.node_rows:
            import logging

            logging.getLogger(__name__).warning(
                "flow rule on tail resource %r needs exact windows and will "
                "NOT be enforced; free exact rows or simplify it",
                r.resource,
            )
        else:
            exact_flow.append(r)
    return RuleSet(
        flow=RT.to_device(RT.compile_flow_rules(exact_flow, cfg, registry), device),
        degrade=RT.to_device(
            RT.compile_degrade_rules(list(degrade_rules), cfg, registry), device
        ),
        auth=RT.to_device(
            RT.compile_authority_rules(list(authority_rules), cfg, registry), device
        ),
        system=RT.to_device(RT.compile_system_rules(list(system_rules), cfg), device),
    )


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
        [FU.Job("stat", cfg.max_nodes, rows, stat_vals, stat_digits)] + other_jobs
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


def _land_hist(cfg: EngineConfig, stat_out, planes, entry_deltas, device):
    """[node_rows, NUM_EVENTS] int32 histogram from the stat job's float
    output (planes -> event columns) plus the ENTRY-row reduction."""
    hist = torch.zeros((cfg.node_rows, W.NUM_EVENTS), dtype=I32, device=device)
    for p, ev in enumerate(planes):
        hist[: cfg.max_nodes, ev] = torch.round(stat_out[:, p]).to(I32)
    hist[cfg.entry_node_row] += entry_deltas
    return hist


def _process_completions_fused(
    cfg: EngineConfig,
    state: EngineState,
    rules: RuleSet,
    comp: CompleteBatch,
    now_ms: int,
    features: frozenset,
) -> EngineState:
    """Exit path: RT/success/exception recording + circuit-breaker
    feedback (StatisticSlot.exit:125-164, DegradeSlot.exit:60-75), every
    scatter in ONE scatter_many launch: stat fan, per-row RT minimum
    heads, breaker columns and half-open probe flags."""
    b = comp.res.shape[0]
    dev = comp.res.device
    valid = comp.res != cfg.trash_row
    with_nodes = "nodes" in features
    sec_cfg, min_cfg = _sec_cfg(cfg), _min_cfg(cfg)
    erow = cfg.entry_node_row

    succ_w = torch.where(valid, comp.success, 0)
    err_w = torch.where(valid, comp.error, 0)
    rt1 = torch.where(valid, comp.rt, 0.0)
    # RT quantized to 1/8 ms (round half to even, as the reference)
    rt_q = torch.round(torch.clamp_max(rt1, float(cfg.statistic_max_rt)) * 8.0).to(I32)
    inb, entry_deltas, entry_rt, entry_rt_min = _completion_entry_stats(cfg, comp, valid)

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
        FU.Job(
            "rowmin",
            cfg.max_nodes,
            mh_rows.reshape(RMIN, b),
            mh_vals.T.reshape(3, RMIN, b).permute(1, 0, 2),
            (2, 2, 1),
        )
    ]

    with_degrade = "degrade" in features
    if with_degrade:
        KD = cfg.degrade_rules_per_resource
        slots_f, cb_counts, cb_epochs, active, is_err, is_slow, g_idx, half_open = (
            _degrade_completion_masks(cfg, state, rules, comp, valid, now_ms)
        )
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

    pad_tail = cfg.node_rows - cfg.max_nodes
    hist = _land_hist(cfg, stat_out, (W.EV_SUCCESS, W.EV_EXCEPTION), entry_deltas, dev)
    rt_hist = torch.cat([stat_out[:, 2] / 8.0, torch.zeros((pad_tail,), dtype=F32, device=dev)])
    rt_hist[erow] += entry_rt
    mins_m, present_m = RM.combine(min_out)
    row_min = (
        torch.cat([mins_m, torch.full((pad_tail,), W.RT_MIN_INIT, dtype=F32, device=dev)]),
        torch.cat([present_m, torch.zeros((pad_tail,), dtype=torch.bool, device=dev)]),
    )
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
    concurrency = torch.clamp_min(state.concurrency - hist[:, W.EV_SUCCESS], 0)

    if not with_degrade:
        return state._replace(concurrency=concurrency)

    cb_out, probe_out = outs[2], outs[3]
    cb_upd = torch.round(cb_out).to(I32).reshape(Dn, nbd, 3)
    cb_counts[:Dn] += cb_upd  # refresh_columns returned a fresh tensor
    sf = torch.cat(
        [torch.round(probe_out).to(I32), torch.zeros((1, 2), dtype=I32, device=dev)]
    )  # pad row back to Dn + 1
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
    delta = torch.zeros((cfg.node_rows, W.NUM_EVENTS), dtype=I32, device=tok.device)
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
    erow = cfg.entry_node_row
    ec = state.win_sec.run[erow]
    e_pass = ec[W.EV_PASS].to(F32)
    e_succ = ec[W.EV_SUCCESS].to(F32)
    ert = state.win_sec.run_rt[erow]
    e_rt_avg = torch.where(e_succ > 0, ert / torch.clamp_min(e_succ, 1.0), 0.0)
    e_conc = state.concurrency[erow].to(F32)
    mask = W.valid_mask(state.win_sec, now_ms, _sec_cfg(cfg))
    bucket_succ = state.win_sec.counts[erow, :, W.EV_SUCCESS]
    max_succ_qps = (
        torch.amax(torch.where(mask, bucket_succ, 0)).to(F32) * cfg.second_sample_count
    )
    min_rt = state.win_sec.run_rt_min[erow]

    inbound = (acq.inbound > 0) & eligible
    cnt = acq.count.to(F32)
    # single group (the ENTRY node): int32 exclusive prefix sum, exact
    vim_i = torch.where(inbound, acq.count, 0)
    rank_q = (torch.cumsum(vim_i, dim=0, dtype=I32) - vim_i).to(F32)
    rank_t = rank_q

    s = rules.system
    blk = (s.qps >= 0) & (e_pass + rank_q + cnt > s.qps)
    blk = blk | ((s.max_thread >= 0) & (e_conc + rank_t + 1 > s.max_thread))
    blk = blk | ((s.avg_rt >= 0) & (e_rt_avg > s.avg_rt))
    bbr_ok = (e_conc + rank_t + 1) <= torch.clamp_min(max_succ_qps * min_rt / 1000.0, 1.0)
    blk = blk | ((s.load >= 0) & (sys_load > s.load) & ~bbr_ok)
    blk = blk | ((s.cpu >= 0) & (sys_cpu > s.cpu))
    return blk & inbound


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
        torch.round(state.latest_passed_ms).to(I32), slots_f
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

    # occupy borrow pool booked against the NEXT bucket, keyed by node row
    cur_wid = W.wid_of(now_ms, cfg.second_window_ms)
    pool_dense = torch.where(state.occ_epoch == cur_wid + 1, state.occ_tokens, 0.0)
    # per-row windowed pass totals straight off the running sums, then ONE
    # gather kernel launch for (pass, concurrency, borrow pool)
    tab = torch.stack(
        [
            W.window_event_run(state.win_sec, W.EV_PASS),
            state.concurrency,
            torch.round(pool_dense).to(I32),
        ],
        dim=1,
    )
    (both,) = FU.gather_many(
        [FU.GatherJob("wsum", node_safe, torch.clamp_max(tab, (1 << 24) - 1), (3, 3, 3))]
    )
    wp = both[:, 0]
    conc = both[:, 1]
    pool = both[:, 2]

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
    """The per-item check phase (Authority -> System -> Flow -> Degrade,
    first-fail order).  Returns (auth_block, sys_block, flow_block,
    wait_ms, occupying, occ_grant, fslots, rl_info, degrade_block,
    cb_state), every *_block masked by its stage's eligibility."""
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
    eligible = eligible & ~flow_block

    if "degrade" in features:
        degrade_block, cb_state = _check_degrade(cfg, state, rules, acq, now_ms, eligible)
        degrade_block = degrade_block & eligible
    else:
        degrade_block = zero_block
        cb_state = state.cb_state
    return (
        auth_block, sys_block, flow_block, wait_ms, occupying, occ_grant,
        fslots, rl_info, degrade_block, cb_state,
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


def _acquire_effects_fused(
    cfg: EngineConfig,
    state: EngineState,
    rules: RuleSet,
    acq: AcquireBatch,
    now_ms: int,
    features: frozenset,
    passed,
    occupying,
    valid,
    fslots,  # [B*K] flow slots from _check_flow (None without "flow")
    occ_grant,  # (grant_lane, onodes, ocnt) or None
    rl_info,  # (rl_ok, cost) or None
) -> EngineState:
    """Acquire-side effects in ONE scatter_many launch: the stat fan, the
    warm-up drain accounting, the RateLimiter (cost, count) sums and the
    occupy-ahead booking."""
    b = acq.res.shape[0]
    dev = acq.res.device
    with_nodes = "nodes" in features
    cd = cfg.count_digits

    pass_c, block_c, occ_c, entry_deltas = _acquire_entry_stats(
        cfg, acq, valid, passed, occupying
    )
    jobs = []
    stat_vals = torch.stack([pass_c, block_c, occ_c])

    slot_planes = []
    oi = 1
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
            FU.Job(
                "occ",
                cfg.max_nodes,
                occ_rows.reshape(b, K).T,
                occ_vals.reshape(b, K).T[:, None, :],
                (cd,),
            )
        )
        occ_idx = oi
        oi += 1

    outs = _scatter_with_stat_fan(
        cfg, jobs, acq.res, acq.ctx_node, acq.origin_node, stat_vals,
        (cd, cd, cd), with_nodes,
    )
    hist = _land_hist(
        cfg, outs[0], (W.EV_PASS, W.EV_BLOCK, W.EV_OCCUPIED), entry_deltas, dev
    )
    win_sec = W.add_dense(state.win_sec, now_ms, hist, None, _sec_cfg(cfg), refreshed=True)
    win_min = state.win_min
    if cfg.enable_minute_window:
        win_min = W.add_dense(state.win_min, now_ms, hist, None, _min_cfg(cfg), refreshed=True)
    concurrency = state.concurrency + hist[:, W.EV_PASS] + hist[:, W.EV_OCCUPIED]
    state = state._replace(win_sec=win_sec, win_min=win_min, concurrency=concurrency)

    if f_idx is not None:
        f_out = outs[f_idx]
        pi = 0
        pad1 = torch.zeros((1,), dtype=F32, device=dev)
        if "warm" in slot_planes:
            state = state._replace(
                warm_acc=state.warm_acc + torch.cat([f_out[:, pi], pad1])
            )
            pi += 1
        if "latest" in slot_planes:
            T_s = torch.cat([f_out[:, pi], pad1])
            n_s = torch.cat([f_out[:, pi + 1], pad1])
            state = state._replace(
                latest_passed_ms=_apply_latest(state.latest_passed_ms, T_s, n_s, now_ms)
            )

    if occ_idx is not None:
        add = torch.cat(
            [
                outs[occ_idx][:, 0],
                torch.zeros((cfg.node_rows - cfg.max_nodes,), dtype=F32, device=dev),
            ]
        )
        cur_wid = W.wid_of(now_ms, cfg.second_window_ms)
        pool_vec = torch.where(state.occ_epoch == cur_wid + 1, state.occ_tokens, 0.0)
        state = state._replace(
            occ_tokens=pool_vec + add,
            occ_epoch=torch.where(add > 0, cur_wid + 1, state.occ_epoch).to(I32),
        )
    return state


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
) -> Tuple[EngineState, TickOutput]:
    """One engine tick: completions, then batched decisions, then effects.
    Consumes ``state`` (its window rings are updated in place)."""
    check_supported(cfg, features)
    b = acq.res.shape[0]
    now_ms = W.i32(int(now_ms))
    sys_load, sys_cpu = float(sys_load), float(sys_cpu)
    # narrow uploads (ops/wire.py) widen before anything reads the batch;
    # every stage below sees int32 columns
    acq = WIRE.widen_acquire(acq)
    comp = WIRE.widen_complete(comp)

    # 1. exits first: they release concurrency and update breakers
    state = _process_completions_fused(cfg, state, rules, comp, now_ms, features)

    # 2. warm-up token sync and the occupy fold
    if "warmup" in features:
        state = _sync_warmup(cfg, state, rules, now_ms)
    if "occupy" in features and "flow" in features:
        state = _fold_occupied(cfg, state, now_ms)

    valid = acq.res != cfg.trash_row
    forced = valid & (acq.pre_verdict > 0)

    # 3. rule checks in reference slot order
    (
        auth_block, sys_block, flow_block, wait_ms, occupying, occ_grant,
        fslots, rl_info, degrade_block, cb_state,
    ) = _run_checks_plain(
        cfg, state, rules, acq, now_ms, sys_load, sys_cpu, valid, forced, features
    )
    state = state._replace(cb_state=cb_state)

    passed = valid & ~forced & ~(auth_block | sys_block | flow_block | degrade_block)
    # occupy grants only COMMIT for items that finally pass
    occupying = occupying & passed

    verdict = torch.full((b,), PASS, dtype=torch.int8, device=acq.res.device)
    verdict = torch.where(forced, acq.pre_verdict.to(torch.int8), verdict)
    verdict = torch.where(auth_block, BLOCK_AUTHORITY, verdict)
    verdict = torch.where(sys_block, BLOCK_SYSTEM, verdict)
    verdict = torch.where(flow_block, BLOCK_FLOW, verdict)
    verdict = torch.where(degrade_block, BLOCK_DEGRADE, verdict)
    verdict = torch.where(passed & (wait_ms > 0), PASS_WAIT, verdict).to(torch.int8)
    wait_ms = torch.where(passed, wait_ms, 0).to(I32)

    # 4. effects (StatisticSlot.java:54-123)
    state = _acquire_effects_fused(
        cfg, state, rules, acq, now_ms, features, passed, occupying, valid,
        fslots, occ_grant, rl_info,
    )
    if cfg.packed_wire:
        return state, TickOutput(
            verdict=None,
            wait_ms=wait_ms,
            wire=WIRE.pack_tick_output(cfg, verdict, wait_ms, 0),
        )
    return state, TickOutput(verdict=verdict, wait_ms=wait_ms)


def make_tick(cfg: EngineConfig, features: frozenset = ALL_FEATURES):
    """The tick bound to a config and a feature set (the JAX package's
    compiled-tick factory; PyTorch runs eagerly, so this only binds)."""
    check_supported(cfg, features)

    def _tick(state, rules, acq, comp, now_ms, sys_load, sys_cpu):
        return tick(state, rules, acq, comp, now_ms, sys_load, sys_cpu, cfg, features)

    return _tick
