"""Segment-compacted phases of the tick.

PyTorch counterpart of ``sentinel_tpu/ops/engine_seg.py``.  The effects
phases contract ONE entry per batch *segment* (a maximal run of items
sharing every scatter-relevant key, capped at 256 items; ops/segment.py)
instead of one per item, and the segment check phase reads every
per-resource table once per segment and expands the values back to items
through ONE shared gather.

Dataflow per side:
  1. prepare_*: everything known at batch arrival (stat digit cumsums,
     row columns, the RT running minimum — kernel B4, ops/segscan.py) is
     compacted at each segment's last item.
  2. values that exist only after the checks (pass/block masks, breaker
     event masks) pack into ONE [N, cols] matrix and take one row gather
     at the segment ends.

Both scatter phases run through one ``fused.scatter_many`` call each
(kernel B1); with the sketch tier on, the sketch rides them as
``sketch{d}`` jobs on the segment axis.  The single-lane check phase ranks
with segmented scans (kernel B3); the sketch-tail stage (``tail_flow``)
reads its thresholds and estimates once per segment and ranks its items
with one more B3 call over the runs of equal resources.  Hot-parameter
scatters key on (rule, value-hash) — not segment-constant — so with the
``param`` stage on each phase makes one more ``scatter_many`` call on the
ITEM axis (``prel{d}``, ``param{d}``).

No host sync: the JAX phases decide the occupy rank, the probe election
and the breaker flip with ``lax.cond`` on "any candidate" (zeros
otherwise), and — with ``seg_static_ranks`` off — pick between scan ranks
and sort ranks with ``lax.cond``.  Every branch is pure, so here both
sides are computed and selected with ``torch.where``; with no candidate
the computed branch gives zeros too, so the results are identical.

Correctness does NOT require a sorted batch: an unsorted batch only has
more segments.  Past the capacity ``seg_u`` the overflow segments'
effects are dropped and their items fail closed (``dropped_items``
counts them) — unless ``seg_fallback`` is on, when the tick takes the
per-item branch for that side instead (ops/engine.py).  The effects
phases here stop at their deltas (``engine.CompletionDeltas``,
``engine.AcquireDeltas``): the tick lands whichever branch it picked.

Row-sharded (parallel/spmd.py): the segment structure, the ranks and the
expansion are batch work, replicated on every rank; the scatter jobs on
the node-row and sketch-width axes land the rank's own rows
(``engine._rows_job`` / ``_width_job``), and the single-lane flow check
builds its dense [rows, 3] table over the rank's rows only and reads it
with one all-reduce.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sentinel_tpu_torch.core import rule_tensors as RT
from sentinel_tpu_torch.core.config import EngineConfig
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
from sentinel_tpu_torch.ops import degrade as D
from sentinel_tpu_torch.ops import fused as FU
from sentinel_tpu_torch.ops import param as PM
from sentinel_tpu_torch.ops import rowmin as RM
from sentinel_tpu_torch.ops import segment as SG
from sentinel_tpu_torch.ops import segscan as SC
from sentinel_tpu_torch.ops import tables as T
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops.rank import grouped_exclusive_cumsum
from sentinel_tpu_torch.parallel import collectives as CL

I32, F32 = torch.int32, torch.float32

#: rowmin sentinel (> any valid rt; replaced by a drop row before scatter)
_RT_ABSENT = 3.0e38


def seg_capacity(cfg: EngineConfig, b: int) -> int:
    """Static compacted-axis capacity: explicit cfg.seg_u, else sized for
    Zipf-like traffic plus the 256-block split overhead."""
    if cfg.seg_u:
        return cfg.seg_u
    return min(b, b // 8 + b // SG.BLOCK + 64)


def dropped_items(ctx: SG.SegCtx, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Items whose effects an overflowing compacted pass dropped (int32
    scalar on the device): everything past the last kept segment's end.
    ``valid`` excludes trash-row padding from the count."""
    n = ctx.head.shape[0]
    kept = ctx.seg_end[-1] + 1
    if valid is None:
        late = n - kept
    else:
        iota = torch.arange(n, dtype=I32, device=valid.device)
        late = torch.sum(valid & (iota >= kept), dtype=I32)
    return torch.where(ctx.ok, 0, late).to(I32)


class CompCarry(NamedTuple):
    """Compacted payloads of one completion batch ([U] each)."""

    ce: list  # cumsum-at-tail cols for (success, error, rt_q)
    split: list
    min_rt: torch.Tensor  # per-segment min rt (or _RT_ABSENT)
    res: torch.Tensor
    ctx_node: torch.Tensor
    origin_node: torch.Tensor


class AcqCarry(NamedTuple):
    res: torch.Tensor  # [U]
    ctx_node: torch.Tensor
    origin_node: torch.Tensor
    origin_id: torch.Tensor
    ctx_name: torch.Tensor
    res_sorted: torch.Tensor  # bool scalar — res nondecreasing over the batch


def prepare_completions(cfg: EngineConfig, comp, features: frozenset):
    """The completion-side SegCtx, with every batch-known payload compacted
    at the segment ends."""
    valid = comp.res != cfg.trash_row
    succ_w = torch.where(valid, comp.success, 0)
    err_w = torch.where(valid, comp.error, 0)
    rt1 = torch.where(valid, comp.rt, 0.0)
    rt_q = torch.round(torch.clamp_max(rt1, float(cfg.statistic_max_rt)) * 8.0).to(I32)
    cm = cfg.max_batch_count
    rtm = int(cfg.statistic_max_rt) * 8
    C_rows, split = SG.cum_cols([succ_w, err_w, rt_q], [cm, cm, rtm])
    head = SG.heads_from_keys(comp.res, comp.ctx_node, comp.origin_node)
    inc_min = SC.seg_incl_min(head, torch.where(valid & (rt1 > 0), rt1, _RT_ABSENT))
    U = seg_capacity(cfg, comp.res.shape[0])
    ctx, carried = SG.build_from_head(
        head, U, payloads=list(C_rows) + [inc_min, comp.res, comp.ctx_node, comp.origin_node]
    )
    nC = len(C_rows)
    carry = CompCarry(
        ce=carried[:nC],
        split=split,
        min_rt=torch.where(ctx.live, carried[nC], _RT_ABSENT),
        res=carried[nC + 1],
        ctx_node=carried[nC + 2],
        origin_node=carried[nC + 3],
    )
    return ctx, carry


def prepare_acquire(cfg: EngineConfig, acq):
    """Acquire-side SegCtx; only row sources are batch-known (values come
    after the checks via one packed gather)."""
    U = seg_capacity(cfg, acq.res.shape[0])
    keys = [acq.res, acq.ctx_node, acq.origin_node, acq.origin_id, acq.ctx_name]
    ctx, carried = SG.build(keys, U, payloads=keys)
    return ctx, AcqCarry(
        res=carried[0],
        ctx_node=carried[1],
        origin_node=carried[2],
        origin_id=carried[3],
        ctx_name=carried[4],
        res_sorted=torch.all(acq.res[1:] >= acq.res[:-1]),
    )


def _chunks_to_planes(chunk_lists):
    """sums_from_ce output -> (vals [P2, U], digits tuple, spec per plane)."""
    vals, digits, spec = [], [], []
    for chunks in chunk_lists:
        s = []
        for arr, w, dig in chunks:
            s.append((len(vals), w))
            vals.append(arr)
            digits.append(dig)
        spec.append(s)
    return torch.stack(vals), tuple(digits), spec


def _recombine(out, spec):
    """Scatter output [n, P2] -> one exact int32 [n] column per plane
    (int32 arithmetic, wrapping as the reference's does)."""
    o = torch.round(out).to(I32)
    cols = []
    for s in spec:
        acc = None
        for i, w in s:
            term = o[:, i] * w if w != 1 else o[:, i]
            acc = term if acc is None else acc + term
        cols.append(acc.to(I32))
    return cols


def _packed_seg_values(ctx: SG.SegCtx, planes, maxes, extra_rows=()):
    """Post-check compaction: ONE [N, cols] pack + ONE row gather at the
    segment ends.  planes -> sums chunks (exact); extra_rows (segment-
    constant int32 row ids) -> compacted [U] columns (-1 on dead slots)."""
    C_rows, split = SG.cum_cols(planes, maxes)
    cols = list(C_rows) + [r.to(I32) for r in extra_rows]
    G = torch.stack(cols, dim=1)[ctx.seg_end.to(torch.int64)]  # [U, X]
    nC = len(C_rows)
    chunks = SG.sums_from_ce(ctx, [G[:, i] for i in range(nC)], split)
    rows = [torch.where(ctx.live, G[:, nC + i], -1) for i in range(len(extra_rows))]
    return chunks, rows


def _clean_rows_u(cfg: EngineConfig, x, live):
    """Dead slots, trash rows and negative rows -> 2^30, which every
    scatter drops (dead slots hold junk: this is what keeps it out)."""
    return torch.where(live & (x != cfg.trash_row) & (x >= 0), x, 2**30)


def _live_res(cfg: EngineConfig, ctx, carry):
    """Which compacted slots carry a real resource (live, not trash, not
    negative): the sketch jobs' valid mask on the segment axis."""
    return ctx.live & (carry.res != cfg.trash_row) & (carry.res >= 0)


def _stat_rows_u(cfg: EngineConfig, ctx, carry, with_nodes: bool):
    res_u = _clean_rows_u(cfg, carry.res, ctx.live)
    if not with_nodes:
        return res_u[None, :]
    c_u = _clean_rows_u(cfg, carry.ctx_node, ctx.live)
    o_u = _clean_rows_u(cfg, carry.origin_node, ctx.live)
    return torch.stack([res_u, c_u, o_u])


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with the same bits (a bitcast, not a conversion)."""
    return x.to(F32).contiguous().view(I32)


def _unbits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(F32)


class _Expander:
    """Collects per-segment int32 columns, then performs ONE [B]-row gather
    by sid plus one transpose, so every per-item column reads as a
    contiguous row.  Float columns ride as their int32 bits."""

    def __init__(self, ctx: SG.SegCtx):
        self.ctx = ctx
        self.cols = []
        self.R = None

    def add(self, col) -> int:
        assert self.R is None, "expander already ran"
        self.cols.append(col.to(I32))
        return len(self.cols) - 1

    def add_f(self, col) -> int:
        return self.add(_bits(col))

    def run(self):
        if not self.cols:
            self.R = torch.zeros((0, self.ctx.sid.shape[0]), dtype=I32, device=self.ctx.sid.device)
            return
        G = SG.expand(self.ctx, torch.stack(self.cols, dim=1))  # [B, C]
        self.R = G.T.contiguous()  # [C, B]

    def get(self, i):
        return self.R[i]

    def get_f(self, i):
        return _unbits(self.R[i])


def _head_of_runs(key: torch.Tensor) -> torch.Tensor:
    """Heads of the runs of equal keys (position 0 starts one)."""
    return torch.cat([torch.ones((1,), dtype=torch.bool, device=key.device), key[1:] != key[:-1]])


def run_checks_seg(
    cfg: EngineConfig,
    state,
    rules,
    acq,
    now_ms: int,
    sys_load: float,
    sys_cpu: float,
    valid,
    forced,
    ctx: SG.SegCtx,
    carry: AcqCarry,
    features: frozenset,
):
    """The whole acquire check phase with every per-item table read hoisted
    to the segment level (AuthoritySlot -> SystemSlot -> ParamFlowSlot ->
    FlowSlot (+tail) -> DegradeSlot, first-fail order).  Needs *_rules_per_resource == 1 (the
    tick checks it).  Ranks are segmented scans of the sorted batch (B3);
    with ``seg_static_ranks`` off, sort ranks are computed too and chosen
    when the batch is unsorted or a flow rule is not DIRECT/ANY.

    Comparisons use the margin form (rank + cnt > thr - wp), as the JAX
    phase does; float operations keep its order.

    Returns the tuple ``engine._run_checks_plain`` returns."""
    from sentinel_tpu_torch.ops import engine as E

    b = acq.res.shape[0]
    dev = acq.res.device
    now_f = float(now_ms)
    cnt = acq.count.to(F32)
    zero_block = torch.zeros((b,), dtype=torch.bool, device=dev)
    live = ctx.live
    res_u = torch.where(live & (carry.res >= 0), carry.res, cfg.max_resources)
    res_l = torch.clamp_max(res_u, cfg.max_resources)
    exp = _Expander(ctx)

    # ================= segment-level phase =================
    with_auth = "authority" in features
    with_param = "param" in features
    with_flow = "flow" in features
    with_degrade = "degrade" in features

    n_res1 = cfg.max_resources + 1
    slot_tabs = []
    if with_auth:
        slot_tabs.append(("auth", rules.auth.mode))
    if with_param:
        slot_tabs.append(("param", rules.param.res_params[:, 0]))
    if with_flow:
        slot_tabs.append(("flow", rules.flow.res_rules[:, 0]))
    if with_degrade:
        slot_tabs.append(("degrade", rules.degrade.res_cbs[:, 0]))
    slot_vals = {}
    if slot_tabs:
        got = T.lane_gather_multi([t for _n, t in slot_tabs], res_l, n_res1)
        slot_vals = {name: g.to(I32) for (name, _t), g in zip(slot_tabs, got)}

    if with_auth:
        mode = slot_vals["auth"]
        origins = T.big_gather(rules.auth.origins, res_l, n_res1)
        listed = (
            (origins == carry.origin_id[:, None]) & (origins != RT.AUTH_EMPTY)
        ).any(dim=1)
        auth_u = ((mode == 1) & ~listed) | ((mode == 2) & listed)

    if with_param:
        # KP == 1 (the tick's gate): the shared slot gather serves; dead
        # segment slots read the pad resource (res_u), never junk
        pslot_u = slot_vals["param"]
        pcms, pcms_epochs, pcms_idx = PM.refresh(state.pcms, state.pcms_epochs, now_ms, cfg)
        pgu = T.small_gather_fields(
            T.pack_fields(
                [
                    rules.param.enabled, rules.param.threshold, rules.param.grade,
                    rules.param.cls, rules.param.lane,
                ]
            ),
            pslot_u,
        )
        ih_u = T.small_gather_int(rules.param.item_hash, pslot_u)  # [U, KI]
        it_u = T.small_gather_fields(rules.param.item_threshold, pslot_u)
        KI = ih_u.shape[1]
        p_en_u = (pgu[:, 0] > 0) & live
        p_thread_u = pgu[:, 2].to(I32) == GRADE_THREAD
        i_pflags = exp.add(p_en_u.to(I32) | (p_thread_u.to(I32) << 1))
        i_plane = exp.add(torch.clamp(pgu[:, 4].to(I32), -1, cfg.param_dims - 1))
        i_pslot = exp.add(torch.where(live, pslot_u, cfg.max_param_rules))
        i_pcls = exp.add(torch.clamp(pgu[:, 3].to(I32), 0, max(cfg.param_classes - 1, 0)))
        i_pthr = exp.add_f(pgu[:, 1])
        i_ih = [exp.add(ih_u[:, k]) for k in range(KI)]
        i_it = [exp.add_f(it_u[:, k]) for k in range(KI)]

    if with_flow:
        f = rules.flow
        slot_u = slot_vals["flow"]
        fg = T.small_gather_fields(
            T.pack_fields(
                [
                    f.enabled, f.limit_app, f.strategy, f.ref_node, f.ref_ctx,
                    f.grade, f.count, f.behavior, f.max_queue_ms,
                    f.warning_token, f.slope, state.warmup_tokens,
                ]
            ),
            slot_u,
        )
        latest_u = T.small_gather_int(
            W.f32_to_i32(torch.round(state.latest_passed_ms)), slot_u
        ).to(F32)
        enabled = fg[:, 0] > 0
        la = fg[:, 1].to(I32)
        named = (la >= 0) & (la == carry.origin_id)
        match = (
            (la == RT.LIMIT_ANY)
            | ((la >= 0) & (la == carry.origin_id))
            | ((la == RT.LIMIT_OTHER) & (carry.origin_id >= 0) & ~named)
        )
        applicable_u = enabled & match & live
        strategy = fg[:, 2].to(I32)
        ref_node = fg[:, 3].to(I32)
        ref_ctx = fg[:, 4].to(I32)
        direct_node = torch.where(la == RT.LIMIT_ANY, carry.res, carry.origin_node)
        chain_ok = (ref_ctx >= 0) & (ref_ctx == carry.ctx_name)
        node = torch.where(
            strategy == STRATEGY_DIRECT,
            direct_node,
            torch.where(
                strategy == STRATEGY_RELATE,
                ref_node,
                torch.where(chain_ok, carry.ctx_node, -1),
            ),
        )
        node_ok = (node >= 0) & (node != cfg.trash_row)
        applicable_u = applicable_u & node_ok
        node_safe_u = torch.where(node_ok & (node < cfg.node_rows), node, cfg.trash_row)
        grade = fg[:, 5].to(I32)
        rcount = fg[:, 6]
        behavior = torch.where(grade == GRADE_QPS, fg[:, 7].to(I32), CONTROL_DEFAULT)
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
        thr_eff = torch.where(is_warm, warm_qps, rcount)
        # the next window's key as the reference's int32 computes it (it
        # wraps at 2^31), as flow_read_job keys the fused path's read
        nxt = W.i32(W.wid_of(now_ms, cfg.second_window_ms) + 1)
        pool_dense = torch.where(state.occ_epoch == nxt, state.occ_tokens, 0.0)
        # running sums are exact here: completions refreshed this now_ms;
        # on a shard the table holds the rank's rows, read at the rebased
        # rows (zeros where another rank holds one) and all-reduced
        tab = torch.stack(
            [
                W.window_event_run(state.win_sec, W.EV_PASS),
                state.concurrency,
                torch.round(pool_dense).to(I32),
            ],
            dim=1,
        )
        sh = CL.current()
        if sh is None:
            g = tab[node_safe_u.to(torch.int64)]
        else:
            g = T.big_gather(tab, node_safe_u, cfg.node_rows, sharded=True)
        wp = g[:, 0].to(F32)
        conc = g[:, 1].to(F32)
        pool = g[:, 2].to(F32)
        i_fflags = exp.add(
            applicable_u.to(I32)
            | (is_rl.to(I32) << 1)
            | ((behavior == CONTROL_WARM_UP_RATE_LIMITER).to(I32) << 2)
            | ((grade == GRADE_QPS).to(I32) << 3)
            | ((behavior == CONTROL_DEFAULT).to(I32) << 4)
        )
        i_node = exp.add(node_safe_u)
        i_fslot = exp.add(torch.where(live, slot_u, cfg.max_flow_rules))
        i_mq = exp.add_f(thr_eff - wp)
        i_mt = exp.add_f(rcount - conc)
        i_mrl = exp.add_f(latest_u - now_f)
        i_maxq = exp.add_f(fg[:, 8])
        i_pace = exp.add_f(pace_qps)
        i_mo = exp.add_f(rcount - pool)

    with_tail = "tail_flow" in features and cfg.sketch_stats
    if with_tail:
        # unconditional under the feature, as the reference's: with no tail
        # rule loaded the thresholds read UNRULED and nothing blocks
        tres_u = torch.where(live, carry.res, -1)
        tcols = PM.cms_cell(tres_u, cfg.sketch_depth, cfg.sketch_width)
        thr_u = E.tail_thresholds(cfg, rules, tcols, live & (tres_u >= cfg.node_rows))
        est_u = E._sketch(cfg).estimate_plane_mxu(
            state.gs, now_ms, tres_u, W.EV_PASS, E.sketch_config(cfg), cols=tcols
        )
        i_tthr = exp.add_f(thr_u)
        i_test = exp.add_f(est_u)

    if with_degrade:
        dslot_u = slot_vals["degrade"]
        dgu = T.small_gather_fields(
            T.pack_fields([rules.degrade.enabled, state.cb_state]), dslot_u
        )
        d_en = (dgu[:, 0] > 0) & live
        st_u = dgu[:, 1].to(I32)
        retry_due = now_ms >= T.small_gather_int(state.cb_retry_ms, dslot_u)
        open_wait = (st_u == D.CB_OPEN) & ~retry_due
        open_due = (st_u == D.CB_OPEN) & retry_due
        half = st_u == D.CB_HALF_OPEN
        i_dflags = exp.add(
            d_en.to(I32)
            | (open_wait.to(I32) << 1)
            | (open_due.to(I32) << 2)
            | (half.to(I32) << 3)
        )
        i_dslot = exp.add(
            torch.clamp_max(
                torch.where(live, dslot_u, cfg.max_degrade_rules), cfg.max_degrade_rules
            )
        )

    if with_auth:
        i_auth = exp.add(auth_u.to(I32))

    exp.run()

    # ================= item-level phase (slot order) =================
    # items in segments past the capacity have no segment-level data (their
    # expansions read slot U-1): they FAIL CLOSED as system rejections and
    # are counted by dropped_items.  Empty whenever ctx.ok, so this is a
    # no-op on the branch seg_fallback selects
    overflow = valid & (ctx.sid >= ctx.U)

    if with_auth:
        auth_block = (exp.get(i_auth) > 0) & valid & ~forced & ~overflow
    else:
        auth_block = zero_block
    eligible = valid & ~auth_block & ~forced & ~overflow

    if "system" in features:
        sys_block = E._check_system(
            cfg, state, rules, acq, now_ms, sys_load, sys_cpu, eligible
        ) | overflow
    else:
        sys_block = zero_block | overflow
    eligible = eligible & ~sys_block

    if with_param:
        fl = exp.get(i_pflags)
        p_thread_i = (fl & 2) > 0
        pslot_i = exp.get(i_pslot)
        ph = E._lane_hash(acq.param_hash, exp.get(i_plane), cfg.param_dims)
        p_app = ((fl & 1) > 0) & (ph != 0)
        elig_p = eligible & p_app
        prows, over = E.param_verdicts(
            cfg, state, rules, pcms, pcms_epochs, now_ms, pslot_i, ph, exp.get(i_pcls),
            p_thread_i, exp.get_f(i_pthr),
            torch.stack([exp.get(i) for i in i_ih], dim=1),
            torch.stack([exp.get_f(i) for i in i_it], dim=1),
            cnt, elig_p, 2,  # the rank key's multiplier is KP + 1, and KP == 1
        )
        param_block = p_app & over & elig_p & eligible
        param_state = (pcms, pcms_epochs, pcms_idx, prows, p_app & ~p_thread_i, p_app & p_thread_i)
    else:
        param_block = zero_block
        param_state = None
    eligible = eligible & ~param_block

    if with_flow:
        fl = exp.get(i_fflags)
        app_i = (fl & 1) > 0
        rl_i = (fl & 2) > 0
        wurl_i = (fl & 4) > 0
        qps_i = (fl & 8) > 0
        def_i = (fl & 16) > 0
        node_i = exp.get(i_node)
        slot_i = exp.get(i_fslot)
        margin_q = exp.get_f(i_mq)
        margin_t = exp.get_f(i_mt)
        m_rl = exp.get_f(i_mrl)
        mq_i = exp.get_f(i_maxq)
        pace_i = exp.get_f(i_pace)
        margin_o = exp.get_f(i_mo)
        # the same pacing-cost clamp as the per-item flow check
        cost = torch.where(
            rl_i,
            torch.clamp_max(torch.floor(1000.0 * cnt / pace_i + 0.5), float((1 << 24) - 1)),
            0.0,
        )
        elig_f = eligible & app_i
        rank_key = torch.where(rl_i, cfg.node_rows + slot_i, node_i).to(I32)
        direct_any = ~torch.any(
            f.enabled & ((f.strategy != STRATEGY_DIRECT) | (f.limit_app != RT.LIMIT_ANY))
        )
        seg_rank_ok = carry.res_sorted & direct_any

        # ONE B3 launch for all three ranks: they share the run heads of
        # rank_key; the token and thread ranks are narrow rows, the pacing
        # cost a wide row (its 12-bit lanes and their recombination happen
        # inside the kernel, the bits of seg_excl_cumsum_wide)
        r, r_cost = SC.seg_excl_cumsum_many(
            _head_of_runs(rank_key),
            torch.stack([torch.where(elig_f, acq.count, 0), elig_f.to(I32)]),
            torch.where(elig_f, cost, 0.0).to(I32)[None, :],
        )
        rank_tok, rank_thr = r[0].to(F32), r[1].to(F32)
        rank_cost = r_cost[0]
        if cfg.seg_static_ranks:
            # scans only (contract: sorted + DIRECT/ANY rules); a broken
            # contract makes the ranks garbage, so every applicable item
            # fails closed below instead of being misranked silently
            rank_guard = ~seg_rank_ok
        else:
            s_tok, s_thr, s_cost = grouped_exclusive_cumsum(
                rank_key, [cnt, torch.ones_like(cnt), cost], elig_f
            )
            rank_tok = torch.where(seg_rank_ok, rank_tok, s_tok)
            rank_thr = torch.where(seg_rank_ok, rank_thr, s_thr)
            rank_cost = torch.where(seg_rank_ok, rank_cost, s_cost)
            rank_guard = torch.zeros((), dtype=torch.bool, device=dev)
        qps_block = rank_tok + cnt > margin_q
        thread_block = rank_thr + cnt > margin_t
        basic_block = torch.where(qps_i, qps_block, thread_block)
        csum_incl = rank_cost + cost
        rl_wait = torch.maximum(m_rl + csum_incl, csum_incl - cost)
        rl_block = rl_wait > mq_i
        entry_block = torch.where(rl_i, rl_block, basic_block) & app_i
        entry_block = entry_block | (wurl_i & app_i & qps_block)
        entry_block = entry_block | (rank_guard & app_i)
        flow_block = entry_block & elig_f

        occupying = zero_block
        occ_wait = torch.zeros((b,), dtype=F32, device=dev)
        occ_grant = None
        if "occupy" in features:
            cand = (acq.prio > 0) & def_i & qps_i & app_i & elig_f & qps_block
            if cfg.seg_static_ranks:
                # under a broken static-rank contract nothing may occupy ahead
                cand = cand & ~rank_guard
            # the JAX phase skips this rank when no item is a candidate;
            # with no candidate every grant is False either way
            (r_occ,) = SC.seg_excl_cumsum(
                _head_of_runs(node_i), torch.where(cand, acq.count, 0)[None, :]
            )
            rank_occ = r_occ.to(F32)
            if not cfg.seg_static_ranks:
                (s_occ,) = grouped_exclusive_cumsum(node_i, [cnt], cand)
                rank_occ = torch.where(seg_rank_ok, rank_occ, s_occ)
            granted = cand & (rank_occ + cnt <= margin_o)
            still_blocked = entry_block & ~granted & elig_f
            occupying = granted & elig_f & ~still_blocked
            flow_block = still_blocked
            occ_wait_v = float(cfg.second_window_ms - (now_ms % cfg.second_window_ms))
            occ_wait = torch.where(occupying, occ_wait_v, 0.0)
            occ_grant = (granted & elig_f, node_i, cnt)

        rl_ok = rl_i & app_i & ~entry_block & elig_f & ~flow_block
        wait_ms_entry = torch.where(rl_ok, torch.clamp_min(rl_wait, 0.0), 0.0)
        wait_ms = torch.maximum(wait_ms_entry, occ_wait).to(I32)
        fslots = slot_i
        rl_info = (rl_ok, cost)
    else:
        flow_block = zero_block
        occupying = zero_block
        occ_grant = fslots = rl_info = None
        wait_ms = torch.zeros((b,), dtype=I32, device=dev)
    if with_tail:
        thr = torch.where(eligible & (acq.res >= cfg.node_rows), exp.get_f(i_tthr), RT.TAIL_UNRULED)
        est_t = exp.get_f(i_test)
        ruled = thr < RT.TAIL_UNRULED / 2
        # the within-tick rank: B3 over the runs of equal resources
        (r_t,) = SC.seg_excl_cumsum(_head_of_runs(acq.res), torch.where(ruled, acq.count, 0)[None, :])
        t_rank = r_t.to(F32)
        if cfg.seg_static_ranks:
            # an unsorted batch under the static contract: ruled tail items
            # block outright (fail closed) — the scan rank would be garbage
            tail_block = ruled & ((est_t + t_rank + cnt > thr) | ~carry.res_sorted)
        else:
            (s_t,) = grouped_exclusive_cumsum(acq.res, [cnt], ruled)
            t_rank = torch.where(carry.res_sorted, t_rank, s_t)
            tail_block = ruled & (est_t + t_rank + cnt > thr)
        flow_block = flow_block | (tail_block & eligible)
    eligible = eligible & ~flow_block

    if with_degrade:
        fl = exp.get(i_dflags)
        en_i = (fl & 1) > 0
        ow_i = (fl & 2) > 0
        od_i = (fl & 4) > 0
        hf_i = (fl & 8) > 0
        dslot_i = exp.get(i_dslot)
        probe_cand = od_i & en_i & eligible
        # the JAX phase runs the election only when some item is a
        # candidate; with none, every probe is False either way
        (r_p,) = SC.seg_excl_cumsum(_head_of_runs(dslot_i), probe_cand.to(I32)[None, :])
        p_rank = r_p.to(F32)
        if cfg.seg_static_ranks:
            # unsorted under the static contract: elect NO probes
            probe = probe_cand & (p_rank < 0.5) & carry.res_sorted
        else:
            (s_p,) = grouped_exclusive_cumsum(
                dslot_i, [torch.ones_like(dslot_i, dtype=F32)], probe_cand
            )
            p_rank = torch.where(carry.res_sorted, p_rank, s_p)
            probe = probe_cand & (p_rank < 0.5)
        entry_blk_d = en_i & (ow_i | (od_i & ~probe) | hf_i)
        degrade_block = entry_blk_d & eligible
        probe_ok = probe & ~degrade_block
        Dn1 = cfg.max_degrade_rules + 1
        flip = T.small_scatter_or(
            torch.zeros((Dn1,), dtype=I32, device=dev), dslot_i, probe_ok
        )
        cb_state = torch.where(
            (flip > 0) & (state.cb_state == D.CB_OPEN), D.CB_HALF_OPEN, state.cb_state
        ).to(I32)
    else:
        degrade_block = zero_block
        cb_state = state.cb_state

    return (
        auth_block, sys_block, param_block, param_state, flow_block, wait_ms,
        occupying, occ_grant, fslots, rl_info, degrade_block, cb_state,
    )


def completion_scatters_seg(
    cfg: EngineConfig,
    rules,
    comp,
    features: frozenset,
    ctx: SG.SegCtx,
    carry: CompCarry,
    dg,
):
    """``engine._completion_scatters_fused`` with segment-compacted
    scatters (the reference's ``process_completions_seg`` up to its
    landing): the same deltas (integer sums and float minima do not depend
    on the order), one scatter_many call on the segment axis and, with the
    ``param`` stage, one on the item axis.  ``dg``: the breaker masks or
    None.  Returns ``engine.CompletionDeltas``."""
    from sentinel_tpu_torch.ops import engine as E

    b = comp.res.shape[0]
    U = ctx.U
    dev = comp.res.device
    valid = comp.res != cfg.trash_row
    with_nodes = "nodes" in features

    vals3_u, digits3, spec3 = _chunks_to_planes(SG.sums_from_ce(ctx, carry.ce, carry.split))
    stat_rows = _stat_rows_u(cfg, ctx, carry, with_nodes)
    jobs = [E._rows_job(cfg, FU.Job("stat", cfg.max_nodes, stat_rows, vals3_u, digits3))]

    # exact per-row windowed minRt over the compacted per-segment minima;
    # jnp.tile is Tensor.repeat (row-vector after row-vector)
    RMIN = stat_rows.shape[0]
    seg_min = torch.where(carry.min_rt < 1.0e38, carry.min_rt, -1.0)
    mh_rows, mh_vals = RM.min_heads(
        torch.where(stat_rows < cfg.max_nodes, stat_rows, -1).reshape(-1),
        seg_min.repeat(RMIN),
        torch.ones((RMIN * U,), dtype=torch.bool, device=dev),
        cfg.max_nodes,
    )
    jobs.append(
        E._rows_job(cfg, FU.Job(
            "rowmin",
            cfg.max_nodes,
            mh_rows.reshape(RMIN, U),
            mh_vals.T.reshape(3, RMIN, U).permute(1, 0, 2),
            (2, 2, 1),
        ))
    )
    if cfg.sketch_stats:
        jobs += E.sketch_jobs(cfg, carry.res, _live_res(cfg, ctx, carry), vals3_u, digits3)
    n_pre = len(jobs)

    if dg is not None:
        KD = cfg.degrade_rules_per_resource
        slots_f, _cb_counts, _cb_epochs, active, is_err, is_slow, g_idx, half_open = dg
        nbd = cfg.cb_sample_count
        Dn = cfg.max_degrade_rules
        probe_done = active & half_open
        probe_fail = probe_done & (is_err | is_slow)
        flat = torch.where(slots_f < Dn, slots_f * nbd + g_idx, -1)
        pslot = torch.where(slots_f < Dn, slots_f, -1)
        planes, rows_src = [], []
        for d in range(KD):
            sl = lambda x: x.reshape(b, KD)[:, d]
            planes += [
                sl(active.to(I32)),
                sl(is_err.to(I32)),
                sl(is_slow.to(I32)),
                sl(probe_done.to(I32)),
                sl(probe_fail.to(I32)),
            ]
            rows_src += [sl(flat), sl(pslot)]
        # per-ITEM plane bound is 1 (event flags): one 2-digit chunk each
        chunks, crows = _packed_seg_values(ctx, planes, [1] * len(planes), extra_rows=rows_src)
        cbp_vals, cbp_digits, cbp_spec = _chunks_to_planes(
            [chunks[5 * d + k] for d in range(KD) for k in range(3)]
        )
        prp_vals, prp_digits, prp_spec = _chunks_to_planes(
            [chunks[5 * d + k] for d in range(KD) for k in range(3, 5)]
        )
        P2c = cbp_vals.shape[0] // KD
        P2p = prp_vals.shape[0] // KD
        jobs.append(
            FU.Job(
                "cb", Dn * nbd, torch.stack([crows[2 * d] for d in range(KD)]),
                cbp_vals.reshape(KD, P2c, U), cbp_digits[:P2c],
            )
        )
        jobs.append(
            FU.Job(
                "probe", Dn, torch.stack([crows[2 * d + 1] for d in range(KD)]),
                prp_vals.reshape(KD, P2p, U), prp_digits[:P2p],
            )
        )

    outs = FU.scatter_many(jobs)
    stat_out, min_out = outs[0], outs[1]

    # THREAD-grade param release: its own launch on the ITEM axis.  The
    # reference skips it (lax.cond) when no lane releases; lanes that
    # release nothing drop, so the always-run scatter adds zeros then
    prel = None
    if "param" in features:
        prel = E.param_release_deltas(FU.scatter_many(E.param_release_jobs(cfg, rules, comp, valid)))

    succ_h, err_h, rtq_h = _recombine(stat_out, spec3)
    sketch = cb = probe = None
    if cfg.sketch_stats:
        sketch = torch.stack(
            [torch.stack(_recombine(o, spec3), dim=1) for o in outs[2:n_pre]]
        )  # [depth, width, 3]
    if dg is not None:
        cb = torch.stack(_recombine(outs[n_pre], cbp_spec[:3]), dim=1).reshape(Dn, nbd, 3)
        probe = torch.stack(_recombine(outs[n_pre + 1], prp_spec[:2]), dim=1)
    return E.CompletionDeltas(
        succ=succ_h, err=err_h, rt=rtq_h.to(F32) / 8.0, row_min=RM.combine(min_out),
        sketch=sketch, prel=prel, cb=cb, probe=probe,
    )


def acquire_scatters_seg(
    cfg: EngineConfig,
    acq,
    features: frozenset,
    passed,
    occupying,
    valid,
    fslots,
    occ_grant,
    rl_info,
    param_ctx,
    ctx: SG.SegCtx,
    carry: AcqCarry,
):
    """``engine._acquire_scatters_fused`` with segment-compacted scatters
    (the reference's ``acquire_effects_seg`` up to its landing): every
    post-check value plane and per-lane row compacts through ONE packed
    gather, then one scatter_many call; the param-flow counts take a
    second call on the item axis.  Returns ``engine.AcquireDeltas``."""
    from sentinel_tpu_torch.ops import engine as E

    b = acq.res.shape[0]
    U = ctx.U
    with_nodes = "nodes" in features
    K = cfg.flow_rules_per_resource
    CMAX = cfg.max_batch_count

    pass_c, block_c, occ_c, _entry_deltas = E._acquire_entry_stats(
        cfg, acq, valid, passed, occupying
    )

    planes = [pass_c, block_c, occ_c]
    maxes = [CMAX, CMAX, CMAX]
    if cfg.sketch_stats:
        planes.append(torch.where(passed, acq.count, 0))  # the sketch's admitted count
        maxes.append(CMAX)
    rows_src = []
    slot_planes = []
    if fslots is not None:
        F = cfg.max_flow_rules
        cnt_f = E._fan(acq.count, K)
        w = c = n1 = None
        if "warmup" in features:
            w = torch.where(E._fan(passed, K), cnt_f, 0).reshape(b, K)
            slot_planes.append("warm")
        if rl_info is not None:
            rl_ok, cost = rl_info
            c = torch.where(rl_ok, torch.round(cost).to(I32), 0).reshape(b, K)
            n1 = torch.where(rl_ok, 1, 0).to(I32).reshape(b, K)
            slot_planes.append("latest")
        # LANE-MAJOR: the chunk slicing below walks chunks per lane
        for d in range(K):
            if w is not None:
                planes.append(w[:, d])
                maxes.append(CMAX)
            if c is not None:
                planes += [c[:, d], n1[:, d]]
                maxes += [(1 << 24) - 1, 255]
        fs = torch.where(fslots < F, fslots, -1).reshape(b, K)
        rows_src += [fs[:, d] for d in range(K)]
    if occ_grant is not None:
        grant_lane, onodes, ocnt = occ_grant
        commit = grant_lane & E._fan(occupying, K)
        cm = torch.where(commit, torch.round(ocnt).to(I32), 0).reshape(b, K)
        on = torch.where(onodes < cfg.max_nodes, onodes, -1).reshape(b, K)
        for d in range(K):
            planes.append(cm[:, d])
            maxes.append(CMAX)
            rows_src.append(on[:, d])

    chunks, crows = _packed_seg_values(ctx, planes, maxes, extra_rows=rows_src)
    pi = ri = 0
    vals3_u, digits3, spec3 = _chunks_to_planes(chunks[pi : pi + 3])
    pi += 3
    stat_rows = _stat_rows_u(cfg, ctx, carry, with_nodes)
    jobs = [E._rows_job(cfg, FU.Job("stat", cfg.max_nodes, stat_rows, vals3_u, digits3))]
    if cfg.sketch_stats:
        # (admitted count, block) per segment
        sk_vals, sk_digits, sk_spec = _chunks_to_planes([chunks[pi], chunks[1]])
        pi += 1
        jobs += E.sketch_jobs(cfg, carry.res, _live_res(cfg, ctx, carry), sk_vals, sk_digits)

    f_idx = occ_idx = None
    if fslots is not None and slot_planes:
        per_lane = (1 if "warm" in slot_planes else 0) + (2 if "latest" in slot_planes else 0)
        lane_chunks = []
        for d in range(K):
            lane_chunks.extend(chunks[pi + d * per_lane : pi + (d + 1) * per_lane])
        f_vals, f_digits, f_spec = _chunks_to_planes(lane_chunks)
        pi += K * per_lane
        P2f = f_vals.shape[0] // K
        jobs.append(
            FU.Job(
                "fslots", cfg.max_flow_rules, torch.stack(crows[ri : ri + K]),
                f_vals.reshape(K, P2f, U), f_digits[:P2f],
            )
        )
        ri += K
        f_idx = len(jobs) - 1
    elif fslots is not None:
        ri += K

    if occ_grant is not None:
        o_vals, o_digits, o_spec = _chunks_to_planes(chunks[pi : pi + K])
        pi += K
        P2o = o_vals.shape[0] // K
        jobs.append(
            E._rows_job(cfg, FU.Job(
                "occ", cfg.max_nodes, torch.stack(crows[ri : ri + K]),
                o_vals.reshape(K, P2o, U), o_digits[:P2o],
            ))
        )
        ri += K
        occ_idx = len(jobs) - 1

    outs = FU.scatter_many(jobs)
    param = None
    if param_ctx is not None:
        param = E.param_effect_deltas(FU.scatter_many(E.param_effect_jobs(cfg, acq, passed, param_ctx)))

    pass_h, block_h, occ_h = _recombine(outs[0], spec3)
    sketch = warm = latest = occ_add = None
    if cfg.sketch_stats:
        sketch = torch.stack(
            [torch.stack(_recombine(o, sk_spec), dim=1) for o in outs[1 : 1 + cfg.sketch_depth]]
        )
    if f_idx is not None:
        # lanes are row-vectors of one job, so the output is already summed
        # over lanes; recombine with lane 0's spec (lanes share it)
        cols = _recombine(outs[f_idx], f_spec[: len(f_spec) // K])
        fi = 0
        if "warm" in slot_planes:
            warm = cols[fi].to(F32)
            fi += 1
        if "latest" in slot_planes:
            latest = (cols[fi].to(F32), cols[fi + 1].to(F32))
    if occ_idx is not None:
        occ_add = _recombine(outs[occ_idx], o_spec[: len(o_spec) // K])[0].to(F32)
    return E.AcquireDeltas(
        pas=pass_h, blk=block_h, occ=occ_h, sketch=sketch, warm=warm, latest=latest,
        occ_add=occ_add, param=param,
    )
