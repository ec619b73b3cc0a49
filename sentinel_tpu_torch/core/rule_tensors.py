"""Rule compilation: rule objects → structure-of-arrays tensors.

The port's own copy of the numpy compilers of
``sentinel_tpu/core/rule_tensors.py`` for the rule kinds this package
enforces — flow, degrade, param-flow, authority, system and the
sketch-tail flow thresholds — plus ``hash_param`` and ``param_lanes``.
The analog of FlowRuleUtil.buildFlowRuleMap/generateRater
(slots/block/flow/FlowRuleUtil.java:45-136): on a (re)load
the whole rule set is recompiled into dense arrays indexed by *rule slot*,
plus per-resource lookup tables ``res_* : int32[max_resources + 1, K]``
mapping a resource id to its rule slots.

Every array family has one extra "trash" slot at index ``max_*`` with
``enabled=False`` so lookups never need bounds branches.  The compilers
produce numpy; ``to_device`` turns a compiled NamedTuple into tensors.
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple

import numpy as np
import torch

from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.core.config import EngineConfig

# limit_app encodings
LIMIT_ANY = -1  # "default" — matches every origin
LIMIT_OTHER = -2  # "other" — matches origins not named by any sibling rule

AUTH_EMPTY = -9  # never a valid origin id (-1 means "no origin")


class FlowRuleTensors(NamedTuple):
    enabled: np.ndarray  # bool [F+1]
    res: np.ndarray  # int32 [F+1]
    grade: np.ndarray  # int32 — 0 thread / 1 qps
    count: np.ndarray  # float32 threshold
    behavior: np.ndarray  # int32 control behavior
    strategy: np.ndarray  # int32 direct/relate/chain
    ref_node: np.ndarray  # int32 node row for RELATE (-1 = none)
    ref_ctx: np.ndarray  # int32 interned context name for CHAIN (-1 = none)
    limit_app: np.ndarray  # int32 (LIMIT_ANY / LIMIT_OTHER / origin id)
    max_queue_ms: np.ndarray  # int32 (rate-limiter queueing budget)
    cluster_mode: np.ndarray  # bool
    # warm-up precomputation (WarmUpController.java:103-112)
    warning_token: np.ndarray  # float32
    max_token: np.ndarray  # float32
    slope: np.ndarray  # float32
    cold_factor: np.ndarray  # float32
    res_rules: np.ndarray  # int32 [max_resources + 1, K] rule slots (trash padded)


class DegradeRuleTensors(NamedTuple):
    enabled: np.ndarray  # bool [D+1]
    res: np.ndarray  # int32
    grade: np.ndarray  # int32 (0 slow-ratio, 1 error-ratio, 2 error-count)
    count: np.ndarray  # float32 (max RT / ratio / count)
    slow_ratio: np.ndarray  # float32
    retry_timeout_ms: np.ndarray  # int32
    min_request: np.ndarray  # int32
    window_ms: np.ndarray  # int32 per-rule bucket length (= statInterval / nb)
    res_cbs: np.ndarray  # int32 [max_resources + 1, KD]


class ParamRuleTensors(NamedTuple):
    enabled: np.ndarray  # bool [P+1]
    res: np.ndarray  # int32
    grade: np.ndarray  # int32 — GRADE_QPS (windowed budget) or GRADE_THREAD
    threshold: np.ndarray  # float32 — count * duration + burst (window budget)
    cls: np.ndarray  # int32 [P+1] duration-class index (ops/param.py)
    lane: np.ndarray  # int32 [P+1] which param_hash lane the rule reads (-1 none)
    item_hash: np.ndarray  # int32 [P+1, KI] per-value exceptions
    item_threshold: np.ndarray  # float32 [P+1, KI]
    res_params: np.ndarray  # int32 [max_resources + 1, KP]
    class_k: np.ndarray  # int32 [param_classes] window length (buckets) per class


#: per-value exception items a param rule carries
_PARAM_ITEM_SLOTS = 8


class TailFlowTensors(NamedTuple):
    """Approximate QPS thresholds for SKETCH-TAIL resources (ids beyond the
    exact row space).  Thresholds live in depth hashed cells (the sketch's
    hashes, ops/param.cms_cell); a lookup takes the max over depth, so a
    collision in one depth row cannot tighten an unruled resource's
    budget — only a resource colliding with a ruled cell in EVERY depth
    can be falsely limited:

        P(false limit) <= (n_tail_rules / width) ** depth        (delta)

    and enforcement reads the sketch's windowed pass estimate, whose
    overestimate over-blocks by at most eps = e/width of window volume —
    both errors in the conservative direction."""

    thr: np.ndarray  # float32 [sketch_depth, sketch_width]; >= TAIL_UNRULED = unruled


#: finite "unruled" sentinel, the reference's (+inf would turn its one-hot
#: contraction into 0*inf = NaN); no real threshold approaches it
TAIL_UNRULED = 2.0e38


def compile_tail_flow_rules(tail_rules: List[tuple], cfg: EngineConfig) -> TailFlowTensors:
    """tail_rules: [(sketch_resource_id, count), ...] — QPS grade only.

    ``count`` is a QPS; the cell threshold is count times the sketch tier's
    window interval in seconds (enforcement compares it with the WINDOWED
    pass sum), clamped just below the read's 2^24 - 1 cap so a rule past
    it still enforces at the cap.  Colliding rules take the MIN threshold
    per cell (conservative).  Vectorized over rules."""
    from sentinel_tpu_torch.ops.param import cms_cell

    thr = np.full((cfg.sketch_depth, cfg.sketch_width), TAIL_UNRULED, dtype=np.float32)
    if tail_rules:
        nb, wms = cfg.sketch_shape
        scale = (nb * wms) / 1000.0
        ids = np.asarray([rid for rid, _ in tail_rules], dtype=np.int32)
        counts = np.asarray([c for _rid, c in tail_rules], dtype=np.float32) * np.float32(scale)
        counts = np.minimum(counts, np.float32((1 << 24) - 2))
        cols = cms_cell(torch.from_numpy(ids), cfg.sketch_depth, cfg.sketch_width).numpy()  # stlint: disable=blocking-under-lock — a host tensor (torch.from_numpy): host arithmetic, no device to wait for
        for d in range(cfg.sketch_depth):
            np.minimum.at(thr[d], cols[:, d], counts)
    return TailFlowTensors(thr=thr)


class AuthorityTensors(NamedTuple):
    mode: np.ndarray  # int32 [max_resources + 1] 0 none / 1 white / 2 black
    origins: np.ndarray  # int32 [max_resources + 1, KA] (AUTH_EMPTY = empty)


class SystemTensors(NamedTuple):
    # scalar thresholds, negative = unset (SystemRuleManager.java:68-97)
    load: np.ndarray  # float32 []
    cpu: np.ndarray
    qps: np.ndarray
    avg_rt: np.ndarray
    max_thread: np.ndarray


def to_device(t: NamedTuple, device) -> NamedTuple:
    """The same NamedTuple with every numpy field as a tensor on
    ``device`` (bool stays bool, int32 stays int32, float32 stays
    float32; 0-d scalars become 0-d tensors)."""
    return type(t)(
        *[torch.as_tensor(np.asarray(x)).to(device) for x in t]
    )


def compile_flow_rules(
    rules: List[R.FlowRule], cfg: EngineConfig, registry
) -> FlowRuleTensors:
    F = cfg.max_flow_rules
    K = cfg.flow_rules_per_resource
    t = FlowRuleTensors(
        enabled=np.zeros(F + 1, dtype=bool),
        res=np.zeros(F + 1, dtype=np.int32),
        grade=np.full(F + 1, R.GRADE_QPS, dtype=np.int32),
        count=np.zeros(F + 1, dtype=np.float32),
        behavior=np.zeros(F + 1, dtype=np.int32),
        strategy=np.zeros(F + 1, dtype=np.int32),
        ref_node=np.full(F + 1, -1, dtype=np.int32),
        ref_ctx=np.full(F + 1, -1, dtype=np.int32),
        limit_app=np.full(F + 1, LIMIT_ANY, dtype=np.int32),
        max_queue_ms=np.full(F + 1, 500, dtype=np.int32),
        cluster_mode=np.zeros(F + 1, dtype=bool),
        warning_token=np.zeros(F + 1, dtype=np.float32),
        max_token=np.zeros(F + 1, dtype=np.float32),
        slope=np.zeros(F + 1, dtype=np.float32),
        cold_factor=np.full(F + 1, 3.0, dtype=np.float32),
        res_rules=np.full((cfg.max_resources + 1, K), F, dtype=np.int32),
    )
    slot = 0
    per_res_count: dict = {}
    for rule in rules:
        if not rule.is_valid() or slot >= F:
            continue
        rid = registry.resource_id(rule.resource)
        if rid is None or rid > cfg.max_resources:
            # no exact row (pass-through resource) -> the rule cannot be
            # enforced
            continue
        k = per_res_count.get(rid, 0)
        if k >= K:
            continue  # per-resource rule capacity
        per_res_count[rid] = k + 1
        t.res_rules[rid, k] = slot

        t.enabled[slot] = True
        t.res[slot] = rid
        t.grade[slot] = rule.grade
        t.count[slot] = rule.count
        t.behavior[slot] = rule.control_behavior
        t.strategy[slot] = rule.strategy
        t.max_queue_ms[slot] = rule.max_queueing_time_ms
        t.cluster_mode[slot] = rule.cluster_mode

        if rule.strategy == R.STRATEGY_RELATE and rule.ref_resource:
            ref = registry.resource_id(rule.ref_resource)
            t.ref_node[slot] = ref if ref is not None else -1
        elif rule.strategy == R.STRATEGY_CHAIN and rule.ref_resource:
            # CHAIN: rule applies when the item's context name equals
            # refResource (FlowRuleChecker.selectReferenceNode)
            t.ref_ctx[slot] = registry.context_id(rule.ref_resource)

        la = rule.limit_app or R.LIMIT_APP_DEFAULT
        if la == R.LIMIT_APP_DEFAULT:
            t.limit_app[slot] = LIMIT_ANY
        elif la == R.LIMIT_APP_OTHER:
            t.limit_app[slot] = LIMIT_OTHER
        else:
            t.limit_app[slot] = registry.origin_id(la)

        # Guava-style warm-up precomputation (WarmUpController.java:103-112)
        cf = max(float(rule.cold_factor), 2.0)
        count = max(float(rule.count), 1e-9)
        wp = max(int(rule.warm_up_period_sec), 1)
        warning = (wp * count) / (cf - 1.0)
        max_tok = warning + 2.0 * wp * count / (1.0 + cf)
        slope_v = (cf - 1.0) / count / max(max_tok - warning, 1e-9)
        t.warning_token[slot] = warning
        t.max_token[slot] = max_tok
        t.slope[slot] = slope_v
        t.cold_factor[slot] = cf
        slot += 1
    return t


def compile_degrade_rules(
    rules: List[R.DegradeRule], cfg: EngineConfig, registry
) -> DegradeRuleTensors:
    D = cfg.max_degrade_rules
    KD = cfg.degrade_rules_per_resource
    nb = cfg.cb_sample_count
    t = DegradeRuleTensors(
        enabled=np.zeros(D + 1, dtype=bool),
        res=np.zeros(D + 1, dtype=np.int32),
        grade=np.zeros(D + 1, dtype=np.int32),
        count=np.zeros(D + 1, dtype=np.float32),
        slow_ratio=np.ones(D + 1, dtype=np.float32),
        retry_timeout_ms=np.full(D + 1, 1000, dtype=np.int32),
        min_request=np.full(D + 1, 5, dtype=np.int32),
        window_ms=np.full(D + 1, 1000 // nb, dtype=np.int32),
        res_cbs=np.full((cfg.max_resources + 1, KD), D, dtype=np.int32),
    )
    slot = 0
    per_res_count: dict = {}
    for rule in rules:
        if not rule.is_valid() or slot >= D:
            continue
        rid = registry.resource_id(rule.resource)
        if rid is None or rid > cfg.max_resources:
            continue
        k = per_res_count.get(rid, 0)
        if k >= KD:
            continue
        per_res_count[rid] = k + 1
        t.res_cbs[rid, k] = slot
        t.enabled[slot] = True
        t.res[slot] = rid
        t.grade[slot] = rule.grade
        t.count[slot] = rule.count
        t.slow_ratio[slot] = rule.slow_ratio_threshold
        t.retry_timeout_ms[slot] = rule.time_window * 1000
        t.min_request[slot] = rule.min_request_amount
        t.window_ms[slot] = max(rule.stat_interval_ms // nb, 1)
        slot += 1
    return t


def hash_param(value) -> int:
    """Stable 31-bit hash of a parameter value (int or str) — the same
    function as the JAX package's, so hashed lanes agree across both."""
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        h = (value * 0x9E3779B1) & 0x7FFFFFFF
    else:
        h = 2166136261
        for b in str(value).encode("utf-8"):
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
        h &= 0x7FFFFFFF
    return h if h != 0 else 1  # 0 is reserved for "no parameter"


def param_lanes(
    rules: List[R.ParamFlowRule], max_dims: int, priority: List[R.ParamFlowRule] = ()
) -> dict:
    """resource -> ordered distinct param_idx list (length <= max_dims).

    Each entry hashes its first ``max_dims`` *distinct rule indices* into
    lanes; a rule reads the lane its param_idx was assigned.  ``priority``
    rules claim lanes first.  The host client derives its per-entry hash
    lanes from the SAME function so engine and host agree
    (ParamFlowChecker.java:78 dispatches on paramIdx per rule)."""
    lanes: dict = {}
    for r in list(priority) + [r for r in rules if r not in priority]:
        ls = lanes.setdefault(r.resource, [])
        if r.param_idx not in ls and len(ls) < max_dims:
            ls.append(r.param_idx)
    return lanes


def compile_param_rules(
    rules: List[R.ParamFlowRule], cfg: EngineConfig, registry, lanes: dict = None
) -> ParamRuleTensors:
    P = cfg.max_param_rules
    KP = cfg.param_rules_per_resource
    KI = _PARAM_ITEM_SLOTS
    nb = cfg.param_sample_count
    C = cfg.param_classes
    if lanes is None:
        lanes = param_lanes(rules, cfg.param_dims)
    t = ParamRuleTensors(
        enabled=np.zeros(P + 1, dtype=bool),
        res=np.zeros(P + 1, dtype=np.int32),
        grade=np.full(P + 1, R.GRADE_QPS, dtype=np.int32),
        threshold=np.zeros(P + 1, dtype=np.float32),
        cls=np.zeros(P + 1, dtype=np.int32),
        lane=np.full(P + 1, -1, dtype=np.int32),
        item_hash=np.zeros((P + 1, KI), dtype=np.int32),
        item_threshold=np.zeros((P + 1, KI), dtype=np.float32),
        res_params=np.full((cfg.max_resources + 1, KP), P, dtype=np.int32),
        class_k=np.ones(C, dtype=np.int32),
    )
    slot = 0
    per_res_count: dict = {}
    classes: list = []  # distinct window lengths (buckets), first-seen order
    for rule in rules:
        if not rule.is_valid() or slot >= P:
            continue
        rid = registry.resource_id(rule.resource)
        if rid is None or rid > cfg.max_resources:
            # no exact row (pass-through resource) -> the rule cannot be
            # enforced
            continue
        k = per_res_count.get(rid, 0)
        if k >= KP:
            continue
        dur = max(int(rule.duration_in_sec), 1)
        # window length in global buckets; durations beyond the grid clamp
        # to the full grid with the threshold scaled to preserve the RATE
        # (a >grid-duration rule enforces count*duration*(grid/duration)
        # per grid window instead of count*duration per duration window)
        want_k = max((dur * 1000) // cfg.param_bucket_ms, 1)
        k_buckets = min(want_k, nb)
        scale = k_buckets / want_k
        if k_buckets not in classes:
            if len(classes) >= C:
                # class table full: reuse the nearest class, scale threshold
                k_buckets = min(classes, key=lambda c: abs(c - k_buckets))
                scale = k_buckets / want_k
            else:
                classes.append(k_buckets)
        cls_idx = classes.index(k_buckets)
        per_res_count[rid] = k + 1
        t.res_params[rid, k] = slot
        t.enabled[slot] = True
        t.res[slot] = rid
        t.grade[slot] = rule.grade
        if rule.grade == R.GRADE_THREAD:
            # THREAD grade caps CONCURRENCY at plain `count` — duration and
            # burst are QPS-budget concepts (ParamFlowChecker THREAD branch)
            t.threshold[slot] = rule.count
        else:
            # windowed budget over the rule's duration (ParamFlowChecker
            # token bucket capacity: count * duration + burst, :127-188)
            t.threshold[slot] = (rule.count * dur + rule.burst_count) * scale
        t.cls[slot] = cls_idx
        lane_list = lanes.get(rule.resource, [])
        t.lane[slot] = (
            lane_list.index(rule.param_idx) if rule.param_idx in lane_list else -1
        )
        if t.lane[slot] < 0:
            # the rule's param_idx lost the per-resource lane assignment —
            # it cannot be enforced; surface it instead of silently no-oping
            logging.getLogger(__name__).warning(
                "param rule on %r with param_idx=%d exceeds the %d hash "
                "lanes for this resource and will NOT be enforced "
                "(raise EngineConfig.param_dims or consolidate rule indices)",
                rule.resource,
                rule.param_idx,
                len(lane_list),
            )
        for i, item in enumerate(rule.param_flow_item_list[:KI]):
            t.item_hash[slot, i] = hash_param(item.object)
            t.item_threshold[slot, i] = (
                item.count
                if rule.grade == R.GRADE_THREAD
                else item.count * dur * scale
            )
        slot += 1
    for i, kb in enumerate(classes[:C]):
        t.class_k[i] = kb
    return t


def compile_authority_rules(
    rules: List[R.AuthorityRule], cfg: EngineConfig, registry
) -> AuthorityTensors:
    KA = cfg.authority_origins_per_resource
    t = AuthorityTensors(
        mode=np.zeros(cfg.max_resources + 1, dtype=np.int32),
        origins=np.full((cfg.max_resources + 1, KA), AUTH_EMPTY, dtype=np.int32),
    )
    for rule in rules:
        if not rule.is_valid():
            continue
        rid = registry.resource_id(rule.resource)
        if rid is None or rid > cfg.max_resources:
            continue
        t.mode[rid] = 1 if rule.strategy == R.AUTHORITY_WHITE else 2
        # last rule per resource wins: clear the slots before writing
        t.origins[rid, :] = AUTH_EMPTY
        for i, o in enumerate(rule.origins()[:KA]):
            t.origins[rid, i] = registry.origin_id(o)
    return t


def tightest_threshold(*vals) -> np.float32:
    """Fold negative-means-unset system thresholds to the tightest SET
    one (SystemRuleManager.loadSystemConf semantics); -1 when all unset."""
    set_ = [float(v) for v in vals if float(v) >= 0]
    return np.float32(min(set_)) if set_ else np.float32(-1.0)


def compile_system_rules(rules: List[R.SystemRule], cfg: EngineConfig) -> SystemTensors:
    return SystemTensors(
        load=tightest_threshold(*[r.highest_system_load for r in rules]),
        cpu=tightest_threshold(*[r.highest_cpu_usage for r in rules]),
        qps=tightest_threshold(*[r.qps for r in rules]),
        avg_rt=tightest_threshold(*[r.avg_rt for r in rules]),
        max_thread=tightest_threshold(*[r.max_thread for r in rules]),
    )
