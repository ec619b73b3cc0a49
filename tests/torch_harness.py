"""Shared inputs for the port's differential tests (tests/test_torch_*.py).

One rule set and one seeded batch stream, made with numpy and handed to
both packages: the JAX package (the reference) and sentinel_tpu_torch.
"""

from __future__ import annotations

import numpy as np

#: tick features both engines run without param rules (the JAX engine's
#: minus param / tail_flow)
FEATURES = frozenset(
    {"authority", "system", "flow", "degrade", "warmup", "nodes", "occupy"}
)
#: ... and with the hot-parameter stage on
PARAM_FEATURES = FEATURES | {"param"}

#: argument values of the param workloads, hottest first; every rule's
#: param_idx 0 reads lane 0 and param_idx 1 lane 1
PARAM_VALUES = ["v0", "v1", "v2", "v3", "v4", "v5"]

#: config flags of the port's engine: the per-item fused path, no telemetry planes
FUSED_FLAGS = dict(
    use_mxu_tables=True,
    fused_effects=True,
    device_telemetry=False,
    timeline_k=0,
    explain_k=0,
    packed_wire=True,
)


#: config flags of the segment path (the port's platform_config) on top of FUSED_FLAGS
SEG_FLAGS = dict(seg_effects=True, seg_fallback=False)

#: single-lane rule tables: the segment check phase runs (engine.py's gate)
SINGLE_LANE = dict(flow_rules_per_resource=1, degrade_rules_per_resource=1, param_rules_per_resource=1)


def make_rules(R, direct_only: bool = False, param: bool = False):
    """Rule kinds as in tests/test_engine_backends.py, built from the given
    rules module (either package's copy).  ``direct_only`` leaves out the
    origin-limited and RELATE flow rules (the contract of the scan-only
    ranks, ``seg_static_ranks``).  ``param`` adds hot-parameter rules as
    tests/test_param_system_auth.py builds them: QPS and THREAD grade, two
    durations (two window classes), a burst, a per-value exception item,
    a second rule on one resource that reads another argument, and a rule
    whose param_idx lost its lane."""
    rules = _make_rules(R)
    if direct_only:
        rules["flow_rules"] = [r for r in rules["flow_rules"] if r.resource not in ("r9", "r10")]
    if param:
        rules["param_rules"] = [
            R.ParamFlowRule(resource="r1", count=2, duration_in_sec=1),
            R.ParamFlowRule(resource="r1", count=2, param_idx=1, grade=R.GRADE_THREAD),
            R.ParamFlowRule(
                resource="r5", count=1, duration_in_sec=2,
                param_flow_item_list=[R.ParamFlowItem(object=PARAM_VALUES[0], count=3)],
            ),
            R.ParamFlowRule(resource="r7", count=2, grade=R.GRADE_THREAD),
            R.ParamFlowRule(resource="r11", count=1, duration_in_sec=1, burst_count=1),
            # two invalid rules claim both of r3's lanes, so the valid one's
            # param_idx gets lane -1: it must never apply (applied through a
            # clamped lane, its zero budget would block every r3 item)
            R.ParamFlowRule(resource="r3", count=-1, param_idx=5),
            R.ParamFlowRule(resource="r3", count=-1, param_idx=6),
            R.ParamFlowRule(resource="r3", count=0, param_idx=0),
        ]
    return rules


def presort(w: dict) -> dict:
    """The client's host presort of one workload: acquires by (res,
    ctx_node, origin_node, origin_id, ctx_name), completions by (res,
    ctx_node, origin_node), both stable."""
    a, c = w["acq"], w["comp"]
    o = np.lexsort((a["ctx_name"], a["origin_id"], a["origin_node"], a["ctx_node"], a["res"]))
    oc = np.lexsort((c["origin_node"], c["ctx_node"], c["res"]))
    return dict(acq={k: v[o] for k, v in a.items()}, comp={k: v[oc] for k, v in c.items()})


def _make_rules(R):
    return dict(
        flow_rules=[
            R.FlowRule(resource="r1", count=5),
            R.FlowRule(resource="r2", count=3, control_behavior=R.CONTROL_RATE_LIMITER),
            R.FlowRule(resource="r3", count=100, grade=R.GRADE_THREAD),
            R.FlowRule(resource="r4", count=8, control_behavior=R.CONTROL_WARM_UP),
            R.FlowRule(resource="r9", count=4, limit_app="bad"),
            R.FlowRule(resource="r10", count=6, strategy=R.STRATEGY_RELATE, ref_resource="r1"),
        ],
        degrade_rules=[
            R.DegradeRule(resource="r5", grade=R.CB_STRATEGY_ERROR_COUNT, count=2, time_window=3),
            R.DegradeRule(
                resource="r6", grade=R.CB_STRATEGY_SLOW_REQUEST_RATIO, count=50,
                slow_ratio_threshold=0.5, time_window=2,
            ),
        ],
        authority_rules=[
            R.AuthorityRule(resource="r8", limit_app="bad", strategy=R.AUTHORITY_BLACK)
        ],
        system_rules=[R.SystemRule(qps=1000)],
    )


def intern(reg):
    """Intern the same names in the same order in a registry."""
    for i in range(1, 33):
        reg.resource_id(f"r{i}")
    reg.origin_id("bad")
    reg.origin_id("good")


def _param_hashes(rng, n: int, dims: int, hash_param) -> np.ndarray:
    """int32 [n, dims]: every lane's argument drawn Zipf-like from
    PARAM_VALUES; about one in five has no argument (hash 0)."""
    w = 1.0 / np.arange(1, len(PARAM_VALUES) + 1) ** 1.1
    hashes = np.array([hash_param(v) for v in PARAM_VALUES], dtype=np.int32)
    picks = hashes[rng.choice(len(PARAM_VALUES), size=(n, dims), p=w / w.sum())]
    return np.where(rng.random((n, dims)) < 0.2, 0, picks).astype(np.int32)


def workload(cfg, reg, seed: int, b: int = None, param: bool = False) -> dict:
    """Numpy columns of one acquire batch and one completion batch: resources
    r1..r11, some origins and context rows (so the stat fan is 3 wide),
    prioritized items, inbound items, and RTs on the 1/8 ms grid.  ``param``
    fills ``param_hash`` on acquires and completions from PARAM_VALUES
    (drawn after everything else, so the other columns do not depend on it)."""
    rng = np.random.default_rng(seed)
    b = b or cfg.batch_size
    trash = cfg.trash_row
    res = rng.integers(1, 12, b).astype(np.int32)
    res[rng.random(b) < 0.1] = trash  # padding items
    bad, good = reg.origin_id("bad"), reg.origin_id("good")
    oid = np.where(rng.random(b) < 0.3, bad, np.where(rng.random(b) < 0.3, good, -1)).astype(np.int32)
    res[:2], oid[:2] = 8, bad  # every batch meets the authority black list
    onode = np.array(
        [
            reg.origin_node_row(f"r{r}", "bad" if o == bad else "good") if o >= 0 and r != trash else trash
            for r, o in zip(res, oid)
        ],
        dtype=np.int32,
    )
    with_ctx = rng.random(b) < 0.2
    cnode = np.array(
        [reg.ctx_node_row(f"r{r}", "ctxA") if c and r != trash else trash for r, c in zip(res, with_ctx)],
        dtype=np.int32,
    )
    acq = dict(
        res=res,
        count=np.ones(b, np.int32),
        prio=(rng.random(b) < 0.2).astype(np.int32),
        origin_id=oid,
        origin_node=onode,
        ctx_node=cnode,
        ctx_name=np.where(with_ctx, reg.context_id("ctxA"), -1).astype(np.int32),
        inbound=(rng.random(b) < 0.5).astype(np.int32),
        param_hash=np.zeros((b, cfg.param_dims), np.int32),
        pre_verdict=np.where(rng.random(b) < 0.03, 1, 0).astype(np.int32),
    )
    comp_res = rng.integers(1, 12, b).astype(np.int32)
    comp_res[rng.random(b) < 0.1] = trash
    comp = dict(
        res=comp_res,
        origin_node=np.full(b, trash, np.int32),
        ctx_node=np.full(b, trash, np.int32),
        inbound=(rng.random(b) < 0.5).astype(np.int32),
        rt=(rng.integers(1, 960, b) / 8.0).astype(np.float32),
        success=np.ones(b, np.int32),
        error=(rng.random(b) < 0.3).astype(np.int32),
        param_hash=np.zeros((b, cfg.param_dims), np.int32),
    )
    # a few completions carry origin / context rows too
    sel = (rng.random(b) < 0.3) & (comp_res != trash)
    comp["origin_node"][sel] = [reg.origin_node_row(f"r{r}", "good") for r in comp_res[sel]]
    if param:
        from sentinel_tpu_torch.core.rule_tensors import hash_param

        acq["param_hash"] = _param_hashes(rng, b, cfg.param_dims, hash_param)
        comp["param_hash"] = _param_hashes(rng, b, cfg.param_dims, hash_param)
    return dict(acq=acq, comp=comp)


def jax_host_client(monkeypatch, cfg, time_source):
    """The JAX package's client on ``cfg``'s HOST path (the count clamp and
    narrow uploads of ``fused_effects``, the presort of ``seg_effects``),
    whose engine tick is its jitted plain path (``make_tick`` on the same
    config with the fused, MXU and segment flags off).

    The host path is what the client-surface tests compare: stage spans,
    upload bytes, extension callbacks.  The plain tick gives the same
    verdicts (the JAX package's own equivalence tests) and the same state
    and wire layouts, and compiles in seconds where an interpret-mode
    fused tick takes most of a minute.  Every column upload gets a private
    copy (ROADMAP.md Queue C: on the CPU ``jnp.asarray`` may alias the
    client's reused staging buffers)."""
    import dataclasses

    from sentinel_tpu.ops import engine as JE
    from sentinel_tpu.runtime.client import SentinelClient as JaxClient

    real = JE.make_tick

    def plain_tick(c, *args, **kw):
        return real(dataclasses.replace(c, fused_effects=False, use_mxu_tables=False, seg_effects=False),
                    *args, **kw)

    monkeypatch.setattr(JE, "make_tick", plain_tick)
    jc = JaxClient(cfg=cfg, time_source=time_source, mode="sync")
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    return jc
