"""Shared inputs for the port's differential tests (tests/test_torch_*.py).

One rule set and one seeded batch stream, made with numpy and handed to
both packages: the JAX package (the reference) and sentinel_tpu_torch.
"""

from __future__ import annotations

import numpy as np

#: tick features both engines run (the JAX engine's minus param/tail_flow)
FEATURES = frozenset(
    {"authority", "system", "flow", "degrade", "warmup", "nodes", "occupy"}
)

#: config flags of the port's engine: the per-item fused path, no telemetry planes
FUSED_FLAGS = dict(
    use_mxu_tables=True,
    fused_effects=True,
    device_telemetry=False,
    timeline_k=0,
    explain_k=0,
    packed_wire=True,
)


def make_rules(R):
    """Rule kinds as in tests/test_engine_backends.py (no param rule),
    built from the given rules module (either package's copy)."""
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


def workload(cfg, reg, seed: int, b: int = None) -> dict:
    """Numpy columns of one acquire batch and one completion batch: resources
    r1..r11, some origins and context rows (so the stat fan is 3 wide),
    prioritized items, inbound items, and RTs on the 1/8 ms grid."""
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
    return dict(acq=acq, comp=comp)
