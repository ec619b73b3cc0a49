"""The port's sketch-tail stage and the sketch tier in the tick, against the
JAX package's.

Both engines run ``sketch_stats=True`` (SALSA, width 256, depth 2) with
the hot block (``hotset_k``), the telemetry row, the timeline and the
explain records on the packed wire, over the same rules: exact flow and
degrade rules, and QPS flow rules on resources whose registry ids are
SKETCH ids (past the exact row space), which compile into the tail
threshold tables.  The same seeded numpy stream goes through the fused,
seg4 and seg1 (``seg_static_ranks``) paths, presorted on the segment
paths as the client presorts it.  The JAX tick runs eagerly
(``jax.disable_jit``) with its Pallas kernels in interpret mode and its
one-hot table reads; the port runs on the CPU with its kernels' plain
versions.

Verdicts, waits, every wire byte (the hot block and the explain records'
sketch flag included) and every integer state leaf (the sketch's
``words``, ``lvlmap``, ``run``, ``epochs``, ``cur`` ...) must be EQUAL;
float state leaves within rtol=1e-6, atol=1e-4, the tolerance of
tests/test_torch_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_harness as H
from tests.test_torch_engine import _assert_states_match
from sentinel_tpu.core import rule_tensors as JRT
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.ops import wire as JW
from sentinel_tpu.runtime.registry import Registry as JaxRegistry
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core import rule_tensors as RT
from sentinel_tpu_torch.core import rules as TR
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs import explain as TX
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime.registry import Registry

FEATURES = H.FEATURES | {"tail_flow"}
#: the sketch tier on, small, with every plane the wire carries
SKETCH = dict(
    max_resources=16, max_nodes=32, max_flow_rules=16, max_degrade_rules=16,
    sketch_stats=True, sketch_width=256, sketch_depth=2, hotset_k=8,
    device_telemetry=True, timeline_k=8, explain_k=16,
)
PATHS = {
    "fused": {},
    "seg4": dict(H.SEG_FLAGS),
    "seg1": dict(H.SEG_FLAGS, **H.SINGLE_LANE, seg_static_ranks=True),
}
#: two ticks in one 500 ms bucket, bucket by bucket (the sketch lands its
#: finished buckets), then a gap past the window
NOWS = [1_000, 1_130, 1_620, 2_250, 4_050]
EXACT = [f"e{i}" for i in range(10)]
TAIL = [f"t{i}" for i in range(12)]


def _rules(R):
    """Exact flow and degrade rules, and flow rules on sketch-id resources:
    three QPS rules the tail tables take, and a rate limiter and an
    origin-scoped rule they cannot (dropped with a warning)."""
    return dict(
        flow_rules=[
            R.FlowRule(resource="e0", count=5),
            R.FlowRule(resource="e1", count=4, control_behavior=R.CONTROL_RATE_LIMITER),
            R.FlowRule(resource="t0", count=3),
            R.FlowRule(resource="t1", count=2),
            R.FlowRule(resource="t2", count=6),
            R.FlowRule(resource="t3", count=1, control_behavior=R.CONTROL_RATE_LIMITER),
            R.FlowRule(resource="t4", count=1, limit_app="bad"),
        ],
        degrade_rules=[R.DegradeRule(resource="e2", grade=R.CB_STRATEGY_ERROR_COUNT, count=2, time_window=3)],
        authority_rules=[R.AuthorityRule(resource="e3", limit_app="bad", strategy=R.AUTHORITY_BLACK)],
        system_rules=[],
    )


def _intern(reg):
    """The same names in the same order: EXACT take exact rows, fillers use
    up the organic space, TAIL intern as sketch ids."""
    for n in EXACT:
        reg.resource_id(n)
    i = 0
    while not reg.is_sketch_id(reg.resource_id(f"fill{i}")):
        i += 1
    for n in TAIL:
        assert reg.is_sketch_id(reg.resource_id(n))
    reg.origin_id("bad")


def _setup(b, flags, hotset_k=8):
    kw = dict(H.FUSED_FLAGS, batch_size=b, complete_batch_size=b, **dict(SKETCH, hotset_k=hotset_k))
    kw.update(flags)
    jcfg, tcfg = jax_small_cfg(**kw), small_engine_config(**kw)
    jreg, treg = JaxRegistry(jcfg), Registry(tcfg)
    _intern(jreg)
    _intern(treg)
    jrs = JE.compile_ruleset(jcfg, jreg, **_rules(JR))
    trs = E.compile_ruleset(tcfg, treg, device="cpu", **_rules(TR))
    return jcfg, tcfg, treg, jrs, trs


def _workload(cfg, reg, seed, b):
    """Acquires and completions over the exact and tail names, Zipf-like
    (t0 and e0 hottest), some padding, some "bad" origins, RTs on the
    1/8 ms grid."""
    rng = np.random.default_rng(seed)
    trash = cfg.trash_row
    names = ["t0", "e0", "t1", "t2", "e1", "t3", "e2", "t4", "e3"] + TAIL[5:] + EXACT[4:]
    w = 1.0 / np.arange(1, len(names) + 1) ** 0.9
    ids = np.array([reg.peek_resource_id(n) for n in names], np.int32)

    def pick():
        res = ids[rng.choice(len(names), size=b, p=w / w.sum())]
        res[rng.random(b) < 0.08] = trash
        return res.astype(np.int32)

    res = pick()
    bad = rng.random(b) < 0.15
    acq = dict(
        res=res,
        count=np.ones(b, np.int32),
        prio=(rng.random(b) < 0.1).astype(np.int32),
        origin_id=np.where(bad & (res != trash), reg.origin_id("bad"), -1).astype(np.int32),
        origin_node=np.full(b, trash, np.int32),
        ctx_node=np.full(b, trash, np.int32),
        ctx_name=np.full(b, -1, np.int32),
        inbound=(rng.random(b) < 0.5).astype(np.int32),
        param_hash=np.zeros((b, cfg.param_dims), np.int32),
        pre_verdict=np.where(rng.random(b) < 0.03, 1, 0).astype(np.int32),
    )
    cres = pick()
    comp = dict(
        res=cres,
        origin_node=np.full(b, trash, np.int32),
        ctx_node=np.full(b, trash, np.int32),
        inbound=(rng.random(b) < 0.5).astype(np.int32),
        rt=(rng.integers(1, 400, b) / 8.0).astype(np.float32),
        success=np.ones(b, np.int32),
        error=(rng.random(b) < 0.3).astype(np.int32),
        param_hash=np.zeros((b, cfg.param_dims), np.int32),
    )
    return dict(acq=acq, comp=comp)


def _ticks(jcfg, tcfg, jrs, trs, stream, nows):
    with jax.disable_jit():
        js = JE.init_state(jcfg)
    ts = E.init_state(tcfg, "cpu")
    frames = []
    for w, now in zip(stream, nows):
        b = w["acq"]["res"].shape[0]
        acq = JE.AcquireBatch(**{k: jnp.asarray(v) for k, v in w["acq"].items()})
        comp = JE.CompleteBatch(**{k: jnp.asarray(v) for k, v in w["comp"].items()})
        with jax.disable_jit():
            js, jout = JE.tick(js, jrs, acq, comp, jnp.int32(now), jnp.float32(0.5), jnp.float32(0.2),
                               jcfg, FEATURES)
            jwire = np.asarray(jout.wire)
        tacq = E.AcquireBatch(**{k: torch.as_tensor(v) for k, v in w["acq"].items()})
        tcomp = E.CompleteBatch(**{k: torch.as_tensor(v) for k, v in w["comp"].items()})
        ts, tout = E.tick(ts, trs, tacq, tcomp, now, 0.5, 0.2, tcfg, FEATURES)
        twire = tout.wire.numpy()
        lo = WIRE.layout_for(tcfg, b)
        assert tuple(lo) == tuple(JW.layout_for(jcfg, b))
        assert twire.tobytes() == jwire.tobytes()  # every block, the hot block and explain included
        np.testing.assert_array_equal(tout.wait_ms.numpy(), np.asarray(jout.wait_ms))
        frames.append(WIRE.unpack(twire.tobytes(), lo))
    return frames, js, ts


def test_compile_tail_flow_rules_matches_reference():
    """Colliding ids (the min per cell), a count past the 2^24 - 2 clamp,
    the second and a minute sketch window, and no rules at all."""
    rng = np.random.default_rng(4)
    ids = rng.integers(40, 1 << 20, 300).tolist() + [77, 77]
    counts = rng.uniform(0.5, 500.0, 302).tolist()
    counts[5] = 3.0e7
    rules = list(zip(ids, counts))
    for kw in (dict(), dict(sketch_sample_count=60, sketch_window_ms=1000), dict(sketch_width=64)):
        jcfg = jax_small_cfg(sketch_stats=True, **kw)
        tcfg = small_engine_config(sketch_stats=True, **kw)
        for r in (rules, []):
            got = RT.compile_tail_flow_rules(r, tcfg).thr
            want = JRT.compile_tail_flow_rules(r, jcfg).thr
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert RT.TAIL_UNRULED == JRT.TAIL_UNRULED


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tail_ticks_match_jax(path):
    """Five ticks per path: tail rules block hot sketch ids, the hot block
    carries sketch ids, explain records carry the sketch flag, and the
    whole state — the sketch's leaves included — equals the reference's."""
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, PATHS[path])
    assert "tail_flow" in E.ALL_FEATURES
    ruled = {treg.peek_resource_id(n) for n in ("t0", "t1", "t2")}
    assert float((trs.tail.thr < RT.TAIL_UNRULED / 2).sum()) > 0
    stream = [_workload(tcfg, treg, seed=50 + i, b=b) for i in range(len(NOWS))]
    if path != "fused":
        stream = [H.presort(w) for w in stream]
    frames, js, ts = _ticks(jcfg, tcfg, jrs, trs, stream, NOWS)
    _assert_states_match(tcfg, js, ts)
    tail_blocks = hot_ids = flagged = 0
    for fr, w in zip(frames, stream):
        res = w["acq"]["res"]
        tail_blocks += int(np.sum((fr.verdict == ERR.BLOCK_FLOW) & np.isin(res, list(ruled))))
        hot_ids += int(np.sum(fr.hot[:, 0] >= tcfg.node_rows))
        _n, recs = TX.decode_section(fr.expl)
        for r in recs:
            rec = TX.decode_record(r)
            if rec.sketch_tier and not rec.forced:
                flagged += 1
                assert rec.resource >= tcfg.node_rows and rec.rule is None
                assert rec.observed is not None
    assert tail_blocks > 0 and hot_ids > 0 and flagged > 0


def test_unsorted_batch_fails_ruled_tail_items_closed_under_static_ranks():
    """seg1 with seg_static_ranks on an UNSORTED batch: the scan ranks are
    garbage, so every eligible ruled tail item blocks, as in the
    reference."""
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, PATHS["seg1"])
    stream = [_workload(tcfg, treg, seed=70 + i, b=b) for i in range(2)]
    assert not np.all(np.diff(stream[1]["acq"]["res"]) >= 0)
    frames, js, ts = _ticks(jcfg, tcfg, jrs, trs, stream, NOWS[:2])
    _assert_states_match(tcfg, js, ts)
    ruled = [treg.peek_resource_id(n) for n in ("t0", "t1", "t2")]
    w = stream[1]["acq"]
    tail = np.isin(w["res"], ruled) & (w["pre_verdict"] == 0)
    assert tail.any()
    assert np.all(frames[1].verdict[tail] == ERR.BLOCK_FLOW)


def test_hot_candidate_ties_come_out_in_reference_order():
    """Twelve sketch ids with two acquires each and K = 8: the estimates
    tie, and the hot block lists the tied ids lower row first, as
    ``lax.top_k`` does; a batch with fewer tail items than K pads with
    -1 scores."""
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, {}, hotset_k=8)
    trash = tcfg.trash_row
    ids = np.array([treg.peek_resource_id(n) for n in TAIL[5:]] + [treg.peek_resource_id("t4")] * 2, np.int32)
    w = _workload(tcfg, treg, seed=1, b=b)
    res = np.full(b, trash, np.int32)
    res[: 2 * ids.size : 2] = ids
    res[1 : 2 * ids.size : 2] = ids[::-1]
    w["acq"].update(res=res, pre_verdict=np.zeros(b, np.int32), origin_id=np.full(b, -1, np.int32))
    few = _workload(tcfg, treg, seed=2, b=b)
    few_res = np.full(b, trash, np.int32)
    few_res[:3] = ids[:3]
    few["acq"].update(res=few_res, pre_verdict=np.zeros(b, np.int32), origin_id=np.full(b, -1, np.int32))
    frames, js, ts = _ticks(jcfg, tcfg, jrs, trs, [w, few], NOWS[:2])
    hot = frames[0].hot
    assert np.sum(hot[:, 1] == hot[0, 1]) > 1  # tied estimates in the block
    assert np.all(frames[1].hot[3:, 1] == -1.0)
    _assert_states_match(tcfg, js, ts)


@pytest.mark.cuda
def test_sketch_jobs_and_the_tail_rank_on_the_card():
    """B1's sketch{d} jobs (both phases' value planes) and B3's tail rank
    over the runs of equal resources, on the card, equal to their plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import segscan as SC

    cfg = small_engine_config(**dict(H.FUSED_FLAGS, sketch_stats=True, sketch_width=16384))
    rng = np.random.default_rng(8)
    for n in (256, 2048, 131_072):
        res = np.sort(rng.integers(cfg.node_rows, cfg.node_rows + (1 << 20), n)).astype(np.int32)
        res[rng.random(n) < 0.02] = cfg.trash_row
        res = torch.as_tensor(res, device="cuda")
        valid = res != cfg.trash_row
        vals = torch.as_tensor(rng.integers(0, 256, (3, n)).astype(np.int32), device="cuda")
        jobs = E.sketch_jobs(cfg, res, valid, vals, (cfg.count_digits, cfg.count_digits, cfg.rt_digits))
        got = FU.scatter_many(jobs)
        want = FU.scatter_many_plain(jobs)
        for g, wv in zip(got, want):
            assert torch.equal(g, wv)
        head = torch.cat([torch.ones(1, dtype=torch.bool, device="cuda"), res[1:] != res[:-1]])
        cnt = torch.as_tensor(rng.integers(0, 3, (1, n)).astype(np.int32), device="cuda")
        (got,) = SC.seg_excl_cumsum(head, cnt)
        (want,) = SC.seg_excl_cumsum_plain(head, cnt)
        assert torch.equal(got, want)
