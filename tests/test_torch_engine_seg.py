"""The port's segment-compacted tick against the JAX package's.

Both run ``fused_effects=True, seg_effects=True, seg_fallback=False`` on
the same rules and the same seeded batch stream (presorted as the client
presorts it, or left unsorted), tick by tick.  The JAX tick runs eagerly
(``jax.disable_jit``) with its Pallas kernels in interpret mode; the port
runs on the CPU with its kernels' plain versions.

Wire bytes (verdicts, the PASS_WAIT sidecar, ``seg_dropped``), wait_ms and
every integer state leaf must be EQUAL; float state leaves are held to
rtol=1e-6, atol=1e-4 (the two packages add float32 values in a different
order, which moves the last bits — the tolerance of tests/test_torch_engine.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_harness as H
from tests.test_torch_engine import (
    NOWS, PARAM_NOWS, _assert_states_match, _assert_ticks_match, _jax_tick, _port_tick, run_param_ticks,
)
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.runtime.registry import Registry as JaxRegistry
from sentinel_tpu_torch import state as S
from sentinel_tpu_torch.core import rules as TR
from sentinel_tpu_torch.core.errors import BLOCK_FLOW, BLOCK_PARAM, PASS, PASS_WAIT
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import segscan as SC
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime.registry import Registry


def _setup(b, flags, direct_only=False, device="cpu", param=False):
    kw = dict(batch_size=b, complete_batch_size=b, **H.FUSED_FLAGS, **H.SEG_FLAGS, **flags)
    jcfg, tcfg = jax_small_cfg(**kw), small_engine_config(**kw)
    jreg, treg = JaxRegistry(jcfg), Registry(tcfg)
    H.intern(jreg)
    H.intern(treg)
    rules_j = H.make_rules(JR, direct_only, param)
    rules_j["system_rules"] = [JR.SystemRule(qps=40)]
    rules_t = H.make_rules(TR, direct_only, param)
    rules_t["system_rules"] = [TR.SystemRule(qps=40)]
    jrs = JE.compile_ruleset(jcfg, jreg, **rules_j)
    trs = E.compile_ruleset(tcfg, treg, device=device, **rules_t)
    return jcfg, tcfg, treg, jrs, trs


def _stream(tcfg, treg, b, seed, sort, n, param=False):
    out = []
    for step in range(n):
        w = H.workload(tcfg, treg, seed=seed + step, b=b, param=param)
        out.append(H.presort(w) if sort else w)
    return out


def _run(b, flags, *, sort=True, direct_only=False, seed=0, device="cpu"):
    """Four ticks through both engines; returns the port's decoded frames."""
    jcfg, tcfg, treg, jrs, trs = _setup(b, flags, direct_only, device)
    with jax.disable_jit():
        js = JE.init_state(jcfg)
    ts = E.init_state(tcfg, device)
    frames, stream = [], _stream(tcfg, treg, b, 1000 * b + seed, sort, 4)
    for w, now in zip(stream, NOWS):
        js, jwire, jwait = _jax_tick(jcfg, js, jrs, w, now)
        ts, twire, twait = _port_tick(tcfg, ts, trs, w, now, device)
        _assert_ticks_match((jwire, jwait), (twire, twait))
        _assert_states_match(tcfg, js, ts)
        frames.append(WIRE.unpack(twire.tobytes(), WIRE.layout_for(tcfg, b)))
    return frames, stream, tcfg, treg


@pytest.mark.parametrize("static", [False, True])
def test_single_lane_segment_tick_matches_jax(static):
    """The segment check phase (ranks by B3, RT minima by B4): with the
    scan-only ranks the rules keep to their contract (DIRECT, default
    limitApp); without, the full rule set."""
    flags = dict(H.SINGLE_LANE, seg_static_ranks=static)
    frames, *_ = _run(96, flags, direct_only=static)
    seen = set()
    for fr in frames:
        assert fr.seg_dropped == 0
        seen |= set(fr.verdict.tolist())
    assert {PASS, BLOCK_FLOW, PASS_WAIT} <= seen


def test_single_lane_unsorted_batches_match_jax():
    """Unsorted batches: more segments, and (scan ranks off) the sort
    ranks are chosen on the device."""
    _run(64, dict(H.SINGLE_LANE), sort=False, seed=1)


def test_static_ranks_on_an_unsorted_batch_fail_closed():
    """seg_static_ranks with the contract broken (an unsorted batch): both
    engines block every flow-ruled item rather than misrank it."""
    flags = dict(H.SINGLE_LANE, seg_static_ranks=True)
    frames, stream, tcfg, treg = _run(64, flags, sort=False, direct_only=True, seed=2)
    ruled = {treg.resource_id(r.resource) for r in H.make_rules(TR, True)["flow_rules"]}
    checked = 0
    for fr, w in zip(frames, stream):
        res = w["acq"]["res"]
        if np.all(res[1:] >= res[:-1]):
            continue
        mine = np.isin(res, list(ruled))
        assert not np.any(np.isin(fr.verdict[mine], [PASS, PASS_WAIT]))
        checked += int(mine.sum())
    assert checked > 0


def test_four_lane_segment_effects_match_jax():
    """The default 4 lanes: per-item checks (B2), segment effects (B1, B4)."""
    _run(96, {}, seed=3)


def test_undersized_seg_u_fails_items_closed():
    """seg_u below the live segment count: overflow items fail closed as
    system blocks and the wire counts them, in both engines alike."""
    frames, *_ = _run(64, dict(H.SINGLE_LANE, seg_u=8), seed=4)
    assert all(fr.seg_dropped > 0 for fr in frames)


def test_segment_tick_continues_a_jax_run_state():
    b = 64
    jcfg, tcfg, treg, jrs, _ = _setup(b, dict(H.SINGLE_LANE))
    with jax.disable_jit():
        js = JE.init_state(jcfg)
    stream = _stream(tcfg, treg, b, 77, True, 4)
    for w, now in zip(stream[:2], NOWS[:2]):
        js, _, _ = _jax_tick(jcfg, js, jrs, w, now)
    ts = S.state_from_numpy(tcfg, jax.tree.map(np.asarray, js), "cpu")
    trs = S.ruleset_from_numpy(tcfg, jax.tree.map(np.asarray, jrs), "cpu")
    for w, now in zip(stream[2:], NOWS[2:]):
        js, jwire, jwait = _jax_tick(jcfg, js, jrs, w, now)
        ts, twire, twait = _port_tick(tcfg, ts, trs, w, now)
        _assert_ticks_match((jwire, jwait), (twire, twait))
        _assert_states_match(tcfg, js, ts)


@pytest.mark.parametrize(
    "lanes,carry_after", [("single", None), ("single", 1), ("four", None), ("single-static", None)]
)
def test_param_segment_tick_matches_jax(lanes, carry_after):
    """The param stage on the segment path: single lanes (the segment-level
    slot gather through the expander, the segment check) and the default 4
    lanes (per-item checks), both with the release and the pass scatters as
    their own item-axis launches; fresh and carried across from a JAX run.
    BLOCK_PARAM verdicts, wire bytes (``seg_dropped`` in them), wait_ms and
    pcms / pcms_epochs / pconc equal, across a bucket's expiry."""
    static = lanes == "single-static"
    flags = {} if lanes == "four" else dict(H.SINGLE_LANE, seg_static_ranks=static)
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, flags, direct_only=static, param=True)
    stream = _stream(tcfg, treg, b, 500, True, len(PARAM_NOWS), param=True)
    seen, ts = run_param_ticks(jcfg, tcfg, treg, jrs, trs, stream, PARAM_NOWS, carry_after=carry_after)
    assert BLOCK_PARAM in seen and {PASS, BLOCK_FLOW} <= seen
    assert int(ts.pcms.sum()) > 0 and int(ts.pconc.sum()) > 0
    assert ts.pcms_epochs.tolist()[2] == 10


def test_param_segment_tick_on_unsorted_batches_matches_jax():
    """Unsorted batches with param on: dead segment slots and more
    segments; the param rank is a sort rank either way."""
    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, dict(H.SINGLE_LANE), param=True)
    stream = _stream(tcfg, treg, b, 900, False, 4, param=True)
    seen, _ts = run_param_ticks(jcfg, tcfg, treg, jrs, trs, stream, PARAM_NOWS[:4])
    assert BLOCK_PARAM in seen


@pytest.mark.cuda
def test_param_segment_tick_on_the_card_matches_jax():
    """The single-lane segment tick with param on and the CUDA kernels
    against the JAX reference: the item-axis param launches run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from sentinel_tpu_torch.ops import fused as FU

    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, dict(H.SINGLE_LANE), device="cuda", param=True)
    stream = _stream(tcfg, treg, b, 500, True, 4, param=True)
    FU.reset_launches()
    seen, _ts = run_param_ticks(jcfg, tcfg, treg, jrs, trs, stream, PARAM_NOWS[:4], device="cuda")
    assert BLOCK_PARAM in seen
    # two segment + two item-axis calls a tick, two launches each
    assert FU.LAUNCHES["scatter_many"] == 2 * 4 * 4


@pytest.mark.cuda
def test_segment_tick_on_the_card_matches_jax():
    """The single-lane segment tick with the CUDA kernels against the JAX
    reference; B3 launches, and B4's work rides seg_build, one launch a
    side a tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    SC.reset_launches()
    _run(96, dict(H.SINGLE_LANE), device="cuda")
    assert SC.LAUNCHES["seg_excl_cumsum"] > 0 and SC.LAUNCHES["seg_build"] == 2 * 4
    assert SC.LAUNCHES["seg_incl_min"] == 0
