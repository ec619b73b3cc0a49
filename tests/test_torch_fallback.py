"""The port's ``seg_fallback=True`` tick against the JAX package's.

Both engines run ``fused_effects=True, seg_effects=True, seg_fallback=True``
with a small segment capacity (``seg_u=8``) over one seeded stream whose
ticks fit it on both sides, overflow it on the acquire side, on the
completion side, or on both.  The JAX tick picks the segment or the
per-item branch of each phase with ``lax.cond`` on ``ctx.ok``; it runs
eagerly (``jax.disable_jit``) with its Pallas kernels in interpret mode.
The port runs on the CPU with its kernels' plain versions, two ways from
one state: route A (no host hint: both branches of each phase run, and
``torch.where`` on the device's ``ctx.ok`` selects their deltas) and
route B (the host's exact segment count says which branch each side
needs, ``engine.tick``'s ``seg_fits``).

Wire bytes (verdicts, the PASS_WAIT sidecar, ``seg_dropped``), wait_ms and
every integer state leaf must be EQUAL; float state leaves within
rtol=1e-6, atol=1e-4, the tolerance of tests/test_torch_engine.py.
``seg_dropped`` stays 0: overflow ticks are exact through the fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_harness as H
from tests import test_torch_tail as TT
from tests.test_torch_engine import PARAM_NOWS, _assert_states_match
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.runtime.registry import Registry as JaxRegistry
from sentinel_tpu_torch import state as S
from sentinel_tpu_torch.core import rules as TR
from sentinel_tpu_torch.core.config import platform_config, small_engine_config
from sentinel_tpu_torch.core.errors import BLOCK_FLOW, PASS
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import engine_seg as ES
from sentinel_tpu_torch.ops import fused as FU
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime import presort as PS
from sentinel_tpu_torch.runtime.registry import Registry

FALLBACK = dict(seg_effects=True, seg_fallback=True, seg_u=8)
#: (acquire side overflows, completion side overflows) per tick
PATTERN = [(False, False), (True, False), (False, True), (True, True)]
ACQ_KEYS = ("res", "ctx_node", "origin_node", "origin_id", "ctx_name")
COMP_KEYS = ("res", "ctx_node", "origin_node")
B = 64


def _setup_exact(flags, direct_only, param, device="cpu"):
    kw = dict(batch_size=B, complete_batch_size=B, **H.FUSED_FLAGS, **FALLBACK, **flags)
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


def _narrow(cfg, side: dict, names, reg, rng):
    """The side's columns squeezed onto a few keys: ``names`` only, no
    origin and no context rows, padding kept."""
    trash = cfg.trash_row
    ids = np.array([reg.peek_resource_id(n) for n in names], np.int32)
    out = dict(side)
    live = side["res"] != trash
    out["res"] = np.where(live, ids[rng.integers(0, len(ids), live.shape[0])], trash).astype(np.int32)
    for k in ("origin_node", "ctx_node"):
        out[k] = np.full_like(side[k], trash)
    for k in ("origin_id", "ctx_name"):
        if k in side:
            out[k] = np.full_like(side[k], -1)
    return out


def _stream(kind, tcfg, treg, seed):
    """PATTERN's ticks, presorted as the client presorts them; each side
    of each tick holds the segment capacity or overflows it, as asked."""
    rng = np.random.default_rng(seed)
    narrow = ["e0", "e1", "t0"] if kind == "sketch" else ["r1", "r2", "r4"]
    out = []
    for i, (acq_over, comp_over) in enumerate(PATTERN):
        if kind == "sketch":
            w = TT._workload(tcfg, treg, seed + i, B)
        else:
            w = H.workload(tcfg, treg, seed=seed + i, b=B, param=kind == "seg1")
        if not acq_over:
            w["acq"] = _narrow(tcfg, w["acq"], narrow, treg, rng)
        if not comp_over:
            w["comp"] = _narrow(tcfg, w["comp"], narrow[::-1], treg, rng)
        w = H.presort(w)
        U = ES.seg_capacity(tcfg, B)
        segs_a = PS.host_seg_count([w["acq"][k] for k in ACQ_KEYS])
        segs_c = PS.host_seg_count([w["comp"][k] for k in COMP_KEYS])
        assert (segs_a > U, segs_c > U) == (acq_over, comp_over), (i, segs_a, segs_c, U)
        out.append((w, (segs_c <= U, segs_a <= U)))
    return out


def _jax_tick(jcfg, js, jrs, w, now, features):
    acq = JE.AcquireBatch(**{k: jnp.asarray(v) for k, v in w["acq"].items()})
    comp = JE.CompleteBatch(**{k: jnp.asarray(v) for k, v in w["comp"].items()})
    with jax.disable_jit():
        js, out = JE.tick(js, jrs, acq, comp, jnp.int32(now), jnp.float32(0.5),
                          jnp.float32(0.2), jcfg, features)
        return js, np.asarray(out.wire), np.asarray(out.wait_ms)


def _port_tick(tcfg, ts, trs, w, now, features, seg_fits, device="cpu"):
    acq = E.AcquireBatch(**{k: torch.as_tensor(v).to(device) for k, v in w["acq"].items()})
    comp = E.CompleteBatch(**{k: torch.as_tensor(v).to(device) for k, v in w["comp"].items()})
    ts, out = E.tick(ts, trs, acq, comp, now, 0.5, 0.2, tcfg, features, seg_fits=seg_fits)
    return ts, out.wire.cpu().numpy(), out.wait_ms.cpu().numpy()


def _setup(kind, device="cpu"):
    """(jcfg, tcfg, treg, jrs, trs, features) for one configuration."""
    if kind == "sketch":
        jcfg, tcfg, treg, jrs, trs = TT._setup(
            B, dict(FALLBACK, **H.SINGLE_LANE, seg_static_ranks=True)
        )
        return jcfg, tcfg, treg, jrs, trs, TT.FEATURES
    flags = {
        "seg4": {},
        "seg1": dict(H.SINGLE_LANE),
        "seg1-static": dict(H.SINGLE_LANE, seg_static_ranks=True),
    }[kind]
    # the param stage on seg1 only: its per-item branch lands the param
    # jobs the segment branch keeps on the item axis (the JAX tick's 4-lane
    # interpret-mode param phase would double this file's time)
    param = kind == "seg1"
    feats = H.PARAM_FEATURES if param else H.FEATURES
    return (*_setup_exact(flags, kind == "seg1-static", param, device), feats)


def _run(kind, seed, device="cpu"):
    """The stream through the JAX tick and the port's two routes, each from
    its own state, compared tick by tick; returns the port's frames."""
    jcfg, tcfg, treg, jrs, trs, feats = _setup(kind, device)
    with jax.disable_jit():
        js = JE.init_state(jcfg)
    states = {"A": E.init_state(tcfg, device), "B": E.init_state(tcfg, device)}
    lo = WIRE.layout_for(tcfg, B)
    frames = []
    for (w, fits), now in zip(_stream(kind, tcfg, treg, seed), PARAM_NOWS):
        js, jwire, jwait = _jax_tick(jcfg, js, jrs, w, now, feats)
        for route, hint in (("A", None), ("B", fits)):
            states[route], twire, twait = _port_tick(tcfg, states[route], trs, w, now, feats, hint, device)
            assert twire.tobytes() == jwire.tobytes(), (route, now)
            np.testing.assert_array_equal(twait, jwait, err_msg=route)
            _assert_states_match(tcfg, js, states[route])
            frame = WIRE.unpack(twire.tobytes(), lo)
            assert frame.seg_dropped == 0
        frames.append(frame)
    # the two routes leave the same state, leaf for leaf
    la, lb = S.leaves(states["A"]), S.leaves(states["B"])
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    return frames


@pytest.mark.parametrize("kind", ["seg4", "seg1", "seg1-static", "sketch"])
def test_fallback_tick_matches_jax_on_fitting_and_overflowing_batches(kind):
    """Every side of every tick in both branches: fits, the acquire side
    overflows, the completion side overflows, both; routes A and B."""
    frames = _run(kind, seed={"seg4": 11, "seg1": 12, "seg1-static": 13, "sketch": 14}[kind])
    seen = set()
    for fr in frames:
        seen |= set(fr.verdict.tolist())
    assert {PASS, BLOCK_FLOW} <= seen


def _count_calls(monkeypatch):
    calls = []
    real = FU.scatter_many

    def counted(jobs, *a, **kw):
        calls.append(tuple(j.name for j in jobs))
        return real(jobs, *a, **kw)

    monkeypatch.setattr(FU, "scatter_many", counted)
    return calls


def test_route_b_runs_one_branch_a_side_and_route_a_both(monkeypatch):
    """The branches each route runs, by the scatter calls of one tick: the
    segment branch's two calls (completions, acquires) with the host
    saying both sides fit; the per-item branch's two when neither does;
    all four without a hint."""
    _jcfg, tcfg, treg, _jrs, trs, feats = _setup("seg1-static")
    (w_fit, fits_fit), _w1, _w2, (w_over, fits_over) = _stream("seg1-static", tcfg, treg, 21)[:4]
    assert fits_fit == (True, True) and fits_over == (False, False)
    calls = _count_calls(monkeypatch)
    ts = E.init_state(tcfg, "cpu")
    ts, *_ = _port_tick(tcfg, ts, trs, w_fit, 1_000, feats, fits_fit)
    seg_calls = list(calls)
    calls.clear()
    ts, *_ = _port_tick(tcfg, ts, trs, w_over, 1_100, feats, fits_over)
    item_calls = list(calls)
    calls.clear()
    ts, *_ = _port_tick(tcfg, ts, trs, w_over, 1_200, feats, None)
    assert len(seg_calls) == len(item_calls) == 2
    assert len(calls) == 4


def test_a_stream_through_route_a_equals_route_b():
    """Eight ticks of fitting and overflowing batches (seg1 with the param
    stage) from one state: route A and route B give the same wires, waits
    and state, tick by tick."""
    _jcfg, tcfg, treg, _jrs, trs, feats = _setup("seg1")
    stream = _stream("seg1", tcfg, treg, 31) + _stream("seg1", tcfg, treg, 41)
    sa, sb = E.init_state(tcfg, "cpu"), E.init_state(tcfg, "cpu")
    for (w, fits), now in zip(stream, PARAM_NOWS + [6_000, 6_300]):
        sa, wa, ta = _port_tick(tcfg, sa, trs, w, now, feats, None)
        sb, wb, tb = _port_tick(tcfg, sb, trs, w, now, feats, fits)
        assert wa.tobytes() == wb.tobytes(), now
        np.testing.assert_array_equal(ta, tb)
        la, lb = S.leaves(sa), S.leaves(sb)
        for k in la:
            assert torch.equal(la[k], lb[k]), (now, k)


def test_seg_fallback_is_supported_and_the_platform_default():
    """check_supported accepts seg_effects with seg_fallback=True, and
    platform_config() turns it on, as the reference's
    platform_engine_config() does on an accelerator."""
    cfg = platform_config()
    assert cfg.seg_effects and cfg.seg_fallback and cfg.fused_effects
    E.check_supported(cfg)
    E.make_tick(small_engine_config(**H.FUSED_FLAGS, **FALLBACK))


@pytest.mark.cuda
def test_fallback_tick_on_the_card_matches_jax():
    """The single-lane fallback tick with the CUDA kernels, both routes,
    against the JAX reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _run("seg1", seed=12, device="cuda")
