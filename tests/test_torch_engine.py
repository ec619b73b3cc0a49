"""The port's tick against the JAX package's fused tick.

Both run the per-item fused path (``fused_effects=True``, no telemetry
planes, packed wire) on the same rules and the same seeded batch stream.
The JAX tick runs eagerly (``jax.disable_jit``) with its Pallas kernels in
interpret mode; the port runs on the CPU with its kernels' plain versions.

Verdicts, wait_ms, the wire bytes and every integer state leaf (the
hot-parameter store ``pcms``, ``pcms_epochs``, ``pconc`` among them) must
be EQUAL.  Float state leaves (RT sums, warm-up tokens, latestPassedTime) are
held to rtol=1e-6, atol=1e-4: the two packages add float32 values in a
different order (XLA's reductions vs torch's), which moves the last bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_harness as H
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.runtime.registry import Registry as JaxRegistry
from sentinel_tpu_torch import state as S
from sentinel_tpu_torch.core import rules as TR
from sentinel_tpu_torch.core.config import platform_config, small_engine_config
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.runtime.registry import Registry

#: tick timestamps: inside one bucket, across buckets, and past idle gaps
#: longer than the second window
NOWS = [1_000, 1_130, 1_610, 4_050, 4_499]
#: ... for the param stage (500 ms buckets, 8 of them): two ticks in one
#: bucket, the next bucket, a 1 s rule's window running out (2,100 -> 4,050),
#: and at 5,200 bucket id 10 reuses — and zeroes — the column of bucket id 2
PARAM_NOWS = [1_000, 1_130, 1_610, 2_100, 4_050, 5_200]


def _setup(b, device="cpu", param=False):
    jcfg = jax_small_cfg(batch_size=b, complete_batch_size=b, **H.FUSED_FLAGS)
    tcfg = small_engine_config(batch_size=b, complete_batch_size=b, **H.FUSED_FLAGS)
    jreg, treg = JaxRegistry(jcfg), Registry(tcfg)
    H.intern(jreg)
    H.intern(treg)
    rules_j = H.make_rules(JR, param=param)
    rules_j["system_rules"] = [JR.SystemRule(qps=40)]
    rules_t = H.make_rules(TR, param=param)
    rules_t["system_rules"] = [TR.SystemRule(qps=40)]
    jrs = JE.compile_ruleset(jcfg, jreg, **rules_j)
    trs = E.compile_ruleset(tcfg, treg, device=device, **rules_t)
    return jcfg, tcfg, treg, jrs, trs


def _jax_tick(jcfg, js, jrs, w, now, features=H.FEATURES):
    acq = JE.AcquireBatch(**{k: jnp.asarray(v) for k, v in w["acq"].items()})
    comp = JE.CompleteBatch(**{k: jnp.asarray(v) for k, v in w["comp"].items()})
    with jax.disable_jit():
        js, out = JE.tick(js, jrs, acq, comp, jnp.int32(now), jnp.float32(0.5),
                          jnp.float32(0.2), jcfg, features)
        return js, np.asarray(out.wire), np.asarray(out.wait_ms)


def _port_tick(tcfg, ts, trs, w, now, device="cpu", features=H.FEATURES):
    acq = E.AcquireBatch(**{k: torch.as_tensor(v).to(device) for k, v in w["acq"].items()})
    comp = E.CompleteBatch(**{k: torch.as_tensor(v).to(device) for k, v in w["comp"].items()})
    ts, out = E.tick(ts, trs, acq, comp, now, 0.5, 0.2, tcfg, features)
    return ts, out.wire.cpu().numpy(), out.wait_ms.cpu().numpy()


def _assert_states_match(tcfg, js, ts):
    want = S.leaves(S.state_from_numpy(tcfg, jax.tree.map(np.asarray, js), "cpu"))
    got = S.leaves(ts)
    assert want.keys() == got.keys()
    for k in want:
        a, b = want[k].numpy(), got[k].cpu().numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def _assert_ticks_match(jout, tout):
    jwire, jwait = jout
    twire, twait = tout
    assert twire.tobytes() == jwire.tobytes()  # verdict bitmap + sidecar + header
    np.testing.assert_array_equal(twait, jwait)


def _run_against_jax(b, device):
    from sentinel_tpu_torch.ops import wire as WIRE

    jcfg, tcfg, treg, jrs, trs = _setup(b, device)
    with jax.disable_jit():
        js = JE.init_state(jcfg)
    ts = E.init_state(tcfg, device)
    seen = set()
    for step, now in enumerate(NOWS[:4]):
        w = H.workload(tcfg, treg, seed=100 * b + step, b=b)
        js, jwire, jwait = _jax_tick(jcfg, js, jrs, w, now)
        ts, twire, twait = _port_tick(tcfg, ts, trs, w, now, device)
        _assert_ticks_match((jwire, jwait), (twire, twait))
        _assert_states_match(tcfg, js, ts)
        seen |= set(WIRE.unpack(twire.tobytes(), WIRE.layout_for(tcfg, b)).verdict.tolist())
    # pass, flow, degrade, system, authority and pacing verdicts all occurred
    assert {0, 1, 2, 4, 5, 6} <= seen


@pytest.mark.parametrize("b", [64, 96])
def test_tick_matches_jax_fused_tick(b):
    _run_against_jax(b, "cpu")


@pytest.mark.cuda
def test_tick_on_the_card_matches_jax_fused_tick():
    """The same check with the port on the card: its CUDA kernels, not
    their plain versions, against the JAX reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from sentinel_tpu_torch.ops import fused as FU

    FU.reset_launches()
    _run_against_jax(96, "cuda")
    # two scatter_many calls a tick, two launches each (scatter, convert)
    assert FU.LAUNCHES["scatter_many"] == 2 * 8 and FU.LAUNCHES["gather_many"] == 4


def test_tick_continues_a_jax_run_state():
    """Run the JAX tick for a while, carry its state and rules into the
    port with state_from_numpy / ruleset_from_numpy, and continue both."""
    b = 64
    jcfg, tcfg, treg, jrs, _ = _setup(b)
    with jax.disable_jit():
        js = JE.init_state(jcfg)
    for step, now in enumerate(NOWS[:2]):
        w = H.workload(tcfg, treg, seed=7 + step, b=b)
        js, _, _ = _jax_tick(jcfg, js, jrs, w, now)
    ts = S.state_from_numpy(tcfg, jax.tree.map(np.asarray, js), "cpu")
    trs = S.ruleset_from_numpy(tcfg, jax.tree.map(np.asarray, jrs), "cpu")
    for step, now in enumerate(NOWS[2:], start=2):
        w = H.workload(tcfg, treg, seed=7 + step, b=b)
        js, jwire, jwait = _jax_tick(jcfg, js, jrs, w, now)
        ts, twire, twait = _port_tick(tcfg, ts, trs, w, now)
        _assert_ticks_match((jwire, jwait), (twire, twait))
        _assert_states_match(tcfg, js, ts)
    # and back: the port's state round-trips to numpy leaf for leaf
    back = S.state_from_numpy(tcfg, S.to_numpy(ts), "cpu")
    for k, v in S.leaves(back).items():
        assert torch.equal(v, S.leaves(ts)[k]), k


@pytest.mark.parametrize(
    "flags",
    [
        dict(fused_effects=False, seg_fallback=False),
        dict(fused_effects=False),
    ],
)
def test_unported_flags_raise(flags):
    """The plain scatter path (``fused_effects=False``) is ported now
    (tests/test_torch_plain.py holds it against the reference), whatever
    ``seg_fallback`` says: ``check_supported`` accepts it and the tick
    takes the plain path, as the reference's ``_use_fused`` picks it; what
    still raises is a tick stage the engine does not know."""
    base = dict(H.FUSED_FLAGS)
    base.update(flags)
    cfg = small_engine_config(**base)
    E.check_supported(cfg)
    assert not E._use_fused(cfg)
    with pytest.raises(ValueError):
        E.check_supported(cfg, H.FEATURES | {"no_such_stage"})


def test_the_param_feature_is_ported_and_unknown_features_are_refused():
    cfg = small_engine_config(**H.FUSED_FLAGS)
    assert "param" in E.ALL_FEATURES
    E.make_tick(cfg, features=H.PARAM_FEATURES)
    with pytest.raises(ValueError):
        E.make_tick(cfg, features=H.FEATURES | {"no_such_stage"})


def test_cluster_mode_param_rules_raise_naming_their_queue_item():
    """Since the cluster layer is ported, a cluster-mode param rule no
    longer raises: the engine compiles it as the reference's
    ``compile_ruleset`` does, as an ordinary param rule (the client hands
    it over only while its cluster enforcement is degraded to local
    rules).  The rule tensors equal the reference's."""
    cfg = small_engine_config(**H.FUSED_FLAGS)
    jcfg = jax_small_cfg(**H.FUSED_FLAGS)
    reg, jreg = Registry(cfg), JaxRegistry(jcfg)

    def rules(m):
        return [
            m.ParamFlowRule(resource="p", count=1, cluster_mode=True, cluster_flow_id=55),
            m.ParamFlowRule(resource="q", count=3, param_idx=1, cluster_mode=True, cluster_flow_id=56,
                            duration_in_sec=2),
            m.ParamFlowRule(resource="q", count=2),
        ]

    trs = E.compile_ruleset(cfg, reg, device="cpu", param_rules=rules(TR))
    jrs = JE.compile_ruleset(jcfg, jreg, param_rules=rules(JR))
    want = S.leaves(S.ruleset_from_numpy(cfg, jax.tree.map(np.asarray, jrs), "cpu"))
    got = S.leaves(trs)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert int(trs.param.enabled.sum()) == 3


# -- the hot-parameter stage -----------------------------------------------------


def run_param_ticks(jcfg, tcfg, treg, jrs, trs, stream, nows, device="cpu", carry_after=None):
    """Both engines over ``stream`` with the param stage on, compared tick
    by tick; ``carry_after``: run the first ticks in the JAX engine only,
    then carry its state and rules across.  Returns the verdicts seen and
    the port's final state."""
    from sentinel_tpu_torch.ops import wire as WIRE

    with jax.disable_jit():
        js = JE.init_state(jcfg)
    ts = E.init_state(tcfg, device)
    seen = set()
    for step, (w, now) in enumerate(zip(stream, nows)):
        js, jwire, jwait = _jax_tick(jcfg, js, jrs, w, now, H.PARAM_FEATURES)
        if carry_after is not None and step < carry_after:
            continue
        if carry_after is not None and step == carry_after:
            # state as it was BEFORE this tick is gone; carry the state
            # after it instead and compare from the next tick on
            ts = S.state_from_numpy(tcfg, jax.tree.map(np.asarray, js), device)
            trs = S.ruleset_from_numpy(tcfg, jax.tree.map(np.asarray, jrs), device)
            continue
        ts, twire, twait = _port_tick(tcfg, ts, trs, w, now, device, H.PARAM_FEATURES)
        _assert_ticks_match((jwire, jwait), (twire, twait))
        _assert_states_match(tcfg, js, ts)
        b = w["acq"]["res"].shape[0]
        seen |= set(WIRE.unpack(twire.tobytes(), WIRE.layout_for(tcfg, b)).verdict.tolist())
    return seen, ts


@pytest.mark.parametrize("carry_after", [None, 1])
def test_param_tick_matches_jax_fused_tick(carry_after):
    """The param stage on the per-item fused path, fresh and carried
    across from a JAX run: BLOCK_PARAM verdicts, wire bytes, wait_ms and
    pcms / pcms_epochs / pconc equal, across a bucket's expiry."""
    from sentinel_tpu_torch.core.errors import BLOCK_PARAM

    b = 64
    jcfg, tcfg, treg, jrs, trs = _setup(b, param=True)
    stream = [H.workload(tcfg, treg, seed=300 + i, b=b, param=True) for i in range(len(PARAM_NOWS))]
    seen, ts = run_param_ticks(jcfg, tcfg, treg, jrs, trs, stream, PARAM_NOWS, carry_after=carry_after)
    assert BLOCK_PARAM in seen and {0, 1} <= seen
    assert int(ts.pcms.sum()) > 0 and int(ts.pconc.sum()) > 0
    # bucket id 10 took over the column of bucket id 2
    assert ts.pcms_epochs.tolist()[2] == 10


def test_platform_config_is_the_fused_path_and_carries_across():
    """platform_config() is the segment path with the per-tick fallback,
    as the reference's accelerator default, with the reference's
    observability defaults (telemetry row, 128 timeline rows, 32 explain
    records); seg_effects=False gives the per-item fused path; both are
    supported."""
    cfg = platform_config()
    assert cfg.fused_effects and cfg.seg_effects and cfg.seg_fallback
    assert cfg.device_telemetry and cfg.timeline_k == 128 and cfg.explain_k == 32
    E.check_supported(cfg)
    fused = platform_config(seg_effects=False)
    assert fused.fused_effects and not fused.seg_effects
    E.check_supported(fused)
    # the port's EngineConfig has the JAX package's fields and defaults
    from sentinel_tpu.core.config import EngineConfig as JaxEngineConfig

    from sentinel_tpu_torch.core.config import EngineConfig

    assert dataclasses.asdict(EngineConfig()) == dataclasses.asdict(JaxEngineConfig())
