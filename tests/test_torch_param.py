"""The port's hot-parameter module and rule compiler against the JAX package's.

``ops/param.py``: ``cms_cell`` and ``pair_rows`` (the uint32 hashes, which
the port computes in int64), ``refresh``, ``class_tables``,
``estimate_fused`` and ``conc_estimate`` on the same numpy inputs through
both packages — the reference under ``use_mxu_tables=True`` (its one-hot
table reads), the port on the CPU.  Every result is an integer or an
integer-valued float32 and is held to EXACT equality.

``core/rule_tensors.py``: ``param_lanes`` equal, ``compile_param_rules``
equal leaf for leaf (dtype, shape and values).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.core import rule_tensors as JRT
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.ops import param as JP
from sentinel_tpu.runtime.registry import Registry as JaxRegistry
from sentinel_tpu_torch.core import rule_tensors as TRT
from sentinel_tpu_torch.core import rules as TR
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.ops import param as TP
from sentinel_tpu_torch.ops import tables as T
from sentinel_tpu_torch.runtime.registry import Registry

#: hashes at the edges of int32: the largest 31-bit hash, 1, 0, and negative
#: int32 bit patterns (hashes are 31-bit today, but the device sees raw bits)
EDGE_HASHES = [0x7FFFFFFF, 1, 0, 2, -1, -(2**31), -(2**31) + 1, 0x12345678, -0x12345678, 0x7FFFFFFE]


def _hashes(n=400, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    h[: len(EDGE_HASHES)] = np.array(EDGE_HASHES, dtype=np.int64).astype(np.int32)
    return h


@pytest.mark.parametrize("depth,width", [(2, 16384), (2, 512), (4, 1000), (6, 7), (7, 65536)])
def test_cms_cell_equals_the_jax_function(depth, width):
    h = _hashes()
    want = np.asarray(JP.cms_cell(jnp.asarray(h), depth, width))
    got = TP.cms_cell(torch.as_tensor(h), depth, width)
    assert got.dtype == torch.int32 and tuple(got.shape) == (h.size, depth)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < width


@pytest.mark.parametrize("depth,width", [(2, 16384), (2, 512), (3, 999)])
def test_pair_rows_equals_the_jax_function_for_every_slot(depth, width):
    h = _hashes(seed=1)
    for slot in range(0, 33):
        slots = np.full(h.size, slot, np.int32)
        want = np.asarray(JP.pair_rows(jnp.asarray(slots), jnp.asarray(h), depth, width))
        got = TP.pair_rows(torch.as_tensor(slots), torch.as_tensor(h), depth, width)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"slot {slot}")
    # distinct slots put one value on different rows (almost always)
    a = TP.pair_rows(torch.zeros(h.size, dtype=torch.int32), torch.as_tensor(h), depth, width)
    b = TP.pair_rows(torch.ones(h.size, dtype=torch.int32), torch.as_tensor(h), depth, width)
    assert (a != b).any(dim=1).float().mean() > 0.9


def _cfgs(**kw):
    flags = dict(use_mxu_tables=True, fused_effects=True, device_telemetry=False, timeline_k=0, explain_k=0)
    flags.update(kw)
    return jax_small_cfg(**flags), small_engine_config(**flags)


def _store(cfg, seed, hi=50):
    rng = np.random.default_rng(seed)
    pcms = rng.integers(0, hi, (cfg.param_depth, cfg.param_width, cfg.param_sample_count)).astype(np.int32)
    pconc = rng.integers(0, hi, (cfg.param_depth, cfg.param_width)).astype(np.int32)
    return pcms, pconc


@pytest.mark.parametrize("now_ms", [0, 499, 500, 4_050, 123_456, -1, -501])
def test_refresh_equals_the_jax_function(now_ms):
    """The current bucket's column is zeroed when its epoch is stale and kept
    when it is current; negative times floor-divide."""
    jcfg, tcfg = _cfgs()
    pcms, _ = _store(tcfg, 2)
    nb = tcfg.param_sample_count
    wid = now_ms // tcfg.param_bucket_ms
    for epochs in (
        np.full(nb, -(nb + 1), np.int32),
        np.arange(wid - nb + 1, wid + 1, dtype=np.int32)[np.argsort((np.arange(wid - nb + 1, wid + 1) % nb))],
    ):
        jp, je, jidx = JP.refresh(jnp.asarray(pcms), jnp.asarray(epochs), jnp.int32(now_ms), jcfg)
        tp, te, tidx = TP.refresh(torch.as_tensor(pcms), torch.as_tensor(epochs), now_ms, tcfg)
        assert int(jidx) == tidx
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the second epochs are current everywhere: nothing was zeroed
    np.testing.assert_array_equal(tp.numpy(), pcms)


@pytest.mark.parametrize("now_ms", [4_050, 7_999, -20])
def test_class_tables_equal_the_jax_function(now_ms):
    jcfg, tcfg = _cfgs()
    pcms, _ = _store(tcfg, 3, hi=100_000)
    nb = tcfg.param_sample_count
    wid = now_ms // tcfg.param_bucket_ms
    rng = np.random.default_rng(4)
    # some columns current, some stale, one from the future
    epochs = (wid - rng.integers(0, 2 * nb, nb)).astype(np.int32)
    epochs[0] = wid + 1
    class_k = np.array([2, 4, 8, 1], np.int32)
    want = np.asarray(JP.class_tables(jnp.asarray(pcms), jnp.asarray(epochs), jnp.asarray(class_k), jnp.int32(now_ms), jcfg))
    got = TP.class_tables(torch.as_tensor(pcms), torch.as_tensor(epochs), torch.as_tensor(class_k), now_ms, tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("digits", [3, 1])
def test_estimate_fused_equals_the_jax_function(digits):
    """Saturation at 256**param_est_digits - 1 comes before the read."""
    jcfg, tcfg = _cfgs(param_est_digits=digits)
    rng = np.random.default_rng(5)
    C = tcfg.param_classes
    wtab = rng.integers(0, 3000, (tcfg.param_depth, tcfg.param_width, C)).astype(np.float32)
    wtab[0, :5] = [2**24 + 5, 255, 256, 65535, 65536][:C] if C >= 5 else 2**24 + 5
    n = 300
    rows = rng.integers(0, tcfg.param_width, (n, tcfg.param_depth)).astype(np.int32)
    rows[:5, 0] = np.arange(5)
    cls = rng.integers(0, C, n).astype(np.int32)
    cls[:3] = [-1, C, C + 5]  # clipped, as in the reference
    want = np.asarray(JP.estimate_fused(jcfg, jnp.asarray(wtab), jnp.asarray(rows), jnp.asarray(cls)))
    got = TP.estimate_fused(tcfg, torch.as_tensor(wtab), torch.as_tensor(rows), torch.as_tensor(cls))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() <= 256**digits - 1


def test_conc_estimate_equals_the_jax_function():
    jcfg, tcfg = _cfgs()
    _, pconc = _store(tcfg, 6)
    pconc[0, :3] = [2**24 + 9, 2**24 - 1, 0]  # saturates at 2^24 - 1
    rng = np.random.default_rng(7)
    rows = rng.integers(0, tcfg.param_width, (200, tcfg.param_depth)).astype(np.int32)
    rows[:3, 0] = [0, 1, 2]
    want = np.asarray(JP.conc_estimate(jcfg, jnp.asarray(pconc), jnp.asarray(rows)))
    got = TP.conc_estimate(tcfg, torch.as_tensor(pconc), torch.as_tensor(rows))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_reads_the_param_stage_uses():
    """big_gather with max_int reads modulo 256**digits (the reference's
    digit planes); lane_gather_1col zeroes ids outside the table."""
    tab = torch.tensor([0, 255, 256, 70000, 5], dtype=torch.int32)
    idx = torch.tensor([1, 2, 3, -1, 5, 4], dtype=torch.int32)
    assert T.big_gather(tab, idx, 5, max_int=255).tolist() == [255, 0, 70000 % 256, 0, 0, 5]
    assert T.big_gather(tab, idx, 5, max_int=65535).tolist() == [255, 256, 70000 % 65536, 0, 0, 5]
    assert T.big_gather(tab, idx, 5).tolist() == [255, 256, 70000, 0, 0, 5]
    assert T.lane_gather_1col(tab, idx, 5).tolist() == [255.0, 256.0, 70000.0, 0.0, 0.0, 5.0]


# -- the rule compiler ------------------------------------------------------------


def _param_rules(R):
    """Durations 1 s, 2 s and 10 s (past the 8 x 500 ms grid: clamped, its
    threshold scaled), a fifth duration past ``param_classes`` (reuses the
    nearest class), THREAD grade, exception items (one list longer than
    the item slots), a rule whose param_idx loses its lane (two earlier
    rules on its resource hold both lanes), a third rule on one resource
    (past KP = 2), invalid rules, and more rules than ``max_param_rules``."""
    items = [R.ParamFlowItem(object=f"vip{i}", count=5 + i) for i in range(10)]
    return [
        R.ParamFlowRule(resource="a", count=2, duration_in_sec=1),
        R.ParamFlowRule(resource="a", count=3, param_idx=2, duration_in_sec=2, burst_count=4),
        R.ParamFlowRule(resource="a", count=9, param_idx=1),  # a third rule on "a"
        R.ParamFlowRule(resource="b", count=7, duration_in_sec=10, param_flow_item_list=items[:2]),
        R.ParamFlowRule(resource="c", count=4, grade=R.GRADE_THREAD, duration_in_sec=3, param_flow_item_list=items),
        R.ParamFlowRule(resource="d", count=1, duration_in_sec=4),
        R.ParamFlowRule(resource="e", count=6, duration_in_sec=3),  # a fifth class: nearest reused
        R.ParamFlowRule(resource="f", count=-1),  # invalid
        R.ParamFlowRule(resource="g", count=-5, param_idx=7),  # invalid, but it claims a lane
        R.ParamFlowRule(resource="g", count=5, param_idx=8),
        R.ParamFlowRule(resource="g", count=5, param_idx=9),
        R.ParamFlowRule(resource="h", count=8, param_idx=0, grade=R.GRADE_THREAD,
                        param_flow_item_list=[R.ParamFlowItem(object="x", count=2)]),
        R.ParamFlowRule(resource="i", count=8),
        R.ParamFlowRule(resource="j", count=8),  # past max_param_rules = 8
    ]


def _assert_leaves_equal(got, want):
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("kp", [2, 1])
def test_compile_param_rules_equals_the_jax_compiler_leaf_for_leaf(kp, caplog):
    jcfg, tcfg = _cfgs(param_rules_per_resource=kp)
    jreg, treg = JaxRegistry(jcfg), Registry(tcfg)
    jrules, trules = _param_rules(JR), _param_rules(TR)
    assert TRT.param_lanes(trules, tcfg.param_dims) == JRT.param_lanes(jrules, jcfg.param_dims)
    want = JRT.compile_param_rules(jrules, jcfg, jreg)
    with caplog.at_level(logging.WARNING, logger="sentinel_tpu_torch.core.rule_tensors"):
        got = TRT.compile_param_rules(trules, tcfg, treg)
    _assert_leaves_equal(got, want)
    # the cases the rule list is there for
    assert got.enabled.sum() == tcfg.max_param_rules
    if kp == 2:
        assert (got.lane[got.enabled] == -1).any()  # "g" param_idx 9 lost its lane ...
        assert "will NOT be enforced" in caplog.text  # ... and the compiler said so
    assert len(set(got.class_k.tolist())) == tcfg.param_classes  # the class table is full
    assert (got.grade[got.enabled] == TR.GRADE_THREAD).any()
    assert (got.item_hash != 0).sum() >= 2 + 8
    # and with the client's lane map handed in, priority rules first
    lanes_j = JRT.param_lanes(jrules, jcfg.param_dims, priority=[jrules[1]])
    lanes_t = TRT.param_lanes(trules, tcfg.param_dims, priority=[trules[1]])
    assert lanes_t == lanes_j and lanes_t["a"][0] == 2
    _assert_leaves_equal(
        TRT.compile_param_rules(trules, tcfg, Registry(tcfg), lanes=lanes_t),
        JRT.compile_param_rules(jrules, jcfg, JaxRegistry(jcfg), lanes=lanes_j),
    )


def test_param_ruleset_carries_across():
    """ruleset_from_numpy carries RuleSet.param instead of raising."""
    import jax

    from sentinel_tpu.ops import engine as JE
    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.ops import engine as E

    jcfg, tcfg = _cfgs()
    jrs = JE.compile_ruleset(jcfg, JaxRegistry(jcfg), param_rules=_param_rules(JR)[:6])
    trs = S.ruleset_from_numpy(tcfg, jax.tree.map(np.asarray, jrs), "cpu")
    own = E.compile_ruleset(tcfg, Registry(tcfg), param_rules=_param_rules(TR)[:6], device="cpu")
    assert isinstance(trs.param.enabled, torch.Tensor) and trs.param.enabled.any()
    for name, a, b in zip(own.param._fields, own.param, trs.param):
        assert a.dtype == b.dtype and torch.equal(a, b), name
