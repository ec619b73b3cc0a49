"""The client's tick-loop failpoint sites, against the JAX package's.

The reference registers seven failpoint sites in its client; the port
registered three until now.  These tests hold the other four —
``runtime.tick.clock`` (a clock skew on the tick's timestamp),
``runtime.resolve.readback`` (the readback), ``runtime.resolve.fanout``
(the fan-out, before any consumer resolves) and ``runtime.seg.resize``
(the ``seg_u`` grow) — to the reference on the same plans:

* each site is in the port's catalog with the reference's description
  and action set;
* a raise at the readback or the fan-out fails that entry CLOSED
  (``SystemBlockException``, never an entry timeout) and the next entry
  serves — ``tests/test_chaos.py::test_resolve_failure_fails_entries_
  closed_not_stranded`` on both packages, with equal blocked and passed
  counts and equal verdicts after the fault;
* a clock-skew plan on the tick's timestamp gives the reference's
  verdicts entry by entry, armed and after it is disarmed;
* a raise at the ``seg_u`` resize keeps the old capacity in both
  packages, and the next overflow grows it.

Both packages run sync clients on virtual time; verdicts are integers and
compared for equality.
"""

from __future__ import annotations

import pytest

from sentinel_tpu.chaos import failpoints as JFP
from sentinel_tpu.chaos.plans import FaultPlan as JPlan
from sentinel_tpu.chaos.plans import FaultSpec as JSpec
from sentinel_tpu.core import errors as JERR
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

from sentinel_tpu_torch.chaos import failpoints as TFP
from sentinel_tpu_torch.chaos.plans import FaultPlan as TPlan
from sentinel_tpu_torch.chaos.plans import FaultSpec as TSpec
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.core.config import platform_config, small_engine_config
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.torch_harness import jax_host_client

SITES = ("runtime.tick.clock", "runtime.resolve.readback", "runtime.resolve.fanout", "runtime.seg.resize")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    TFP.disarm()
    JFP.disarm()


@pytest.fixture()
def pair():
    """A started JAX client and a started port client: sync, the small
    config, virtual time 1,000."""
    jc = JaxClient(cfg=jax_small_cfg(), time_source=JVT(1_000), mode="sync")
    tc = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    jc.start()
    tc.start()
    yield jc, tc
    jc.stop()
    tc.stop()


def _outcome(c, errors, res):
    """'pass', or the block's exception name; an entry that passes exits."""
    try:
        e = c.entry(res)
    except errors.BlockException as be:
        return type(be).__name__
    e.exit()
    return "pass"


@pytest.mark.parametrize("site", SITES)
def test_the_site_is_registered_as_the_reference_registers_it(site):
    import sentinel_tpu.runtime.client  # noqa: F401
    import sentinel_tpu_torch.runtime.client  # noqa: F401

    mine, ref = TFP.catalog()[site], JFP.catalog()[site]
    assert (mine.desc, mine.kinds) == (ref.desc, ref.kinds)


@pytest.mark.parametrize("site", ["runtime.resolve.readback", "runtime.resolve.fanout", "transport.packed.decode"])
def test_a_resolve_failure_fails_the_entry_closed_and_the_next_serves(pair, site):
    """tests/test_chaos.py:255 on both packages: the armed raise fails one
    entry CLOSED (SystemBlockException at once, not after the entry
    timeout), and the engine serves the next entry.  A raise at the
    packed-wire decode takes the same path: the port's resolver used to
    re-raise it, so a sync client's ``entry()`` raised the injected error
    instead of failing closed."""
    jc, tc = pair
    out = {}
    for name, c, fp, plan, spec, errors in (
        ("ref", jc, JFP, JPlan, JSpec, JERR),
        ("port", tc, TFP, TPlan, TSpec, ERR),
    ):
        c.registry.resource_id("chaos/ft")
        f = c.submit_acquire("chaos/ft")
        assert f.result(timeout=60.0)[0] == errors.PASS  # prime outside the plan
        with fp.armed(plan(seed=2, faults=[spec(site, "raise", max_fires=1)])) as st:
            first = _outcome(c, errors, "chaos/ft")
            fired = st.injected()
        out[name] = (first, fired, [_outcome(c, errors, "chaos/ft") for _ in range(3)])
    assert out["port"] == out["ref"]
    assert out["port"][0] == "SystemBlockException"
    assert out["port"][1] == {f"{site}:raise": 1}
    assert out["port"][2] == ["pass"] * 3


def test_a_clock_skew_on_the_tick_timestamp_gives_the_reference_verdicts(pair):
    """The skew plan of tests/test_chaos.py:145 / :212 on the tick's
    timestamp: every fourth tick (entries' and exits' alike) runs 1,500 ms
    ahead.  Under a 3-a-second flow rule the verdicts, armed and after the
    plan is disarmed, equal the reference's entry by entry."""
    jc, tc = pair
    jc.flow_rules.load([JR.FlowRule(resource="skew", count=3)])
    tc.flow_rules.load([R.FlowRule(resource="skew", count=3)])
    out = {}
    for name, c, fp, plan, spec, errors in (
        ("ref", jc, JFP, JPlan, JSpec, JERR),
        ("port", tc, TFP, TPlan, TSpec, ERR),
    ):
        seq = []
        fault = spec("runtime.tick.clock", "clock_skew", every_nth=4, skew_ms=1500)
        with fp.armed(plan(seed=1, faults=[fault])) as st:
            for _ in range(12):
                seq.append(_outcome(c, errors, "skew"))
                c.time.advance(50)
            fires = st.injected()
        for _ in range(6):
            seq.append(_outcome(c, errors, "skew"))
            c.time.advance(50)
        out[name] = (seq, fires)
    assert out["port"] == out["ref"]
    assert out["port"][1]["runtime.tick.clock:clock_skew"] >= 3
    assert "FlowException" in out["port"][0] and "pass" in out["port"][0]


def test_a_failed_seg_resize_keeps_the_old_capacity_and_the_next_overflow_grows_it(monkeypatch):
    """``seg_fallback=False`` at ``seg_u=128``: a 200-resource batch
    overflows the capacity, so both clients grow ``seg_u`` at once (the
    port inline before the tick, the JAX client inline in sync mode).  An
    armed raise at the resize keeps the old capacity in both; the next
    overflowing batch, disarmed, grows it in both."""
    small = dict(max_resources=256, max_nodes=512, batch_size=512, complete_batch_size=64, seg_u=128)
    flags = dict(use_mxu_tables=True, fused_effects=True, seg_effects=True, seg_fallback=False)
    jc = jax_host_client(monkeypatch, jax_small_cfg(**flags, **small), JVT(1_000))
    tc = SentinelClient(cfg=platform_config(seg_fallback=False, **small), time_source=VirtualTimeSource(1_000),
                        mode="sync", device="cpu")
    jc.start()
    tc.start()
    try:
        names = [f"r{i}" for i in range(200)]
        out = {}
        for name, c, fp, plan, spec in (("ref", jc, JFP, JPlan, JSpec), ("port", tc, TFP, TPlan, TSpec)):
            with fp.armed(plan(seed=3, faults=[spec("runtime.seg.resize", "raise", max_fires=1)])) as st:
                c.check_batch(names)
                kept = c.cfg.seg_u
                fired = st.injected()
            c.time.advance(1_000)
            c.check_batch(names)
            out[name] = (kept, fired, c.cfg.seg_u)
        assert out["port"][:2] == out["ref"][:2] == (128, {"runtime.seg.resize:raise": 1})
        assert out["port"][2] == out["ref"][2] > 128
    finally:
        jc.stop()
        tc.stop()
