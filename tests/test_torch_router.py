"""The port's host-layer shard router (``sentinel_tpu_torch.parallel.router``)
against the JAX package's.

The counterparts of tests/test_router.py: ``shard_of`` gives the
reference's shard for 1–8 shards over 1,000 names; ``check_batch`` over
in-process port clients (sync, virtual time, ``device="cpu"``) gives the
reference router's verdicts and waits over reference clients on the same
batches (mixed shards, per-item counts, origins, params and prioritized
flags, sliced with their shard group); ``entry`` routes to the owner;
``snapshot`` merges shards as the reference's does; the three
``on_shard_error`` modes (``block``: BLOCK_SYSTEM, ``fallback``: the
fallback client's local rules, ``raise``: the first failing leg's
exception) and the route-failure counter by shard and kind move as the
reference's; the router's private ring agrees with ``shard_of``; a
GLOBAL budget holds across two hosts through one token service.
Verdicts, waits and counts are integers: equal; ``snapshot``'s floats
within rtol 1e-6 / atol 1e-4 (tests/test_torch_stats.assert_close).
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.cluster.token_service import DefaultTokenService as JService
from sentinel_tpu.core import errors as JERR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs.registry import REGISTRY as JREG
from sentinel_tpu.parallel import router as JR
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService as TService
from sentinel_tpu_torch.core import errors as TERR
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs.registry import REGISTRY as TREG
from sentinel_tpu_torch.parallel import router as TR
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.test_torch_stats import assert_close

PORT = types.SimpleNamespace(name="port", st=tst, R=TR, ERR=TERR, REG=TREG, Service=TService)
REF = types.SimpleNamespace(name="ref", st=jst, R=JR, ERR=JERR, REG=JREG, Service=JService)
SIDES = (REF, PORT)
NAMES = [f"res-{i}" for i in range(1000)]


@pytest.mark.parametrize("n", range(1, 9))
def test_shard_of_equals_the_reference(n):
    port = [TR.shard_of(x, n) for x in NAMES]
    assert port == [JR.shard_of(x, n) for x in NAMES]
    assert set(port) == set(range(n))  # every shard owns some of 1,000 names


@pytest.fixture()
def made():
    """made(side) -> a started sync client on a clock shared per side."""
    clients = []
    clocks = {"port": VirtualTimeSource(1_000), "ref": JVT(1_000)}

    def make(side):
        if side is PORT:
            c = SentinelClient(cfg=small_engine_config(), time_source=clocks["port"], mode="sync", device="cpu")
        else:
            c = JaxClient(cfg=jax_small_cfg(), time_source=clocks["ref"], mode="sync")
            upload = c._dev_col  # a private copy per upload (ROADMAP.md Queue C: jnp.asarray may alias)
            c._dev_col = lambda field, x, fill, _u=upload: _u(field, np.array(x, copy=True), fill)
        c.start()
        clients.append(c)
        return c

    make.clocks = clocks
    yield make
    for c in clients:
        c.stop()


def owned(prefix, shard, n=2):
    return next(f"{prefix}{i}" for i in range(200) if TR.shard_of(f"{prefix}{i}", n) == shard)


def both(made, script):
    return {side.name: script(side, made) for side in SIDES}


def test_check_batch_over_in_process_clients_equals_the_reference(made):
    """Seeded mixed batches over three hosts, each with its own rules
    (QPS, a rate limiter, a param rule, a black list), with per-item
    counts, origins, params and prioritized flags: verdicts and waits
    equal, in input order."""
    rng = np.random.default_rng(1812)
    names = [f"svc-{i}" for i in range(48)]
    batches = []
    for _ in range(6):
        n = int(rng.integers(20, 80))
        batches.append(dict(
            resources=[names[int(i)] for i in rng.integers(0, len(names), size=n)],
            counts=[int(c) for c in rng.integers(1, 3, size=n)],
            origins=[("good", "bad", "")[int(o)] for o in rng.integers(0, 3, size=n)],
            params=[(f"u{int(p)}" if p < 3 else int(p)) for p in rng.integers(0, 5, size=n)],
            prioritized=[bool(b) for b in rng.random(n) < 0.2],
        ))

    def script(side, made):
        hosts = [made(side) for _ in range(3)]
        st = side.st
        for k, h in enumerate(hosts):
            mine = [x for x in names if side.R.shard_of(x, 3) == k]
            h.flow_rules.load([st.FlowRule(resource=x, count=3 + j % 4) for j, x in enumerate(mine[:4])]
                              + [st.FlowRule(resource=mine[4], count=5, control_behavior=st.CONTROL_RATE_LIMITER,
                                             max_queueing_time_ms=500)])
            h.param_flow_rules.load([st.ParamFlowRule(resource=mine[5], count=2, param_idx=0)])
            h.authority_rules.load([st.AuthorityRule(resource=mine[6], limit_app="bad",
                                                     strategy=st.AUTHORITY_BLACK)])
        router = side.R.ShardRouter(hosts)
        out = []
        for b in batches:
            out.append([tuple(map(int, r)) for r in router.check_batch(**b)])
            made.clocks[side.name].advance(300)
        return out, [side.R.shard_of(x, 3) for x in names]

    got = both(made, script)
    assert got["port"] == got["ref"]
    out, owners = got["port"]
    verdicts = {v for batch in out for v, _ in batch}
    assert {TERR.PASS, TERR.BLOCK_FLOW} <= verdicts and set(owners) == {0, 1, 2}
    assert [len(o) for o in out] == [len(b["resources"]) for b in batches]


def test_router_entry_and_batch(made):
    def script(side, made):
        hosts = [made(side), made(side)]
        router = side.R.ShardRouter(hosts)
        r0, r1 = owned("a", 0), owned("b", 1)
        hosts[0].flow_rules.load([side.st.FlowRule(resource=r0, count=2)])
        hosts[1].flow_rules.load([side.st.FlowRule(resource=r1, count=3)])
        results = [tuple(map(int, r)) for r in router.check_batch([r0, r1] * 5)]
        try:
            router.entry(r0)
            blocked = False
        except side.st.BlockException:
            blocked = True
        return (results, blocked, hosts[0].stats.resource(r0)["blockQps"], hosts[1].stats.resource(r0) is None,
                sorted(router.snapshot()))

    got = both(made, script)
    assert got["port"] == got["ref"]
    results, blocked, block_qps, unseen, snap = got["port"]
    assert sum(results[i][0] == 0 for i in range(0, 10, 2)) == 2
    assert sum(results[i][0] == 0 for i in range(1, 10, 2)) == 3
    assert blocked and block_qps >= 1 and unseen and len(snap) >= 2


def test_the_router_slices_per_item_sequences(made):
    def script(side, made):
        hosts = [made(side), made(side)]
        router = side.R.ShardRouter(hosts)
        r0, r1 = owned("p", 0), owned("q", 1)
        for h, r in ((hosts[0], r0), (hosts[1], r1)):
            h.param_flow_rules.load([side.st.ParamFlowRule(resource=r, count=1, param_idx=0)])
        return [tuple(map(int, r)) for r in router.check_batch([r0, r1, r0, r1], params=["u1", "u2", "u1", "zz"])]

    got = both(made, script)
    assert got["port"] == got["ref"]
    assert [v for v, _ in got["port"]] == [0, 0, TERR.BLOCK_PARAM, 0]  # only the repeated (r0, u1)


def test_snapshot_sums_a_resource_served_by_two_hosts(made):
    def script(side, made):
        hosts = [made(side), made(side)]
        router = side.R.ShardRouter(hosts)
        for h in hosts:
            h.flow_rules.load([side.st.FlowRule(resource="both", count=100)])
            for _ in range(3):
                with h.entry("both"):
                    made.clocks[side.name].advance(2)
        return router.snapshot()["both"]

    got = both(made, script)
    assert got["port"]["passQps"] == 6  # summed, not overwritten
    assert set(got["port"]) == set(got["ref"])
    for k in got["port"]:
        assert_close(got["port"][k], got["ref"][k])


class _ExplodingShard:
    """A shard whose check_batch raises (the mid-batch fan-out failure)."""

    def __init__(self, exc):
        self.exc = exc
        self.calls = 0

    def check_batch(self, resources, **kw):
        self.calls += 1
        raise self.exc


def _route_failures(reg) -> dict:
    return {k: v for k, v in reg.snapshot().items() if k.startswith("sentinel_shard_route_failures_total")}


@pytest.mark.parametrize("mode,exc", [("block", TimeoutError("dcn")), ("block", OSError("io")),
                                      ("fallback", OSError("io")), ("fallback", ValueError("bad")),
                                      ("raise", OSError("io"))], ids=["block-timeout", "block-io",
                                                                      "fallback-io", "fallback-error", "raise-io"])
def test_the_on_shard_error_modes_and_the_route_failure_counter(made, mode, exc):
    def script(side, made):
        healthy = made(side)
        fallback = made(side) if mode == "fallback" else None
        bad = _ExplodingShard(exc)
        router = side.R.ShardRouter([healthy, bad], on_shard_error=mode, fallback=fallback)
        r0, r1 = owned("a", 0), owned("b", 1)
        healthy.flow_rules.load([side.st.FlowRule(resource=r0, count=100)])
        if fallback is not None:
            fallback.flow_rules.load([side.st.FlowRule(resource=r1, count=2)])
        before = _route_failures(side.REG)
        try:
            out = [tuple(map(int, r)) for r in router.check_batch([r0, r1, r0, r1, r1])]
        except Exception as e:  # the legacy mode: the failing leg's exception
            out = (type(e).__name__, str(e))
        try:
            single = [tuple(map(int, r)) for r in router.check_batch([r1])]
        except Exception as e:
            single = (type(e).__name__, str(e))
        after = _route_failures(side.REG)
        return out, single, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}, bad.calls

    got = both(made, script)
    assert got["port"] == got["ref"]
    out, single, counted, calls = got["port"]
    kind = {"TimeoutError": "timeout", "OSError": "io"}.get(type(exc).__name__, "error")
    assert counted == {f'sentinel_shard_route_failures_total{{kind="{kind}",shard="1"}}': 2} and calls == 2
    if mode == "block":
        assert [v for v, _ in out] == [0, TERR.BLOCK_SYSTEM, 0, TERR.BLOCK_SYSTEM, TERR.BLOCK_SYSTEM]
        assert single == [(TERR.BLOCK_SYSTEM, 0)]
    elif mode == "fallback":
        assert [v for v, _ in out] == [0, 0, 0, 0, TERR.BLOCK_FLOW]  # the fallback's local budget of 2
        assert single[0][0] == TERR.BLOCK_FLOW
    else:
        assert out == ("OSError", "io") and single == ("OSError", "io")


def test_a_fallback_that_also_fails_fails_closed_and_counts_twice(made):
    def script(side, made):
        router = side.R.ShardRouter([made(side), _ExplodingShard(OSError("io"))], on_shard_error="fallback",
                                    fallback=_ExplodingShard(TimeoutError("t")))
        before = _route_failures(side.REG)
        out = [tuple(map(int, r)) for r in router.check_batch([owned("b", 1)] * 2)]
        after = _route_failures(side.REG)
        return out, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    got = both(made, script)
    assert got["port"] == got["ref"]
    out, counted = got["port"]
    assert out == [(TERR.BLOCK_SYSTEM, 0)] * 2
    assert counted == {'sentinel_shard_route_failures_total{kind="io",shard="1"}': 1,
                       'sentinel_shard_route_failures_total{kind="timeout",shard="1"}': 1}


def test_the_same_construction_errors(made):
    got = {}
    for side in SIDES:
        errs = []
        for kw in (dict(on_shard_error="fallback"), dict(on_shard_error="sometimes")):
            try:
                side.R.ShardRouter([object()], **kw)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        got[side.name] = errs
    assert got["port"] == got["ref"] and None not in got["port"]
    assert TR._ROUTE_FAIL_HELP == JR._ROUTE_FAIL_HELP


def test_the_routers_ring_agrees_with_shard_of(made):
    for side in SIDES:
        router = side.R.ShardRouter([made(side), made(side)])
        for i in range(50):
            name = f"res-{i}"
            assert router.shards[side.R.shard_of(name, 2)] is router.shard_for(name)
            assert int(router.ring.owner(name)) == side.R.shard_of(name, 2)
        # a private ring: mutating it leaves shard_of and other routers alone
        assert router.ring is not side.R._index_ring(2)
    assert TR._index_ring(2)._table == JR._index_ring(2)._table


def test_a_global_cluster_budget_holds_across_two_hosts(made):
    def script(side, made):
        hosts = [made(side), made(side)]
        svc = side.Service(made(side))
        rule = side.st.FlowRule(resource="shared", count=4, cluster_mode=True, cluster_flow_id=99,
                                cluster_threshold_type=1)
        svc.flow_rules.load("ns", [rule])

        class Local:
            mode = 0

            def token_service(self):
                return svc

            def is_available(self):
                return True

        for h in hosts:
            h.flow_rules.load([rule])
            h.set_cluster(Local())
        out = []
        for i in range(10):
            try:
                with hosts[i % 2].entry("shared"):
                    pass
                out.append("pass")
            except side.st.BlockException as e:
                out.append(type(e).__name__)
        svc.close()
        return out

    got = both(made, script)
    assert got["port"] == got["ref"]
    assert got["port"].count("pass") == 4  # the global cap across both hosts
