"""The port's sharded token fleet (``sentinel_tpu_torch.cluster.shard``)
against the JAX package's.

The counterparts of tests/test_shard_fleet.py: every case builds a port
fleet (port decision clients, ``device="cpu"``) and a reference fleet of
the same shape, each shard a ``DefaultTokenService`` on a sync decision
client on virtual time behind a ``ClusterTokenServer`` on 127.0.0.1 (port
0), and drives both through the same scripted sequence: routing to the
ring owners, budgets, lease grants and lease-first local admits, the
kill → lease fallback → fail-closed → rejoin cycle, param flows failing
closed while degraded, ``request_token_many``'s one exchange per owner,
``describe()`` and the ``api/shards`` JSON (ports aside), and the
``sentinel_shard_*`` series.  Then through the port alone, each held to
the reference's outcome on the same inputs: ``set_to_sharded_client``
routing a cluster-mode rule of a serving client, the RLS front door over
a fleet, one trace spanning client → RLS → shard, ``GET
/metrics?fleet=1`` over a live 4-shard fleet, and the port's
``ShardedTokenClient`` in front of two reference token servers.

Clocks: both packages' lease expiry reads ``shard.wall_ms_now``, pinned
here to one shared clock (``WALL``); failover cooldowns are 300 s of the
real monotonic clock and heal only where a test sets ``degraded_until``;
top-ups run inline (``lease_refresh_async=False``) except in the case
that checks the refresher; ``reconnect_interval_s=0.0``.  Each fleet's
clients reach protocol v3 before a case drives them.  Every fleet is
stopped at the end of its case, so ``api/shards`` never sees another
case's.  Everything compared is an integer status, count, id or string:
equal.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu import obs as jobs
from sentinel_tpu.cluster import constants as JC
from sentinel_tpu.cluster import protocol as JP
from sentinel_tpu.cluster import shard as JS
from sentinel_tpu.cluster import state as JSTATE
from sentinel_tpu.cluster import token_service as JTS
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs import fleet as JF
from sentinel_tpu.obs.registry import REGISTRY as JREG
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.transport import handlers as JH
from sentinel_tpu.transport.command import CommandRequest as JReq
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import obs as tobs
from sentinel_tpu_torch.cluster import constants as TC
from sentinel_tpu_torch.cluster import protocol as TP
from sentinel_tpu_torch.cluster import shard as TS
from sentinel_tpu_torch.cluster import state as TSTATE
from sentinel_tpu_torch.cluster import token_service as TTS
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.obs import fleet as TF
from sentinel_tpu_torch.obs.registry import REGISTRY as TREG
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.transport import handlers as TH
from sentinel_tpu_torch.transport.command import CommandRequest as TReq
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

PORT = types.SimpleNamespace(name="port", st=tst, C=TC, P=TP, shard=TS, state=TSTATE, ts=TTS, REG=TREG, H=TH,
                             Req=TReq, F=TF, obs=tobs, rls="sentinel_tpu_torch.rls")
REF = types.SimpleNamespace(name="ref", st=jst, C=JC, P=JP, shard=JS, state=JSTATE, ts=JTS, REG=JREG, H=JH,
                            Req=JReq, F=JF, obs=jobs, rls="sentinel_tpu.rls")
SIDES = (REF, PORT)

#: the reference test's fixture (tests/test_shard_fleet.py::fleet)
FLEET_KW = dict(lease_slack=0.5, retry_interval_s=300.0, lease_ttl_ms=600_000, timeout_ms=5000,
                reconnect_interval_s=0.0, lease_refresh_async=False)


class _Wall:
    """The one wall clock both packages' lease accounting reads."""

    def __init__(self):
        self.ms = int(time.time() * 1000)

    def __call__(self) -> int:
        return self.ms


@pytest.fixture(autouse=True)
def wall(monkeypatch):
    w = _Wall()
    for side in SIDES:
        monkeypatch.setattr(side.shard, "wall_ms_now", w)
    return w


def _decision_client(side, vt):
    if side is PORT:
        return SentinelClient(cfg=small_engine_config(), time_source=vt, mode="sync", device="cpu")
    jc = JaxClient(cfg=jax_small_cfg(), time_source=vt, mode="sync")
    upload = jc._dev_col  # a private copy per upload (ROADMAP.md Queue C: jnp.asarray may alias)
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    return jc


def _wait_v3(clients, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while any(c.peer_version < 3 for c in clients) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert all(c.peer_version >= 3 for c in clients), [c.peer_version for c in clients]


@pytest.fixture()
def build():
    """build(side, n_shards=2, **kw) -> a started fleet; everything it made
    (fleet, services' columns, decision clients) stops at teardown."""
    fleets, clients = [], []

    def make(side, n_shards=2, **kw):
        vt = VirtualTimeSource(1_000) if side is PORT else JVT(1_000)

        def factory():
            c = _decision_client(side, vt)
            c.start()
            clients.append(c)
            return c

        f = side.shard.ShardFleet(factory, n_shards=n_shards, **dict(FLEET_KW, **kw))
        fleets.append(f)
        _wait_v3([st.client for st in f.client._shards.values()])
        return f

    yield make
    for f in fleets:
        f.stop()
        for svc in f.services.values():
            svc.close()
    for c in clients:
        c.stop()


def flow_rule(st, fid, count=100.0):
    return st.FlowRule(resource=f"res-{fid}", count=count, cluster_mode=True, cluster_flow_id=fid,
                       cluster_threshold_type=1)  # GLOBAL


def owned_flow(fleet, shard_name, lo=101, hi=900):
    return next(f for f in range(lo, hi) if fleet.client.owner_of(f) == shard_name)


def res(r) -> tuple:
    """A TokenResult as compared: everything but the opaque token id."""
    return (r.status, r.remaining, r.wait_ms, r.prov_kind, r.prov_rule, r.prov_observed, r.prov_limit)


def shard_series(reg) -> dict:
    """The fleet's counters and gauges (the router's chunk histogram, once
    its module is imported, is left out)."""
    return {k: v for k, v in reg.snapshot().items()
            if k.startswith(("sentinel_shard_", "sentinel_lease_local_admits_total")) and not isinstance(v, dict)}


def deltas(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def both(build, script, **kw):
    """Run ``script(side, fleet)`` on a fresh fleet of each package; return
    {"ref": out, "port": out}."""
    return {side.name: script(side, build(side, **kw)) for side in SIDES}


def kill(fleet, name):
    fleet.kill(name)
    time.sleep(0.2)


def heal(fleet, name):
    """Rejoin a killed shard and lapse its cooldown, so the next routed
    request probes it.  The token client reconnects and renegotiates
    protocol v3 first: a probe sent before the HELLO answer rides v1
    frames, whose denies carry no provenance, at a time that differs run
    to run."""
    fleet.rejoin(name)
    st = fleet.client._shards[name]
    assert st.client._ensure_connected()
    _wait_v3([st.client])
    with st.lock:
        st.degraded_until = 0.0


# ---------------------------------------------------------------------------
# routing + budgets
# ---------------------------------------------------------------------------


def test_flows_route_to_their_ring_owners_and_each_budget_holds(build):
    def script(side, f):
        fa, fb = owned_flow(f, "shard-0"), owned_flow(f, "shard-1")
        f.load_flow_rules("default", [flow_rule(side.st, fa, 3.0), flow_rule(side.st, fb, 3.0)])
        placed = [(n, fid, f.services[n].flow_rules.get_by_id(fid) is not None) for n in f.names for fid in (fa, fb)]
        f.client.lease_slack = 0.0  # exact budget arithmetic
        sa = [res(f.client.request_token(fa)) for _ in range(5)]
        sb = [res(f.client.request_token(fb)) for _ in range(5)]
        return (fa, fb), [f.client.owner_of(x) for x in range(101, 301)], placed, sa, sb

    got = both(build, script)
    assert got["port"] == got["ref"]
    (fa, fb), owners, placed, sa, sb = got["port"]
    assert placed == [("shard-0", fa, True), ("shard-0", fb, False), ("shard-1", fa, False), ("shard-1", fb, True)]
    assert [s[0] for s in sa] == [TC.STATUS_OK] * 3 + [TC.STATUS_BLOCKED] * 2
    assert [s[0] for s in sb] == [TC.STATUS_OK] * 3 + [TC.STATUS_BLOCKED] * 2
    assert set(owners) == {"shard-0", "shard-1"}


def test_an_unknown_flow_is_no_rule(build):
    got = both(build, lambda side, f: [res(f.client.request_token(999_999)),
                                       res(f.client.request_token_batch(999_998, 3))])
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == TC.STATUS_NO_RULE


def test_concurrent_tokens_round_trip_through_the_owner(build):
    def script(side, f):
        fid = owned_flow(f, "shard-1")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 2.0)])
        r1, r2, r3 = (f.client.request_concurrent_token(fid) for _ in range(3))
        rel = f.client.release_concurrent_token(r1.token_id)
        r4 = f.client.request_concurrent_token(fid)
        bad = f.client.release_concurrent_token(7 << 48)
        return ([(r.status, r.token_id >> 48, r.token_id != 0) for r in (r1, r2, r3, r4)], r1.token_id != r2.token_id,
                rel.status, bad.status)

    got = both(build, script)
    assert got["port"] == got["ref"]
    toks, distinct, rel, bad = got["port"]
    assert [t[0] for t in toks] == [TC.STATUS_OK, TC.STATUS_OK, TC.STATUS_BLOCKED, TC.STATUS_OK]
    assert toks[0][1] == 1 and distinct  # composite ids carry the owner's index (shard-1)
    assert rel == TC.STATUS_RELEASE_OK and bad == TC.STATUS_BAD_REQUEST


# ---------------------------------------------------------------------------
# failover + leases
# ---------------------------------------------------------------------------


def test_the_kill_lease_fallback_fail_closed_rejoin_cycle(build):
    def script(side, f):
        fa, fb = owned_flow(f, "shard-0"), owned_flow(f, "shard-1")
        f.load_flow_rules("default", [flow_rule(side.st, fa, 4.0), flow_rule(side.st, fb, 100.0)])
        before = shard_series(side.REG)
        out = [res(f.client.request_token(fa))]
        lease = f.client._shards["shard-0"].leases[fa]
        out.append((lease.granted, lease.used))
        kill(f, "shard-0")
        out.append([res(f.client.request_token(fa)) for _ in range(4)])
        out.append(f.client.shard_degraded("shard-0"))
        out.append(res(f.client.request_token(fb)))
        out.append(f.client.shard_degraded("shard-1"))
        heal(f, "shard-0")
        out.append(res(f.client.request_token(fa)))
        out.append(f.client.shard_degraded("shard-0"))
        series = deltas(before, shard_series(side.REG))
        # gauges are read as they stand, not as deltas
        series = {k: v for k, v in series.items() if not k.startswith("sentinel_shard_degraded")}
        out.append(series)
        out.append(side.REG.snapshot()['sentinel_shard_degraded{shard="shard-0"}'])
        return out

    got = both(build, script)
    assert got["port"] == got["ref"]
    first, lease, fallback, deg0, other, deg1, probe, healed, series, gauge = got["port"]
    assert first[0] == TC.STATUS_OK and lease == (2, 0)
    # the lease carries two (admitted locally before the death is seen),
    # then FAIL-CLOSED: never an unmetered pass, never STATUS_FAIL
    assert [r[0] for r in fallback] == [TC.STATUS_OK, TC.STATUS_OK, TC.STATUS_BLOCKED, TC.STATUS_BLOCKED]
    assert deg0 and other[0] == TC.STATUS_OK and not deg1
    assert probe[0] in (TC.STATUS_OK, TC.STATUS_BLOCKED) and not healed and gauge == 0
    assert series['sentinel_lease_local_admits_total{shard="shard-0"}'] == 2
    assert 'sentinel_shard_fallback_total{shard="shard-0",verdict="pass"}' not in series
    assert series['sentinel_shard_fallback_total{shard="shard-0",verdict="block"}'] == 2
    assert series['sentinel_shard_degrade_transitions_total{shard="shard-0",transition="enter"}'] == 1
    assert series['sentinel_shard_degrade_transitions_total{shard="shard-0",transition="exit"}'] == 1


def test_param_flows_fail_closed_while_degraded(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid)])
        kill(f, "shard-0")
        return [res(f.client.request_param_token(fid, 1, ["u1"])), res(f.client.request_concurrent_token(fid)),
                res(f.client.request_lease(fid, 4))]

    got = both(build, script)
    assert got["port"] == got["ref"]
    assert [r[0] for r in got["port"]] == [TC.STATUS_BLOCKED, TC.STATUS_BLOCKED, TC.STATUS_FAIL]


def test_no_lease_means_fail_closed(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid)])
        out = [res(f.client.request_token(fid))]
        kill(f, "shard-0")
        out.append(res(f.client.request_token(fid)))
        return out

    got = both(build, script, n_shards=1, lease_slack=0.0)
    assert got["port"] == got["ref"]
    assert [r[0] for r in got["port"]] == [TC.STATUS_OK, TC.STATUS_BLOCKED]


def test_an_expired_lease_routes_remote_and_fails_closed_on_the_pinned_clock(build, wall):
    """Expiry is wall-clock ms: past ``expires_ms`` the lease-first path
    does not apply (the request routes to the owner), and a dead owner's
    expired lease fails closed."""
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 10.0)])
        st = f.client._shards["shard-0"]
        out = [res(f.client.request_token(fid))]
        req0 = st.c_requests.value
        out.append(res(f.client.request_token(fid)))
        out.append(st.c_requests.value - req0)  # lease-local: no routed request
        wall.ms += 600_001
        out.append(res(f.client.request_token(fid)))
        out.append(st.c_requests.value - req0)  # expired: routed (and re-leased)
        out.append((st.leases[fid].granted, st.leases[fid].used, st.leases[fid].expires_ms - wall.ms))
        wall.ms += 600_001
        kill(f, "shard-0")
        out.append([res(f.client.request_token(fid)) for _ in range(2)])
        wall.ms -= 1_200_002
        return out

    got = both(build, script)
    assert got["port"] == got["ref"]
    out = got["port"]
    # the re-lease asks 5 (half of 10) and gets what is left of the window: 10 - 1 - 5 - 1
    assert out[2] == 0 and out[4] == 1 and out[5] == (3, 0, 600_000)
    assert [r[0] for r in out[6]] == [TC.STATUS_BLOCKED] * 2


# ---------------------------------------------------------------------------
# the LEASE wire extension
# ---------------------------------------------------------------------------


def test_a_lease_round_trips_on_the_wire_and_debits_the_budget(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 10.0)])
        r = f.client._shards["shard-0"].client.request_lease(fid, 4)
        f.client.lease_slack = 0.0
        return res(r), [res(f.client.request_token(fid)) for _ in range(10)]

    got = both(build, script)
    assert got["port"] == got["ref"]
    lease, after = got["port"]
    assert lease[:3] == (TC.STATUS_OK, 4, 600_000)
    assert sum(r[0] == TC.STATUS_OK for r in after) == 6


def test_lease_units_are_capped_both_sides(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 1e9)])
        r = f.client._shards["shard-0"].client.request_lease(fid, 10_000_000)
        return f.client._lease_units(fid), res(r)

    got = both(build, script)
    assert got["port"] == got["ref"]
    units, r = got["port"]
    assert units == TC.MAX_LEASE_UNITS and r[0] == TC.STATUS_OK and 0 < r[1] <= TC.MAX_LEASE_UNITS


def test_the_lease_frame_codec_is_byte_equal():
    got = {}
    for side in SIDES:
        req = side.P.ClusterRequest(xid=7, type=side.C.MSG_TYPE_LEASE, flow_id=12345, count=16)
        raw = side.P.encode_request(req)
        back = side.P.decode_request(raw[2:])
        rsp = side.P.ClusterResponse(xid=7, type=side.C.MSG_TYPE_LEASE, status=side.C.STATUS_OK, remaining=12,
                                     wait_ms=1000)
        rraw = side.P.encode_response(rsp)
        b = side.P.decode_response(rraw[2:])
        got[side.name] = (raw, rraw, (back.type, back.flow_id, back.count), (b.status, b.remaining, b.wait_ms))
    assert got["port"] == got["ref"]
    assert got["port"][2] == (TC.MSG_TYPE_LEASE, 12345, 16) and got["port"][3] == (TC.STATUS_OK, 12, 1000)


def test_a_dropped_rule_evicts_its_standing_lease(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 10.0)])
        f.client.request_token(fid)
        st = f.client._shards["shard-0"]
        had = fid in st.leases
        f.load_flow_rules("default", [])
        gone = fid not in st.leases
        kill(f, "shard-0")
        return had, gone, res(f.client.request_token(fid))

    got = both(build, script)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (True, True) and got["port"][2][0] == TC.STATUS_BLOCKED


def test_a_lease_transport_fail_is_not_cached_as_a_denial(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 10.0)])
        st = f.client._shards["shard-0"]
        orig = st.client.request_lease
        st.client.request_lease = lambda fl, u: side.ts.TokenResult(side.C.STATUS_FAIL)
        try:
            out = [res(f.client.request_token(fid)), fid in st.leases]
        finally:
            st.client.request_lease = orig
        f.client.request_token(fid)
        return out + [st.leases[fid].granted]

    got = both(build, script)
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == TC.STATUS_OK and got["port"][1] is False and got["port"][2] > 0


def test_the_bare_client_flow_rules_facade_behind_the_rls_rule_manager(build):
    import importlib

    def script(side, f):
        rls = importlib.import_module(side.rls)
        members = {n: ("127.0.0.1", f._ports[n]) for n in f.names}
        bare = side.shard.ShardedTokenClient(members, lease_slack=0.5, reconnect_interval_s=0.0)
        try:
            mgr = rls.EnvoyRlsRuleManager(bare)
            mgr.load([rls.EnvoyRlsRule(domain="d", descriptors=[
                rls.RlsResourceDescriptor(key_values=[rls.RlsKeyValue("k", "v")], count=8.0)])])
            fid = mgr.lookup_flow_id("d", [("k", "v")])
            units = bare._lease_units(fid)
            mgr.load([])
            return fid, units, bare._lease_units(fid), len(side.shard.describe_fleets())
        finally:
            bare.close()

    got = both(build, script)
    assert got["port"] == got["ref"]
    fid, units, after, n_fleets = got["port"]
    assert fid is not None and units == 4 and after == 0 and n_fleets == 2  # the bare client and the fleet's


# ---------------------------------------------------------------------------
# the runtime's entry point and the RLS front door over a fleet
# ---------------------------------------------------------------------------


def test_set_to_sharded_client_routes_a_cluster_mode_rule(build):
    """A serving client flipped to fleet mode through ClusterStateManager:
    its cluster-mode rule is decided by the ring owner (with a sized lease),
    and after the owner dies its entries fail closed through the fleet's
    lease fallback — the client's own cluster degrade never engages."""
    def script(side, f):
        fid = owned_flow(f, "shard-1")
        rule = flow_rule(side.st, fid, 8.0)
        f.load_flow_rules("default", [rule])
        state = side.state.ClusterStateManager()
        state.set_to_sharded_client({n: ("127.0.0.1", f._ports[n]) for n in f.names}, timeout_ms=5000,
                                    reconnect_interval_s=0.0)
        vt = VirtualTimeSource(5_000) if side is PORT else JVT(5_000)
        app = (SentinelClient(cfg=small_engine_config(), time_source=vt, mode="sync", device="cpu")
               if side is PORT else _decision_client(side, vt))
        app.start()
        try:
            tc = state.token_service()
            _wait_v3([s.client for s in tc._shards.values()])
            tc.flow_rules.load("default", [rule])
            app.set_cluster(state)
            app.flow_rules.load([rule])
            out = [state.mode == side.state.CLUSTER_CLIENT, tc._lease_units(fid), state.is_available()]

            def outcomes(n):
                got = []
                for _ in range(n):
                    try:
                        app.entry(rule.resource).exit()
                        got.append("pass")
                    except side.st.BlockException as e:
                        got.append(type(e).__name__)
                return got

            out.append(outcomes(10))
            out.append(tc._shards["shard-1"].c_local_admits.value)
            kill(f, "shard-1")
            vt.advance(2_000)  # a fresh local window: the local rule would pass these
            out.append(outcomes(4))
            out.append((app._cluster_degraded_active, tc.shard_degraded("shard-1")))
            return out
        finally:
            app.stop()
            state.token_service().close()

    got = both(build, script)
    assert got["port"][:4] == got["ref"][:4] and got["port"][5:] == got["ref"][5:]
    mode_ok, units, avail, first, admits, after, degraded = got["port"]
    assert mode_ok and units == 2 and avail  # default lease_slack 0.25 of 8
    assert first.count("pass") == 8 and set(first[8:]) == {"FlowException"}
    assert admits == got["ref"][4] > 0  # lease-first local admits
    assert after == ["FlowException"] * 4 and degraded == (False, True)


def _rls_rules(rr, values, count=2.0):
    return [rr.EnvoyRlsRule(domain="mesh", descriptors=[
        rr.RlsResourceDescriptor(key_values=[rr.RlsKeyValue("dest", v)], count=count) for v in values])]


def _rls_request(pb, value, hits=1):
    req = pb.RateLimitRequest(domain="mesh", hits_addend=hits)
    e = req.descriptors.add().entries.add()
    e.key, e.value = "dest", value
    return req


def test_the_rls_front_door_routes_descriptors_through_the_ring(build):
    pytest.importorskip("grpc")
    import importlib

    def script(side, f):
        rules = importlib.import_module(side.rls + ".rules")
        server = importlib.import_module(side.rls + ".server")
        pb = importlib.import_module(side.rls + ".rls_pb2")
        f.client.lease_slack = 0.0  # exact budgets
        rls = server.SentinelEnvoyRlsService(f.client)
        values = [f"svc-{i}" for i in range(6)]
        rls.rules.load(_rls_rules(rules, values))
        fids = [rules.identifier_flow_id(rules.descriptor_identifier("mesh", [("dest", v)])) for v in values]
        placed = [[n for n in f.names if f.services[n].flow_rules.get_by_id(fid) is not None] for fid in fids]
        owners = [f.client.owner_of(fid) for fid in fids]
        codes = [int(rls.should_rate_limit(_rls_request(pb, v)).overall_code) for v in ["svc-0"] * 4 + ["svc-1"]]
        multi = pb.RateLimitRequest(domain="mesh", hits_addend=1)
        for v in values[2:]:
            e = multi.descriptors.add().entries.add()
            e.key, e.value = "dest", v
        rsp = rls.should_rate_limit(multi)
        return placed, owners, codes, int(rsp.overall_code), [int(s.code) for s in rsp.statuses]

    got = both(build, script)
    assert got["port"] == got["ref"]
    placed, owners, codes, _overall, _statuses = got["port"]
    assert placed == [[o] for o in owners]  # every descriptor's rule on its owner alone
    assert codes == [1, 1, 2, 2, 1]  # OK, OK, OVER_LIMIT, OVER_LIMIT; svc-1 its own budget


def test_one_trace_spans_client_rls_and_shard(build):
    pytest.importorskip("grpc")
    import importlib

    def script(side, f):
        rules = importlib.import_module(side.rls + ".rules")
        server = importlib.import_module(side.rls + ".server")
        pb = importlib.import_module(side.rls + ".rls_pb2")
        rls = server.SentinelEnvoyRlsService(f.client)
        rls.rules.load(_rls_rules(rules, ["svc-t"], count=50.0))
        side.obs.TRACER.reset()
        side.obs.enable()
        try:
            code = int(rls.should_rate_limit(_rls_request(pb, "svc-t")).overall_code)
            time.sleep(0.1)  # the shard's decision span lands on its server thread
        finally:
            side.obs.disable()
        spans = side.obs.TRACER.snapshot()
        side.obs.TRACER.reset()  # leave the process's tracer ring empty
        root = next(s for s in spans if s["name"] == "rls.should_rate_limit")
        trace = root["trace"]
        mine = [s for s in spans if s["trace"] == trace]
        ids = {s["attrs"].get("span_id"): s["name"] for s in mine if s["attrs"].get("span_id")}
        links = sorted((s["name"], ids.get(s["attrs"].get("parent"))) for s in mine)
        return code, trace != 0, links

    got = both(build, script)
    assert got["port"] == got["ref"]
    code, traced, links = got["port"]
    assert code == 1 and traced
    assert ("cluster.rpc", "rls.should_rate_limit") in links
    assert ("token.decision", "cluster.rpc") in links
    assert not tobs.TRACER.snapshot()


# ---------------------------------------------------------------------------
# observability: api/shards, the series, metrics?fleet=1
# ---------------------------------------------------------------------------


def _ours(fleets: list, fleet) -> list:
    ports = {f"127.0.0.1:{p}" for p in fleet._ports.values()}
    return [d for d in fleets if {s["addr"] for s in d["shards"]} == ports]


def _ports_aside(desc: dict) -> dict:
    d = dict(desc, shards=[dict(s, addr=s["addr"].split(":")[0]) for s in desc["shards"]])
    for s in d["shards"]:
        # real monotonic seconds left of a 300 s cooldown: within a second
        s["cooldown_remaining_s"] = round(s["cooldown_remaining_s"] / 10)
    return d


def test_describe_and_the_api_shards_json_equal_the_reference_ports_aside(build):
    def script(side, f):
        fa, fb = owned_flow(f, "shard-0"), owned_flow(f, "shard-1")
        f.load_flow_rules("default", [flow_rule(side.st, x) for x in (fa, fb, 901, 902, 903)])
        f.client.request_token(fa)
        f.client.request_token(fb)
        healthy = f.describe()
        kill(f, "shard-0")
        f.client.request_param_token(fa, 1, ["u1"])  # routed (no lease covers it): the death is seen
        rsp = side.H.build_default_handlers(f.services["shard-1"].client).handle("api/shards", side.Req())
        listed = "api/shards" in {c["name"] for c in side.H.build_default_handlers(
            f.services["shard-1"].client).handle("api", side.Req()).result}
        ours = _ours(rsp.result, f)
        return (rsp.success, listed, len(ours), _ports_aside(healthy), [_ports_aside(d) for d in ours],
                [_ports_aside(d) for d in _ours(side.shard.describe_fleets(), f)])

    got = both(build, script)
    assert got["port"] == got["ref"]
    ok, listed, n, healthy, ours, direct = got["port"]
    assert ok and listed and n == 1 and ours == direct
    assert healthy["flows_registered"] == 5 and healthy["vnodes"] == 64 and healthy["lease_slack"] == 0.5
    assert [s["degraded"] for s in ours[0]["shards"]] == [True, False]
    assert ours[0]["shards"][0]["cooldown_remaining_s"] == 30  # ~300 s left


def test_the_shard_series_move_as_the_reference_moves_them(build):
    def script(side, f):
        before = shard_series(side.REG)
        fids = [owned_flow(f, "shard-0"), owned_flow(f, "shard-1")]
        f.load_flow_rules("default", [flow_rule(side.st, x, 40.0) for x in fids])
        for i in range(30):
            f.client.request_token(fids[i % 2], 1 + i % 2)
        f.client.request_token_many([(fids[0], 1), (fids[1], 3)] * 4)
        return deltas(before, shard_series(side.REG)), [f.client.shard_degraded(n) for n in f.names]

    got = both(build, script)
    assert got["port"] == got["ref"]
    moved, degraded = got["port"]
    for name in ("shard-0", "shard-1"):
        assert moved[f'sentinel_shard_requests_total{{shard="{name}"}}'] >= 1
        assert moved[f'sentinel_lease_local_admits_total{{shard="{name}"}}'] > 0
        assert moved[f'sentinel_shard_lease_tokens_total{{shard="{name}"}}'] > 0
    assert degraded == [False, False]
    # the help texts of the six series every shard registers, too
    names = ("sentinel_shard_requests_total", "sentinel_lease_local_admits_total", "sentinel_shard_fallback_total",
             "sentinel_shard_degrade_transitions_total", "sentinel_shard_degraded", "sentinel_shard_lease_tokens_total")
    helps = {side.name: sorted(ln for ln in side.REG.exposition().splitlines()
                               if ln.startswith("# HELP ") and ln.split(" ")[2] in names)
             for side in SIDES}
    assert helps["port"] == helps["ref"] and len(helps["port"]) == 6


def test_metrics_fleet_over_a_live_four_shard_fleet(build):
    from tests.test_torch_slo_fleet import _member_registry
    from sentinel_tpu.obs.registry import MetricRegistry as JRegistry
    from sentinel_tpu_torch.obs.registry import MetricRegistry as TRegistry

    def script(side, f):
        f.load_flow_rules("default", [flow_rule(side.st, fid, 1000.0) for fid in (101, 202, 303, 404)])
        for fid in (101, 202, 303, 404):
            f.client.request_token(fid)
        remote = _member_registry(TRegistry if side is PORT else JRegistry, 9).exposition()
        side.F.set_fleet_targets(["remote-host:8719"])
        orig = side.F._http_fetch
        side.F._http_fetch = lambda url, timeout_s=2.0: remote
        try:
            rsp = side.H.build_default_handlers(f.services["shard-0"].client).handle(
                "metrics", side.Req(parameters={"fleet": "1"}))
        finally:
            side.F._http_fetch = orig
            side.F.set_fleet_targets([])
        ports = {str(p) for p in f._ports.values()}
        lines = rsp.result.splitlines()
        info = [ln for ln in lines if ln.startswith("sentinel_fleet_shard_info") and any(f':{p}"' in ln for p in ports)]
        for p in ports:
            info = [ln.replace(f':{p}"', ':<port>"') for ln in info]
        info.sort()
        return (rsp.success, "sentinel_fleet_members 2" in lines, info,
                sorted({ln.split(" ")[0] for ln in lines if ln.startswith("sentinel_shard_requests_total{")}),
                [ln for ln in lines if ln.startswith("# HELP sentinel_fleet_shard_info")])

    got = both(build, script, n_shards=4, lease_slack=0.25)
    assert got["port"] == got["ref"]
    ok, members, info, requests, helps = got["port"]
    assert ok and members and len(info) == 4 and len(helps) == 1
    assert all('degraded="0"' in ln and 'fleet="default"' in ln for ln in info)
    # the four live shards' series and the remote host's, merged by full label set
    assert requests == [f'sentinel_shard_requests_total{{shard="shard-{i}"}}' for i in (0, 1, 2, 3, 9)]


# ---------------------------------------------------------------------------
# lease-first admission (protocol v2)
# ---------------------------------------------------------------------------


def test_lease_first_steady_state_is_rpc_free(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 100.0)])
        st = f.client._shards["shard-0"]
        first = res(f.client.request_token(fid))
        base, admits0 = st.c_requests.value, st.c_local_admits.value
        grant = (st.leases[fid].granted, st.leases[fid].used)
        steady = [res(f.client.request_token(fid)) for _ in range(10)]
        return first, grant, steady, st.c_requests.value - base, st.c_local_admits.value - admits0, st.leases[fid].used

    got = both(build, script)
    assert got["port"] == got["ref"]
    first, grant, steady, routed, admits, used = got["port"]
    assert first[0] == TC.STATUS_OK and grant == (50, 0)
    assert [r[:2] for r in steady] == [(TC.STATUS_OK, 49 - i) for i in range(10)]
    assert (routed, admits, used) == (0, 10, 10)


def test_the_lease_tops_up_ahead_of_exhaustion(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 100.0)])
        st = f.client._shards["shard-0"]
        f.client.request_token(fid)
        base = st.c_requests.value
        admits = [res(f.client.request_token(fid)) for _ in range(25)]
        return admits, (st.leases[fid].granted, st.leases[fid].used), st.c_requests.value - base

    got = both(build, script)
    assert got["port"] == got["ref"]
    admits, lease, routed = got["port"]
    assert all(r[0] == TC.STATUS_OK for r in admits) and lease == (50, 0) and routed == 0


def test_the_async_refresher_tops_up_in_the_background(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 100.0)])
        st = f.client._shards["shard-0"]
        f.client.request_token(fid)
        base = st.c_requests.value
        ok = all(f.client.request_token(fid).ok for _ in range(25))
        flushed = f.client.flush_lease_refresh(5.0)
        return ok, flushed, (st.leases[fid].granted, st.leases[fid].used), st.c_requests.value - base

    got = both(build, script, lease_refresh_async=True)
    assert got["port"] == got["ref"] == (True, True, (50, 0), 0)


def _count_batches(f) -> dict:
    calls = {}
    for name, st in f.client._shards.items():
        real = st.client.request_batch

        def counted(entries, _real=real, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(entries)

        st.client.request_batch = counted
    return calls


def test_request_token_many_is_one_exchange_per_owner(build):
    def script(side, f):
        fa, fb = owned_flow(f, "shard-0"), owned_flow(f, "shard-1")
        f.load_flow_rules("default", [flow_rule(side.st, fa, 3.0), flow_rule(side.st, fb, 3.0)])
        f.client.lease_slack = 0.0  # every decision remote
        calls = _count_batches(f)
        rs = f.client.request_token_many([(fa, 1), (fb, 1), (fa, 1), (999_999, 1), (fa, 2)])
        return [res(r) for r in rs], dict(calls)

    got = both(build, script)
    assert got["port"] == got["ref"]
    rs, calls = got["port"]
    assert [r[0] for r in rs] == [TC.STATUS_OK, TC.STATUS_OK, TC.STATUS_OK, TC.STATUS_NO_RULE, TC.STATUS_BLOCKED]
    owner_of_unknown = PORT.shard.HashRing(["shard-0", "shard-1"]).owner_of_flow(999_999)
    assert calls == {"shard-0": 1, "shard-1": 1} and owner_of_unknown in calls


def test_request_token_many_admits_locally_against_leases(build):
    def script(side, f):
        fid = owned_flow(f, "shard-0")
        f.load_flow_rules("default", [flow_rule(side.st, fid, 100.0)])
        st = f.client._shards["shard-0"]
        f.client.request_token(fid)
        base = st.c_requests.value
        calls = _count_batches(f)
        rs = f.client.request_token_many([(fid, 1)] * 5)
        return [res(r) for r in rs], st.c_requests.value - base, dict(calls)

    got = both(build, script)
    assert got["port"] == got["ref"]
    rs, routed, calls = got["port"]
    assert all(r[0] == TC.STATUS_OK for r in rs) and routed == 0 and calls == {}


def test_request_token_many_fails_over_per_shard(build):
    def script(side, f):
        fa, fb = owned_flow(f, "shard-0"), owned_flow(f, "shard-1")
        f.load_flow_rules("default", [flow_rule(side.st, fa, 4.0), flow_rule(side.st, fb, 4.0)])
        f.client.lease_slack = 0.0
        f.kill("shard-0")
        rs = f.client.request_token_many([(fa, 1), (fb, 1)])
        return [res(r) for r in rs], f.client.shard_degraded("shard-0"), f.client.shard_degraded("shard-1")

    got = both(build, script)
    assert got["port"] == got["ref"]
    rs, d0, d1 = got["port"]
    assert [r[0] for r in rs] == [TC.STATUS_BLOCKED, TC.STATUS_OK] and d0 and not d1


def test_a_seeded_mixed_sequence_with_a_kill_and_a_rejoin(build):
    """200 operations drawn from a seed — single tokens (some
    prioritized), batch tokens, many-flow asks, param tokens, concurrent
    acquire / release and leases — over eight flows on both shards, with
    shard-0 killed at operation 80 and healed at 140: every result equal,
    deny provenance included."""
    rng = np.random.default_rng(1811)
    counts = [int(c) for c in rng.integers(3, 30, size=8)]
    plan = []
    for i in range(200):
        k = int(rng.integers(7))
        # a many-flow ask names each flow once: entries of one flow in one
        # frame are decided in chunks the column worker forms as it wakes,
        # so a denied entry's units may or may not count toward the next
        # one's observed usage, in both packages (ROADMAP.md Queue C)
        many = rng.choice(8, size=int(rng.integers(1, 6)), replace=False)
        plan.append((k, int(rng.integers(8)), int(rng.integers(1, 4)), bool(rng.random() < 0.2),
                     [(int(a), int(rng.integers(1, 3))) for a in many], f"u{int(rng.integers(3))}"))

    def script(side, f):
        fids = [owned_flow(f, "shard-0", lo=101 + 50 * i) if i % 2 == 0 else owned_flow(f, "shard-1", lo=101 + 50 * i)
                for i in range(8)]
        f.load_flow_rules("default", [flow_rule(side.st, fid, float(c)) for fid, c in zip(fids, counts)])
        for n in f.names:
            f.services[n].param_rules.load("default", [
                side.st.ParamFlowRule(resource=f"res-{fid}", count=2, cluster_mode=True, cluster_flow_id=fid)
                for fid in fids if f.client.owner_of(fid) == n])
            # the param stage's first tick on a throwaway resource: the JAX
            # engine compiles it there, not inside a 5 s token timeout
            f.services[n].client.check_batch(["warm/param"])
        held, out = [], []
        for i, (k, j, n, prio, many, value) in enumerate(plan):
            if i == 80:
                kill(f, "shard-0")
            if i == 140:
                heal(f, "shard-0")
            fid = fids[j]
            if k == 0:
                out.append(res(f.client.request_token(fid, n, prio)))
            elif k == 1:
                out.append(res(f.client.request_token_batch(fid, n)))
            elif k == 2:
                out.append([res(r) for r in f.client.request_token_many([(fids[a], b) for a, b in many])])
            elif k == 3:
                out.append(res(f.client.request_param_token(fid, 1, [value])))
            elif k == 4:
                r = f.client.request_concurrent_token(fid)
                if r.ok:
                    held.append(r.token_id)
                out.append((res(r), r.token_id >> 48))
            elif k == 5 and held:
                out.append(res(f.client.release_concurrent_token(held.pop(0))))
            else:
                out.append(res(f.client.request_lease(fid, n)))
        leases = {n: {fid: (ls.granted, ls.used) for fid, ls in st.leases.items()}
                  for n, st in f.client._shards.items()}
        return out, leases

    got = both(build, script)
    for i, (a, b) in enumerate(zip(got["port"][0], got["ref"][0])):
        assert a == b, (i, plan[i], a, b)
    assert got["port"] == got["ref"]
    flat = [r for o in got["port"][0] for r in (o if isinstance(o, list) else [o[0] if isinstance(o[0], tuple) else o])]
    statuses = {r[0] for r in flat}
    assert {TC.STATUS_OK, TC.STATUS_BLOCKED} <= statuses


# ---------------------------------------------------------------------------
# interop: the port's client in front of reference token servers
# ---------------------------------------------------------------------------


def test_the_ports_sharded_client_in_front_of_two_reference_servers(build):
    f = build(REF, lease_slack=0.0)
    fa, fb = owned_flow(f, "shard-0"), owned_flow(f, "shard-1")
    fa2, fb2 = owned_flow(f, "shard-0", lo=fa + 1), owned_flow(f, "shard-1", lo=fb + 1)
    f.load_flow_rules("default", [flow_rule(jst, x, 3.0) for x in (fa, fb, fa2, fb2)])
    port = TS.ShardedTokenClient({n: ("127.0.0.1", f._ports[n]) for n in f.names}, lease_slack=0.0,
                                 reconnect_interval_s=0.0, timeout_ms=5000)
    try:
        port.start()
        _wait_v3([st.client for st in port._shards.values()])
        assert [port.owner_of(x) for x in (fa, fb)] == ["shard-0", "shard-1"]
        got = [res(port.request_token(x)) for x in (fa, fb) for _ in range(4)]
        got.append([res(r) for r in port.request_token_many([(fa, 1), (fb, 1)])])
        want = [res(f.client.request_token(x)) for x in (fa2, fb2) for _ in range(4)]
        want.append([res(r) for r in f.client.request_token_many([(fa2, 1), (fb2, 1)])])
        # the deny provenance names each flow's own id: compare it aside
        swap = {fa: fa2, fb: fb2}
        got = [[r[:4] + (swap.get(r[4], r[4]),) + r[5:] for r in g] if isinstance(g, list)
               else g[:4] + (swap.get(g[4], g[4]),) + g[5:] for g in got]
        assert got == want
        assert [r[0] for r in want[:4]] == [TC.STATUS_OK] * 3 + [TC.STATUS_BLOCKED]
        assert [r[0] for r in want[8]] == [TC.STATUS_BLOCKED] * 2
    finally:
        port.close()
