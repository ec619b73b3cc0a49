"""The port's client in cluster mode against the JAX package's client.

Both clients run in mode="sync" on virtual time with the same rules and
the same entry stream; cluster-mode rules consult a token service (or, with
none attached, degrade to their local fallback), and the verdicts must be
equal.
"""

import time
import types

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

NO_PLANES = dict(device_telemetry=False, timeline_k=0, explain_k=0)


def _jax_client(time_source=None, **cfg):
    """The JAX client; every column upload gets a private copy (ROADMAP.md
    Queue C: on the CPU ``jnp.asarray`` may alias the staging buffers)."""
    jc = JaxClient(cfg=jax_small_cfg(**dict(NO_PLANES, **cfg)), time_source=time_source or JaxVT(1_000), mode="sync")
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    return jc


def _port_client(time_source=None, **cfg):
    return SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **dict(NO_PLANES, **cfg)),
                          time_source=time_source or VirtualTimeSource(1_000), mode="sync", device="cpu")


def _outcomes(client, m, resource, n, **kw):
    out = []
    for _ in range(n):
        try:
            client.entry(resource, **kw).exit()
            out.append("pass")
        except m.BlockException as exc:
            out.append(type(exc).__name__)
    return out


@pytest.mark.parametrize("fallback", [True, False])
def test_a_cluster_mode_flow_rule_with_no_cluster_attached_is_enforced_as_the_reference_does(fallback):
    """A cluster-mode flow rule on a client with no token service: the
    reference degrades to local rules and, with ``cluster_fallback_to_local``
    (the default), compiles the rule as a local one — six entries in one
    virtual millisecond give pass, pass and four FlowExceptions.  Without
    the fallback the rule is not enforced at all: six passes."""
    got = {}
    for name, make, m in (("jax", _jax_client, jst), ("port", _port_client, tst)):
        c = make()
        c.start()
        try:
            c.flow_rules.load([m.FlowRule(resource="r", count=2, cluster_mode=True, cluster_flow_id=7,
                                          cluster_fallback_to_local=fallback)])
            got[name] = _outcomes(c, m, "r", 6)
        finally:
            c.stop()
    want = ["pass", "pass"] + ["FlowException"] * 4 if fallback else ["pass"] * 6
    assert got["jax"] == want
    assert got["port"] == got["jax"]


# -- the token server and client over loopback TCP --------------------------------


def _pkg(name):
    """One package's cluster surface."""
    if name == "jax":
        from sentinel_tpu.cluster import client as CLI
        from sentinel_tpu.cluster import constants as C
        from sentinel_tpu.cluster import server as SRV
        from sentinel_tpu.cluster import state as STM
        from sentinel_tpu.cluster import token_service as TS

        return types.SimpleNamespace(m=jst, C=C, TS=TS, SRV=SRV, CLI=CLI, STM=STM, make=_jax_client)
    from sentinel_tpu_torch.cluster import client as CLI
    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster import server as SRV
    from sentinel_tpu_torch.cluster import state as STM
    from sentinel_tpu_torch.cluster import token_service as TS

    return types.SimpleNamespace(m=tst, C=C, TS=TS, SRV=SRV, CLI=CLI, STM=STM, make=_port_client)


def _cluster_rule(m, fid, count, **kw):
    return m.FlowRule(resource=f"res-{fid}", count=count, cluster_mode=True, cluster_flow_id=fid, **kw)


def _tr(r):
    return (r.status, r.remaining, r.wait_ms, r.prov_kind, r.prov_rule, r.prov_observed, r.prov_limit)


def _wait_for(pred, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _server(p, use_token_column=True):
    dec = p.make()
    dec.start()
    svc = p.TS.DefaultTokenService(dec, use_token_column=use_token_column)
    svc.flow_rules.load("default", [_cluster_rule(p.m, fid, n, cluster_threshold_type=p.C.FLOW_THRESHOLD_GLOBAL)
                                    for fid, n in ((101, 3), (102, 50), (103, 5))])
    # one decision on a flow the session leaves alone, so a first call's
    # one-time costs in this process (compiles, library loads) stay off the
    # session's request timeout
    svc.request_token(103)
    srv = p.SRV.ClusterTokenServer(svc, host="127.0.0.1", port=0)
    srv.start()
    return dec, svc, srv


def _tcp_session(p_client, srv):
    """One client session: HELLO negotiation and the server's census (its
    PING), then v1 frames of each type and a v2 BATCH frame (v3: with deny
    provenance)."""
    C = p_client.C
    tok = p_client.CLI.ClusterTokenClient("127.0.0.1", srv.port, timeout_ms=5000, reconnect_interval_s=0.0)
    tok.start()
    try:
        _wait_for(lambda: tok.peer_version >= 2)
        _wait_for(lambda: srv.connections.connected_count("default") >= 1)
        out = [("version", tok.peer_version)]
        out += [("tok", _tr(tok.request_token(101))) for _ in range(5)]
        out.append(("no-rule", _tr(tok.request_token(31337))))
        out.append(("batch", _tr(tok.request_token_batch(102, 20))))
        out.append(("batch", _tr(tok.request_token_batch(102, 40))))
        r = tok.request_concurrent_token(102)
        out.append(("conc", r.status, r.token_id > 0))
        out.append(("release", tok.request_concurrent_token(102).status, tok.release_concurrent_token(r.token_id).status,
                    tok.release_concurrent_token(r.token_id).status))
        out.append(("lease", _tr(tok.request_lease(102, 5))))
        res = tok.request_batch([(C.BATCH_KIND_FLOW, 101, 1), (C.BATCH_KIND_FLOW_BATCH, 102, 3),
                                 (C.BATCH_KIND_LEASE, 31337, 2), (C.BATCH_KIND_FLOW, 102, 0)])
        out.append(("v2", [_tr(x) for x in res]))
        return out
    finally:
        tok.close()


@pytest.mark.parametrize("use_token_column", [True, False])
def test_tcp_round_trip_and_negotiation_match_the_reference_and_interoperate(use_token_column):
    """The port's server and client over 127.0.0.1 answer a session as the
    reference's pair does; the port's client against the reference's
    server, and the reference's client against the port's, too (the wire
    is byte-identical)."""
    jp, tp = _pkg("jax"), _pkg("port")
    got = {}
    for srv_name, cli_name in (("jax", "jax"), ("port", "port"), ("jax", "port"), ("port", "jax")):
        ps = jp if srv_name == "jax" else tp
        dec, svc, srv = _server(ps, use_token_column)
        try:
            got[(srv_name, cli_name)] = _tcp_session(jp if cli_name == "jax" else tp, srv)
        finally:
            srv.stop()
            svc.close()
            dec.stop()
    want = got[("jax", "jax")]
    assert want[0] == ("version", 3)
    assert [o[1][0] for o in want[1:6]] == [0, 0, 0, 2, 2]
    for k, v in got.items():
        assert v == want, k


# -- the client's cluster mode ----------------------------------------------------


def _entries(c, m, resource, n, **kw):
    return _outcomes(c, m, resource, n, **kw)


def _embedded(p, rules, param_rules=(), **cfg):
    """An app client whose cluster rules consult an embedded token server
    (``set_to_server(serve_network=False)``) on a second client."""
    dec = p.make()
    dec.start()
    svc = p.TS.DefaultTokenService(dec)
    svc.flow_rules.load("default", [r for r in rules if r.cluster_mode])
    svc.param_rules.load("default", list(param_rules))
    mgr = p.STM.ClusterStateManager()
    mgr.set_to_server(svc, serve_network=False)
    app = p.make(time_source=dec.time, **cfg)  # one clock: the token windows roll with the app's
    app.start()
    app.set_cluster(mgr)
    app.flow_rules.load(rules)
    app.param_flow_rules.load(list(param_rules))
    return app, dec, svc


def _scenario_embedded(p):
    m = p.m
    rules = [_cluster_rule(m, 101, 2, cluster_threshold_type=p.C.FLOW_THRESHOLD_GLOBAL),
             m.FlowRule(resource="local", count=1)]
    prule = m.ParamFlowRule(resource="res-55", count=1, cluster_mode=True, cluster_flow_id=55)
    app, dec, svc = _embedded(p, rules, [prule])
    try:
        out = _entries(app, m, "res-101", 5) + _entries(app, m, "local", 3)
        out += _entries(app, m, "res-55", 3, args=["alice"]) + _entries(app, m, "res-55", 2, args=["bob"])
        # the bulk path: one partial-grant round trip a (resource, argument)
        # group, granted units handed out greedily in item order
        app.time.advance(1_100)
        out.append(app.check_batch(["res-101"] * 3, counts=[1, 2, 1]))
        out.append(app.check_batch(["res-101", "res-55", "res-55", "res-55"], params=[None, "carol", "carol", "dave"]))
        stats = app.stats.resource("res-101")
        out.append(("blockQps", stats["blockQps"] > 0, stats["passQps"]))
        out.append(("degraded", app._cluster_degraded_active, "param" in app._features))
        return out
    finally:
        app.stop()
        svc.close()
        dec.stop()


def _scenario_degrade_and_recover(p):
    """No service → degraded (the fallback rules enforce locally); a
    failing service keeps it degraded through probes; the first answered
    probe recovers; a BLOCKED answer while degraded recovers too; the
    namespace guard's TOO_MANY_REQUEST degrades like a failure."""
    m, C = p.m, p.C

    class Flapping:
        def __init__(self):
            self.status = C.STATUS_FAIL
            self.calls = 0

        def request_token(self, flow_id, count=1, prioritized=False):
            self.calls += 1
            return p.TS.TokenResult(self.status)

    svc = Flapping()
    mgr = types.SimpleNamespace(token_service=lambda: svc)
    app = p.make()
    app.start()
    try:
        app.set_cluster(mgr)
        app.cluster_retry_interval_s = 0.0  # every entry re-probes
        app.flow_rules.load([_cluster_rule(m, 11, 2)])
        out = []
        for status in (C.STATUS_FAIL, C.STATUS_FAIL, C.STATUS_OK, C.STATUS_TOO_MANY_REQUEST, C.STATUS_BLOCKED,
                       C.STATUS_OK, C.STATUS_SHOULD_WAIT):
            svc.status = status
            out.append((status, _entries(app, m, "res-11", 3), app._cluster_degraded_active, svc.calls))
            app.time.advance(1_100)
        return out
    finally:
        app.stop()


def _scenario_authority_first(p):
    """An authority-doomed request consumes no token, on entry() and the
    bulk path; an allowed one does."""
    m, C = p.m, p.C

    class Counting:
        calls = 0

        def request_token(self, flow_id, count=1, prioritized=False):
            Counting.calls += 1
            return p.TS.TokenResult(C.STATUS_OK)

        def request_token_batch(self, flow_id, units):
            Counting.calls += 1
            return p.TS.TokenResult(C.STATUS_OK, remaining=units)

    mgr = types.SimpleNamespace(token_service=lambda: Counting())
    app = p.make()
    app.start()
    try:
        app.set_cluster(mgr)
        app.flow_rules.load([_cluster_rule(m, 77, 100)])
        app.authority_rules.load([m.AuthorityRule(resource="res-77", limit_app="badcaller",
                                                  strategy=m.AUTHORITY_BLACK)])
        out = [_entries(app, m, "res-77", 1, origin="badcaller"), Counting.calls]
        out += [_entries(app, m, "res-77", 1, origin="goodcaller"), Counting.calls]
        out += [app.check_batch(["res-77", "res-77"], origins=["badcaller", "goodcaller"]), Counting.calls]
        app.authority_rules.load([m.AuthorityRule(resource="res-77", limit_app="goodcaller",
                                                  strategy=m.AUTHORITY_WHITE)])
        out += [_entries(app, m, "res-77", 1, origin="stranger"), Counting.calls]
        return out
    finally:
        app.stop()


def _scenario_remote_provenance(p):
    """A remote deny's provenance lands in the explain plane (planes on):
    the service's (kind, flow id, observed, limit) from the column path,
    and a deny without provenance counts as unexplained."""
    m, C = p.m, p.C
    rules = [_cluster_rule(m, 101, 2, cluster_threshold_type=C.FLOW_THRESHOLD_GLOBAL)]
    app, dec, svc = _embedded(p, rules, explain_k=32)
    try:
        out = _entries(app, m, "res-101", 4)
        out.append(app.check_batch(["res-101"] * 2))
        recs = [(r.kind_name, r.rule, r.observed, r.threshold, r.origin, r.forced)
                for r in app.explain("res-101")]
        cov = app.explain_coverage()
        return out + [sorted(recs, key=repr), cov]
    finally:
        app.stop()
        svc.close()
        dec.stop()


def _scenario_param_fallback(p):
    """A cluster-mode param rule with no service: the client degrades and
    hands the rule to its engine as a local param rule (lane 0's value)."""
    m = p.m
    app = p.make()
    app.start()
    try:
        app.set_cluster(p.STM.ClusterStateManager())
        app.param_flow_rules.load([m.ParamFlowRule(resource="res-55", count=1, cluster_mode=True, cluster_flow_id=55)])
        out = [("param" in app._features, app._cluster_degraded_active)]
        out += _entries(app, m, "res-55", 3, args=["alice"]) + _entries(app, m, "res-55", 2, args=["bob"])
        out.append(("param" in app._features, app._cluster_degraded_active))
        return out
    finally:
        app.stop()


@pytest.mark.parametrize(
    "scenario", ["embedded", "degrade_and_recover", "authority_first", "remote_provenance", "param_fallback"]
)
def test_cluster_mode_matches_the_reference(scenario):
    fn = globals()[f"_scenario_{scenario}"]
    want = fn(_pkg("jax"))
    got = fn(_pkg("port"))
    assert got == want
    if scenario == "embedded":
        # fallback off the table here: the service answered every request
        assert want[-1][0] == "degraded" and not want[-1][1]
        assert want[:5] == ["pass", "pass", "FlowException", "FlowException", "FlowException"]
    if scenario == "degrade_and_recover":
        assert [o[2] for o in want] == [True, True, False, True, False, False, False]
    if scenario == "remote_provenance":
        assert any(r[4] == "cluster" for r in want[-2])
    if scenario == "param_fallback":
        assert want == [(False, False), "pass", "ParamFlowException", "ParamFlowException", "pass",
                        "ParamFlowException", (True, True)]
