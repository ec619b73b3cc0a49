"""The Envoy RLS front door (``sentinel_tpu_torch.rls``), against the JAX
package's.

The counterparts of tests/test_rls.py's ten tests: the descriptor
identifier (order independence, the zlib flow id), ``should_rate_limit``
in process (limits, unmatched descriptors, ``hits_addend``, an empty
descriptor list, an unknown domain, a decision that raises failing CLOSED
to OVER_LIMIT, the any-over-limit rule over several descriptors), the rule
dict round trip, and the gRPC end-to-end pair over this box's grpcio on
127.0.0.1 (port 0).  Each runs on a port decision client (sync, virtual
time, the small config, ``device="cpu"``) and on the reference's on the
same requests; the overall codes and per-descriptor statuses must be
equal.  A seeded stream of 300 requests across three domains (matched,
unmatched, unknown) and two ``hits_addend`` values is answered as the
reference answers it, and the ``sentinel_rls_requests_total{code}``
counters move as the reference's do.  Codes are integers, compared for
equality.
"""

from __future__ import annotations

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from sentinel_tpu.cluster.token_service import DefaultTokenService as JService  # noqa: E402
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg  # noqa: E402
from sentinel_tpu.obs.registry import REGISTRY as JREG  # noqa: E402
from sentinel_tpu.rls import rules as JRR  # noqa: E402
from sentinel_tpu.rls import server as JRS  # noqa: E402
from sentinel_tpu.runtime.client import SentinelClient as JaxClient  # noqa: E402
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT  # noqa: E402

from sentinel_tpu_torch.cluster.token_service import DefaultTokenService  # noqa: E402
from sentinel_tpu_torch.core.config import small_engine_config  # noqa: E402
from sentinel_tpu_torch.obs.registry import REGISTRY  # noqa: E402
from sentinel_tpu_torch.rls import rls_pb2 as pb  # noqa: E402
from sentinel_tpu_torch.rls import rules as RR  # noqa: E402
from sentinel_tpu_torch.rls import server as RS  # noqa: E402
from sentinel_tpu_torch.runtime.client import SentinelClient  # noqa: E402
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource  # noqa: E402

PORT = dict(rules=RR, server=RS, service=DefaultTokenService, reg=REGISTRY)
REF = dict(rules=JRR, server=JRS, service=JService, reg=JREG)


@pytest.fixture()
def made():
    clients = []
    yield clients
    for c in clients:
        c.stop()


def _service(side, made):
    if side is REF:
        c = JaxClient(cfg=jax_small_cfg(), time_source=JVT(1_000), mode="sync")
    else:
        c = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                           device="cpu")
    c.start()
    made.append(c)
    return side["service"](c)


def make_rule(rr, domain="mesh", key="dest", value="svc-a", count=3.0):
    return rr.EnvoyRlsRule(domain=domain, descriptors=[
        rr.RlsResourceDescriptor(key_values=[rr.RlsKeyValue(key, value)], count=count)])


def make_request(domain="mesh", entries=(("dest", "svc-a"),), hits=1, more=()):
    req = pb.RateLimitRequest(domain=domain, hits_addend=hits)
    for ents in (entries,) + tuple(more):
        d = req.descriptors.add()
        for k, v in ents:
            e = d.entries.add()
            e.key, e.value = k, v
    return req


def _codes(rsp):
    return int(rsp.overall_code), [int(s.code) for s in rsp.statuses]


def _both(made, fn):
    return fn(REF, made), fn(PORT, made)


def test_identifier_stability_and_order_independence():
    for rr in (JRR, RR):
        a = rr.descriptor_identifier("d", [("k1", "v1"), ("k2", "v2")])
        b = rr.descriptor_identifier("d", [("k2", "v2"), ("k1", "v1")])
        assert a == b
        assert rr.identifier_flow_id(a) == rr.identifier_flow_id(b) > 0
    assert RR.identifier_flow_id(RR.descriptor_identifier("mesh", [("dest", "svc-a")])) == \
        JRR.identifier_flow_id(JRR.descriptor_identifier("mesh", [("dest", "svc-a")]))


def test_should_rate_limit_inproc(made):
    def run(side, made):
        rls = side["server"].SentinelEnvoyRlsService(_service(side, made))
        rls.rules.load([make_rule(side["rules"], count=2.0)])
        codes = [_codes(rls.should_rate_limit(make_request())) for _ in range(4)]
        codes.append(_codes(rls.should_rate_limit(make_request(entries=(("dest", "unknown"),)))))
        return codes

    ref, port = _both(made, run)
    assert port == ref
    overall = [c[0] for c in port]
    assert overall[:4].count(pb.RateLimitResponse.OK) == 2
    assert overall[:4].count(pb.RateLimitResponse.OVER_LIMIT) == 2
    assert overall[4] == pb.RateLimitResponse.OK  # unmatched descriptor: no rule


def test_hits_addend_consumes_multiple_tokens(made):
    def run(side, made):
        rls = side["server"].SentinelEnvoyRlsService(_service(side, made))
        rls.rules.load([make_rule(side["rules"], count=5.0)])
        return [_codes(rls.should_rate_limit(make_request(hits=h)))[0] for h in (5, 1)]

    ref, port = _both(made, run)
    assert port == ref == [pb.RateLimitResponse.OK, pb.RateLimitResponse.OVER_LIMIT]


def _grpc_run(side, made, rule_count, requests):
    server = side["server"].SentinelRlsGrpcServer(_service(side, made), host="127.0.0.1", port=0)
    server.rules.load([make_rule(side["rules"], count=rule_count)])
    server.start()
    try:
        channel, call = side["server"].make_channel_stub(f"127.0.0.1:{server.port}")
        try:
            return [_codes(call(r, timeout=10)) for r in requests]
        finally:
            channel.close()
    finally:
        server.stop()


def test_grpc_server_end_to_end(made):
    port = _grpc_run(PORT, made, 2.0, [make_request() for _ in range(4)])
    rls = JRS.SentinelEnvoyRlsService(_service(REF, made))
    rls.rules.load([make_rule(JRR, count=2.0)])
    ref = [_codes(rls.should_rate_limit(make_request())) for _ in range(4)]
    assert port == ref
    overall = [c[0] for c in port]
    assert overall.count(pb.RateLimitResponse.OK) == 2 and overall.count(pb.RateLimitResponse.OVER_LIMIT) == 2


def test_rule_dict_roundtrip():
    rule = make_rule(RR)
    assert RR.EnvoyRlsRule.from_dict(rule.to_dict()) == rule
    assert rule.to_dict() == make_rule(JRR).to_dict()


def test_empty_descriptor_list_is_ok(made):
    def run(side, made):
        rls = side["server"].SentinelEnvoyRlsService(_service(side, made))
        rls.rules.load([make_rule(side["rules"])])
        return _codes(rls.should_rate_limit(pb.RateLimitRequest(domain="mesh")))

    ref, port = _both(made, run)
    assert port == ref == (pb.RateLimitResponse.OK, [])  # one status a descriptor, none sent


def test_unknown_domain_is_ok_not_over_limit(made):
    def run(side, made):
        rls = side["server"].SentinelEnvoyRlsService(_service(side, made))
        rls.rules.load([make_rule(side["rules"], domain="mesh")])
        return _codes(rls.should_rate_limit(make_request(domain="not-mesh")))

    ref, port = _both(made, run)
    assert port == ref == (pb.RateLimitResponse.OK, [pb.RateLimitResponse.OK])


def test_decision_exception_fails_closed(made):
    """An exception escaping the decision path becomes OVER_LIMIT (counted
    under code="error"), not a gRPC UNKNOWN: Envoy's default failure_mode
    would admit an errored request unmetered."""

    def run(side, made):
        svc = _service(side, made)
        rls = side["server"].SentinelEnvoyRlsService(svc)
        rls.rules.load([make_rule(side["rules"], domain="mesh")])
        first = _codes(rls.should_rate_limit(make_request(domain="mesh")))

        def boom(*a, **k):
            raise RuntimeError("decision backend down")

        err = side["reg"].get("sentinel_rls_requests_total", {"code": "error"})
        before = err.value
        svc.request_token = boom
        try:
            broken = _codes(rls.should_rate_limit(make_request(domain="mesh")))
        finally:
            del svc.request_token
        return first, broken, err.value - before

    ref, port = _both(made, run)
    assert port == ref
    assert port[0][0] == pb.RateLimitResponse.OK
    assert port[1][0] == pb.RateLimitResponse.OVER_LIMIT and port[2] == 1


def test_multi_descriptor_any_over_limit_semantics(made):
    def run(side, made):
        rr = side["rules"]
        rls = side["server"].SentinelEnvoyRlsService(_service(side, made))
        rls.rules.load([rr.EnvoyRlsRule(domain="mesh", descriptors=[
            rr.RlsResourceDescriptor(key_values=[rr.RlsKeyValue("dest", "svc-tight")], count=1.0),
            rr.RlsResourceDescriptor(key_values=[rr.RlsKeyValue("dest", "svc-wide")], count=100.0),
        ])])
        req = make_request(entries=(("dest", "svc-tight"),), more=((("dest", "svc-wide"),),))
        return [_codes(rls.should_rate_limit(req)) for _ in range(2)]

    ref, port = _both(made, run)
    assert port == ref
    assert port[0][0] == pb.RateLimitResponse.OK
    assert port[1] == (pb.RateLimitResponse.OVER_LIMIT, [pb.RateLimitResponse.OVER_LIMIT, pb.RateLimitResponse.OK])


def test_grpc_roundtrip_multi_descriptor_and_empty(made):
    """The wire path agrees with the reference's in-process service on an
    empty descriptor list, an unknown domain and multi-descriptor
    verdicts."""
    mixed = make_request(more=((("dest", "unknown"),),))
    requests = [pb.RateLimitRequest(domain="mesh"), make_request(domain="elsewhere"), mixed, mixed]
    port = _grpc_run(PORT, made, 1.0, requests)
    rls = JRS.SentinelEnvoyRlsService(_service(REF, made))
    rls.rules.load([make_rule(JRR, count=1.0)])
    ref = [_codes(rls.should_rate_limit(r)) for r in requests]
    assert port == ref
    assert [c[0] for c in port[:3]] == [pb.RateLimitResponse.OK] * 3
    assert port[3] == (pb.RateLimitResponse.OVER_LIMIT, [pb.RateLimitResponse.OVER_LIMIT, pb.RateLimitResponse.OK])


def _stream(seed: int, n: int):
    """(domain, value, hits) triples: a matched domain with five
    descriptors, an unmatched value in it, and an unknown domain."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        u = rng.random()
        if u < 0.7:
            out.append(("mesh", f"svc-{int(rng.integers(5))}", int(rng.choice([1, 3]))))
        elif u < 0.85:
            out.append(("mesh", "svc-none", 1))
        else:
            out.append(("other", "svc-0", 1))
    return out


def test_a_descriptor_stream_is_answered_as_the_reference_answers_it(made):
    stream = _stream(16, 300)

    def run(side, made):
        rr = side["rules"]
        svc = _service(side, made)
        rls = side["server"].SentinelEnvoyRlsService(svc)
        rls.rules.load([rr.EnvoyRlsRule(domain="mesh", descriptors=[
            rr.RlsResourceDescriptor(key_values=[rr.RlsKeyValue("dest", f"svc-{i}")], count=10.0 * (i + 1))
            for i in range(5)])])
        ctr = {k: side["reg"].get("sentinel_rls_requests_total", {"code": k}) for k in ("ok", "over_limit")}
        before = {k: c.value for k, c in ctr.items()}
        codes = []
        for i, (dom, val, hits) in enumerate(stream):
            codes.append(_codes(rls.should_rate_limit(make_request(domain=dom, entries=(("dest", val),),
                                                                   hits=hits))))
            if i % 50 == 49:
                svc.client.time.advance(1_000)  # a fresh second every 50 requests
        return codes, {k: c.value - before[k] for k, c in ctr.items()}

    ref, port = _both(made, run)
    assert port == ref
    codes, moved = port
    n_over = sum(c[0] == pb.RateLimitResponse.OVER_LIMIT for c in codes)
    assert 0 < n_over < len(codes)
    assert moved == {"ok": len(codes) - n_over, "over_limit": n_over}
