"""The adapters (``sentinel_tpu_torch.adapters``) and the workload plane's
adapter drivers, against the JAX package's.

The counterparts of tests/test_adapters.py (decorator, WSGI, ASGI,
outbound HTTP guard, gRPC interceptors, the gateway's parser, API groups
and per-parameter limits), tests/test_rpc_streaming.py (the provider and
consumer resource chains, the streaming guards) and
tests/test_workload_adapters.py (``drive_gateway``, ``drive_streaming``,
``drive_asgi``, ``drive_grpc`` over a flash crowd, with the timeline
rows).  Each scenario runs on a port client (sync, virtual time, the
small config, ``device="cpu"``) and on the reference's, on the same
requests: the outcomes (pass, the block's exception, a fallback), the
handler calls and the per-resource stats the reference's test reads must
be equal, and the reference test's own assertions hold on the port.

The slice as a whole: ``drive_gateway`` on both packages' sync clients
under ``platform_config()`` at small widths, with route rules, a
header-keyed and a URL-param-keyed gateway param rule, a client-IP rule
on an API group and a flow rule, over a seeded hot-parameter flood —
``DriveResult`` counts and every request's verdict equal.  The JAX client
there runs ``platform_config()``'s host path with its jitted plain tick
(``tests/torch_harness.jax_host_client``).  Counts and verdicts are
integers, compared for equality; stats floats within rtol 1e-6 / atol 1e-4.
"""

from __future__ import annotations

import asyncio
import gc
import math

import pytest

import sentinel_tpu as jst
import sentinel_tpu.adapters as JA
from sentinel_tpu import workload as JWL
from sentinel_tpu.adapters import gateway as JGW
from sentinel_tpu.adapters import rpc as JRPC
from sentinel_tpu.adapters import streaming as JSTR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.obs import timeline as JTL
from sentinel_tpu.runtime import context as JCTX
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

import sentinel_tpu_torch as st
import sentinel_tpu_torch.adapters as TA
from sentinel_tpu_torch import workload as WL
from sentinel_tpu_torch.adapters import gateway as GW
from sentinel_tpu_torch.adapters import rpc as RPC
from sentinel_tpu_torch.adapters import streaming as STR
from sentinel_tpu_torch.core.config import platform_config, small_engine_config
from sentinel_tpu_torch.obs import timeline as TL
from sentinel_tpu_torch.runtime import context as CTX
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.torch_harness import jax_host_client

REF = dict(st=jst, A=JA, GW=JGW, RPC=JRPC, STR=JSTR, WL=JWL, TL=JTL, grpc_mod="sentinel_tpu.adapters.grpc_adapter")
PORT = dict(st=st, A=TA, GW=GW, RPC=RPC, STR=STR, WL=WL, TL=TL, grpc_mod="sentinel_tpu_torch.adapters.grpc_adapter")
BIG = 1 << 60
IFACE = "com.demo.OrderService"
METHOD = "com.demo.OrderService:place(Order)"


@pytest.fixture(autouse=True)
def _clean_port_context():
    yield
    CTX.clear()
    JCTX.clear()


@pytest.fixture()
def make():
    """make(side, **kw): a started sync client of that side on virtual time
    1,000 (the small config); all stopped at teardown."""
    made = []

    def factory(side, **kw):
        if side is REF:
            c = JaxClient(cfg=jax_small_cfg(), time_source=JVT(1_000), mode="sync", **kw)
        else:
            c = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                               device="cpu", **kw)
        c.start()
        made.append(c)
        return c

    yield factory
    for c in made:
        c.stop()


def _stats(c, name, keys=("passQps", "blockQps", "successQps", "exceptionQps", "curThreadNum")):
    s = c.stats.resource(name)
    return None if s is None else tuple(s[k] for k in keys)


def _close(a, b):
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-4)
    return a == b


def _both(make, fn):
    """``fn(side, client)`` on the reference, then on the port."""
    ref = fn(REF, make(REF))
    port = fn(PORT, make(PORT))
    assert _close(port, ref), (port, ref)
    return port


# -- decorator --------------------------------------------------------------


def test_decorator_pass_block_fallback(make):
    def run(side, c):
        calls = []

        def on_block(x, block_exception=None):
            calls.append(("block", x, type(block_exception).__name__))
            return "blocked"

        def on_err(x, exception=None):
            calls.append(("fallback", x, type(exception).__name__))
            return "fell-back"

        @side["A"].sentinel_resource("deco", block_handler=on_block, fallback=on_err, client=c)
        def fn(x):
            if x == "boom":
                raise ValueError("biz")
            return x * 2

        c.flow_rules.load([side["st"].FlowRule(resource="deco", count=2)])
        return [fn("a"), fn("boom"), fn("c")], calls, _stats(c, "deco")

    out, calls, s = _both(make, run)
    assert out == ["aa", "fell-back", "blocked"]
    assert calls == [("fallback", "boom", "ValueError"), ("block", "c", "FlowException")]
    assert s[1] == 1 and s[3] == 1


def test_decorator_default_name_and_ignore(make):
    def run(side, c):
        @side["A"].sentinel_resource(exceptions_to_ignore=(KeyError,), client=c)
        def named():
            raise KeyError("skip")

        with pytest.raises(KeyError):
            named()
        return named.__sentinel_resource__.rsplit(":", 1)[1], _stats(c, named.__sentinel_resource__)

    name, s = _both(make, run)
    assert name.endswith("named") and s[3] == 0  # ignored exceptions are not traced


# -- WSGI -------------------------------------------------------------------


def _wsgi_get(mw, path, **environ):
    status_headers = {}

    def start_response(status, headers):
        status_headers["status"] = status

    result = mw({"REQUEST_METHOD": "GET", "PATH_INFO": path, **environ}, start_response)
    try:
        body = b"".join(result)
    finally:
        close = getattr(result, "close", None)
        if close is not None:
            close()  # WSGI servers always call close()
    return status_headers["status"], body


def test_wsgi_block_and_pass(make):
    def run(side, c):
        def app(environ, start_response):
            start_response("200 OK", [("Content-Type", "text/plain")])
            return [b"hello"]

        mw = side["A"].SentinelWSGIMiddleware(app, client=c)
        c.flow_rules.load([side["st"].FlowRule(resource="GET:/api", count=2)])
        return [_wsgi_get(mw, "/api") for _ in range(3)], _stats(c, "GET:/api")

    got, s = _both(make, run)
    assert got[:2] == [("200 OK", b"hello")] * 2
    assert got[2][0].startswith("429") and b"Blocked" in got[2][1]
    assert s[0] == 2 and s[1] == 1 and s[4] == 0  # the iterator's close exits every entry


def test_wsgi_origin_and_exception(make):
    def run(side, c):
        def app(environ, start_response):
            raise RuntimeError("app broke")

        mw = side["A"].SentinelWSGIMiddleware(app, client=c)
        c.authority_rules.load([side["st"].AuthorityRule(resource="GET:/sec", limit_app="evil",
                                                         strategy=side["st"].AUTHORITY_BLACK)])
        status, _body = _wsgi_get(mw, "/sec", HTTP_S_USER="evil")
        with pytest.raises(RuntimeError):
            _wsgi_get(mw, "/ok", HTTP_S_USER="good")
        return status, _stats(c, "GET:/ok")

    status, s = _both(make, run)
    assert status.startswith("429") and s[3] == 1 and s[4] == 0


# -- ASGI -------------------------------------------------------------------


async def _asgi_app(scope, receive, send):
    await send({"type": "http.response.start", "status": 200, "headers": []})
    await send({"type": "http.response.body", "body": b"ok"})


def _asgi_get(mw, path):
    async def one():
        sent = []

        async def send(msg):
            sent.append(msg)

        async def receive():
            return {"type": "http.request"}

        await mw({"type": "http", "method": "GET", "path": path, "headers": []}, receive, send)
        return [(m.get("status"), m.get("body")) for m in sent]

    return asyncio.run(one())


def test_asgi_block_and_pass(make):
    def run(side, c):
        mw = side["A"].SentinelASGIMiddleware(_asgi_app, client=c)
        c.flow_rules.load([side["st"].FlowRule(resource="GET:/a", count=1)])
        return [_asgi_get(mw, "/a") for _ in range(2)], _stats(c, "GET:/a")

    got, s = _both(make, run)
    assert got[0][0][0] == 200 and got[1][0][0] == 429
    assert s[0] == 1 and s[1] == 1


# -- outbound HTTP guard ----------------------------------------------------


def test_http_client_guard(make):
    def run(side, c):
        sent = []

        def send(method, url, **kw):
            sent.append((method, url))
            return "rsp"

        hc = side["A"].SentinelHttpClient(send, client=c)
        c.flow_rules.load([side["st"].FlowRule(resource="GET:http://svc/api", count=1)])
        first = hc.request("GET", "http://svc/api?q=1")
        with pytest.raises(side["st"].BlockException):
            hc.request("GET", "http://svc/api?q=2")  # the query is stripped: the same resource
        return first, sent, side["A"].default_url_resource("post", "https://h:8/p/q?x=1")

    first, sent, name = _both(make, run)
    assert first == "rsp" and len(sent) == 1 and name == "POST:https://h:8/p/q"


# -- gRPC interceptors ------------------------------------------------------


def test_grpc_server_interceptor(make):
    grpc = pytest.importorskip("grpc")
    import importlib

    def run(side, c):
        inner_calls = []

        def inner(request, context):
            inner_calls.append(request)
            return "reply"

        base_handler = grpc.unary_unary_rpc_method_handler(inner)

        class Details:
            method = "/pkg.Svc/Do"
            invocation_metadata = (("s-user", "caller-x"),)

        class FakeContext:
            aborted = None

            def abort(self, code, details):
                self.aborted = code
                raise RuntimeError("aborted")

        mod = importlib.import_module(side["grpc_mod"])
        handler = mod.SentinelServerInterceptor(client=c).intercept_service(lambda d: base_handler, Details())
        c.flow_rules.load([side["st"].FlowRule(resource="/pkg.Svc/Do", count=1)])
        first = handler.unary_unary("req", FakeContext())
        ctx2 = FakeContext()
        with pytest.raises(RuntimeError):
            handler.unary_unary("req2", ctx2)
        return first, ctx2.aborted == grpc.StatusCode.RESOURCE_EXHAUSTED, inner_calls

    assert _both(make, run) == ("reply", True, ["req"])


def test_grpc_client_interceptor(make):
    grpc = pytest.importorskip("grpc")
    import importlib

    def run(side, c):
        class FakeCall:
            def __init__(self):
                self.cbs = []

            def add_done_callback(self, cb):
                self.cbs.append(cb)

            def code(self):
                return grpc.StatusCode.OK

        class Details:
            method = "/pkg.Svc/Out"

        mod = importlib.import_module(side["grpc_mod"])
        interceptor = mod.SentinelClientInterceptor(client=c)
        c.flow_rules.load([side["st"].FlowRule(resource="/pkg.Svc/Out", count=1)])
        call = interceptor.intercept_unary_unary(lambda d, r: FakeCall(), Details(), "req")
        for cb in call.cbs:
            cb(call)  # the RPC completes: the entry exits
        with pytest.raises(side["st"].BlockException):
            interceptor.intercept_unary_unary(lambda d, r: FakeCall(), Details(), "req")
        return _stats(c, "/pkg.Svc/Out")

    assert _both(make, run)[4] == 0


# -- gateway ----------------------------------------------------------------


def test_gateway_param_parser_strategies():
    out = {}
    for name, gw in (("ref", JGW), ("port", GW)):
        p = gw.GatewayParamParser()
        req = gw.RequestAttributes(path="/x", client_ip="10.0.0.9", host="svc.example", headers={"X-Tenant": "acme"},
                                   url_params={"user": "u1"}, cookies={"session": "s1"})
        vals = [p.parse_value(gw.GatewayParamFlowItem(gw.PARAM_PARSE_STRATEGY_CLIENT_IP), req),
                p.parse_value(gw.GatewayParamFlowItem(gw.PARAM_PARSE_STRATEGY_HOST), req),
                p.parse_value(gw.GatewayParamFlowItem(gw.PARAM_PARSE_STRATEGY_HEADER, field_name="X-Tenant"), req),
                p.parse_value(gw.GatewayParamFlowItem(gw.PARAM_PARSE_STRATEGY_URL_PARAM, field_name="user"), req),
                p.parse_value(gw.GatewayParamFlowItem(gw.PARAM_PARSE_STRATEGY_COOKIE, field_name="session"), req)]
        item = gw.GatewayParamFlowItem(gw.PARAM_PARSE_STRATEGY_HEADER, field_name="X-Tenant", pattern="globex",
                                       match_strategy=gw.PARAM_MATCH_STRATEGY_EXACT)
        vals.append(p.parse_value(item, req))  # a pattern mismatch: the NOT_MATCH sentinel
        item.match_strategy, item.pattern = gw.PARAM_MATCH_STRATEGY_CONTAINS, "cm"
        vals.append(p.parse_value(item, req))
        item.match_strategy, item.pattern = gw.PARAM_MATCH_STRATEGY_REGEX, "[("  # a bad regex never matches
        vals.append(p.parse_value(item, req))
        rule = gw.GatewayFlowRule(resource="r", count=3, param_item=gw.GatewayParamFlowItem(
            gw.PARAM_PARSE_STRATEGY_HEADER, field_name="X-Tenant"))
        out[name] = (vals, p.parse([rule, gw.GatewayFlowRule(resource="r", count=9)], req))
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["10.0.0.9", "svc.example", "acme", "u1", "s1", GW.NOT_MATCH_PARAM, "acme",
                              GW.NOT_MATCH_PARAM]
    assert out["port"][1] == ["acme", GW.DEFAULT_PARAM]
    r = GW.convert_to_param_rule(GW.GatewayFlowRule(resource="r", count=3, burst=2), 1)
    j = JGW.convert_to_param_rule(JGW.GatewayFlowRule(resource="r", count=3, burst=2), 1)
    assert (r.resource, r.count, r.grade, r.param_idx, r.burst_count, r.duration_in_sec) == \
        (j.resource, j.count, j.grade, j.param_idx, j.burst_count, j.duration_in_sec)
    assert [(i.object, i.count) for i in r.param_flow_item_list] == [(i.object, i.count) for i in j.param_flow_item_list]


def test_api_definition_matching():
    out = {}
    for name, gw in (("ref", JGW), ("port", GW)):
        apis = gw.ApiDefinitionManager()
        apis.load([
            gw.ApiDefinition("user-api", [gw.ApiPredicateItem("/users", gw.URL_MATCH_STRATEGY_PREFIX)]),
            gw.ApiDefinition("exact-api", [gw.ApiPredicateItem("/ping", gw.URL_MATCH_STRATEGY_EXACT)]),
            gw.ApiDefinition("re-api", [gw.ApiPredicateItem(r"/v\d+/items", gw.URL_MATCH_STRATEGY_REGEX)]),
        ])
        out[name] = [apis.match(p) for p in ("/users/42", "/ping", "/v2/items", "/other")]
    assert out["port"] == out["ref"] == [["user-api"], ["exact-api"], ["re-api"], []]


def test_gateway_end_to_end_per_param_limit(make):
    def run(side, c):
        gw_mod = side["GW"]
        gw = gw_mod.GatewayAdapter(c)
        gw.rules.load_rules([gw_mod.GatewayFlowRule(resource="route-a", count=2, param_item=gw_mod.GatewayParamFlowItem(
            gw_mod.PARAM_PARSE_STRATEGY_HEADER, field_name="X-Tenant"))])

        def hit(tenant):
            req = gw_mod.RequestAttributes(path="/svc", client_ip="1.1.1.1", headers={"X-Tenant": tenant})
            try:
                entries = gw.entries_for("route-a", req)
            except side["st"].BlockException:
                return False
            for e in entries:
                e.exit()
            return True

        out = [hit("acme"), hit("acme"), hit("acme"), hit("globex")]
        c.time.advance(1100)
        out.append(hit("acme"))
        return out, c.param_lane("route-a", 0)

    out, lane = _both(make, run)
    assert out == [True, True, False, True, True] and lane == 0


def test_gateway_api_group_entry(make):
    def run(side, c):
        gw_mod = side["GW"]
        gw = gw_mod.GatewayAdapter(c)
        gw.apis.load([gw_mod.ApiDefinition("grp", [gw_mod.ApiPredicateItem("/g", gw_mod.URL_MATCH_STRATEGY_PREFIX)])])
        gw.rules.load_rules([gw_mod.GatewayFlowRule(resource="grp", count=1)])
        req = gw_mod.RequestAttributes(path="/g/1", client_ip="2.2.2.2")
        entries = gw.entries_for("route-b", req)
        names = [e.resource for e in entries]
        for e in entries:
            e.exit()
        with pytest.raises(side["st"].BlockException):
            gw.entries_for("route-b", req)  # grp's limit of 1 a second is spent
        # the failed acquisition exited the route entry it had taken
        return names, _stats(c, "route-b")[4], [r.resource for r in gw.rules.get_rules()]

    assert _both(make, run) == (["route-b", "grp"], 0, ["grp"])


# -- the RPC chain ----------------------------------------------------------


def test_provider_chain_counts_both_nodes(make):
    def run(side, c):
        out = [side["RPC"].provider_call(IFACE, METHOD, lambda: "ok", origin="caller-app", client=c) for _ in range(3)]
        so = c.stats.origin(IFACE, "caller-app")
        return out, _stats(c, IFACE), _stats(c, METHOD), None if so is None else so["passQps"]

    out, si, sm, so = _both(make, run)
    assert out == ["ok"] * 3 and si[0] == sm[0] == 3 and si[4] == sm[4] == 0 and so == 3


def test_method_rule_blocks_only_method(make):
    def run(side, c):
        c.flow_rules.load([side["st"].FlowRule(resource=METHOD, count=2.0)])
        out = []
        for _ in range(5):
            try:
                side["RPC"].provider_call(IFACE, METHOD, lambda: "ok", origin="caller-app", client=c)
                out.append("pass")
            except side["st"].BlockException:
                out.append("block")
        return out, _stats(c, IFACE), _stats(c, METHOD)

    out, si, sm = _both(make, run)
    assert out.count("pass") == 2 and out.count("block") == 3
    # the interface entry passed all five (the block happened below it) and
    # released its concurrency on the blocked calls too
    assert si[0] == 5 and sm[0] == 2 and sm[1] == 3 and si[4] == sm[4] == 0


def test_interface_rule_blocks_before_method(make):
    def run(side, c):
        c.flow_rules.load([side["st"].FlowRule(resource=IFACE, count=1.0)])
        out = []
        for _ in range(3):
            try:
                side["RPC"].provider_call(IFACE, METHOD, lambda: "ok", client=c)
                out.append("pass")
            except side["st"].BlockException:
                out.append("block")
        return out, _stats(c, METHOD)

    out, sm = _both(make, run)
    assert out == ["pass", "block", "block"] and sm[0] == 1 and sm[1] == 0  # never reached


def test_provider_exception_traces_both(make):
    def run(side, c):
        with pytest.raises(ValueError):
            side["RPC"].provider_call(IFACE, METHOD, lambda: (_ for _ in ()).throw(ValueError("x")), client=c)
        return _stats(c, IFACE)[3], _stats(c, METHOD)[3]

    assert _both(make, run) == (1, 1)


def test_consumer_chain(make):
    def run(side, c):
        r = side["RPC"].consumer_call(IFACE, METHOD, lambda: 42, client=c)
        with side["RPC"].consumer_entry(IFACE, METHOD, client=c):
            pass
        return r, _stats(c, IFACE)[0], _stats(c, METHOD)[0]

    assert _both(make, run) == (42, 2, 2)


# -- streaming --------------------------------------------------------------


async def _numbers(n, fail_at=None):
    for i in range(n):
        if fail_at is not None and i == fail_at:
            raise RuntimeError("mid-stream")
        yield i


def test_stream_entry_on_subscribe_exit_on_complete(make):
    def run(side, c):
        async def main():
            stream = side["STR"].guard_stream("stream-res", _numbers(4), client=c)
            lazy = c.stats.resource("stream-res") is None  # assembly does not acquire
            return lazy, [x async for x in stream]

        lazy, got = asyncio.run(main())
        return lazy, got, _stats(c, "stream-res")

    lazy, got, s = _both(make, run)
    assert lazy and got == [0, 1, 2, 3] and s[0] == 1 and s[2] == 1 and s[4] == 0


def test_stream_error_traces_exception(make):
    def run(side, c):
        async def main():
            got = []
            with pytest.raises(RuntimeError):
                async for x in side["STR"].guard_stream("stream-err", _numbers(5, fail_at=2), client=c):
                    got.append(x)
            return got

        return asyncio.run(main()), _stats(c, "stream-err")

    got, s = _both(make, run)
    assert got == [0, 1] and s[0] == 1 and s[3] == 1 and s[4] == 0


def test_stream_block_surfaces_at_first_pull(make):
    def run(side, c):
        c.flow_rules.load([side["st"].FlowRule(resource="stream-lim", count=1.0)])

        async def main():
            ok = [x async for x in side["STR"].guard_stream("stream-lim", _numbers(2), client=c)]
            with pytest.raises(side["st"].BlockException):
                async for _ in side["STR"].guard_stream("stream-lim", _numbers(2), client=c):
                    pass
            return ok

        return asyncio.run(main()), _stats(c, "stream-lim")

    ok, s = _both(make, run)
    assert ok == [0, 1] and s[0] == 1 and s[1] == 1 and s[4] == 0


def test_stream_early_break_releases_entry(make):
    """The consumer breaks mid-stream (the subscriber's cancel): the entry
    releases its concurrency slot WITHOUT error accounting."""

    def run(side, c):
        async def main():
            got = []
            async for x in side["STR"].guard_stream("stream-brk", _numbers(100), client=c):
                got.append(x)
                if x == 1:
                    break
            gc.collect()  # a deterministic aclose on any runtime
            await asyncio.sleep(0)
            return got

        return asyncio.run(main()), _stats(c, "stream-brk")

    got, s = _both(make, run)
    assert got == [0, 1] and s[4] == 0 and s[3] == 0 and s[2] == 1


def test_guard_aiter_decorator_and_awaitable(make):
    def run(side, c):
        @side["STR"].guard_aiter("gen-res", client=c)
        async def gen():
            yield "a"
            yield "b"

        async def one():
            return 7

        async def main():
            return [x async for x in gen()], await side["STR"].guard_awaitable("mono-res", one(), client=c)

        items, r = asyncio.run(main())
        return items, r, _stats(c, "gen-res")[2], _stats(c, "mono-res")[2]

    assert _both(make, run) == (["a", "b"], 7, 1, 1)


# -- the workload plane's adapter drivers ------------------------------------------


def _spec(wl, seed=7, steps=24, base=1.5, start=8, prefix=None, n_keys=4):
    keys = wl.ZipfKeys(n_keys=n_keys, alpha=1.2, prefix=prefix) if prefix else None
    return wl.flash_crowd_2x(seed=seed, base=base, steps=steps, step_ms=10, start_step=start, keys=keys)


def _counts(res):
    return res.submitted, res.passed, res.blocked


def test_gateway_flash_crowd_verdicts_and_timeline(make, tmp_path):
    def run(side, _c):
        log_dir = tmp_path / ("ref" if side is REF else "port")
        c = make(side, timeline_log=side["TL"].MetricLog(str(log_dir)))
        gw = side["GW"].GatewayAdapter(c)
        gw.rules.load_rules([side["GW"].GatewayFlowRule(resource="wl-route", count=20)])
        spec = _spec(side["WL"])
        n_events = len(side["WL"].TrafficGenerator(spec).all_events())
        res = side["WL"].drive_gateway(gw, side["WL"].TrafficGenerator(spec))
        threads = _stats(c, "wl-route")[4]
        c.stop()  # the final timeline flush
        rows = side["TL"].MetricLog(str(log_dir)).find("wl-route", 0, BIG)
        return n_events, _counts(res), threads, sum(r.pass_count for r in rows), sum(r.block_count for r in rows)

    n_events, (sub, passed, blocked), threads, row_pass, row_block = _both(make, run)
    assert sub == n_events > 0 and passed + blocked == sub and passed > 0 and blocked > 0
    assert threads == 0 and (row_pass, row_block) == (passed, blocked)


def test_streaming_flash_crowd_verdicts_and_timeline(make, tmp_path):
    def run(side, _c):
        log_dir = tmp_path / ("ref" if side is REF else "port")
        c = make(side, timeline_log=side["TL"].MetricLog(str(log_dir)))
        c.flow_rules.load([side["st"].FlowRule(resource="wl/s0", count=2)])
        spec = _spec(side["WL"], seed=9, steps=20, prefix="wl/s")
        events = side["WL"].TrafficGenerator(spec).all_events()
        res = side["WL"].drive_streaming(c, side["WL"].TrafficGenerator(spec))
        c.stop()
        cold = side["TL"].MetricLog(str(log_dir))
        keys = sorted({ev.key for ev in events})
        rows = {k: cold.find(k, 0, BIG) for k in keys}
        return (len(events), sum(1 for ev in events if ev.key == "wl/s0"), _counts(res),
                sum(r.pass_count for k in keys for r in rows[k]), sum(r.block_count for k in keys for r in rows[k]),
                sum(r.block_count for r in rows["wl/s0"]))

    n, offered_s0, (sub, passed, blocked), row_pass, row_block, s0_block = _both(make, run)
    assert sub == n > 0 and passed + blocked == sub
    assert offered_s0 > 2 and blocked == offered_s0 - 2  # only wl/s0 carries a rule
    assert (row_pass, row_block, s0_block) == (passed, blocked, blocked)


def test_asgi_driver_accounts_verdicts(make):
    def run(side, c):
        mw = side["A"].SentinelASGIMiddleware(_asgi_app, client=c)
        c.flow_rules.load([side["st"].FlowRule(resource="GET:/wl/a0", count=3)])
        spec = _spec(side["WL"], seed=3, steps=12, prefix="wl/a", n_keys=2)
        events = side["WL"].TrafficGenerator(spec).all_events()
        res = side["WL"].drive_asgi(mw, side["WL"].TrafficGenerator(spec))
        return len(events), sum(1 for ev in events if ev.key == "wl/a0"), _counts(res)

    n, offered_a0, (sub, passed, blocked) = _both(make, run)
    assert sub == n > 0 and passed + blocked == sub and blocked == max(0, offered_a0 - 3) > 0


def test_grpc_driver_accounts_verdicts(make):
    pytest.importorskip("grpc")

    def run(side, c):
        c.flow_rules.load([side["st"].FlowRule(resource="/wl/g0", count=3)])
        spec = _spec(side["WL"], seed=4, steps=12, prefix="wl/g", n_keys=2)
        events = side["WL"].TrafficGenerator(spec).all_events()
        res = side["WL"].drive_grpc(c, side["WL"].TrafficGenerator(spec))
        return len(events), sum(1 for ev in events if ev.key == "wl/g0"), _counts(res)

    n, offered_g0, (sub, passed, blocked) = _both(make, run)
    assert sub == n > 0 and passed + blocked == sub and blocked == max(0, offered_g0 - 3) > 0


# -- the slice: drive_gateway under platform_config() -------------------------------

#: platform_config()'s flags and the small config's widths
SMALL = dict(max_resources=64, max_nodes=128, max_flow_rules=64, max_degrade_rules=32, max_param_rules=8,
             batch_size=64, complete_batch_size=64, param_width=512)
PLATFORM_FLAGS = dict(use_mxu_tables=True, fused_effects=True, seg_effects=True, seg_fallback=True)


class _Recording:
    """A GatewayAdapter seen by ``drive_gateway``: every request's
    verdict, in order (True passed, else the block's exception name)."""

    def __init__(self, adapter, errors):
        self._a, self._errors = adapter, errors
        self.client = adapter.client
        self.verdicts = []

    def entries_for(self, route_id, req):
        try:
            entries = self._a.entries_for(route_id, req)
        except self._errors.BlockException as be:
            self.verdicts.append(type(be).__name__)
            raise
        self.verdicts.append(True)
        return entries


def gateway_setup(side, c, gw_mod):
    """The slice's gateway: route rules (a header-keyed limit, a URL-param
    limit matching the hot values, a route-wide limit), an API group over
    every path with a client-IP limit, and a flow rule on the route."""
    g = gw_mod.GatewayAdapter(c)
    g.apis.load([gw_mod.ApiDefinition("wl-api", [gw_mod.ApiPredicateItem("/", gw_mod.URL_MATCH_STRATEGY_PREFIX)])])
    g.rules.load_rules([
        gw_mod.GatewayFlowRule(resource="wl-route", count=4, param_item=gw_mod.GatewayParamFlowItem(
            gw_mod.PARAM_PARSE_STRATEGY_HEADER, field_name="X-Wl-Param")),
        gw_mod.GatewayFlowRule(resource="wl-route", count=6, param_item=gw_mod.GatewayParamFlowItem(
            gw_mod.PARAM_PARSE_STRATEGY_URL_PARAM, field_name="p", pattern="hot",
            match_strategy=gw_mod.PARAM_MATCH_STRATEGY_PREFIX)),
        gw_mod.GatewayFlowRule(resource="wl-api", count=25, param_item=gw_mod.GatewayParamFlowItem(
            gw_mod.PARAM_PARSE_STRATEGY_CLIENT_IP)),
    ])
    c.flow_rules.load([side["st"].FlowRule(resource="wl-route", count=40)])
    return g


def slice_spec(wl, seed=7, steps=60):
    """A sustained rate with a hot-parameter flood and a flash crowd over
    eight keys (the drivers' traffic)."""
    return wl.WorkloadSpec(seed=seed, steps=steps, step_ms=10, shapes=(
        wl.Constant(rate=3.0, name="base"),
        wl.HotParamFlood(rate=6.0, start_step=10, duration_steps=30),
        wl.FlashCrowd(peak=4.0, start_step=20, ramp_steps=5, hold_steps=15, decay_steps=5),
    ), keys=wl.ZipfKeys(n_keys=8, alpha=1.2))


def test_drive_gateway_under_platform_config_equals_the_reference(monkeypatch):
    import sentinel_tpu.core.errors as JERR

    import sentinel_tpu_torch.core.errors as ERR

    jc = jax_host_client(monkeypatch, jax_small_cfg(**PLATFORM_FLAGS), JVT(1_000))
    tc = SentinelClient(cfg=platform_config(**SMALL), time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    jc.start()
    tc.start()
    try:
        out = {}
        for name, side, c, errors in (("ref", REF, jc, JERR), ("port", PORT, tc, ERR)):
            rec = _Recording(gateway_setup(side, c, side["GW"]), errors)
            res = side["WL"].drive_gateway(rec, side["WL"].TrafficGenerator(slice_spec(side["WL"])))
            lanes = [c.param_lane("wl-route", i) for i in range(2)] + [c.param_lane("wl-api", 0)]
            out[name] = (_counts(res), rec.verdicts, lanes, _stats(c, "wl-route"), _stats(c, "wl-api"))
    finally:
        jc.stop()
        tc.stop()
    assert _close(out["port"], out["ref"])
    (sub, passed, blocked), verdicts, lanes, route, api = out["port"]
    assert sub == len(verdicts) > 0 and passed + blocked == sub
    assert passed == verdicts.count(True) and lanes == [0, 1, 0]
    assert {"ParamFlowException", "FlowException"} & set(verdicts) and passed > 0
    assert route[4] == api[4] == 0  # every entry exited
