"""The port's command plane (transport/command, handlers, writable_registry,
http_server, heartbeat; utils/authn, utils/record_log) against the JAX
package's.

Both clients run in mode="sync" on one virtual clock each and take the
same scripted stream; then every command of ``build_default_handlers``
is asked of both, and the JSON responses must be equal, leaving out only
the process id (``basicInfo``) and the host's load / CPU samples
(``systemStatus``, pinned to one value on both).  ``metrics`` and
``api/traces`` serve each package's own process-global registry and
tracer, so they are held to their shape only.  ``metrics?fleet=1``,
``api/profile``, ``api/memory`` and ``api/shards``, which once answered a
failure naming their ROADMAP.md item, now answer from the port's fleet
view, profiling plane and sharded token clients; ``api/shards`` is held
to the reference's JSON over a one-shard fleet of each package, ports
aside.  Then over a real loopback socket: the HTTP command center (GET,
form POST, JSON POST, bearer auth, 400 on a failure) and the heartbeat
against a local receiver.

Tolerances: integers and strings equal, floats within rtol 1e-6 and
atol 1e-4 (tests/test_torch_stats.assert_close).
"""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu import metrics as JM
from sentinel_tpu import transport as JT
from sentinel_tpu.datasource.base import FileWritableDataSource as JWritable
from sentinel_tpu.datasource.converters import json_rule_encoder as jencode
from sentinel_tpu.transport.command import CommandRequest as JReq

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import metrics as TM
from sentinel_tpu_torch import transport as TT
from sentinel_tpu_torch.datasource.base import FileWritableDataSource as TWritable
from sentinel_tpu_torch.datasource.converters import json_rule_encoder as tencode
from sentinel_tpu_torch.transport.command import CommandRequest as TReq
from sentinel_tpu_torch.utils import authn
from tests.test_torch_stats import _pair, assert_close

WALL_EPOCH_MS = 1_700_000_000_000

#: the commands whose backing modules were once not ported: command, params,
#: and the ROADMAP item it waited for (None: ported since, with obs/fleet,
#: obs/profile and cluster/shard)
UNPORTED = [
    ("metrics", {"fleet": "1"}, None),
    ("api/profile", {"ms": "10"}, None),
    ("api/memory", {}, None),
    ("api/shards", {}, None),
]


def _one_shard_fleets():
    """(port fleet, reference fleet, stop): one shard each, on a sync
    decision client on virtual time (the port's on the CPU)."""
    import numpy as np

    from sentinel_tpu.cluster.shard import ShardFleet as JFleet
    from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
    from sentinel_tpu.runtime.client import SentinelClient as JaxClient
    from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT
    from sentinel_tpu_torch.cluster.shard import ShardFleet
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    made = []

    def port_client():
        c = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                           device="cpu")
        c.start()
        made.append(c)
        return c

    def ref_client():
        c = JaxClient(cfg=jax_small_cfg(), time_source=JVT(1_000), mode="sync")
        upload = c._dev_col  # a private copy per upload (ROADMAP.md Queue C: jnp.asarray may alias)
        c._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
        c.start()
        made.append(c)
        return c

    kw = dict(n_shards=1, retry_interval_s=300.0, timeout_ms=5000, reconnect_interval_s=0.0)
    fleets = [ShardFleet(port_client, **kw), JFleet(ref_client, **kw)]

    def stop():
        for f in fleets:
            f.stop()
            for svc in f.services.values():
                svc.close()
        for c in made:
            c.stop()

    return fleets[0], fleets[1], stop


def _fleet_json(answer, fleet):
    """The fleet's entry of an api/shards answer, its ports aside."""
    addr = f"127.0.0.1:{fleet._ports['shard-0']}"
    ours = [d for d in answer if [s["addr"] for s in d["shards"]] == [addr]]
    return [dict(d, shards=[dict(s, addr="127.0.0.1") for s in d["shards"]]) for d in ours]


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CSP_SENTINEL_LOG_DIR", str(tmp_path / "logs"))


def _script(c, m):
    c.time.wall_epoch_ms = WALL_EPOCH_MS
    c._sys.sample = lambda: (0.25, 0.5)  # the host's load / CPU: pinned on both
    c.flow_rules.load([m.FlowRule(resource="api", count=3), m.FlowRule(resource="slow", count=50)])
    c.authority_rules.load([m.AuthorityRule(resource="api", limit_app="bad", strategy=m.AUTHORITY_BLACK)])
    c.param_flow_rules.load([m.ParamFlowRule(resource="slow", count=100, param_idx=0)])
    rng = np.random.default_rng(5)
    held = []
    for i in range(40):
        name = ("api", "slow", "free")[i % 3]
        origin = ("good", "bad", None)[int(rng.integers(3))]
        try:
            with c.context("gw", origin or ""):
                e = c.entry(name, args=[f"u{int(rng.integers(6))}"], inbound=True, origin=origin)
        except m.BlockException:
            e = None
        if e is not None:
            if i % 7 == 0:
                held.append(e)
            else:
                c.time.advance(int(rng.integers(1, 20)))
                e.exit()
        c.time.advance(int(rng.integers(1, 15)))
    c.tick_once()
    return held


def _ask(registry, Req, name, **params):
    rsp = registry.handle(name, Req(parameters={k: str(v) for k, v in params.items()}))
    return rsp.success, rsp.result


def _all_commands(registry, Req):
    """Every command and a few of their variants, as (ok, result) pairs."""
    out = {}
    for name, params in [
        ("version", {}), ("basicInfo", {}), ("api", {}), ("nope", {}),
        ("getRules", {"type": "flow"}), ("getRules", {"type": "authority"}), ("getRules", {"type": "bogus"}),
        ("getParamFlowRules", {}), ("topParams", {"id": "slow", "n": 3}), ("topParams", {"id": "absent"}),
        ("topParams", {}), ("clusterNode", {}), ("origin", {"id": "api"}), ("origin", {}),
        ("jsonTree", {}), ("rtQuantiles", {}), ("rtQuantiles", {"q": "0.5,0.999"}), ("systemStatus", {}),
        ("getSwitch", {}), ("setSwitch", {"value": "maybe"}), ("getClusterMode", {}),
        ("setClusterMode", {"mode": 1}), ("clusterServerInfo", {}), ("api/metric", {}), ("api/explain", {}),
        ("metric", {"startTime": 0}), ("metric", {"startTime": 0, "identity": "api"}),
        ("metric", {"startTime": 0, "identity": "absent"}), ("metric", {"startTime": 0, "maxLines": 1}),
    ]:
        ok, res = _ask(registry, Req, name, **params)
        if name == "basicInfo":
            res = {k: v for k, v in res.items() if k != "pid"}
        out[name + "?" + urllib.parse.urlencode(params)] = (ok, res)
    return out


def test_every_handler_answers_as_the_reference(tmp_path):
    jc, tc = _pair()
    try:
        got = []
        for c, m, T, M, Req, Writable, enc, d in (
            (jc, jst, JT, JM, JReq, JWritable, jencode, tmp_path / "jax"),
            (tc, tst, TT, TM, TReq, TWritable, tencode, tmp_path / "torch"),
        ):
            held = _script(c, m)
            timer = M.MetricTimerListener(c, M.MetricWriter(str(d), "tapp"))
            timer.run_once()
            timer.writer.close()
            wreg = T.WritableDataSourceRegistry()
            wreg.register("flow", Writable(str(d / "flow.json"), enc))
            reg = T.build_default_handlers(c, metric_searcher=M.MetricSearcher(str(d), "tapp"),
                                           writable_registry=wreg)
            before = _all_commands(reg, Req)
            data = json.dumps([{"resource": "api", "count": 0}, {"resource": "new", "count": 7}])
            pushed = [_ask(reg, Req, "setRules", type="flow", data=data),
                      _ask(reg, Req, "setRules", type="bogus", data=data)]
            blocked = c.try_entry("api") is None
            switched = [_ask(reg, Req, "setSwitch", value="false"), _ask(reg, Req, "getSwitch")]
            passthrough = c.try_entry("api") is not None
            switched.append(_ask(reg, Req, "setSwitch", value="true"))
            c.time.advance(300)
            after = _all_commands(reg, Req)
            for e in held:
                e.exit()
            got.append(dict(before=before, pushed=pushed, blocked=blocked, switched=switched,
                            passthrough=passthrough, after=after, written=(d / "flow.json").read_text()))
    finally:
        jc.stop()
        tc.stop()
    want, have = got
    assert_close(have, want)
    b = want["before"]
    assert b["clusterNode?"][0] and len(b["clusterNode?"][1]) == 3
    assert b["origin?id=api"][1] and b["topParams?id=slow&n=3"][1]
    assert "|api|" in b["metric?startTime=0"][1]
    assert want["blocked"] and want["passthrough"] and not b["nope?"][0]
    assert [n["name"] for n in b["api?"][1]] == sorted(n["name"] for n in b["api?"][1])


@pytest.mark.parametrize("name,params,item", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_handlers_answer_a_failure_naming_their_item(name, params, item):
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient

    c = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True), mode="sync", device="cpu")
    reg = TT.build_default_handlers(c)
    if name == "api/shards":
        fleet, jfleet, stop = _one_shard_fleets()
        try:
            fleet.load_flow_rules("default", [tst.FlowRule(resource="r", count=5, cluster_mode=True,
                                                           cluster_flow_id=101, cluster_threshold_type=1)])
            jfleet.load_flow_rules("default", [jst.FlowRule(resource="r", count=5, cluster_mode=True,
                                                            cluster_flow_id=101, cluster_threshold_type=1)])
            fleet.client.request_token(101)
            jfleet.client.request_token(101)
            ok, msg = _ask(reg, TReq, name, **params)
            jok, jmsg = _ask(JT.build_default_handlers(jfleet.services["shard-0"].client), JReq, name)
            msg, jmsg = _fleet_json(msg, fleet), _fleet_json(jmsg, jfleet)
        finally:
            stop()
        from sentinel_tpu_torch.cluster.shard import describe_fleets

        assert not [d for d in describe_fleets() if _fleet_json([d], fleet)]  # a stopped fleet drops out
    else:
        ok, msg = _ask(reg, TReq, name, **params)
    # ported: the command answers from the port's own plane
    assert item is None and ok
    if name == "metrics":
        assert "sentinel_fleet_members 1" in msg.splitlines()
    elif name == "api/profile":
        assert "chrome_trace" in msg or msg.get("error") == "rate_limited"
    elif name == "api/shards":
        assert jok and msg == jmsg and len(msg) == 1
        assert msg[0]["flows_registered"] == 1 and msg[0]["shards"][0]["leases"] == 1
    else:
        assert "pools" in msg and msg["live_array_bytes"] is None  # no allocator stats on the CPU
    # and the command is listed, as the reference lists it
    assert name in {n["name"] for n in _ask(reg, TReq, "api")[1]}


def test_metrics_and_traces_serve_the_ports_own_planes():
    from sentinel_tpu_torch import obs
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient

    c = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True), mode="sync", device="cpu")
    reg = TT.build_default_handlers(c)
    c.entry("m").exit()
    ok, text = _ask(reg, TReq, "metrics")
    assert ok and "sentinel_build_info{" in text and 'sentinel_version="0.1.0"' in text
    assert "sentinel_scrape_id{" in text and "sentinel_tick_dispatch_ms" in text
    try:
        ok, trace = _ask(reg, TReq, "api/traces", enable="true")
        assert ok and obs.enabled() and "traceEvents" in trace
        assert _ask(reg, TReq, "api/traces", enable="false")[0] and not obs.enabled()
    finally:
        obs.disable()


def _get(url, token=None):
    req = urllib.request.Request(url, headers=authn.bearer_header(token))
    with urllib.request.urlopen(req, timeout=5) as rsp:
        return rsp.status, rsp.headers.get("Content-Type"), rsp.read()


def test_http_command_center_over_loopback():
    """start_command_center on 127.0.0.1 (a free port): JSON and text
    answers, a form-encoded POST (the dashboard's push), a JSON body POST,
    400 on a failure; then with a bearer token, 401 without it."""
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient

    c = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True), mode="sync", device="cpu")
    center = TT.start_command_center(c, port=0)
    try:
        assert center.host == "127.0.0.1" and center.port
        base = f"http://127.0.0.1:{center.port}"
        status, ctype, body = _get(f"{base}/basicInfo")
        assert status == 200 and ctype.startswith("application/json")
        assert json.loads(body)["appName"] == c.app_name
        assert _get(f"{base}/version")[2] == b"0.1.0"
        form = urllib.parse.urlencode({"type": "flow", "data": json.dumps([{"resource": "h", "count": 3}])})
        req = urllib.request.Request(f"{base}/setRules", data=form.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=5) as rsp:
            assert rsp.read() == b"success"
        assert c.flow_rules.get()[0].resource == "h"
        req = urllib.request.Request(f"{base}/setRules?type=degrade", method="POST",
                                     data=json.dumps([{"resource": "h", "count": 5, "grade": 2}]).encode())
        with urllib.request.urlopen(req, timeout=5) as rsp:
            assert rsp.read() == b"success"
        assert c.degrade_rules.get()[0].count == 5
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/bogus")
        assert ei.value.code == 400 and b"bogus" in ei.value.read()
        from sentinel_tpu_torch.cluster.shard import describe_fleets

        status, ctype, body = _get(f"{base}/api/shards")  # answered since the sharded cluster came
        assert status == 200 and ctype.startswith("application/json")
        assert json.loads(body) == json.loads(json.dumps(describe_fleets()))
    finally:
        center.stop()
    secured = TT.SimpleHttpCommandCenter(TT.build_default_handlers(c), port=0, auth_token="s3cret")
    secured.start()
    try:
        base = f"http://127.0.0.1:{secured.port}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/getSwitch")
        assert ei.value.code == 401
        assert json.loads(_get(f"{base}/getSwitch", token="s3cret")[2]) == {"enabled": True}
    finally:
        secured.stop()
    assert authn.normalize_token("  ") is None and authn.check_bearer(None, "")


def test_heartbeat_reaches_a_local_receiver():
    """HeartbeatSender.send_once posts /registry/machine with the app,
    the loopback address a loopback-bound center advertises, its port and
    the port's version; a dead address rotates and counts a failure."""
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient

    seen = []

    class Recv(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            seen.append((self.path, self.headers.get("X-Sentinel-Heartbeat"),
                         self.headers.get("Authorization"), self.rfile.read(n).decode()))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Recv)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    c = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True), mode="sync", device="cpu", app_name="hb-app")
    center = TT.start_command_center(c, port=0)
    dead = ThreadingHTTPServer(("127.0.0.1", 0), Recv)
    dead_port = dead.server_address[1]
    dead.server_close()  # nothing listens there any more
    try:
        hb = TT.HeartbeatSender(c.app_name, dashboard_addresses=[f"127.0.0.1:{srv.server_address[1]}",
                                                                 f"127.0.0.1:{dead_port}"],
                                center=center, auth_token="tok")
        assert hb.send_once()
        path, marker, auth, body = seen[0]
        params = dict(urllib.parse.parse_qsl(body))
        assert path == "/registry/machine" and marker == "1" and auth == "Bearer tok"
        assert params["app"] == "hb-app" and params["ip"] == "127.0.0.1"
        assert params["port"] == str(center.port) and params["version"] == "0.1.0"
        hb._idx = 1
        assert not hb.send_once(timeout_s=1.0)
        assert (hb.sent_ok, hb.sent_fail, hb._idx) == (1, 1, 2)
    finally:
        center.stop()
        srv.shutdown()
        srv.server_close()
