"""The port's dashboard (``sentinel_tpu_torch.dashboard``) against the JAX
package's.

- The host modules alone, on the same inputs: the repository (merge,
  retention, top-N, per-machine timelines merged through
  ``obs/fleet.merge_timelines``), discovery (health by wall clock,
  ``remove_stale``) and the fetcher's catch-up window, Prometheus scrape
  and its two self-observability series, against a fake machine API.
- The UI page, byte for byte.
- Over real loopback HTTP: a JAX client and a port client (sync mode, one
  virtual clock each, the same wall epoch) behind their own command
  centers, each heartbeating into BOTH dashboards.  Every REST route of
  the port's dashboard answers the JSON the reference's answers over the
  same machines, so each dashboard reads the other package's command
  center as its own; and the port machine's data equals the JAX
  machine's.  Rule CRUD for the five rule types goes through each
  dashboard to each machine (both directions): the rules read back and
  the verdicts after each publish are equal.
- The bearer token, answered code for code as the reference answers it.
- ``/cluster/assign`` over two port machines (tests/test_cluster_assign.py
  as the model): one becomes the token server, the other its client, and
  the client's token requests are decided by the assigned server.

Tolerances: JSON, integers and strings equal; floats within rtol 1e-6
and atol 1e-4 (tests/test_torch_stats.assert_close).
"""

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu import dashboard as JD
from sentinel_tpu import metrics as JM
from sentinel_tpu import transport as JT
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.dashboard import metric_fetcher as JMF
from sentinel_tpu.dashboard import ui as JUI
from sentinel_tpu.metrics.node import MetricNode as JNode
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import dashboard as TD
from sentinel_tpu_torch import metrics as TM
from sentinel_tpu_torch import transport as TT
from sentinel_tpu_torch.cluster import constants as CC
from sentinel_tpu_torch.cluster import state as CS
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.dashboard import metric_fetcher as TMF
from sentinel_tpu_torch.dashboard import ui as TUI
from sentinel_tpu_torch.metrics.node import MetricNode as TNode
from sentinel_tpu_torch.obs.registry import REGISTRY as TREG
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.test_torch_stats import assert_close

WALL_EPOCH_MS = 1_700_000_000_000
T0 = 1_700_000_000_000


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CSP_SENTINEL_LOG_DIR", str(tmp_path / "logs"))


# -- the host modules alone ------------------------------------------------


def _nodes(Node, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        out.append(Node(
            timestamp=T0 + 1000 * int(rng.integers(0, 30)), resource=f"r{int(rng.integers(0, 6))}",
            pass_qps=int(rng.integers(0, 50)), block_qps=int(rng.integers(0, 9)),
            success_qps=int(rng.integers(0, 40)), exception_qps=int(rng.integers(0, 3)),
            rt=float(rng.integers(1, 80)) / 8.0, occupied_pass_qps=int(rng.integers(0, 2)),
            concurrency=int(rng.integers(0, 5)),
        ))
    return out


def _timeline_rows(seed, machine):
    rng = np.random.default_rng(seed)
    return [
        dict(ts=T0 + 1000 * s, resource=f"r{k}", **{"pass": int(rng.integers(0, 20))},
             block=int(rng.integers(0, 4)), success=int(rng.integers(0, 20)), exception=0,
             rt_sum=float(rng.integers(0, 90)), rt_min=float(rng.integers(1, 9)), concurrency=machine)
        for s in range(6) for k in range(3)
    ]


def _repo_views(D, Node):
    repo = D.InMemoryMetricsRepository(retention_ms=20_000)
    for seed in (1, 2, 3):  # three machines of one app, some seconds shared
        repo.save_all("app", _nodes(Node, seed))
    repo.save_all("other", _nodes(Node, 4))
    for m in (0, 1):
        repo.save_timeline("app", f"10.0.0.{m}:8719", _timeline_rows(5 + m, m))
    return dict(
        query={r: [vars(n) for n in repo.query("app", r, 0, 2**62)] for r in repo.resources_of("app")},
        window=[vars(n) for n in repo.query("app", "r1", T0 + 12_000, T0 + 20_000)],
        top=[repo.top_resources(a, 0, 2**62, limit) for a in ("app", "other", "none") for limit in (2, 30)],
        resources=repo.resources_of("app"),
        timeline={r: repo.query_timeline("app", r, T0 + 1000, T0 + 4000) for r in ("r0", "r2", "absent")},
        machines=repo.timeline_machines("app"),
    )


def test_repository_equals_the_reference():
    want, got = _repo_views(JD, JNode), _repo_views(TD, TNode)
    assert_close(got, want)
    assert want["timeline"]["r0"] and want["top"][0]


def _discovery_views(D, monkeypatch, mod):
    clock = [1000.0]
    monkeypatch.setattr(mod, "wall_s", lambda: clock[0])
    d = D.AppManagement(stale_after_s=5.0)

    def beat(**kw):  # a heartbeat now, on the patched clock
        d.register(D.MachineInfo(last_heartbeat=clock[0], **kw))

    beat(app="a", ip="1.2.3.4", port=8719)
    beat(app="a", ip="1.2.3.4", port=8719, pid=42, hostname="h", version="v")  # upsert
    beat(app="b", ip="5.6.7.8", port=8719)
    clock[0] += 3.0
    beat(app="a", ip="1.2.3.5", port=8720)
    views = [d.apps(), [m.to_json() for a in d.apps() for m in d.machines(a)]]
    clock[0] += 3.0
    views += [[m.key for m in d.machines("a", only_healthy=True)], d.get_machine("a", "1.2.3.4", 8719).to_json(),
              d.get_machine("a", "9.9.9.9", 1), d.remove_stale(older_than_s=4.0), d.apps(),
              [m.to_json() for a in d.apps() for m in d.machines(a)]]
    return views


def test_discovery_equals_the_reference(monkeypatch):
    from sentinel_tpu.dashboard import discovery as JDisc
    from sentinel_tpu_torch.dashboard import discovery as TDisc

    want = _discovery_views(JD, monkeypatch, JDisc)
    got = _discovery_views(TD, monkeypatch, TDisc)
    assert got == want
    assert want[5] == 2  # the two silent machines went


class _FakeApi:
    """A stand-in machine command plane: canned metric lines, timeline rows
    and exposition text; port 666 is down."""

    def __init__(self, Node):
        self.calls = []
        self.nodes = _nodes(Node, 9)

    def fetch_metric(self, ip, port, start_ms, end_ms):
        self.calls.append(("metric", port, start_ms, end_ms))
        if port == 666:
            raise OSError("down")
        return [n for n in self.nodes if start_ms <= n.timestamp <= end_ms]

    def fetch_timeline(self, ip, port, resource, start_ms, end_ms):
        self.calls.append(("timeline", port, resource, start_ms, end_ms))
        if port == 666:
            raise OSError("down")
        return _timeline_rows(port, 1)

    def fetch_prometheus(self, ip, port):
        self.calls.append(("prom", port))
        if port == 666:
            raise OSError("down")
        return f"sentinel_pipeline_occupancy {port}\n"


def _fetcher_views(D, Node, MF):
    d = D.AppManagement()
    for port in (1, 2, 666):
        d.register(D.MachineInfo(app="app", ip="127.0.0.1", port=port))
    repo = D.InMemoryMetricsRepository()
    api = _FakeApi(Node)
    f = D.MetricFetcher(d, repo, api=api, max_catchup_ms=15_000)
    ok0, err0 = MF._C_FETCH_OK.value, MF._C_FETCH_ERR.value
    saved = [f.fetch_once(T0 + 20_500), f.fetch_once(T0 + 26_000), f.fetch_once(T0 + 26_900),
             f.fetch_timelines("r1", T0, T0 + 9000), f.fetch_timelines(app="none")]
    prom = f.scrape_prometheus("app")
    return dict(
        saved=saved, calls=api.calls, prom=prom, fetched=(f.fetch_ok, f.fetch_fail),
        series=(MF._C_FETCH_OK.value - ok0, MF._C_FETCH_ERR.value - err0),
        repo={r: [vars(n) for n in repo.query("app", r, 0, 2**62)] for r in repo.resources_of("app")},
        timeline=repo.query_timeline("app", "r1", 0, 2**62), last=dict(f._last_fetched_ms),
    )


def test_fetcher_and_its_series_equal_the_reference():
    """The catch-up window (clamped to 15 s before the last full second,
    then resumed after the newest fetched second), the timeline sweep, the
    scrape, and ``sentinel_dashboard_fetch_total{result}`` /
    ``sentinel_dashboard_last_success_ms``, registered in the port's own
    registry."""
    want = _fetcher_views(JD, JNode, JMF)
    t_before = time.time() * 1000.0
    got = _fetcher_views(TD, TNode, TMF)
    assert_close(got, want)
    assert want["saved"][0] > 0 and want["fetched"][1] > 0 and want["series"] == want["fetched"]
    ok = TREG.get("sentinel_dashboard_fetch_total", {"result": "ok"})
    assert ok is TMF._C_FETCH_OK and TREG.get("sentinel_dashboard_fetch_total", {"result": "error"}) is TMF._C_FETCH_ERR
    assert TREG.get("sentinel_dashboard_last_success_ms").value >= t_before - 1.0


def test_the_ui_page_is_the_reference_byte_for_byte():
    assert TUI.PAGE.encode("utf-8") == JUI.PAGE.encode("utf-8")
    got = []
    for D in (JD, TD):
        dash = D.DashboardServer(host="127.0.0.1", port=0, fetch_metrics=False, auth_token="tok")
        dash.start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{dash.port}/", timeout=5) as rsp:
                got.append((rsp.status, rsp.headers["Content-Type"], rsp.read()))
        finally:
            dash.stop()
    assert got[1] == got[0] and got[0][2] == JUI.PAGE.encode("utf-8")


def _codes(D):
    """The reference's auth sequence: every route needs the token, the
    registry also the heartbeat header."""
    dash = D.DashboardServer(host="127.0.0.1", port=0, fetch_metrics=False, auth_token="s3cret")
    dash.start()
    base = f"http://127.0.0.1:{dash.port}"
    hb = urllib.parse.urlencode({"app": "a", "ip": "1.1.1.1", "port": "8719"}).encode()
    out = []
    try:
        for path, data, headers in [
            ("/apps", None, {}), ("/apps", None, {"Authorization": "Bearer s3cret"}),
            ("/apps", None, {"Authorization": "Bearer wrong"}),
            ("/registry/machine", hb, {}), ("/registry/machine", hb, {"Authorization": "Bearer s3cret"}),
            ("/registry/machine", hb, {"Authorization": "Bearer s3cret", "X-Sentinel-Heartbeat": "1"}),
            ("/apps", None, {"Authorization": "Bearer s3cret"}), ("/nope", None, {"Authorization": "Bearer s3cret"}),
            ("/tree?ip=9.9.9.9&port=1", None, {"Authorization": "Bearer s3cret"}),
        ]:
            req = urllib.request.Request(base + path, data=data, headers=headers, method="POST" if data else "GET")
            try:
                with urllib.request.urlopen(req, timeout=5) as rsp:
                    code, body = rsp.status, json.loads(rsp.read())
            except urllib.error.HTTPError as e:
                code, body = e.code, json.loads(e.read())
            if isinstance(body, dict):
                for m in body.get("a", []):
                    m.pop("lastHeartbeat")
            out.append((code, body))
    finally:
        dash.stop()
    return out


def test_the_auth_token_answers_as_the_reference():
    want, got = _codes(JD), _codes(TD)
    assert got == want
    assert [c for c, _b in want] == [401, 200, 401, 401, 403, 200, 200, 404, 400]


# -- two machines behind real command centers ------------------------------


def _start_machine(c, T, M, d, app):
    c.time.wall_epoch_ms = WALL_EPOCH_MS
    c._sys.sample = lambda: (0.25, 0.5)  # the host's load / CPU: pinned on both
    c.start()
    timer = M.MetricTimerListener(c, M.MetricWriter(str(d), app))
    center = T.SimpleHttpCommandCenter(
        T.build_default_handlers(c, metric_searcher=M.MetricSearcher(str(d), app)), host="127.0.0.1", port=0)
    center.start()
    return timer, center


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A JAX machine ("japp") and a port machine ("tapp"), each heartbeating
    into both dashboards: the reference's and the port's."""
    d = tmp_path_factory.mktemp("dash")
    jc = JaxClient(cfg=jax_small_cfg(), time_source=JaxVT(1_000), mode="sync", app_name="japp")
    upload = jc._dev_col  # a private copy per upload (ROADMAP.md Queue C)
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    tc = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True),
                        time_source=VirtualTimeSource(1_000), mode="sync", device="cpu", app_name="tapp")
    jtimer, jcenter = _start_machine(jc, JT, JM, d / "jax", "japp")
    ttimer, tcenter = _start_machine(tc, TT, TM, d / "torch", "tapp")
    jdash = JD.DashboardServer(host="127.0.0.1", port=0, fetch_metrics=False)
    tdash = TD.DashboardServer(host="127.0.0.1", port=0, fetch_metrics=False)
    jdash.start()
    tdash.start()
    for T, c, center in ((JT, jc, jcenter), (TT, tc, tcenter)):
        for dash in (jdash, tdash):  # one heartbeat into each dashboard
            assert T.HeartbeatSender(c.app_name, dashboard_addresses=[f"127.0.0.1:{dash.port}"],
                                     center=center).send_once()
    w = dict(jc=jc, tc=tc, jtimer=jtimer, ttimer=ttimer, jcenter=jcenter, tcenter=tcenter, jdash=jdash, tdash=tdash)
    yield w
    for x in (jdash, tdash, jcenter, tcenter):
        x.stop()
    jc.stop()
    tc.stop()


def _http(dash, path, data=None, method=None):
    req = urllib.request.Request(f"http://127.0.0.1:{dash.port}{path}", data=data,
                                 method=method or ("POST" if data is not None else "GET"),
                                 headers={"Content-Type": "application/json"} if data is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as rsp:
            return rsp.status, json.loads(rsp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _script(c, m):
    c.flow_rules.load([m.FlowRule(resource="api", count=3), m.FlowRule(resource="slow", count=50)])
    c.authority_rules.load([m.AuthorityRule(resource="api", limit_app="bad", strategy=m.AUTHORITY_BLACK)])
    rng = np.random.default_rng(5)
    for i in range(30):
        origin = ("good", "bad", None)[int(rng.integers(3))]
        e = c.try_entry(("api", "slow", "free")[i % 3], origin=origin, inbound=True)
        c.time.advance(int(rng.integers(1, 15)))
        if e is not None:
            e.exit()
        c.time.advance(int(rng.integers(1, 90)))
    c.tick_once()


def _routes(dash, app, port):
    m = f"ip=127.0.0.1&port={port}"
    out = {}
    for path in ["/apps", f"/metric?app={app}&identity=api", f"/metric?app={app}&identity=slow&startTime=0",
                 f"/metric/top?app={app}", f"/metric/top?app={app}&limit=1", f"/resources?app={app}",
                 f"/rules?{m}&type=flow", f"/rules?{m}&type=authority", f"/rules?{m}&type=degrade",
                 f"/rules?{m}&type=paramFlow", f"/rules?{m}&type=system", f"/cluster/mode?{m}", f"/tree?{m}",
                 f"/explain?{m}", f"/explain?{m}&resource=api&top=3", "/metric", "/tree?ip=9.9.9.9&port=1", "/nope"]:
        code, body = _http(dash, path)
        if path == "/apps":
            for machines in body.values():
                for x in machines:
                    x.pop("lastHeartbeat")
        out[path.replace(app, "APP").replace(str(port), "PORT")] = (code, body)
    return out


def test_rest_routes_answer_the_reference_json_and_interoperate(world):
    w = world
    for c, m in ((w["jc"], jst), (w["tc"], tst)):
        _script(c, m)
    w["jtimer"].run_once()
    w["ttimer"].run_once()
    now = w["tc"].time.wall_ms() + 2000
    assert now == w["jc"].time.wall_ms() + 2000
    saved = [dash.fetcher.fetch_once(now) for dash in (w["jdash"], w["tdash"])]
    assert saved[0] == saved[1] > 0
    views = {}
    for dname in ("jdash", "tdash"):
        for app, center in (("japp", "jcenter"), ("tapp", "tcenter")):
            views[dname, app] = _routes(w[dname], app, w[center].port)
    # each dashboard reads the other package's command center as its own
    assert_close(views["tdash", "japp"], views["jdash", "japp"])
    assert_close(views["jdash", "tapp"], views["tdash", "tapp"])
    # and the port machine answers what the JAX machine answers
    native_t, native_j = dict(views["tdash", "tapp"]), dict(views["jdash", "japp"])
    apps_t, apps_j = native_t.pop("/apps"), native_j.pop("/apps")
    assert_close(native_t, native_j)
    assert apps_t == apps_j and set(apps_j[1]) == {"japp", "tapp"}
    assert native_j["/metric?app=APP&identity=api"][1] and native_j["/metric/top?app=APP"][1]
    assert native_j["/explain?ip=127.0.0.1&port=PORT&resource=api&top=3"][1]["recent"]
    assert [native_j[p][0] for p in ("/metric", "/tree?ip=9.9.9.9&port=1", "/nope")] == [400, 400, 404]


def _save(dash, port, rtype, rules):
    return _http(dash, f"/rules?ip=127.0.0.1&port={port}&type={rtype}", data=json.dumps(rules).encode())


def _load(dash, port, rtype):
    return _http(dash, f"/rules?ip=127.0.0.1&port={port}&type={rtype}")[1]


def _crud(dash, port, c, tag):
    """tests/test_dashboard.py's two rule-manager round trips, merged: each
    publish is read back and its enforcement observed.  ``tag`` names the
    round's resources, so no window or breaker of an earlier round is
    met."""
    vt = c.time
    out = []

    def passes(n, res, **kw):
        return sum(1 for _ in range(n) if c.try_entry(res, **kw))

    out.append(_save(dash, port, "flow", [{"resource": f"{tag}-ui-res", "count": 2, "grade": 1}]))
    out.append(passes(5, f"{tag}-ui-res"))
    vt.advance(1100)
    rules = _load(dash, port, "flow")
    rules[0]["count"] = 3
    out += [rules, _save(dash, port, "flow", rules), passes(5, f"{tag}-ui-res")]
    vt.advance(1100)
    out.append(_save(dash, port, "degrade", [{"resource": f"{tag}-ui-res", "grade": 2, "count": 2, "timeWindow": 10,
                                               "minRequestAmount": 1, "statIntervalMs": 1000}]))
    out.append(_load(dash, port, "degrade"))
    for _ in range(2):
        # a degrade rule slot keeps its breaker across reloads, in both
        # packages: a later round may meet the earlier round's breaker
        e = c.try_entry(f"{tag}-ui-res")
        out.append(e is None)
        if e is not None:
            e.trace(RuntimeError("boom"))
            e.exit()
        vt.advance(3)
    vt.advance(3)
    out.append(c.try_entry(f"{tag}-ui-res") is None)
    out.append(_save(dash, port, "paramFlow", [{"resource": f"{tag}-ui-papi", "count": 1, "paramIdx": 0, "grade": 1,
                                                 "durationInSec": 1}]))
    out += [_load(dash, port, "paramFlow"), passes(4, f"{tag}-ui-papi", args=["v"])]
    out.append(_save(dash, port, "authority", [{"resource": f"{tag}-auth-res", "limitApp": "badcaller", "strategy": 1}]))
    got = _load(dash, port, "authority")
    out += [got, passes(1, f"{tag}-auth-res", origin="goodcaller"), passes(1, f"{tag}-auth-res", origin="badcaller")]
    got[0]["strategy"] = 0
    out += [_save(dash, port, "authority", got), passes(1, f"{tag}-auth-res", origin="badcaller"),
            passes(1, f"{tag}-auth-res", origin="goodcaller")]
    vt.advance(1100)
    out.append(_save(dash, port, "system", [{"highestSystemLoad": -1, "highestCpuUsage": -1, "qps": 2, "avgRt": -1,
                                              "maxThread": -1}]))
    out += [_load(dash, port, "system"), passes(5, f"{tag}-sys-res", inbound=True)]
    # deleted in the reverse order of creation: each feature set on the way
    # down is one the machine already built a tick for
    for rtype in ("system", "authority", "paramFlow", "degrade", "flow"):
        out.append(_save(dash, port, rtype, []))
        out.append(_load(dash, port, rtype))
    vt.advance(1100)
    out += [passes(6, f"{tag}-ui-free"), passes(4, f"{tag}-sys-res", inbound=True), passes(2, f"{tag}-auth-res", origin="goodcaller")]
    return out


@pytest.mark.parametrize("cross", [False, True], ids=["own", "cross"])
def test_rule_crud_for_the_five_types_flips_enforcement_as_the_reference(world, cross):
    """Own: each dashboard publishes to its own package's machine; cross:
    the port's dashboard to the JAX machine and the reference's to the
    port machine.  Every answer, every read-back and every verdict count
    equals the reference pairing's."""
    w = world
    for c in (w["jc"], w["tc"]):
        c.time.advance(2_000)  # past every window of an earlier round
    pairs = [("jdash", "jcenter", "jc"), ("tdash", "tcenter", "tc")]
    if cross:
        pairs = [("tdash", "jcenter", "jc"), ("jdash", "tcenter", "tc")]
    want, got = (_crud(w[d], w[cc].port, w[c], "x" if cross else "ui") for d, cc, c in pairs)
    assert_close(got, want)
    assert want[0] == (200, {"code": 0, "pushed": 1, "targets": 1})
    assert want[1] == 2 and want[4] == 3 and want[9] is True  # flow, edited flow, breaker open
    assert want[-3:] == [6, 4, 2]  # deleted: nothing enforced any more


# -- /cluster/assign ---------------------------------------------------------


def _cluster_machine():
    client = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True), mode="threaded",
                            tick_interval_ms=2.0, device="cpu")
    client.start()
    svc = DefaultTokenService(client)
    svc.flow_rules.load("default", [tst.FlowRule(resource="res-101", count=3.0, cluster_mode=True,
                                                 cluster_flow_id=101)])
    cluster = CS.ClusterStateManager()
    cluster._embedded = svc
    cc = TT.SimpleHttpCommandCenter(TT.build_default_handlers(client, cluster=cluster), host="127.0.0.1", port=0)
    cc.start()
    return client, svc, cluster, cc


def test_cluster_assign_flips_one_server_and_its_clients():
    a, b = _cluster_machine(), _cluster_machine()
    dash = TD.DashboardServer(host="127.0.0.1", port=0, fetch_metrics=False)
    for cc in (a[3], b[3]):
        dash.discovery.register(TD.MachineInfo(app="app", ip="127.0.0.1", port=cc.port))
    dash.start()
    try:
        code, out = _http(dash, "/cluster/assign", data=json.dumps({
            "server": {"ip": "127.0.0.1", "port": a[3].port}, "clients": [{"ip": "127.0.0.1", "port": b[3].port}],
        }).encode())
        assert code == 200
        assert a[2].mode == CS.CLUSTER_SERVER and b[2].mode == CS.CLUSTER_CLIENT
        assert out["server"]["tokenPort"] > 0 and out["clients"] == [{"ip": "127.0.0.1", "port": b[3].port, "ok": True}]
        # the client machine's token requests are decided by the new server: count = 3
        statuses = [b[2]._token_client.request_token(101).status for _ in range(5)]
        assert statuses.count(CC.STATUS_OK) == 3 and statuses.count(CC.STATUS_BLOCKED) == 2
        # an unregistered server is refused (the proxy routes' allowlist)
        code, out = _http(dash, "/cluster/assign", data=json.dumps({"server": {"ip": "10.9.9.9", "port": 1}}).encode())
        assert code == 400 and out["error"].startswith("server: unknown machine")
        assert _http(dash, "/cluster/assign", data=b"{bad")[0] == 400
    finally:
        dash.stop()
        for client, svc, cluster, cc in (a, b):
            cc.stop()
            cluster.stop()
            svc.close()
            client.stop()
