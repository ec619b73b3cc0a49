"""Dashboard REST server — the control plane (L7).

A stdlib-HTTP re-design of sentinel-dashboard's Spring controllers (the
AngularJS webapp is out of scope; this is the JSON API it talks to):

    POST /registry/machine                  heartbeat receiver
    GET  /apps                              app → machines listing
    GET  /metric?app&identity&startTime&endTime      chart data (repository)
    GET  /metric/top?app&limit              top-N resources by volume
    GET  /resources?app                     known resources of an app
    GET  /rules?app&ip&port&type            rule CRUD — fetches live from the
    POST /rules?app&ip&port&type  (body: JSON rules)   machine's command plane
    GET  /cluster/mode?ip&port              cluster role of a machine
    POST /cluster/mode?ip&port&mode         flip cluster role
    GET  /tree?ip&port                      live invocation tree

Rule pushes go through DynamicRuleProvider/Publisher when configured
(dashboard/rule/DynamicRuleProvider.java:22 — e.g. a config-store backend);
the default round-trips via the machine API, like the reference.

The port's copy of ``sentinel_tpu/dashboard/server.py``; it touches no tensor.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.dashboard.api_client import SentinelApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement, MachineInfo
from sentinel_tpu_torch.dashboard.metric_fetcher import MetricFetcher
from sentinel_tpu_torch.dashboard.repository import InMemoryMetricsRepository


class DynamicRuleProvider:
    """Fetch rules for an app from an external store (SPI; default: live
    machine API)."""

    def fetch(self, app: str, type_: str):  # pragma: no cover - interface
        raise NotImplementedError


class DynamicRulePublisher:
    """Publish rules for an app to an external store (SPI)."""

    def publish(self, app: str, type_: str, rules: list):  # pragma: no cover
        raise NotImplementedError


class DashboardServer:
    def __init__(
        self,
        host: Optional[str] = None,
        port: int = 8080,
        fetch_metrics: bool = True,
        rule_provider: Optional[DynamicRuleProvider] = None,
        rule_publisher: Optional[DynamicRulePublisher] = None,
        auth_token: Optional[str] = None,
        machine_token: Optional[str] = None,
    ):
        from sentinel_tpu_torch.utils.authn import default_bind_host, normalize_token

        # auth_token gates every route — including /registry/machine — with
        # a bearer token (the AuthController/login-filter analog).  The
        # reference leaves registry open, but an open registry feeds the
        # proxy-target allowlist and the metric fetcher, so when auth is on,
        # heartbeats must carry the token too (HeartbeatSender auth_token=).
        # machine_token is what THIS server sends to each machine's command
        # plane (SimpleHttpCommandCenter auth_token=) on proxy/metric calls.
        self.auth_token = normalize_token(auth_token)
        self.discovery = AppManagement()
        self.repository = InMemoryMetricsRepository()
        self.api = SentinelApiClient(auth_token=machine_token)
        self.fetcher = MetricFetcher(self.discovery, self.repository, self.api)
        self.rule_provider = rule_provider
        self.rule_publisher = rule_publisher
        # default bind is loopback; a wider bind is explicit opt-in
        self.host = default_bind_host(host)
        self.requested_port = port
        self.port: Optional[int] = None
        self._fetch_metrics = fetch_metrics
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._server is not None:
            return
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                from sentinel_tpu_torch.utils.record_log import command_center_log

                command_center_log().info("dashboard %s", fmt % args)

            def do_GET(self):
                outer._route(self, "GET")

            def do_POST(self):
                outer._route(self, "POST")

        last_err = None
        for probe in range(50):
            try:
                self._server = ThreadingHTTPServer(
                    (self.host, self.requested_port + probe), Handler
                )
                break
            except OSError as e:
                last_err = e
        if self._server is None:
            raise OSError(f"no free dashboard port near {self.requested_port}: {last_err}")
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="sentinel-tpu-dashboard", daemon=True
        )
        self._thread.start()
        if self._fetch_metrics:
            self.fetcher.start()

    def stop(self) -> None:
        self.fetcher.stop()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.port = None

    # -- routing -----------------------------------------------------------

    def _route(self, handler: BaseHTTPRequestHandler, method: str) -> None:
        parsed = urllib.parse.urlparse(handler.path)
        params = {k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        length = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(length).decode("utf-8") if length else ""
        if body and not body.lstrip().startswith(("[", "{")):
            for k, v in urllib.parse.parse_qs(body).items():
                params.setdefault(k, v[-1])
            body = ""
        route = (method, parsed.path.rstrip("/") or "/")
        if route == ("GET", "/"):
            # the static UI page (dashboard/ui.py) — no data inside, so it
            # is served without auth; its fetches carry the bearer token
            from sentinel_tpu_torch.dashboard.ui import PAGE

            payload = PAGE.encode("utf-8")
            handler.send_response(200)
            handler.send_header("Content-Type", "text/html; charset=utf-8")
            handler.send_header("Content-Length", str(len(payload)))
            handler.end_headers()
            handler.wfile.write(payload)
            return
        fn = self._routes().get(route)
        try:
            from sentinel_tpu_torch.utils.authn import check_bearer

            if not check_bearer(
                handler.headers.get("Authorization"), self.auth_token
            ):
                code, result = 401, {"error": "unauthorized"}
            elif route == ("POST", "/registry/machine") and not handler.headers.get(
                "X-Sentinel-Heartbeat"
            ):
                # custom-header requirement = CSRF guard: registrations feed
                # the proxy allowlist and the metric fetcher, and a cross-
                # site form POST (which can reach a loopback bind from the
                # operator's browser) cannot carry a custom header
                code, result = 403, {"error": "missing X-Sentinel-Heartbeat"}
            elif fn is None:
                code, result = 404, {"error": f"no route {route[0]} {route[1]}"}
            else:
                code, result = fn(params, body)
        except ValueError as e:
            # parameter validation (missing/unknown machine, bad values) is
            # a client error, not a server fault
            code, result = 400, {"error": str(e)}
        except (OSError, KeyError) as e:
            code, result = 500, {"error": f"{type(e).__name__}: {e}"}
        payload = json.dumps(result).encode("utf-8")
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json; charset=utf-8")
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        handler.wfile.write(payload)

    def _routes(self) -> Dict[Tuple[str, str], Callable]:
        return {
            ("POST", "/registry/machine"): self._register_machine,
            ("GET", "/apps"): self._apps,
            ("GET", "/metric"): self._metric,
            ("GET", "/metric/top"): self._metric_top,
            ("GET", "/resources"): self._resources,
            ("GET", "/rules"): self._get_rules,
            ("POST", "/rules"): self._set_rules,
            ("GET", "/cluster/mode"): self._get_cluster_mode,
            ("POST", "/cluster/mode"): self._set_cluster_mode,
            ("POST", "/cluster/assign"): self._cluster_assign,
            ("GET", "/tree"): self._tree,
            ("GET", "/explain"): self._explain,
        }

    # -- handlers ----------------------------------------------------------

    def _register_machine(self, params, body):
        app = params.get("app")
        ip = params.get("ip")
        port = params.get("port")
        if not (app and ip and port):
            return 400, {"error": "app, ip, port are required"}
        self.discovery.register(
            MachineInfo(
                app=app,
                ip=ip,
                port=int(port),
                hostname=params.get("hostname", ""),
                pid=int(params.get("pid", "0")),
                version=params.get("version", ""),
            )
        )
        return 200, {"code": 0, "msg": "success"}

    def _apps(self, params, body):
        return 200, {
            app: [m.to_json() for m in self.discovery.machines(app)]
            for app in self.discovery.apps()
        }

    def _metric(self, params, body):
        app = params.get("app")
        identity = params.get("identity")
        if not (app and identity):
            return 400, {"error": "app and identity are required"}
        start = int(params.get("startTime", "0"))
        end = int(params.get("endTime", str(2**62)))
        nodes = self.repository.query(app, identity, start, end)
        return 200, [vars(n) for n in nodes]

    def _metric_top(self, params, body):
        app = params.get("app")
        if not app:
            return 400, {"error": "app is required"}
        start = int(params.get("startTime", "0"))
        end = int(params.get("endTime", str(2**62)))
        limit = int(params.get("limit", "30"))
        return 200, self.repository.top_resources(app, start, end, limit)

    def _resources(self, params, body):
        app = params.get("app")
        if not app:
            return 400, {"error": "app is required"}
        return 200, self.repository.resources_of(app)

    def _machine_of(self, params):
        ip, port = params.get("ip"), params.get("port")
        if not (ip and port):
            raise ValueError("ip and port are required")
        port = int(port)
        # proxy routes (/rules, /tree, /cluster/mode) cause server-side HTTP
        # requests to ip:port — only allow targets that actually registered
        # via heartbeat, so the dashboard can't be used as an SSRF relay
        known = {
            (m.ip, m.port)
            for app in self.discovery.apps()
            for m in self.discovery.machines(app)
        }
        if (ip, port) not in known:
            raise ValueError(f"unknown machine {ip}:{port} (not in discovery)")
        return ip, port

    def _get_rules(self, params, body):
        type_ = params.get("type", "flow")
        app = params.get("app", "")
        if self.rule_provider is not None:
            rules = self.rule_provider.fetch(app, type_)
            return 200, R.rules_to_json_list(rules)
        ip, port = self._machine_of(params)
        rules = self.api.fetch_rules(ip, port, type_)
        return 200, R.rules_to_json_list(rules)

    def _set_rules(self, params, body):
        type_ = params.get("type", "flow")
        app = params.get("app", "")
        kind = {"paramFlow": "param-flow"}.get(type_, type_)
        data = body or params.get("data", "[]")
        rules = R.rules_from_json_list(kind, json.loads(data))
        if self.rule_publisher is not None:
            self.rule_publisher.publish(app, type_, rules)
            return 200, {"code": 0, "msg": "published"}
        # default: push straight to every healthy machine of the app, or to
        # the one machine given by ip/port (reference round-trip semantics)
        targets = []
        if params.get("ip") and params.get("port"):
            targets = [self._machine_of(params)]
        elif app:
            targets = [(m.ip, m.port) for m in self.discovery.machines(app, only_healthy=True)]
        if not targets:
            return 400, {"error": "no target machines"}
        pushed = sum(1 for ip, port in targets if self.api.set_rules(ip, port, type_, rules))
        return 200, {"code": 0, "pushed": pushed, "targets": len(targets)}

    def _cluster_assign(self, params, body):
        """One-shot token-server/client assignment across machines
        (ClusterAssignServiceImpl.java analog): body JSON names the server
        machine and the client machines; the dashboard flips the server
        first, reads its bound token port, then points every client at it.

            {"server": {"ip": ..., "port": ...},      # command-plane addr
             "clients": [{"ip": ..., "port": ...}, ...],
             "tokenPort": optional fixed port}

        Every machine must be heartbeat-registered (same SSRF guard as the
        proxy routes).  Partial failures report per-machine results so the
        operator can retry the stragglers."""
        try:
            spec = json.loads(body or "{}")
        except ValueError:
            return 400, {"error": "invalid JSON body"}
        srv = spec.get("server") or {}
        try:
            sip, sport = self._machine_of(srv)
        except ValueError as e:
            return 400, {"error": f"server: {e}"}
        results = {"server": None, "clients": []}
        from sentinel_tpu_torch.cluster import state as CS

        tok_port = spec.get("tokenPort")
        ok = self.api.set_cluster_mode(
            sip, sport, CS.CLUSTER_SERVER, token_port=tok_port
        )
        if not ok:
            return 502, {"error": f"server flip failed on {sip}:{sport}"}
        try:
            info = self.api.get_cluster_server_info(sip, sport)
            token_port = int(info.get("tokenPort", -1))
        except Exception:
            token_port = -1
        if token_port <= 0:
            return 502, {"error": "server reports no token port"}
        results["server"] = {"ip": sip, "tokenPort": token_port}
        for cm in spec.get("clients") or []:
            try:
                cip, cport = self._machine_of(cm)
                ok = self.api.set_cluster_mode(
                    cip, cport, CS.CLUSTER_CLIENT, host=sip, token_port=token_port
                )
                results["clients"].append(
                    {"ip": cip, "port": cport, "ok": bool(ok)}
                )
            except Exception as e:
                results["clients"].append(
                    {"ip": cm.get("ip"), "port": cm.get("port"), "ok": False,
                     "error": str(e)}
                )
        return 200, results

    def _get_cluster_mode(self, params, body):
        ip, port = self._machine_of(params)
        return 200, self.api.get_cluster_mode(ip, port)

    def _set_cluster_mode(self, params, body):
        ip, port = self._machine_of(params)
        ok = self.api.set_cluster_mode(ip, port, int(params.get("mode", "-99")))
        return (200, {"code": 0}) if ok else (500, {"error": "set mode failed"})

    def _tree(self, params, body):
        ip, port = self._machine_of(params)
        return 200, self.api.fetch_json_tree(ip, port)

    def _explain(self, params, body):
        """Proxy to the machine's ``GET /api/explain`` — the "top block
        causes" panel's data source (same SSRF allowlist as the other
        proxy routes)."""
        ip, port = self._machine_of(params)
        top = params.get("top")
        return 200, self.api.fetch_explain(
            ip, port,
            resource=params.get("resource"),
            top=int(top) if top else None,
        )
