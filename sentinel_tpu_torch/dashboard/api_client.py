"""Dashboard-side client for each instance's command plane.

The analog of SentinelApiClient.java:93-121: every dashboard operation on a
machine (fetch/modify rules, pull metrics, read the node tree, flip cluster
mode) is an HTTP call to that machine's command center (§2.4 handlers).

The port's copy of ``sentinel_tpu/dashboard/api_client.py``; it touches no tensor.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from typing import Any, List, Optional

from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.metrics.node import MetricNode

DEFAULT_TIMEOUT_S = 3.0
#: rule pushes are control-plane ops that BLOCK until enforcement is live
#: on the machine — a reload that changes the compiled feature set (e.g.
#: the first authority rule) builds and warms a new tick before it
#: serves.  The publish honestly waits for it (a
#: fast ACK would report rules "live" during an unenforced window), so
#: its timeout is its own, much larger than telemetry's.
RULE_PUSH_TIMEOUT_S = 180.0


class SentinelApiClient:
    def __init__(
        self, timeout_s: float = DEFAULT_TIMEOUT_S, auth_token: Optional[str] = None
    ):
        # auth_token is the MACHINE-side command-plane bearer token — sent
        # on every request so machines running SimpleHttpCommandCenter with
        # auth enabled still accept dashboard pulls and rule pushes
        self.timeout_s = timeout_s
        self.auth_token = auth_token

    # -- raw --------------------------------------------------------------

    def _headers(self) -> dict:
        from sentinel_tpu_torch.utils.authn import bearer_header

        return bearer_header(self.auth_token)

    def _get(self, ip: str, port: int, command: str, **params) -> str:
        qs = urllib.parse.urlencode({k: v for k, v in params.items() if v is not None})
        url = f"http://{ip}:{port}/{command}" + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, headers=self._headers())
        with urllib.request.urlopen(req, timeout=self.timeout_s) as rsp:
            return rsp.read().decode("utf-8")

    def _post(
        self, ip: str, port: int, command: str, timeout_s: Optional[float] = None,
        **params,
    ) -> str:
        url = f"http://{ip}:{port}/{command}"
        body = urllib.parse.urlencode(
            {k: v for k, v in params.items() if v is not None}
        ).encode("ascii")
        req = urllib.request.Request(
            url, data=body, method="POST", headers=self._headers()
        )
        with urllib.request.urlopen(
            req, timeout=timeout_s or self.timeout_s
        ) as rsp:
            return rsp.read().decode("utf-8")

    # -- rules ------------------------------------------------------------

    def fetch_rules(self, ip: str, port: int, type_: str) -> List[Any]:
        kind = {"paramFlow": "param-flow"}.get(type_, type_)
        raw = json.loads(self._get(ip, port, "getRules", type=type_))
        return R.rules_from_json_list(kind, raw)

    def set_rules(self, ip: str, port: int, type_: str, rules: List[Any]) -> bool:
        data = json.dumps(R.rules_to_json_list(rules))
        return (
            self._post(
                ip, port, "setRules", timeout_s=RULE_PUSH_TIMEOUT_S,
                type=type_, data=data,
            )
            == "success"
        )

    # -- telemetry ---------------------------------------------------------

    def fetch_metric(
        self, ip: str, port: int, start_ms: int, end_ms: Optional[int] = None
    ) -> List[MetricNode]:
        raw = self._get(ip, port, "metric", startTime=start_ms, endTime=end_ms)
        out = []
        for line in raw.split("\n"):
            if not line.strip():
                continue
            try:
                out.append(MetricNode.from_line(line))
            except ValueError:
                continue
        return out

    def fetch_timeline(
        self,
        ip: str,
        port: int,
        resource: Optional[str] = None,
        start_ms: int = 0,
        end_ms: Optional[int] = None,
    ) -> List[dict]:
        """``GET /api/metric`` — the machine's per-resource per-second
        timeline rows (obs/timeline.py; dicts with ts/resource/pass/
        block/success/exception/rt_sum/rt_min/concurrency).  The
        device-batched successor of ``fetch_metric``'s text lines."""
        return json.loads(
            self._get(
                ip, port, "api/metric",
                resource=resource, start=start_ms, end=end_ms,
            )
        )

    def fetch_prometheus(self, ip: str, port: int) -> str:
        """``GET /metrics`` — the machine's obs-registry exposition
        (Prometheus text format); raw text so the dashboard can re-serve
        or parse it."""
        return self._get(ip, port, "metrics")

    def fetch_traces(self, ip: str, port: int) -> dict:
        """``GET /api/traces`` — the machine's span ring as Chrome-trace
        JSON (Perfetto-loadable; ``obs.load_spans`` parses it)."""
        return json.loads(self._get(ip, port, "api/traces"))

    def fetch_flight(self, ip: str, port: int, stored: Optional[int] = None):
        """``GET /api/flight`` — the machine's black-box flight recorder:
        a fresh on-demand bundle, or with ``stored=N`` the last N
        automatically-triggered ones (``obs.flight`` docs the contents;
        ``python -m sentinel_tpu_torch.obs --postmortem`` analyzes a bundle)."""
        return json.loads(
            self._get(ip, port, "api/flight", stored=stored)
        )

    def fetch_explain(
        self,
        ip: str,
        port: int,
        resource: Optional[str] = None,
        top: Optional[int] = None,
    ) -> dict:
        """``GET /api/explain`` — the machine's verdict provenance plane:
        coverage, the top block-cause leaderboard, and the newest
        device-packed block explanations (obs/explain.py)."""
        return json.loads(
            self._get(ip, port, "api/explain", resource=resource, top=top)
        )

    def fetch_json_tree(self, ip: str, port: int) -> dict:
        return json.loads(self._get(ip, port, "jsonTree"))

    def fetch_cluster_node(self, ip: str, port: int) -> list:
        return json.loads(self._get(ip, port, "clusterNode"))

    def fetch_basic_info(self, ip: str, port: int) -> dict:
        return json.loads(self._get(ip, port, "basicInfo"))

    # -- cluster ----------------------------------------------------------

    def get_cluster_mode(self, ip: str, port: int) -> dict:
        return json.loads(self._get(ip, port, "getClusterMode"))

    def set_cluster_mode(
        self, ip: str, port: int, mode: int, host: str = None, token_port: int = None
    ) -> bool:
        return (
            self._post(
                ip, port, "setClusterMode", mode=mode, host=host,
                tokenPort=token_port,
            )
            == "success"
        )

    def get_cluster_server_info(self, ip: str, port: int) -> dict:
        return json.loads(self._get(ip, port, "clusterServerInfo"))
