"""Built-in command handlers — the analog of the ~20 handlers in
sentinel-transport-common/.../command/handler/ (ModifyRulesCommandHandler,
FetchActiveRuleCommandHandler, SendMetricCommandHandler, FetchJsonTree...,
FetchClusterNode..., ModifyClusterMode..., OnOffSet..., BasicInfo...).

All handlers are methods on one group object bound to a SentinelClient so
the registry stays explicit and testable.

The port's copy of ``sentinel_tpu/transport/handlers.py``; ``api/flight``
answers from the port's flight recorder (``obs/flight.FLIGHT``),
``metrics?fleet=1`` from its fleet view (``obs/fleet``), ``api/profile``
and ``api/memory`` from its profiling plane (``obs/profile``), and
``api/shards`` from its sharded token clients (``cluster/shard``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.transport.command import (
    CommandRegistry,
    CommandRequest,
    CommandResponse,
    command_mapping,
)

#: command rule-type value → SentinelClient manager attribute
RULE_TYPE_TO_MANAGER = {
    "flow": "flow_rules",
    "degrade": "degrade_rules",
    "system": "system_rules",
    "authority": "authority_rules",
    "paramFlow": "param_flow_rules",
}

#: command rule-type value → converter kind (core.rules codec)
RULE_TYPE_TO_KIND = {
    "flow": "flow",
    "degrade": "degrade",
    "system": "system",
    "authority": "authority",
    "paramFlow": "param-flow",
}


class DefaultHandlerGroup:
    def __init__(self, client, cluster=None, metric_searcher=None, writable_registry=None):
        self.client = client
        self.cluster = cluster
        self.metric_searcher = metric_searcher
        self.writable_registry = writable_registry

    # -- info ---------------------------------------------------------------

    @command_mapping("version", "framework version")
    def version(self, req: CommandRequest) -> CommandResponse:
        import sentinel_tpu_torch

        return CommandResponse.of_success(sentinel_tpu_torch.__version__)

    @command_mapping("basicInfo", "app/runtime basic info")
    def basic_info(self, req: CommandRequest) -> CommandResponse:
        c = self.client
        return CommandResponse.of_success(
            {
                "appName": c.app_name,
                "pid": os.getpid(),
                "mode": c.mode,
                "enabled": c.enabled,
                "maxResources": c.cfg.max_resources,
                "registeredResources": c.registry.num_resources,
            }
        )

    @command_mapping("api", "list available commands")
    def api(self, req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(
            [{"name": n, "desc": d} for n, d in self._registry.names()]
        )

    # -- rules --------------------------------------------------------------

    def _manager(self, type_: Optional[str]):
        attr = RULE_TYPE_TO_MANAGER.get(type_ or "")
        return getattr(self.client, attr) if attr else None

    @command_mapping("getRules", "fetch active rules by type")
    def get_rules(self, req: CommandRequest) -> CommandResponse:
        type_ = req.param("type")
        mgr = self._manager(type_)
        if mgr is None:
            return CommandResponse.of_failure(f"invalid type: {type_}")
        return CommandResponse.of_success(R.rules_to_json_list(mgr.get()))

    @command_mapping("setRules", "replace active rules by type")
    def set_rules(self, req: CommandRequest) -> CommandResponse:
        type_ = req.param("type")
        mgr = self._manager(type_)
        if mgr is None:
            return CommandResponse.of_failure(f"invalid type: {type_}")
        data = req.param("data") or req.body or "[]"
        rules = R.rules_from_json_list(RULE_TYPE_TO_KIND[type_], json.loads(data))
        mgr.load(rules)
        # write-through to the registered writable datasource, so pushed
        # rules survive restart (WritableDataSourceRegistry semantics)
        if self.writable_registry is not None:
            self.writable_registry.write(RULE_TYPE_TO_KIND[type_], rules)
        return CommandResponse.of_success("success")

    @command_mapping("getParamFlowRules", "fetch hot-param rules")
    def get_param_rules(self, req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(
            R.rules_to_json_list(self.client.param_flow_rules.get())
        )

    @command_mapping("topParams", "hottest parameter values for a resource")
    def top_params(self, req: CommandRequest) -> CommandResponse:
        res = req.param("id")
        if not res:
            return CommandResponse.of_failure("id is required")
        n = int(req.param("n", "16"))
        return CommandResponse.of_success(
            [{"param": repr(v), "sightings": c} for v, c in self.client.top_params(res, n)]
        )

    # -- metrics ------------------------------------------------------------

    @command_mapping("metric", "query metric log lines by time range")
    def metric(self, req: CommandRequest) -> CommandResponse:
        if self.metric_searcher is None:
            return CommandResponse.of_success("")
        start = int(req.param("startTime", "0"))
        end = req.param("endTime")
        identity = req.param("identity")
        max_lines = int(req.param("maxLines", "6000"))
        if end or identity:
            nodes = self.metric_searcher.find_by_time_and_resource(
                start, int(end) if end else 2**62, identity
            )[:max_lines]
        else:
            nodes = self.metric_searcher.find(start, max_lines)
        return CommandResponse.of_success("\n".join(n.to_line() for n in nodes))

    @command_mapping("api/metric", "per-resource per-second timeline rows")
    def api_metric(self, req: CommandRequest) -> CommandResponse:
        """``GET /api/metric?resource=&start=&end=`` — the device-driven
        per-second metric timeline (obs/timeline.py): one JSON row per
        (second, resource) with pass/block/success/exception counts,
        rt_sum/rt_min and concurrency, served read-through from the
        indexed on-disk MetricLog + the recorder's open buckets.  The
        reference's ``/metric?startTime&endTime`` channel, binary-backed
        and top-K device-batched; ``obs.fleet.merge_timelines`` aligns
        and sums these rows across a fleet."""
        tl = getattr(self.client, "timeline", None)
        if tl is None:
            return CommandResponse.of_success([])
        resource = req.param("resource") or None
        start = int(req.param("start", "0"))
        end_raw = req.param("end")
        end = int(end_raw) if end_raw else 2**62
        # bounded like the sibling `metric` handler's maxLines: an
        # unbounded default range over a full 8x8MiB log would decode and
        # serialize tens of MB per dashboard poll.  Newest rows win — the
        # catch-up pull wants the recent edge, not the pruned past.
        max_rows = int(req.param("maxRows", "6000"))
        rows = tl.find(resource, start, end)
        if max_rows > 0:
            rows = rows[-max_rows:]
        return CommandResponse.of_success([r.to_dict() for r in rows])

    @command_mapping("clusterNode", "per-resource statistics snapshot")
    def cluster_node(self, req: CommandRequest) -> CommandResponse:
        snap = self.client.stats.snapshot()
        out = [dict(resource=name, **s) for name, s in snap.items()]
        return CommandResponse.of_success(out)

    @command_mapping("origin", "per-origin statistics for one resource")
    def origin(self, req: CommandRequest) -> CommandResponse:
        res = req.param("id")
        if not res:
            return CommandResponse.of_failure("id is required")
        out = []
        for (kind, key), row in self.client.registry.extra_rows().items():
            if kind != "origin":
                continue
            r, _, origin = key.partition("\x00")
            if r == res:
                s = self.client.stats._row_stats(row)
                out.append(dict(resource=res, origin=origin, **s))
        return CommandResponse.of_success(out)

    @command_mapping("jsonTree", "invocation tree with live stats")
    def json_tree(self, req: CommandRequest) -> CommandResponse:
        c = self.client
        root = dict(resource="machine-root", **c.stats.entry_node(), children=[])
        snap = c.stats.snapshot()
        origins = {}
        for (kind, key), row in c.registry.extra_rows().items():
            if kind == "origin":
                r, _, origin = key.partition("\x00")
                origins.setdefault(r, []).append((origin, row))
        for name, s in snap.items():
            node = dict(resource=name, **s, children=[])
            for origin, row in origins.get(name, []):
                node["children"].append(
                    dict(resource=f"{name}|{origin}", origin=origin, **c.stats._row_stats(row))
                )
            root["children"].append(node)
        return CommandResponse.of_success(root)

    @command_mapping("metrics", "Prometheus text exposition (obs registry)")
    def prometheus_metrics(self, req: CommandRequest) -> CommandResponse:
        """``GET /metrics`` — the standard scrape surface: every counter /
        gauge / histogram in the process-global obs registry (tick-stage
        latencies, pipeline occupancy, seg drops, cluster degrade state,
        RPC latencies) in Prometheus text format 0.0.4.

        ``?fleet=1`` merges in every configured fleet member
        (``obs.fleet.add_fleet_target`` / ``SENTINEL_FLEET_TARGETS``):
        counters sum, histograms merge bucket-wise, per-shard labels
        survive, same-process duplicates drop (obs/fleet.py)."""
        from sentinel_tpu_torch.obs import REGISTRY

        if (req.param("fleet") or "").lower() in ("1", "true"):
            from sentinel_tpu_torch.obs.fleet import fleet_exposition

            return CommandResponse.of_success(fleet_exposition())
        return CommandResponse.of_success(REGISTRY.exposition())

    @command_mapping("api/traces", "span-tracer ring dump (Chrome trace JSON)")
    def api_traces(self, req: CommandRequest) -> CommandResponse:
        """``GET /api/traces`` — the current span ring as Chrome Trace
        Event JSON: load in Perfetto / chrome://tracing, or read it back
        with ``obs.trace.load_spans`` and ``obs.summarize``.  ``?enable=true|false``
        flips tracing on the instance first (an ops toggle, like
        setSwitch)."""
        from sentinel_tpu_torch.obs import TRACER

        enable = (req.param("enable") or "").lower()
        if enable == "true":
            TRACER.enable()
        elif enable == "false":
            TRACER.disable()
        return CommandResponse.of_success(TRACER.chrome_trace())

    @command_mapping("api/flight", "flight-recorder bundle (black-box post-mortem)")
    def api_flight(self, req: CommandRequest) -> CommandResponse:
        """``GET /api/flight`` — the black-box surface: by default a FRESH
        bundle captured on demand (not rate-limited — an operator asking
        for state deserves current state); ``?stored=N`` returns the last N
        automatically triggered bundles instead (cluster-degrade entries).
        Read either back with ``obs.flight.load_bundle`` once saved."""
        from sentinel_tpu_torch.obs.flight import FLIGHT

        stored = req.param("stored")
        if stored is not None:
            n = max(int(stored), 0)
            # [-0:] would slice the WHOLE list; stored=0 means none
            return CommandResponse.of_success(FLIGHT.bundles()[-n:] if n else [])
        return CommandResponse.of_success(FLIGHT.dump_bundle(reason="api"))

    @command_mapping("api/profile", "bounded deep-profile capture (Chrome trace)")
    def api_profile(self, req: CommandRequest) -> CommandResponse:
        """``GET /api/profile?ms=250`` — one bounded dense-capture window
        (obs/profile.capture_profile): the span tracer is force-enabled
        (with its ``torch.profiler.record_function`` passthrough) for at
        most ``ms`` milliseconds and the window's spans come back as a
        Chrome-trace payload.  Rate-limited (a second capture inside the
        interval returns ``{"error": "rate_limited", "retry_after_s": ...}``)
        and fail-OPEN: errors return a payload, decisions are untouched."""
        from sentinel_tpu_torch.obs.profile import capture_profile

        return CommandResponse.of_success(capture_profile(req.param("ms") or 250.0))

    @command_mapping("api/memory", "HBM memory-ledger reconciliation")
    def api_memory(self, req: CommandRequest) -> CommandResponse:
        """``GET /api/memory`` — the memory ledger's view (per-pool bytes,
        per-entry breakdown, capacity posture) reconciled on demand against
        the client's device: on the card ``torch.cuda.memory_allocated``
        and the allocator's ``*bytes*`` statistics (``unaccounted_bytes`` =
        allocated bytes no ledger entry claims); on the CPU those read
        None."""
        from sentinel_tpu_torch.obs.profile import LEDGER

        return CommandResponse.of_success(LEDGER.reconcile(getattr(self.client, "device", None)))

    @command_mapping("api/shards", "token-fleet topology + per-shard health")
    def api_shards(self, req: CommandRequest) -> CommandResponse:
        """``GET /api/shards`` — every live sharded token client in the
        process: ring parameters, per-flow spread, and per-shard address
        / connection / failover state (the operator's view of WHICH
        shard is degraded and how long its cooldown has left)."""
        from sentinel_tpu_torch.cluster.shard import describe_fleets

        return CommandResponse.of_success(describe_fleets())

    @command_mapping("api/explain", "verdict provenance: why decisions blocked")
    def api_explain(self, req: CommandRequest) -> CommandResponse:
        """``GET /api/explain`` — the verdict provenance plane
        (obs/explain.py): coverage (what fraction of blocked decisions
        carry an explanation), the top block-cause leaderboard, and the
        newest device-packed block explanations.  ``?resource=NAME``
        restricts the record list to one resource's provenance ring;
        ``?top=N`` sizes the leaderboard.  Also the backing surface for
        the reference's ``obs explain --target`` CLI."""
        plane = getattr(self.client, "explain_plane", None)
        if plane is None:
            return CommandResponse.of_success(
                {"enabled": False, "coverage": {"blocked": 0, "explained": 0,
                                                "frac": 1.0},
                 "top_causes": [], "recent": []}
            )
        top = int(req.param("top") or 10)
        resource = req.param("resource")
        if resource:
            recs = self.client.explain(resource, limit=64)
        else:
            recs = plane.recent(64)
        return CommandResponse.of_success(
            {
                "enabled": True,
                "coverage": plane.coverage(),
                "top_causes": plane.top_causes(top),
                "recent": [r.to_dict() for r in recs],
            }
        )

    @command_mapping("rtQuantiles", "inbound RT quantiles (p50/p90/p99)")
    def rt_quantiles(self, req: CommandRequest) -> CommandResponse:
        qs = [float(x) for x in (req.param("q") or "0.5,0.9,0.99").split(",")]
        out = self.client.rt_quantiles(tuple(qs))
        # keys match the advertised percent form: p50 / p90 / p99 / p99.9
        return CommandResponse.of_success(
            {f"p{round(q * 100, 3):g}": v for q, v in out.items()}
        )

    @command_mapping("systemStatus", "system adaptive-protection inputs")
    def system_status(self, req: CommandRequest) -> CommandResponse:
        load, cpu = self.client._sys.sample()
        entry = self.client.stats.entry_node()
        return CommandResponse.of_success(
            {
                "load": load,
                "cpuUsage": cpu,
                "qps": entry["passQps"],
                "avgRt": entry["avgRt"],
                "threadNum": entry["curThreadNum"],
            }
        )

    # -- switches -----------------------------------------------------------

    @command_mapping("setSwitch", "turn entry protection on/off")
    def set_switch(self, req: CommandRequest) -> CommandResponse:
        value = (req.param("value") or "").lower()
        if value not in ("true", "false"):
            return CommandResponse.of_failure("value must be true|false")
        self.client.enabled = value == "true"
        return CommandResponse.of_success("success")

    @command_mapping("getSwitch", "read the protection switch")
    def get_switch(self, req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success({"enabled": self.client.enabled})

    # -- cluster ------------------------------------------------------------

    @command_mapping("getClusterMode", "cluster role of this instance")
    def get_cluster_mode(self, req: CommandRequest) -> CommandResponse:
        if self.cluster is None:
            return CommandResponse.of_success({"mode": 0, "available": False})
        return CommandResponse.of_success(
            {"mode": self.cluster.mode, "available": self.cluster.is_available()}
        )

    @command_mapping("setClusterMode", "flip cluster role (0=client 1=server)")
    def set_cluster_mode(self, req: CommandRequest) -> CommandResponse:
        """ModifyClusterModeCommandHandler analog. Becoming a server needs a
        DefaultTokenService; the instance keeps its last one, so the flip is
        client↔server with the wiring established at setup time."""
        if self.cluster is None:
            return CommandResponse.of_failure("cluster not configured")
        from sentinel_tpu_torch.cluster import state as CS

        mode = int(req.param("mode", "-99"))
        if mode == CS.CLUSTER_CLIENT:
            # optional assignment: which token server this client consults
            # (the dashboard's assign flow pushes it with the flip —
            # ClusterClientAssignConfig analog)
            host = req.param("host", "") or None
            port = req.param("tokenPort", "")
            self.cluster.set_to_client(
                host=host, port=int(port) if port else None
            )
        elif mode == CS.CLUSTER_SERVER:
            svc = self.cluster._embedded or getattr(
                self.cluster, "_last_service", None
            )
            if svc is None:
                return CommandResponse.of_failure("no token service configured for server mode")
            port = req.param("tokenPort", "")
            self.cluster.set_to_server(svc, port=int(port) if port else None)
        else:
            return CommandResponse.of_failure(f"invalid mode: {mode}")
        return CommandResponse.of_success("success")

    @command_mapping("clusterServerInfo", "embedded token server state")
    def cluster_server_info(self, req: CommandRequest) -> CommandResponse:
        """Port + liveness of this instance's token server — the assign
        flow reads it to point client machines at the right address
        (ClusterServerStateVO analog)."""
        if self.cluster is None:
            return CommandResponse.of_failure("cluster not configured")
        srv = self.cluster.server
        return CommandResponse.of_success(
            {
                "mode": self.cluster.mode,
                "tokenPort": srv.port if srv is not None else -1,
                "running": srv is not None,
            }
        )


def build_default_handlers(
    client, cluster=None, metric_searcher=None, writable_registry=None
) -> CommandRegistry:
    registry = CommandRegistry()
    group = DefaultHandlerGroup(client, cluster, metric_searcher, writable_registry)
    registry.register_group(group)  # also injects group._registry for "api"
    return registry
