"""Cluster rule + config managers.

The port's copy of ``sentinel_tpu/cluster/rules.py``.

The reference keys cluster rules by a **global flowId** across namespaces
(ClusterFlowRuleManager.java:63-76, getFlowRuleById:202); the token server
loads per-namespace rule sets and answers requestToken(flowId, …).  Here the
managers also *project* cluster rules onto the decision engine: every
flowId becomes an interned resource name on the token-server's
SentinelClient, with an engine FlowRule/ParamFlowRule whose threshold is the
computed global threshold.

Config managers mirror ServerFlowConfig / ClusterServerConfigManager /
ClusterClientConfigManager (server namespaces + transport knobs; client
server-address assignment + request timeout), all push-updatable via
SentinelProperty (SURVEY.md §3.4).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.core import rules as R


def flow_resource(flow_id: int) -> str:
    """Engine resource name backing a cluster flow rule."""
    return f"$cluster/flow/{flow_id}"


def param_resource(flow_id: int) -> str:
    return f"$cluster/param/{flow_id}"


@dataclass
class ServerFlowConfig:
    """Per-namespace server-side flow config (ServerFlowConfig.java:26-40)."""

    exceed_count: float = C.DEFAULT_EXCEED_COUNT
    max_occupy_ratio: float = C.DEFAULT_MAX_OCCUPY_RATIO
    interval_ms: int = C.DEFAULT_INTERVAL_MS
    sample_count: int = C.DEFAULT_SAMPLE_COUNT
    max_allowed_qps: float = C.DEFAULT_MAX_ALLOWED_QPS


@dataclass
class ServerTransportConfig:
    """ClusterServerConfigManager's transport slice."""

    port: int = C.DEFAULT_PORT
    idle_seconds: int = C.DEFAULT_IDLE_SECONDS


class ClusterServerConfigManager:
    def __init__(self):
        self._lock = threading.Lock()
        self.transport = ServerTransportConfig()
        self._namespaces: set = {C.DEFAULT_NAMESPACE}
        self._flow_configs: Dict[str, ServerFlowConfig] = {}
        self._listeners: List[Callable[[], None]] = []

    def namespaces(self) -> List[str]:
        return sorted(self._namespaces)

    def set_namespaces(self, namespaces) -> None:
        with self._lock:
            self._namespaces = set(namespaces) or {C.DEFAULT_NAMESPACE}
        self._notify()

    def flow_config(self, namespace: str) -> ServerFlowConfig:
        return self._flow_configs.get(namespace) or self._flow_configs.setdefault(
            "__global__", ServerFlowConfig()
        )

    def set_flow_config(self, namespace: str, cfg: ServerFlowConfig) -> None:
        with self._lock:
            self._flow_configs[namespace] = cfg
        self._notify()

    def add_listener(self, fn: Callable[[], None]) -> None:
        self._listeners.append(fn)

    def _notify(self) -> None:
        for fn in list(self._listeners):
            fn()


@dataclass
class ClusterClientAssignConfig:
    """Token-server address assignment (ClusterClientAssignConfig.java)."""

    host: str = ""
    port: int = C.DEFAULT_PORT


class ClusterClientConfigManager:
    def __init__(self):
        self.assign = ClusterClientAssignConfig()
        self.request_timeout_ms: int = C.DEFAULT_REQUEST_TIMEOUT_MS
        self._listeners: List[Callable[[], None]] = []

    def apply_assign(self, host: str, port: int) -> None:
        self.assign = ClusterClientAssignConfig(host=host, port=port)
        for fn in list(self._listeners):
            fn()

    def add_listener(self, fn: Callable[[], None]) -> None:
        self._listeners.append(fn)


class ClusterFlowRuleManager:
    """flowId → FlowRule, grouped by namespace.

    ``load(namespace, rules)`` replaces a namespace's rule set
    (registerPropertyIfAbsent/applyClusterFlowRule analog); rules must carry
    ``cluster_flow_id`` and have ``cluster_mode=True``.
    """

    def __init__(self, on_change: Optional[Callable[[], None]] = None):
        self._lock = threading.Lock()
        self._by_ns: Dict[str, List[R.FlowRule]] = {}
        self._by_id: Dict[int, R.FlowRule] = {}
        self._ns_by_id: Dict[int, str] = {}
        self._on_change = on_change
        self._listeners: List[Callable[[], None]] = []

    def add_listener(self, fn: Callable[[], None]) -> None:
        """Fires after every load, AFTER the primary on_change (so engine
        rule projection runs first and listeners see compiled state)."""
        self._listeners.append(fn)

    def load(self, namespace: str, rules: List[R.FlowRule]) -> None:
        rules = [r for r in rules if r.cluster_mode and r.cluster_flow_id > 0]
        with self._lock:
            old = self._by_ns.get(namespace, [])
            for r in old:
                # only drop ids this namespace still owns — a flow id that
                # was re-registered by another namespace stays live
                if self._ns_by_id.get(r.cluster_flow_id) == namespace:
                    self._by_id.pop(r.cluster_flow_id, None)
                    self._ns_by_id.pop(r.cluster_flow_id, None)
            self._by_ns[namespace] = rules
            for r in rules:
                self._by_id[r.cluster_flow_id] = r
                self._ns_by_id[r.cluster_flow_id] = namespace
        if self._on_change:
            self._on_change()
        for fn in list(self._listeners):
            fn()

    def get_by_id(self, flow_id: int) -> Optional[R.FlowRule]:
        return self._by_id.get(flow_id)

    def namespace_of(self, flow_id: int) -> Optional[str]:
        return self._ns_by_id.get(flow_id)

    def all_ids(self) -> List[int]:
        return list(self._by_id.keys())

    def rules_of(self, namespace: str) -> List[R.FlowRule]:
        return list(self._by_ns.get(namespace, []))


class ClusterParamFlowRuleManager:
    """flowId → ParamFlowRule, grouped by namespace."""

    def __init__(self, on_change: Optional[Callable[[], None]] = None):
        self._lock = threading.Lock()
        self._by_ns: Dict[str, List[R.ParamFlowRule]] = {}
        self._by_id: Dict[int, R.ParamFlowRule] = {}
        self._ns_by_id: Dict[int, str] = {}
        self._on_change = on_change
        self._listeners: List[Callable[[], None]] = []

    def add_listener(self, fn: Callable[[], None]) -> None:
        """Fires after every load, AFTER the primary on_change (so engine
        recompilation precedes dependents like the front door's id map)."""
        self._listeners.append(fn)

    def load(self, namespace: str, rules: List[R.ParamFlowRule]) -> None:
        rules = [r for r in rules if r.cluster_mode and r.cluster_flow_id > 0]
        with self._lock:
            old = self._by_ns.get(namespace, [])
            for r in old:
                if self._ns_by_id.get(r.cluster_flow_id) == namespace:
                    self._by_id.pop(r.cluster_flow_id, None)
                    self._ns_by_id.pop(r.cluster_flow_id, None)
            self._by_ns[namespace] = rules
            for r in rules:
                self._by_id[r.cluster_flow_id] = r
                self._ns_by_id[r.cluster_flow_id] = namespace
        if self._on_change:
            self._on_change()
        for fn in list(self._listeners):
            fn()

    def get_by_id(self, flow_id: int) -> Optional[R.ParamFlowRule]:
        return self._by_id.get(flow_id)

    def namespace_of(self, flow_id: int) -> Optional[str]:
        return self._ns_by_id.get(flow_id)

    def all_ids(self) -> List[int]:
        return list(self._by_id.keys())
