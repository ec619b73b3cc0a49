"""Cluster role management (ClusterStateManager.java:38-137).

The port's copy of ``sentinel_tpu/cluster/state.py``.

A process is NOT_STARTED, a token CLIENT (remote server), or a token SERVER
(embedded: serves the network *and* its own in-process traffic).  Roles flip
at runtime; the manager owns the lifecycle of the underlying client/server
objects and exposes the TokenService the local runtime should consult for
cluster-mode rules.
"""

from __future__ import annotations

import threading
from typing import Optional

from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.cluster.client import ClusterTokenClient
from sentinel_tpu_torch.cluster.rules import ClusterClientConfigManager
from sentinel_tpu_torch.cluster.server import ClusterTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService, TokenService

CLUSTER_NOT_STARTED = -1
CLUSTER_CLIENT = 0
CLUSTER_SERVER = 1


class ClusterStateManager:
    def __init__(self, client_config: Optional[ClusterClientConfigManager] = None):
        self.mode = CLUSTER_NOT_STARTED
        self.client_config = client_config or ClusterClientConfigManager()
        self._lock = threading.Lock()
        self._token_client: Optional[ClusterTokenClient] = None
        self._server: Optional[ClusterTokenServer] = None
        self._embedded: Optional[DefaultTokenService] = None

    # -- queries -------------------------------------------------------------

    def token_service(self) -> Optional[TokenService]:
        """The TokenService local cluster-mode rules should consult."""
        if self.mode == CLUSTER_CLIENT:
            return self._token_client
        if self.mode == CLUSTER_SERVER:
            return self._embedded
        return None

    def is_available(self) -> bool:
        svc = self.token_service()
        if svc is None:
            return False
        if isinstance(svc, ClusterTokenClient):
            return svc.connected or svc._ensure_connected()
        return True

    # -- transitions ---------------------------------------------------------

    def set_to_client(
        self,
        host: Optional[str] = None,
        port: Optional[int] = None,
        namespace: str = C.DEFAULT_NAMESPACE,
    ) -> None:
        with self._lock:
            # keep the token service so a later set_to_server (dashboard
            # re-assignment) can revive this machine as a server
            if self._embedded is not None:
                self._last_service = self._embedded
            self._stop_server_locked()
            if host is not None:
                self.client_config.apply_assign(host, port or C.DEFAULT_PORT)
            a = self.client_config.assign
            if self._token_client is not None:
                self._token_client.close()
            self._token_client = ClusterTokenClient(
                a.host,
                a.port,
                namespace=namespace,
                timeout_ms=self.client_config.request_timeout_ms,
            )
            self._token_client.start()
            self.mode = CLUSTER_CLIENT

    def set_to_sharded_client(
        self,
        members,
        namespace: str = C.DEFAULT_NAMESPACE,
        **sharded_kw,
    ) -> None:
        """Become a client of an N-shard token FLEET (cluster/shard.py):
        cluster-mode rules consult a ``ShardedTokenClient`` that routes
        each flow to its ring owner.  Failover lives INSIDE the sharded
        client: a dead shard's flows serve from its bounded-slack lease
        and then fail CLOSED — always STATUS_BLOCKED, never STATUS_FAIL
        — so the runtime's cluster-degrade hysteresis and rules'
        ``cluster_fallback_to_local`` do NOT engage behind a fleet.  A
        total-fleet outage blocks cluster-ruled traffic rather than
        reverting to unmetered local enforcement (token conservation
        over availability, the fleet's fail-closed-on-ambiguity law).

        Lease sizing needs the flow thresholds: feed the same rules the
        shard servers hold through ``token_service().flow_rules.load``
        (the client's built-in threshold-learning facade) — without them
        every flow's lease is zero and shard failover fails closed
        immediately."""
        from sentinel_tpu_torch.cluster.shard import ShardedTokenClient

        with self._lock:
            if self._embedded is not None:
                self._last_service = self._embedded
            self._stop_server_locked()
            if self._token_client is not None:
                self._token_client.close()
            sharded_kw.setdefault(
                "timeout_ms", self.client_config.request_timeout_ms
            )
            self._token_client = ShardedTokenClient(
                dict(members),
                namespace=namespace,
                **sharded_kw,
            )
            self._token_client.start()
            self.mode = CLUSTER_CLIENT

    def set_to_server(
        self,
        token_service: DefaultTokenService,
        port: Optional[int] = None,
        serve_network: bool = True,
    ) -> None:
        """Become an (embedded) token server: local traffic consults the
        in-process service directly (DefaultEmbeddedTokenServer)."""
        with self._lock:
            if self._token_client is not None:
                self._token_client.close()
                self._token_client = None
            # idempotent: a machine already in server mode (dashboard
            # re-assign) must not double-bind its port
            self._stop_server_locked()
            self._embedded = token_service
            self._last_service = token_service
            if serve_network:
                self._server = ClusterTokenServer(token_service, port=port)
                self._server.start()
            self.mode = CLUSTER_SERVER

    def stop(self) -> None:
        with self._lock:
            if self._token_client is not None:
                self._token_client.close()
                self._token_client = None
            self._stop_server_locked()
            self._embedded = None
            self.mode = CLUSTER_NOT_STARTED

    def _stop_server_locked(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None

    @property
    def server(self) -> Optional[ClusterTokenServer]:
        return self._server
