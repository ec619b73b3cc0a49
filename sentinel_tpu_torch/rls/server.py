"""Envoy RLS gRPC server.

The port of ``sentinel_tpu/rls/server.py``.  Implements
``envoy.service.ratelimit.v2.RateLimitService/ShouldRateLimit`` (the
reference's SentinelEnvoyRlsServiceImpl.java + SentinelRlsGrpcServer.java):
each request descriptor resolves to a cluster flowId through the rule
manager and is decided through the token service, whose decisions run on
its decision client's device; any over-limit descriptor makes the
overall verdict OVER_LIMIT, and a decision that raises fails CLOSED
(OVER_LIMIT, counted under ``code="error"``).

grpc_tools (stub codegen) is not needed: the service is registered through
a generic handler with the protoc-built message classes (``rls_pb2``) —
the same wire behaviour as a generated servicer.  This module needs
``grpcio`` and ``protobuf``; ``sentinel_tpu_torch.rls`` imports it lazily.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import grpc

from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.rls import rls_pb2 as pb
from sentinel_tpu_torch.rls.rules import EnvoyRlsRuleManager
from sentinel_tpu_torch.utils.record_log import record_log
from sentinel_tpu_torch.utils.time_source import mono_s

SERVICE_NAME = "envoy.service.ratelimit.v2.RateLimitService"

#: rate limit for the fail-closed error log (the error counter carries
#: the rate; the log carries the traceback)
_ERROR_LOG_INTERVAL_S = 10.0
_error_log_lock = threading.Lock()
_last_error_log_s = -_ERROR_LOG_INTERVAL_S

_H_DECISION = _OBS.histogram(
    "sentinel_rls_decision_ms",
    "ShouldRateLimit request latency (descriptor resolution + token "
    "round-trips to the owning shards)",
)
_C_REQUESTS = {
    code: _OBS.counter(
        "sentinel_rls_requests_total",
        "ShouldRateLimit verdicts served by the RLS front door, by "
        "overall code (error = decision raised and was converted to "
        "OVER_LIMIT: the front door fails closed)",
        labels={"code": code},
    )
    for code in ("ok", "over_limit", "error")
}


class SentinelEnvoyRlsService:
    """The ShouldRateLimit decision logic (unary-unary).

    ``token_service`` is anything with the TokenService surface: a local
    ``DefaultTokenService`` (single token server, the embedded shape) or
    a ``ShardedTokenClient``/``ShardFleet.client`` — then each resolved
    flow id routes through the consistent-hash ring to its owning shard,
    and external Envoy traffic is governed by the fleet without linking
    the library.  Unmatched descriptors and unknown domains return OK
    (the reference's semantics); any over-limit descriptor makes the
    overall verdict OVER_LIMIT.
    """

    def __init__(self, token_service, rule_manager: Optional[EnvoyRlsRuleManager] = None):
        self.token_service = token_service
        self.rules = rule_manager or EnvoyRlsRuleManager(token_service)

    def should_rate_limit(self, request: pb.RateLimitRequest, context=None) -> pb.RateLimitResponse:
        _t = OT.t0()
        try:
            rsp = self._traced_decide(request, _t)
        except Exception:
            # converted to OVER_LIMIT: an escaping exception reaches Envoy as
            # UNKNOWN, and Envoy's default failure_mode admits the request
            # unmetered — the front door fails CLOSED instead
            global _last_error_log_s
            now = mono_s()
            if now - _last_error_log_s >= _ERROR_LOG_INTERVAL_S:
                # rate-limited: a persistently broken decision path must
                # be diagnosable, not just an error-counter blip
                with _error_log_lock:
                    if now - _last_error_log_s >= _ERROR_LOG_INTERVAL_S:
                        _last_error_log_s = now
                        record_log().exception(
                            "RLS decision failed; failing CLOSED (OVER_LIMIT)"
                        )
            _C_REQUESTS["error"].inc()
            rsp = pb.RateLimitResponse()
            rsp.overall_code = pb.RateLimitResponse.OVER_LIMIT
            return rsp
        _C_REQUESTS[
            "over_limit"
            if rsp.overall_code == pb.RateLimitResponse.OVER_LIMIT
            else "ok"
        ].inc()
        return rsp

    def _traced_decide(self, request: pb.RateLimitRequest, _t) -> pb.RateLimitResponse:
        if not _t:
            rsp = self._decide(request)
        else:
            # front-door span: mint (or adopt) a wire trace id and install
            # it as the ambient context, so every downstream cluster RPC
            # span (ClusterTokenClient._roundtrip) parents to this span —
            # the merged Perfetto dump then shows one request's
            # client → RLS → shard timeline as a single flow
            tid = OT.current_ctx()[0] or OT.new_trace_id()
            sid = OT.new_span_id()
            with OT.trace_ctx(tid, sid):
                rsp = self._decide(request)
            OT.stage(
                "rls.should_rate_limit",
                _t,
                _H_DECISION,
                trace=tid,
                attrs={
                    "span_id": sid,
                    "domain": request.domain,
                    "descriptors": len(request.descriptors),
                    "over_limit": rsp.overall_code == pb.RateLimitResponse.OVER_LIMIT,
                },
            )
        return rsp

    def _decide(self, request: pb.RateLimitRequest) -> pb.RateLimitResponse:
        hits = request.hits_addend or 1
        rsp = pb.RateLimitResponse()
        overall = pb.RateLimitResponse.OK
        # resolve every descriptor up front: a multi-descriptor request
        # against a sharded fleet then rides ONE batched token exchange
        # per owning shard (request_token_many groups by ring owner and
        # sends a protocol-v2 batch frame) instead of paying a blocking
        # round-trip per descriptor
        resolved = [
            self.rules.lookup_flow_id(
                request.domain, [(e.key, e.value) for e in desc.entries]
            )
            for desc in request.descriptors
        ]
        idxs = [i for i, fid in enumerate(resolved) if fid is not None]
        many = getattr(self.token_service, "request_token_many", None)
        results = {}
        if many is not None and len(idxs) > 1:
            batch = many([(resolved[i], hits) for i in idxs])
            results = dict(zip(idxs, batch))
        else:
            for i in idxs:
                results[i] = self.token_service.request_token(
                    resolved[i], hits, False
                )
        for i, _desc in enumerate(request.descriptors):
            status = rsp.statuses.add()
            if resolved[i] is None:
                # no rule for this descriptor → not limited (reference
                # returns OK for unmatched descriptors)
                status.code = pb.RateLimitResponse.OK
                continue
            r = results[i]
            if r.status in (C.STATUS_OK, C.STATUS_NO_RULE):
                # NO_RULE happens when a concurrent rule push removed the
                # flow id between lookup and check — unmatched descriptors
                # fail open, same as the fid-is-None path above
                status.code = pb.RateLimitResponse.OK
                status.limit_remaining = max(r.remaining, 0)
            else:
                # BLOCKED, and also FAIL/TOO_MANY from a tokenless backend:
                # the front door fails CLOSED on ambiguity (a fleet-backed
                # service already converts shard failure into a lease
                # fallback verdict before it reaches here)
                status.code = pb.RateLimitResponse.OVER_LIMIT
                overall = pb.RateLimitResponse.OVER_LIMIT
        rsp.overall_code = overall
        return rsp


class SentinelRlsGrpcServer:
    """gRPC front door (SentinelRlsGrpcServer.java analog)."""

    def __init__(
        self,
        token_service,
        host: str = "0.0.0.0",
        port: int = 0,
        workers: int = 8,
        rule_manager: Optional[EnvoyRlsRuleManager] = None,
    ):
        self.service = SentinelEnvoyRlsService(token_service, rule_manager)
        self._server = grpc.server(ThreadPoolExecutor(max_workers=workers))
        handler = grpc.method_handlers_generic_handler(
            SERVICE_NAME,
            {
                "ShouldRateLimit": grpc.unary_unary_rpc_method_handler(
                    self.service.should_rate_limit,
                    request_deserializer=pb.RateLimitRequest.FromString,
                    response_serializer=pb.RateLimitResponse.SerializeToString,
                )
            },
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    @property
    def rules(self) -> EnvoyRlsRuleManager:
        return self.service.rules

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)


def make_channel_stub(address: str):
    """Client-side helper: callable for ShouldRateLimit on a channel
    (tests and smoke checks; Envoy itself is the production client)."""
    channel = grpc.insecure_channel(address)
    fn = channel.unary_unary(
        f"/{SERVICE_NAME}/ShouldRateLimit",
        request_serializer=pb.RateLimitRequest.SerializeToString,
        response_deserializer=pb.RateLimitResponse.FromString,
    )
    return channel, fn
