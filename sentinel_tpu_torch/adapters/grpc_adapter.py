"""gRPC interceptors — the RPC adapter.

The analog of sentinel-grpc-adapter's SentinelGrpcServerInterceptor /
SentinelGrpcClientInterceptor (251 LoC): the server side guards inbound
RPCs by full method name and aborts blocked calls with RESOURCE_EXHAUSTED;
the client side guards outbound calls (outbound entry, no origin).
"""

from __future__ import annotations

from typing import Optional

import grpc

from sentinel_tpu_torch.adapters._common import resolve_client
from sentinel_tpu_torch.core import errors as ERR

ORIGIN_METADATA_KEY = "s-user"


class SentinelServerInterceptor(grpc.ServerInterceptor):
    def __init__(self, client=None):
        self._client = client

    def intercept_service(self, continuation, handler_call_details):
        client = resolve_client(self._client)
        resource = handler_call_details.method  # "/pkg.Service/Method"
        origin = ""
        for k, v in handler_call_details.invocation_metadata or ():
            if k == ORIGIN_METADATA_KEY:
                origin = v
                break
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        # wrap the unary-unary behavior (streaming variants pass through the
        # same pattern; reference guards unary calls)
        if not handler.unary_unary:
            return handler

        inner = handler.unary_unary

        def guarded(request, context):
            try:
                entry = client.entry(resource, inbound=True, origin=origin)
            except ERR.BlockException as e:
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED, f"Blocked by Sentinel: {e}"
                )
                return None  # pragma: no cover — abort raises
            try:
                return inner(request, context)
            except Exception as ex:
                entry.trace(ex)
                raise
            finally:
                entry.exit()

        return grpc.unary_unary_rpc_method_handler(
            guarded,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


class SentinelClientInterceptor(grpc.UnaryUnaryClientInterceptor):
    def __init__(self, client=None):
        self._client = client

    def intercept_unary_unary(self, continuation, client_call_details, request):
        client = resolve_client(self._client)
        resource = client_call_details.method
        if isinstance(resource, bytes):
            resource = resource.decode("ascii")
        entry = client.entry(resource, inbound=False)  # raises BlockException
        try:
            call = continuation(client_call_details, request)
        except Exception as e:
            entry.trace(e)
            entry.exit()
            raise
        # exit when the RPC completes so RT covers the wire round-trip
        call.add_done_callback(lambda c: _finish(entry, c))
        return call


def _finish(entry, call) -> None:
    try:
        if call.code() is not None and call.code() != grpc.StatusCode.OK:
            entry.trace(RuntimeError(f"grpc status {call.code()}"))
    except Exception:  # noqa: BLE001
        pass
    entry.exit()
