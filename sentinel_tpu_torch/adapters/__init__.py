"""Adapters: entry points that bridge user traffic into the engine —
decorator, WSGI/ASGI middleware, gRPC interceptors, outbound HTTP client
guards, the chained-resource RPC provider/consumer pattern, the
async-streaming wrapper, and the API-gateway rule/param bridge.

The port of ``sentinel_tpu/adapters``.  Every adapter calls a port
``SentinelClient``'s ``entry()`` / ``entry_async()`` (an explicit
``client=`` or the process-wide one of ``sentinel_tpu_torch.init()``), so
its traffic joins the engine batches of that client's ticks on the card.
The gRPC interceptors (``adapters.grpc_adapter``) import ``grpc`` at
module level and are not exported here, as in the reference."""

from sentinel_tpu_torch.adapters.decorator import sentinel_resource
from sentinel_tpu_torch.adapters.wsgi import SentinelWSGIMiddleware
from sentinel_tpu_torch.adapters.asgi import SentinelASGIMiddleware
from sentinel_tpu_torch.adapters.http_client import (
    SentinelHttpClient,
    guarded_urlopen,
    default_url_resource,
)
from sentinel_tpu_torch.adapters.rpc import (
    consumer_call,
    consumer_entry,
    provider_call,
    provider_entry,
)
from sentinel_tpu_torch.adapters.streaming import (
    guard_aiter,
    guard_awaitable,
    guard_stream,
)
from sentinel_tpu_torch.adapters.gateway import (
    ApiDefinition,
    ApiDefinitionManager,
    ApiPredicateItem,
    GatewayAdapter,
    GatewayFlowRule,
    GatewayParamFlowItem,
    GatewayParamParser,
    GatewayRuleManager,
    RequestAttributes,
    convert_to_param_rule,
)

__all__ = [
    "sentinel_resource",
    "SentinelWSGIMiddleware",
    "SentinelASGIMiddleware",
    "SentinelHttpClient",
    "consumer_call",
    "consumer_entry",
    "provider_call",
    "provider_entry",
    "guard_aiter",
    "guard_awaitable",
    "guard_stream",
    "guarded_urlopen",
    "default_url_resource",
    "ApiDefinition",
    "ApiDefinitionManager",
    "ApiPredicateItem",
    "GatewayAdapter",
    "GatewayFlowRule",
    "GatewayParamFlowItem",
    "GatewayParamParser",
    "GatewayRuleManager",
    "RequestAttributes",
    "convert_to_param_rule",
]
