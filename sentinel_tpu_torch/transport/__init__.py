"""Transport / command plane (SURVEY §2.4): per-instance HTTP command
center, built-in command handlers, heartbeat to the dashboard, and the
writable-datasource write-back registry.

The port's copy of ``sentinel_tpu/transport``."""

from sentinel_tpu_torch.transport.command import (
    CommandRegistry,
    CommandRequest,
    CommandResponse,
    command_mapping,
)
from sentinel_tpu_torch.transport.handlers import DefaultHandlerGroup, build_default_handlers
from sentinel_tpu_torch.transport.http_server import DEFAULT_PORT, SimpleHttpCommandCenter
from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender
from sentinel_tpu_torch.transport.writable_registry import (
    WritableDataSourceRegistry,
    default_registry,
)


def start_command_center(
    client,
    cluster=None,
    metric_searcher=None,
    writable_registry=None,
    host=None,
    port: int = DEFAULT_PORT,
    auth_token=None,
) -> SimpleHttpCommandCenter:
    """Build the default handler set and serve it (CommandCenterInitFunc).

    Binds loopback by default; pass ``host='0.0.0.0'`` (ideally with
    ``auth_token``) to serve the dashboard across machines.
    """
    registry = build_default_handlers(client, cluster, metric_searcher, writable_registry)
    center = SimpleHttpCommandCenter(registry, host=host, port=port, auth_token=auth_token)
    center.start()
    return center


__all__ = [
    "CommandRegistry",
    "CommandRequest",
    "CommandResponse",
    "command_mapping",
    "DefaultHandlerGroup",
    "build_default_handlers",
    "SimpleHttpCommandCenter",
    "HeartbeatSender",
    "WritableDataSourceRegistry",
    "default_registry",
    "start_command_center",
    "DEFAULT_PORT",
]
