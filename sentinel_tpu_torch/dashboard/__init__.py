"""Dashboard-lite (SURVEY §2.6): machine discovery via heartbeats, metric
pull + in-memory repository, rule CRUD proxied to each machine's command
plane, cluster role assignment — the control plane, minus the AngularJS UI.

The port's copy of ``sentinel_tpu/dashboard/__init__.py``; it touches no tensor.
"""

from sentinel_tpu_torch.dashboard.api_client import SentinelApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement, MachineInfo
from sentinel_tpu_torch.dashboard.metric_fetcher import MetricFetcher
from sentinel_tpu_torch.dashboard.repository import InMemoryMetricsRepository
from sentinel_tpu_torch.dashboard.server import (
    DashboardServer,
    DynamicRuleProvider,
    DynamicRulePublisher,
)

__all__ = [
    "SentinelApiClient",
    "AppManagement",
    "MachineInfo",
    "MetricFetcher",
    "InMemoryMetricsRepository",
    "DashboardServer",
    "DynamicRuleProvider",
    "DynamicRulePublisher",
]
