"""Metric fetcher — polls every healthy machine's ``metric`` command.

The analog of MetricFetcher.java:70-88: a loop wakes ~every second, asks
each healthy machine for metric-log lines since the machine's last fetched
second (with a catch-up window capped at ``max_catchup_ms`` — reference 15 s
:74,263-282), and saves parsed nodes into the repository keyed by app.

The port's copy of ``sentinel_tpu/dashboard/metric_fetcher.py``; it touches no tensor.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from sentinel_tpu_torch.dashboard.api_client import SentinelApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement
from sentinel_tpu_torch.dashboard.repository import InMemoryMetricsRepository
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.time_source import wall_ms_now

DEFAULT_INTERVAL_S = 1.0
DEFAULT_MAX_CATCHUP_MS = 15_000

# dashboard self-observability: a silently failing fetch loop used to be
# invisible — the repository just stopped filling.  Now every machine
# pull (metric-log line fetch or /metrics scrape) counts by outcome, and
# the last-success gauge gives alerting a freshness signal.
_FETCH_HELP = "dashboard machine pulls (metric fetch + prometheus scrape) by outcome"
_C_FETCH_OK = _OBS.counter(
    "sentinel_dashboard_fetch_total", _FETCH_HELP, labels={"result": "ok"}
)
_C_FETCH_ERR = _OBS.counter(
    "sentinel_dashboard_fetch_total", _FETCH_HELP, labels={"result": "error"}
)
_G_LAST_SUCCESS = _OBS.gauge(
    "sentinel_dashboard_last_success_ms",
    "wall-clock ms of the dashboard's last successful machine pull",
)


class MetricFetcher:
    def __init__(
        self,
        discovery: AppManagement,
        repository: InMemoryMetricsRepository,
        api: Optional[SentinelApiClient] = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        max_catchup_ms: int = DEFAULT_MAX_CATCHUP_MS,
    ):
        self.discovery = discovery
        self.repository = repository
        self.api = api or SentinelApiClient(timeout_s=2.0)
        self.interval_s = interval_s
        self.max_catchup_ms = max_catchup_ms
        self._last_fetched_ms: Dict[str, int] = {}  # machine key → last second pulled
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fetch_ok = 0
        self.fetch_fail = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="sentinel-tpu-metric-fetcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def fetch_once(self, now_ms: Optional[int] = None) -> int:
        """One sweep over all healthy machines; returns #nodes saved."""
        now_ms = wall_ms_now() if now_ms is None else now_ms
        saved = 0
        for app in self.discovery.apps():
            for m in self.discovery.machines(app, only_healthy=True):
                # fetch up to the PREVIOUS full second — the current second
                # is still being written on the machine
                end = (now_ms // 1000) * 1000 - 1000
                # first fetch looks back the whole catch-up window so a
                # dashboard restart doesn't lose the recent history
                start = self._last_fetched_ms.get(m.key, end - self.max_catchup_ms)
                start = max(start, end - self.max_catchup_ms)
                if start > end:
                    continue
                try:
                    nodes = self.api.fetch_metric(m.ip, m.port, start, end)
                    self.fetch_ok += 1
                    _C_FETCH_OK.inc()
                    _G_LAST_SUCCESS.set(wall_ms_now())
                except OSError:
                    self.fetch_fail += 1
                    _C_FETCH_ERR.inc()
                    continue
                if nodes:
                    self.repository.save_all(app, nodes)
                    saved += len(nodes)
                    self._last_fetched_ms[m.key] = max(n.timestamp for n in nodes) + 1000
                else:
                    self._last_fetched_ms[m.key] = end
        return saved

    def fetch_timelines(
        self,
        resource: Optional[str] = None,
        start_ms: int = 0,
        end_ms: Optional[int] = None,
        app: Optional[str] = None,
    ) -> int:
        """One sweep of every healthy machine's ``GET /api/metric``
        (obs/timeline.py rows), saved into the repository PER MACHINE —
        ``repository.query_timeline`` then merges machines on second
        boundaries with per-machine provenance.  Returns #rows saved;
        unreachable machines are counted in ``fetch_fail``."""
        saved = 0
        apps = [app] if app is not None else self.discovery.apps()
        for a in apps:
            for m in self.discovery.machines(a, only_healthy=True):
                try:
                    rows = self.api.fetch_timeline(
                        m.ip, m.port, resource, start_ms, end_ms
                    )
                    self.fetch_ok += 1
                    _C_FETCH_OK.inc()
                    _G_LAST_SUCCESS.set(wall_ms_now())
                except OSError:
                    self.fetch_fail += 1
                    _C_FETCH_ERR.inc()
                    continue
                if rows:
                    self.repository.save_timeline(a, m.key, rows)
                    saved += len(rows)
        return saved

    def scrape_prometheus(self, app: Optional[str] = None) -> Dict[str, str]:
        """One sweep of every healthy machine's ``GET /metrics`` — the
        obs-plane exposition (tick-stage histograms, pipeline occupancy,
        degrade state) keyed by machine, alongside the metric-log poll.
        Unreachable machines are skipped (counted in ``fetch_fail``)."""
        out: Dict[str, str] = {}
        apps = [app] if app is not None else self.discovery.apps()
        for a in apps:
            for m in self.discovery.machines(a, only_healthy=True):
                try:
                    out[m.key] = self.api.fetch_prometheus(m.ip, m.port)
                    self.fetch_ok += 1
                    _C_FETCH_OK.inc()
                    _G_LAST_SUCCESS.set(wall_ms_now())
                except OSError:
                    self.fetch_fail += 1
                    _C_FETCH_ERR.inc()
        return out

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.fetch_once()
            except Exception:  # noqa: BLE001 — the poll loop must survive anything
                from sentinel_tpu_torch.utils.record_log import record_log

                record_log().exception("metric fetch sweep failed")
