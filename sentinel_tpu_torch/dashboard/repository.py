"""In-memory metrics repository — 5-minute retention ring of MetricNodes.

The analog of InMemoryMetricsRepository: the metric fetcher saves parsed
MetricNode entries keyed (app, resource, second); queries serve the UI's
per-resource charts and the top-N resource listing.

The port's copy of ``sentinel_tpu/dashboard/repository.py``; it touches no tensor.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List

from sentinel_tpu_torch.metrics.node import MetricNode

DEFAULT_RETENTION_MS = 5 * 60 * 1000


class InMemoryMetricsRepository:
    def __init__(self, retention_ms: int = DEFAULT_RETENTION_MS):
        self.retention_ms = retention_ms
        # app -> resource -> {second_ts -> MetricNode}
        self._data: Dict[str, Dict[str, Dict[int, MetricNode]]] = defaultdict(
            lambda: defaultdict(dict)
        )
        # app -> machine -> resource -> {second_ts -> timeline row dict}
        # (the /api/metric channel, kept per machine — see save_timeline)
        self._timelines: Dict[str, Dict[str, Dict[str, Dict[int, dict]]]] = {}
        self._lock = threading.Lock()

    def save_all(self, app: str, nodes: List[MetricNode]) -> None:
        if not nodes:
            return
        with self._lock:
            per_app = self._data[app]
            for n in nodes:
                prev = per_app[n.resource].get(n.timestamp)
                if prev is not None:
                    # multiple machines of one app in the same second → sum
                    prev.pass_qps += n.pass_qps
                    prev.block_qps += n.block_qps
                    prev.success_qps += n.success_qps
                    prev.exception_qps += n.exception_qps
                    prev.occupied_pass_qps += n.occupied_pass_qps
                    prev.concurrency += n.concurrency
                    prev.rt = max(prev.rt, n.rt)
                else:
                    per_app[n.resource][n.timestamp] = n
            self._trim(per_app, max(n.timestamp for n in nodes))

    def query(self, app: str, resource: str, start_ms: int, end_ms: int) -> List[MetricNode]:
        per_res = self._data.get(app, {}).get(resource, {})
        return [per_res[t] for t in sorted(per_res) if start_ms <= t <= end_ms]

    def resources_of(self, app: str) -> List[str]:
        return sorted(self._data.get(app, {}))

    def top_resources(self, app: str, start_ms: int, end_ms: int, limit: int = 30) -> List[str]:
        """Resources ranked by total pass+block volume in the range
        (queryTopResourceMetric's ordering)."""
        totals: Dict[str, float] = {}
        for resource, per_res in self._data.get(app, {}).items():
            v = sum(
                n.pass_qps + n.block_qps
                for t, n in per_res.items()
                if start_ms <= t <= end_ms
            )
            if v > 0:
                totals[resource] = v
        ranked = sorted(totals, key=lambda r: (-totals[r], r))
        return ranked[:limit]

    def _trim(self, per_app: Dict[str, Dict[int, MetricNode]], now_ms: int) -> None:
        cutoff = now_ms - self.retention_ms
        for per_res in per_app.values():
            for t in [t for t in per_res if t < cutoff]:
                del per_res[t]

    # -- per-machine timelines (obs/timeline.py rows) ------------------------

    def save_timeline(self, app: str, machine: str, rows: List[dict]) -> None:
        """Store fetched ``/api/metric`` rows keyed (app, machine,
        resource, second) — machines stay separate so queries can merge
        with per-machine provenance (or inspect one machine)."""
        if not rows:
            return
        with self._lock:
            per_m = self._timelines.setdefault(app, {}).setdefault(machine, {})
            newest = 0
            for r in rows:
                per_m.setdefault(r["resource"], {})[int(r["ts"])] = dict(r)
                newest = max(newest, int(r["ts"]))
            cutoff = newest - self.retention_ms
            for per_res in per_m.values():
                for t in [t for t in per_res if t < cutoff]:
                    del per_res[t]

    def query_timeline(
        self, app: str, resource: str, start_ms: int, end_ms: int
    ) -> List[dict]:
        """Fleet view of one resource's timeline: machines aligned on
        second boundaries and summed (obs.fleet.merge_timelines — each
        merged row's ``sources`` maps machine → pass+block volume)."""
        from sentinel_tpu_torch.obs.fleet import merge_timelines

        with self._lock:
            per_source = {
                machine: [
                    dict(row)
                    for t, row in sorted(per_m.get(resource, {}).items())
                    if start_ms <= t <= end_ms
                ]
                for machine, per_m in self._timelines.get(app, {}).items()
            }
        return merge_timelines(per_source)

    def timeline_machines(self, app: str) -> List[str]:
        with self._lock:
            return sorted(self._timelines.get(app, {}))
