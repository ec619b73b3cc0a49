"""Per-second metric aggregation → metric log.

The port's copy of ``sentinel_tpu/metrics/timer.py``.

The analog of MetricTimerListener (node/metric/MetricTimerListener.java:34-59):
once per second, snapshot every registered resource's trailing-second window
counters and append active ones to the metric log.

Here, instead of walking a ClusterNode map, the snapshot is ONE batched
device gather over all resource rows (ClientStats.snapshot), so cost is
independent of resource count up to the engine capacity.
"""

from __future__ import annotations

import threading
from typing import Optional

from sentinel_tpu_torch.metrics.node import MetricNode
from sentinel_tpu_torch.utils.time_source import wall_s
from sentinel_tpu_torch.metrics.writer import MetricWriter


class MetricTimerListener:
    def __init__(self, client, writer: MetricWriter):
        self.client = client
        self.writer = writer
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="sentinel-tpu-metric-timer", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.writer.close()

    def run_once(self, now_ms: Optional[int] = None) -> int:
        """Aggregate and write one snapshot; returns #lines written.
        Exposed for tests / virtual-time drives."""
        now_ms = self.client.time.now_ms() if now_ms is None else now_ms
        snap = self.client.stats.snapshot(now_ms)
        # engine time is monotonic-relative; metric lines carry wall-clock
        # stamps so the dashboard/searcher can query by real time
        wall_ms = self.client.time.wall_ms(now_ms)
        # only active resources become MetricNodes: the writer skips the
        # inactive ones anyway, and at 100,000 registered resources the
        # objects alone would take most of the timer's second
        nodes = [
            MetricNode(
                timestamp=wall_ms,
                resource=name,
                pass_qps=s["passQps"],
                block_qps=s["blockQps"],
                success_qps=s["successQps"],
                exception_qps=s["exceptionQps"],
                rt=s["avgRt"],
                occupied_pass_qps=s.get("occupiedPassQps", 0.0),
                concurrency=int(s["curThreadNum"]),
            )
            for name, s in snap.items()
            if s["passQps"] > 0
            or s["blockQps"] > 0
            or s["successQps"] > 0
            or s["exceptionQps"] > 0
            or s.get("occupiedPassQps", 0.0) > 0
            or int(s["curThreadNum"]) > 0
        ]
        self.writer.write(wall_ms, nodes)
        return len(nodes)

    def _loop(self) -> None:
        while not self._stop.is_set():
            # align to the wall-second boundary so each line covers one
            # whole second (the scheduled-at-fixed-rate 1 s cadence)
            delay = 1.0 - (wall_s() % 1.0)
            if self._stop.wait(delay + 0.01):
                break
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — aggregation must never kill the loop
                from sentinel_tpu_torch.utils.record_log import record_log

                record_log().exception("metric timer aggregation failed")
