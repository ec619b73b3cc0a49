"""Metric log reader — time-range queries over the writer's files.

The port's copy of ``sentinel_tpu/metrics/searcher.py``.

The analog of MetricSearcher (node/metric/MetricSearcher.java:34,84-113):
used by the ``metric`` command handler (SendMetricCommandHandler.java:41-43)
to serve the dashboard's catch-up pull.  The ``.idx`` companion file maps
second-timestamps to byte offsets so queries seek, not scan.
"""

from __future__ import annotations

import os
from typing import List, Optional

from sentinel_tpu_torch.metrics.node import MetricNode
from sentinel_tpu_torch.metrics.writer import list_metric_files


def _read_idx(path: str):
    """[(second_ms, offset)] for one metric file, or [] if no idx."""
    idx_path = path + ".idx"
    out = []
    if not os.path.exists(idx_path):
        return out
    with open(idx_path, "r", encoding="utf-8") as f:
        for line in f:
            try:
                sec, off = line.split()
                out.append((int(sec), int(off)))
            except ValueError:
                continue
    return out


class MetricSearcher:
    def __init__(self, base_dir: str, app_name: str):
        self.base_dir = base_dir
        self.app_name = app_name

    def find(self, begin_ms: int, recommended_count: int = 6000) -> List[MetricNode]:
        """Nodes with timestamp >= begin_ms, up to recommended_count —
        but never truncating mid-second (MetricSearcher.find contract:
        all lines of the last included second are returned)."""
        out: List[MetricNode] = []
        for path in list_metric_files(self.base_dir, self.app_name):
            idx = _read_idx(path)
            if idx and idx[-1][0] < begin_ms:
                continue  # whole file before range
            offset = _seek_offset(idx, begin_ms)
            for node in _iter_file(path, offset):
                if node.timestamp < begin_ms:
                    continue
                if len(out) >= recommended_count and node.timestamp != out[-1].timestamp:
                    return out
                out.append(node)
        return out

    def find_by_time_and_resource(
        self, begin_ms: int, end_ms: int, resource: Optional[str] = None
    ) -> List[MetricNode]:
        out: List[MetricNode] = []
        for path in list_metric_files(self.base_dir, self.app_name):
            idx = _read_idx(path)
            if idx and idx[-1][0] < begin_ms:
                continue
            offset = _seek_offset(idx, begin_ms)
            for node in _iter_file(path, offset):
                if node.timestamp < begin_ms:
                    continue
                if node.timestamp > end_ms:
                    break
                if resource is None or node.resource == resource:
                    out.append(node)
        return out


def _seek_offset(idx, begin_ms: int) -> int:
    """Greatest indexed offset whose second <= begin_ms (binary search)."""
    lo, hi, best = 0, len(idx) - 1, 0
    while lo <= hi:
        mid = (lo + hi) // 2
        if idx[mid][0] <= begin_ms:
            best = idx[mid][1]
            lo = mid + 1
        else:
            hi = mid - 1
    return best


def _iter_file(path: str, offset: int):
    try:
        with open(path, "r", encoding="utf-8") as f:
            f.seek(offset)
            for line in f:
                try:
                    yield MetricNode.from_line(line)
                except ValueError:
                    continue
    except OSError:
        return
