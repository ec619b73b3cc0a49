"""Metric line codec — the analog of the reference's MetricNode.

The port's copy of ``sentinel_tpu/metrics/node.py``.

One line per (second, resource), written to the app metric log and parsed
back by the searcher / dashboard fetcher (reference:
sentinel-core/src/main/java/com/alibaba/csp/sentinel/node/metric/MetricNode.java).

Line format (all counts are totals within the stamped second, so count ==
QPS for that second, as in the reference):

    timestamp|yyyy-mm-dd HH:MM:SS|resource|pass|block|success|exception|rt|occupiedPass|concurrency|classification

Resource names are percent-encoded so ``|`` and newlines can never break
the framing (the reference forbids them instead).
"""

from __future__ import annotations

import time
import urllib.parse
from dataclasses import dataclass, field


@dataclass
class MetricNode:
    timestamp: int = 0  # ms, second-aligned
    resource: str = ""
    pass_qps: float = 0.0
    block_qps: float = 0.0
    success_qps: float = 0.0
    exception_qps: float = 0.0
    rt: float = 0.0  # average RT over the second, ms
    occupied_pass_qps: float = 0.0
    concurrency: int = 0
    classification: int = 0

    def is_active(self) -> bool:
        return (
            self.pass_qps > 0
            or self.block_qps > 0
            or self.success_qps > 0
            or self.exception_qps > 0
            or self.occupied_pass_qps > 0
            or self.concurrency > 0
        )

    def to_line(self) -> str:
        ts = self.timestamp
        human = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts / 1000.0))
        res = urllib.parse.quote(self.resource, safe="")
        nums = "|".join(
            _fmt(v)
            for v in (
                self.pass_qps,
                self.block_qps,
                self.success_qps,
                self.exception_qps,
                self.rt,
                self.occupied_pass_qps,
            )
        )
        return f"{ts}|{human}|{res}|{nums}|{self.concurrency}|{self.classification}"

    @staticmethod
    def from_line(line: str) -> "MetricNode":
        parts = line.rstrip("\n").split("|")
        if len(parts) != 11:
            raise ValueError(f"bad metric line ({len(parts)} fields): {line!r}")
        return MetricNode(
            timestamp=int(parts[0]),
            resource=urllib.parse.unquote(parts[2]),
            pass_qps=float(parts[3]),
            block_qps=float(parts[4]),
            success_qps=float(parts[5]),
            exception_qps=float(parts[6]),
            rt=float(parts[7]),
            occupied_pass_qps=float(parts[8]),
            concurrency=int(parts[9]),
            classification=int(parts[10]),
        )


def _fmt(v: float) -> str:
    # integers print bare, fractions keep precision — keeps files compact
    return str(int(v)) if float(v).is_integer() else repr(float(v))
