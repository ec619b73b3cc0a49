"""sentinel_tpu_torch.workload — the serving operating point.

Ported so far: ``operating_point`` (the shared ``OperatingPoint``, which
the overload simulator, adaptive/simload.py, builds its client from).
The traffic shapes, the seeded generator with its traffic sources, and the
SLO-driven autotuner that applies a point live are ROADMAP.md Queue A.
"""

from sentinel_tpu_torch.workload.operating_point import (
    BENCH_WINDOW_EXACT,
    BENCH_WINDOW_MINUTE,
    BENCH_WINDOW_MINUTE_SLACK,
    ENGINE_FIELDS,
    OperatingPoint,
    sim_default_op,
)

__all__ = [
    "BENCH_WINDOW_EXACT",
    "BENCH_WINDOW_MINUTE",
    "BENCH_WINDOW_MINUTE_SLACK",
    "ENGINE_FIELDS",
    "OperatingPoint",
    "sim_default_op",
]
