"""sentinel_tpu_torch.workload — seeded workload engine and the
closed-loop live autotuner (the port's copy of ``sentinel_tpu/workload``).

Three layers, importable independently:

* :mod:`~sentinel_tpu_torch.workload.shapes` — pure-arithmetic traffic
  shapes (diurnal, flash crowd, Zipf churn, hot-param flood, skewed keys);
* :mod:`~sentinel_tpu_torch.workload.generator` — the seeded
  deterministic offered-event stream, the drivers that push it through
  the real adapters (``drive_client``, ``drive_gateway``, ``drive_asgi``,
  ``drive_streaming``, ``drive_grpc``), and the queueing service model
  that turns real verdicts into modeled request latencies;
* :mod:`~sentinel_tpu_torch.workload.tuner` /
  :mod:`~sentinel_tpu_torch.workload.operating_point` — the SLO-burn
  driven autotuner that retunes the shared ``OperatingPoint`` LIVE
  (``SentinelClient.apply_operating_point``), guarded by the retrace
  journal and the memory ledger (obs/profile.py).
"""

from sentinel_tpu_torch.workload.generator import (
    OfferedEvent,
    ServiceBackend,
    ServiceModel,
    TrafficGenerator,
    drive_asgi,
    drive_client,
    drive_gateway,
    drive_grpc,
    drive_streaming,
)
from sentinel_tpu_torch.workload.operating_point import (
    BENCH_WINDOW_EXACT,
    BENCH_WINDOW_MINUTE,
    BENCH_WINDOW_MINUTE_SLACK,
    ENGINE_FIELDS,
    OperatingPoint,
    sim_default_op,
)
from sentinel_tpu_torch.workload.shapes import (
    Constant,
    Diurnal,
    FlashCrowd,
    HotParamFlood,
    SkewedKeys,
    WorkloadSpec,
    ZipfKeys,
    flash_crowd_2x,
)
from sentinel_tpu_torch.workload.tuner import (
    AutoTuner,
    LoopResult,
    TunerConfig,
    run_closed_loop,
    workload_slos,
)

__all__ = [
    "AutoTuner",
    "BENCH_WINDOW_EXACT",
    "BENCH_WINDOW_MINUTE",
    "BENCH_WINDOW_MINUTE_SLACK",
    "Constant",
    "Diurnal",
    "ENGINE_FIELDS",
    "FlashCrowd",
    "HotParamFlood",
    "LoopResult",
    "OfferedEvent",
    "OperatingPoint",
    "ServiceBackend",
    "ServiceModel",
    "SkewedKeys",
    "TrafficGenerator",
    "TunerConfig",
    "WorkloadSpec",
    "ZipfKeys",
    "drive_asgi",
    "drive_client",
    "drive_gateway",
    "drive_grpc",
    "drive_streaming",
    "flash_crowd_2x",
    "run_closed_loop",
    "sim_default_op",
    "workload_slos",
]
