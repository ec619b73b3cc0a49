"""The serving operating point as ONE shared frozen dataclass.

The knobs that decide how the engine is driven — batch size, pipeline
depth, sketch window shape, ``slack_frac``, audit cadence — in one
definition its consumers share, so the point a simulation or a benchmark
runs and the point a client serves cannot silently drift:

* **the overload simulator** (``adaptive/simload.py``) builds its client
  from it, and its controller preset (``storm_controller_preset``)
  derives its queue bound from the same point;
* the live retune (``SentinelClient.apply_operating_point``) and the
  autotuner over it come with ``workload/`` (ROADMAP.md, Queue A).

Engine-built knobs (batch / sketch shape) are separated from host-only
knobs (pipeline depth, audit cadence) because applying them costs very
differently: the former rebuild the tick and migrate the state, the
latter are a plain attribute write.

The port's copy of ``sentinel_tpu/workload/operating_point.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

#: EngineConfig fields an OperatingPoint owns — exactly the knobs a
#: LIVE retune may change (see ops/engine.migrate_state's contract).
ENGINE_FIELDS: Tuple[str, ...] = (
    "batch_size",
    "complete_batch_size",
    "sketch_sample_count",
    "sketch_window_ms",
    "sketch_slack_frac",
)


@dataclass(frozen=True)
class OperatingPoint:
    """One serving configuration the simulator, a benchmark and a client
    agree on."""

    # engine-built knobs (changing any rebuilds the tick)
    batch_size: int = 2048
    complete_batch_size: int = 2048
    sketch_sample_count: int = 0  # 0 inherits the second window shape
    sketch_window_ms: int = 0
    sketch_slack_frac: float = 0.05
    # host-only knobs (applied without touching the traced program)
    pipeline_depth: int = 0
    audit_period: int = 16

    @classmethod
    def from_engine_config(
        cls, cfg: Any, pipeline_depth: int = 0, audit_period: int = 16
    ) -> "OperatingPoint":
        """The point a config already runs at (identity apply)."""
        return cls(
            pipeline_depth=int(pipeline_depth),
            audit_period=int(audit_period),
            **{f: getattr(cfg, f) for f in ENGINE_FIELDS},
        )

    def engine_changes(self, cfg: Any) -> Dict[str, Any]:
        """The EngineConfig field replacements this point requires on
        top of ``cfg`` — empty when the compiled program can stay."""
        return {
            f: getattr(self, f)
            for f in ENGINE_FIELDS
            if getattr(self, f) != getattr(cfg, f)
        }

    def apply_to_config(self, cfg: Any) -> Any:
        changes = self.engine_changes(cfg)
        return dataclasses.replace(cfg, **changes) if changes else cfg

    def replace(self, **kw: Any) -> "OperatingPoint":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        """Compact stable label (decision journals, bench rows)."""
        return (
            f"b{self.batch_size}/c{self.complete_batch_size}"
            f"/p{self.pipeline_depth}"
            f"/s{self.sketch_sample_count}x{self.sketch_window_ms}ms"
            f"@{self.sketch_slack_frac:g}/a{self.audit_period}"
        )


def sim_default_op() -> OperatingPoint:
    """The small-config point the overload simulator drives — identity
    against ``small_engine_config()``, so the shared definition changes no
    seeded result."""
    from sentinel_tpu_torch.core.config import small_engine_config

    return OperatingPoint.from_engine_config(small_engine_config())


#: the reference benchmark's window-compare rows: the exact-tier
#: second-window shape and the minute-scale rotation shape with and
#: without slack.
BENCH_WINDOW_EXACT = OperatingPoint(
    batch_size=4096,
    complete_batch_size=4096,
    sketch_sample_count=10,
    sketch_window_ms=100,
    sketch_slack_frac=0.0,
)
BENCH_WINDOW_MINUTE = BENCH_WINDOW_EXACT.replace(
    sketch_sample_count=60, sketch_window_ms=1000
)
BENCH_WINDOW_MINUTE_SLACK = BENCH_WINDOW_MINUTE.replace(
    sketch_slack_frac=0.05
)
