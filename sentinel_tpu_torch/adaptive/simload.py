"""Deterministic flash-crowd simulator for the adaptive plane.

Drives a REAL sync-mode ``SentinelClient`` on virtual time through a
healthy → 2×-capacity storm → recovery schedule, with a queueing service
model on top: admitted requests enter a FIFO backend that serves at most
``capacity_per_step`` of them per step, each taking ``base_svc_steps``
more steps to finish — latency is queue wait plus service.  Offered
load under capacity rides at base latency; 2× capacity with unbounded
admission grows the queue linearly and latency collapses (a request
p99 near a second, reproduced in miniature), while
the adaptive gate bounds in-flight work at the BBR product and keeps
latency flat at ~capacity goodput.  Everything is engine-time
pure: the same inputs replay the same admissions, ladder transitions and
latencies — on the CPU and on the card alike, which is what lets one run
be held to the other field for field.

The port's copy of ``sentinel_tpu/adaptive/simload.py``.  The client runs
on ``device`` (the card unless the caller asks for the CPU) and on the
reference's config, ``small_engine_config()`` — the plain effects path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def storm_controller_preset(op=None):
    """Controller tuning for the simulator's scales: host-CPU input
    disabled (a busy host must not steer the ladder — this is what keeps
    the simulation deterministic), blocking pressure on (the sim's
    overload shows up as sustained shedding), engine-time holds sized to
    the 10 ms step.

    ``op`` is the serving ``workload.OperatingPoint`` (default
    ``sim_default_op()``): the admission queue bound follows its pipeline
    depth, so the preset cannot drift from the point the simulation
    runs."""
    from sentinel_tpu_torch.adaptive.controller import AdaptiveConfig

    if op is None:
        from sentinel_tpu_torch.workload.operating_point import sim_default_op

        op = sim_default_op()
    return AdaptiveConfig(
        rt_tolerance=3.0,
        cpu_high=2.0,
        min_ceiling=4.0,
        climb_hold_ms=50,
        cool_hold_ms=300,
        block_pressure_ratio=1.0,
        queue_max=int(op.pipeline_depth),
    )


@dataclass
class SimResult:
    p99_healthy_ms: float = 0.0
    p99_storm_ms: float = 0.0
    goodput_healthy: float = 0.0  # completions/step over the healthy tail
    goodput_storm: float = 0.0  # completions/step over the storm window
    #: min rolling-window completions while the ladder sat BELOW
    #: FAIL_CLOSED (the "goodput never hits zero" invariant input)
    goodput_floor: float = 0.0
    submitted: int = 0
    passed: int = 0
    blocked: int = 0
    final_level: int = 0
    max_level: int = 0
    ladder_transitions: List[tuple] = field(default_factory=list)
    max_inflight: int = 0

    def to_dict(self) -> dict:
        return {
            "p99_healthy_ms": round(self.p99_healthy_ms, 3),
            "p99_storm_ms": round(self.p99_storm_ms, 3),
            "goodput_healthy_per_step": round(self.goodput_healthy, 3),
            "goodput_storm_per_step": round(self.goodput_storm, 3),
            "goodput_floor": round(self.goodput_floor, 3),
            "submitted": self.submitted,
            "passed": self.passed,
            "blocked": self.blocked,
            "final_level": self.final_level,
            "max_level": self.max_level,
            "ladder_transitions": len(self.ladder_transitions),
            "max_inflight": self.max_inflight,
        }


def run_overload_sim(
    adaptive: bool = True,
    adaptive_cfg=None,
    healthy_steps: int = 100,
    storm_steps: int = 200,
    recover_steps: int = 120,
    step_ms: int = 10,
    offered_healthy: int = 3,
    offered_storm: int = 8,
    capacity_per_step: int = 4,
    base_svc_steps: int = 2,
    prio_every: int = 2,
    resource: str = "storm/api",
    op=None,
    device=None,
) -> SimResult:
    """One full healthy→storm→recover run; see module docstring.

    ``op`` (a ``workload.OperatingPoint``, default ``sim_default_op()`` —
    identity against the small config) decides the client's engine
    config and pipeline depth.  ``device``: where the client runs (the
    card by default; ``"cpu"`` on a host without one)."""
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    if op is None:
        from sentinel_tpu_torch.workload.operating_point import sim_default_op

        op = sim_default_op()
    vt = VirtualTimeSource(start_ms=1_000)
    client = SentinelClient(
        cfg=op.apply_to_config(small_engine_config()),
        time_source=vt,
        mode="sync",
        pipeline_depth=op.pipeline_depth,
        device=device,
    )
    client.start()
    rid = client.registry.resource_id(resource)
    assert rid is not None
    ad = client.enable_adaptive(adaptive_cfg) if adaptive else None

    out = SimResult()
    backlog: List[int] = []  # FIFO of submit_step awaiting a server slot
    in_service: List[tuple] = []  # (done_step, submit_step)
    lat_healthy: List[float] = []
    lat_storm: List[float] = []
    per_step_completed: List[int] = []
    per_step_level: List[int] = []
    total_steps = healthy_steps + storm_steps + recover_steps
    storm_lo, storm_hi = healthy_steps, healthy_steps + storm_steps

    def offered_at(step: int) -> int:
        if step >= total_steps:
            return 0  # drain phase
        return offered_storm if storm_lo <= step < storm_hi else offered_healthy

    step = 0
    max_steps = total_steps + 4000  # drain bound (queue collapse is long)
    while step < max_steps:
        # 1) completions due this step (one bulk completion tick)
        done = [e for e in in_service if e[0] <= step]
        if done:
            in_service[:] = [e for e in in_service if e[0] > step]
            k = len(done)
            lat = np.asarray(
                [(step - sub) * step_ms for _due, sub in done], np.float32
            )
            client.submit_completion_block(
                res=np.full(k, rid, np.int32),
                rt=lat,
                success=np.ones(k, np.int32),
                inbound=np.ones(k, np.int32),
            )
            per_step_completed.append(k)
            for _due, sub in done:
                l = float((step - sub) * step_ms)
                if sub < storm_lo:
                    lat_healthy.append(l)
                elif sub < storm_hi:
                    lat_storm.append(l)
        else:
            per_step_completed.append(0)
        per_step_level.append(ad.ladder.level if ad is not None else 0)

        # 2) the backend serves at most capacity_per_step queued requests
        for _ in range(min(capacity_per_step, len(backlog))):
            in_service.append((step + base_svc_steps, backlog.pop(0)))

        # 3) offered load (one bulk decision tick)
        n = offered_at(step)
        if n:
            prio = [(i % prio_every) == 0 for i in range(n)]
            verdicts = client.check_batch(
                [resource] * n, prioritized=prio, inbound=True
            )
            out.submitted += n
            for v, _w in verdicts:
                if v in (ERR.PASS, ERR.PASS_WAIT):
                    out.passed += 1
                    backlog.append(step)
                else:
                    out.blocked += 1
            out.max_inflight = max(
                out.max_inflight, len(backlog) + len(in_service)
            )
        elif not backlog and not in_service:
            break  # drained
        vt.advance(step_ms)
        step += 1

    if ad is not None:
        out.final_level = ad.ladder.level
        out.ladder_transitions = list(ad.ladder.transitions)
        out.max_level = max(
            (t[2] for t in out.ladder_transitions), default=0
        )
    client.stop()

    def p99(xs: List[float]) -> float:
        return float(np.percentile(np.asarray(xs), 99)) if xs else 0.0

    out.p99_healthy_ms = p99(lat_healthy)
    out.p99_storm_ms = p99(lat_storm)
    tail = per_step_completed[max(storm_lo - 50, 0) : storm_lo]
    out.goodput_healthy = float(np.mean(tail)) if tail else 0.0
    storm_done = per_step_completed[storm_lo:storm_hi]
    out.goodput_storm = float(np.mean(storm_done)) if storm_done else 0.0
    # rolling 10-step goodput floor while the ladder sat below FAIL_CLOSED
    # (healthy warm-up excluded; completions only start after the first
    # service time anyway)
    from sentinel_tpu_torch.adaptive.degrade import FAIL_CLOSED

    win = 10
    floors = []
    comp = per_step_completed
    for i in range(storm_lo, min(len(comp), total_steps) - win):
        if all(lv < FAIL_CLOSED for lv in per_step_level[i : i + win]):
            floors.append(sum(comp[i : i + win]))
    out.goodput_floor = float(min(floors)) if floors else 0.0
    return out
