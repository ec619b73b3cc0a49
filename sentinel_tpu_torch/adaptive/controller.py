"""Closed-loop system-adaptive protection controller.

The reference's SystemSlot is an *adaptive* gate — ``checkBbr`` admits
new work only while concurrency fits ``maxSuccessQps × minRt`` — but it
still needs an operator-authored ``SystemRule`` to arm it.  This
controller closes the loop: each engine tick it folds the live
``SystemSignals`` row into a BBR-style capacity estimate and republishes
the SystemSlot ceilings as fresh values of the existing rule-tensor
columns (``SystemTensors.qps`` / ``max_thread``).  The columns are
ordinary tensor arguments of the tick, so new values are a five-scalar
upload (``ops/engine.replace_system_columns``: staged in pinned memory
and copied behind an event on the card, no host sync) — **no rebuilt
tick**.

Control law (AIMD around the BBR estimate):

* capacity estimate ``cap = max_pass_rate × max(min_rt, floor) / 1000``
  — admitted throughput at its recent best times the windowed RT floor,
  i.e. the concurrency the pipe fits (checkBbr's product, host side);
* overloaded ticks multiply the concurrency ceiling by ``shrink``
  (never below ``min_ceiling`` — the controller must not choke the very
  traffic that re-measures capacity);
* healthy ticks grow it by ``grow`` toward ``cap × headroom`` so a
  recovered system re-opens quickly but never past what it measured;
* the QPS column follows via Little's law (``ceiling × 1000 / min_rt``).

The same pressure verdict drives the unified degrade ladder
(``degrade.DegradeLadder``); the runtime applies each rung's effect
(shed low-priority, param tail off, cluster fallback, fail closed).
Everything runs in ENGINE time off the signals row — fully
deterministic under a VirtualTimeSource, which is what lets the overload
simulator (adaptive/simload.py) replay a storm exactly.

The port's copy of ``sentinel_tpu/adaptive/controller.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from sentinel_tpu_torch.adaptive import degrade as DG
from sentinel_tpu_torch.adaptive.signals import SignalCollector, SystemSignals
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS

_G_CEILING = _OBS.gauge(
    "sentinel_adaptive_ceiling",
    "live adaptive concurrency ceiling (maxPass x minRT; -1 while unarmed)",
)


@dataclass(frozen=True)
class AdaptiveConfig:
    """Tuning knobs; the defaults suit millisecond ticks."""

    #: overloaded when service RT runs this many times above the floor
    rt_tolerance: float = 5.0
    #: un-ticked admission queue depth that counts as overload
    queue_high: int = 4096
    #: host CPU fraction that counts as overload
    cpu_high: float = 0.95
    #: ceiling may probe up to cap × headroom while healthy
    headroom: float = 2.0
    #: multiplicative decrease per overloaded control step
    shrink: float = 0.9
    #: multiplicative increase per healthy control step
    grow: float = 1.05
    #: concurrency floor — capacity re-measurement must keep flowing
    min_ceiling: float = 8.0
    #: minRT floor (ms): a sub-ms RT must not collapse the BBR product
    min_rt_floor_ms: float = 1.0
    #: re-upload threshold — skip the device transfer for <5% moves
    update_epsilon: float = 0.05
    #: ladder hysteresis (engine-time ms)
    climb_hold_ms: int = 200
    cool_hold_ms: int = 1000
    #: fraction of queue_high where non-prioritized work starts shedding
    #: at SHED_LOW_PRIORITY and above
    shed_lowprio_frac: float = 0.5
    #: hard admission bound (items); beyond it every submit sheds
    queue_max: int = 65536
    #: treat sustained blocking as overload evidence when
    #: block_rate > ratio × pass_rate (0 disables — a rule-heavy service
    #: blocking by POLICY must not read as overload by default)
    block_pressure_ratio: float = 0.0
    #: long-memory capacity estimate: per control step the stored
    #: estimate decays by this factor unless re-measured higher.  The 1 s
    #: signal window alone forgets healthy capacity the moment the gate
    #: starts suppressing traffic; the slow decay keeps the BBR product
    #: anchored at what the system actually served when it was well.
    cap_decay: float = 0.999
    #: AIMD adjustment cadence (engine-time ms): shrink/grow act at most
    #: once per interval, not once per tick — a 1 ms tick train must not
    #: multiply the ceiling to the floor within one RT window
    adjust_interval_ms: int = 50


class AdaptiveController:
    """One per client; the tick loop drives ``on_tick`` once per tick."""

    def __init__(self, cfg: Optional[AdaptiveConfig] = None):
        self.cfg = cfg or AdaptiveConfig()
        self.signals = SignalCollector()
        self.ladder = DG.DegradeLadder(
            climb_hold_ms=self.cfg.climb_hold_ms,
            cool_hold_ms=self.cfg.cool_hold_ms,
        )
        #: live concurrency ceiling; inf = unarmed (no overload seen and
        #: nothing measured yet — the gate stays open)
        self.ceiling = float("inf")
        #: long-memory BBR capacity estimate (concurrency units)
        self.cap_est = 0.0
        # None = never adjusted (engine clocks may legitimately start at
        # 0, so 0 cannot be the sentinel)
        self._last_adjust_ms: Optional[int] = None
        self._uploaded = (-1.0, -1.0)  # (qps, max_thread) last published
        self.last: SystemSignals = SystemSignals()
        self._severe_pending = False
        _G_CEILING.set(-1)

    def disarm(self) -> None:
        """Full reset at disable: gate open, ladder down, gauges back to
        their unarmed values (a disabled plane must not keep reporting
        an armed ceiling on /metrics)."""
        self.ceiling = float("inf")
        self.cap_est = 0.0
        self._last_adjust_ms = None
        self._uploaded = (-1.0, -1.0)
        self.ladder.reset()
        _G_CEILING.set(-1)

    # -- external severity hints --------------------------------------------

    def note_severe(self) -> None:
        """A watchdog fire / fail-closed tick: escalate on the next
        observation without waiting out the climb hold."""
        self._severe_pending = True

    # -- control step --------------------------------------------------------

    def overloaded(self, s: SystemSignals) -> bool:
        c = self.cfg
        if s.queue_depth > c.queue_high:
            return True
        if s.sys_cpu > c.cpu_high and s.inflight > c.min_ceiling:
            # host CPU saturation counts only WITH traffic pressure — a
            # busy co-tenant must not climb the ladder of an idle service
            return True
        floor = max(s.min_rt_ms, c.min_rt_floor_ms)
        if (
            s.min_rt_ms > 0
            and s.rt_ewma_ms > c.rt_tolerance * floor
            and s.inflight > c.min_ceiling
        ):
            return True
        if (
            c.block_pressure_ratio > 0
            and s.block_rate > c.block_pressure_ratio * max(s.pass_rate, 1.0)
        ):
            return True
        return False

    def on_tick(self, s: SystemSignals):
        """One control step.  Returns the (qps, max_thread) pair to
        publish into the system columns, or None when the last upload
        still stands (within ``update_epsilon``)."""
        self.last = s
        c = self.cfg
        over = self.overloaded(s)
        severe = self._severe_pending
        self._severe_pending = False
        self.ladder.observe(s.now_ms, over or severe, severe=severe)

        min_rt = max(s.min_rt_ms, c.min_rt_floor_ms)
        cap_now = s.max_pass_rate * min_rt / 1000.0  # BBR: maxPass × minRT
        # long-memory capacity: re-measure up, decay down slowly — the
        # gate's own suppression must not erase what the pipe fits
        self.cap_est = max(cap_now, self.cap_est * c.cap_decay)
        cap = self.cap_est
        adjust = (
            self._last_adjust_ms is None
            or s.now_ms - self._last_adjust_ms >= c.adjust_interval_ms
        )
        if over:
            if self.ceiling == float("inf"):
                # arm at the measured capacity (not current inflight —
                # that is exactly the runaway value being cut back)
                self.ceiling = max(cap, c.min_ceiling)
                self._last_adjust_ms = s.now_ms
            elif adjust:
                self.ceiling = max(self.ceiling * c.shrink, c.min_ceiling)
                self._last_adjust_ms = s.now_ms
        elif self.ceiling != float("inf") and adjust:
            limit = cap * c.headroom if cap > 0 else self.ceiling * c.grow
            self.ceiling = min(self.ceiling * c.grow, max(limit, c.min_ceiling))
            self._last_adjust_ms = s.now_ms
            if self.ladder.level == DG.NORMAL and cap > 0 and (
                self.ceiling >= cap * c.headroom
            ):
                # fully recovered and re-opened: disarm (gate off) so a
                # long-healthy system pays zero admission friction
                self.ceiling = float("inf")

        if self.ceiling == float("inf"):
            want = (-1.0, -1.0)
        else:
            qps = self.ceiling * 1000.0 / min_rt
            want = (qps, self.ceiling)
        _G_CEILING.set(-1 if want[1] < 0 else want[1])
        prev = self._uploaded
        if want == prev:
            return None
        if want[1] > 0 and prev[1] > 0:
            rel = abs(want[1] - prev[1]) / prev[1]
            if rel < c.update_epsilon:
                return None
        self._uploaded = want
        return want

    # -- rung effects (read by the runtime's admission path) -----------------

    @property
    def level(self) -> int:
        return self.ladder.level

    def system_columns(
        self, static, qps: float, max_thread: float
    ):
        """Fold the adaptive ceilings into a static ``SystemTensors``:
        tightest-wins per column (an operator rule stricter than the
        controller keeps enforcing, via the same fold
        ``compile_system_rules`` uses), adaptive values replace unset
        statics.  Returns plain ``np.float32`` leaves (the engine stages
        them for the upload)."""
        from sentinel_tpu_torch.core.rule_tensors import tightest_threshold

        return type(static)(
            load=np.float32(static.load),
            cpu=np.float32(static.cpu),
            qps=tightest_threshold(static.qps, qps),
            avg_rt=np.float32(static.avg_rt),
            max_thread=tightest_threshold(static.max_thread, max_thread),
        )
