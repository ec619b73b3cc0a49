"""Per-tick system signals for the closed-loop controller.

``SignalCollector`` turns what the tick loop already knows — queue
depths, batch sizes, the completion columns' RT minima, the obs plane's
stage histograms and gauges, cluster RPC failure counters, and the
host's load/CPU sample — into one ``SystemSignals`` row per tick,
without locks on the hot path:

* the tick thread is the only writer of the EWMA/ring state
  (``observe_tick``); readers get a consistent-enough snapshot the same
  way the span tracer's ring does — torn reads cost one stale sample,
  never a crash;
* the resolver pool feeds verdict counts through ``note_resolved``
  (plain int adds under the GIL — a lost increment skews one tick's
  rate by <1%, which the EWMA smooths out anyway);
* percentile reads come from the existing ``obs`` histograms — the
  client's ``sentinel_tick_device_ms`` (runtime/client.py: dispatch to
  the wire host-visible, recorded while tracing is on) — the collector
  never keeps its own histogram.

Windowed extrema (BBR's maxPass and minRT) ride small fixed rings of
per-tick values in ENGINE time, so the whole collector is deterministic
under a VirtualTimeSource.  Disabled mode costs nothing: a client
without adaptive protection never constructs a collector, and its tick
hook is one ``is None`` check (guarded by a <5 µs test).

The port's copy of ``sentinel_tpu/adaptive/signals.py``: pure host code
over the port's own registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS

#: ring length for windowed max-pass-rate / min-RT (per-tick samples);
#: at a 1 ms tick this spans ~64 ms of saturated serving, and idle ticks
#: stretch it — plenty against the 1 s admission windows it feeds
_RING = 64


@dataclass
class SystemSignals:
    """One tick's view of system health (the controller's input row)."""

    now_ms: int = 0
    #: un-ticked acquire queue depth at drain time
    queue_depth: int = 0
    #: dispatched-but-unresolved engine ticks / in-flight readbacks
    pipeline_occupancy: int = 0
    resolver_queue_depth: int = 0
    #: admitted (PASS/PASS_WAIT) vs blocked items per second, windowed
    pass_rate: float = 0.0
    block_rate: float = 0.0
    #: BBR inputs: best recent admitted rate and the windowed RT floor
    max_pass_rate: float = 0.0
    min_rt_ms: float = 0.0
    #: EWMA of completion RT (the "how slow is service NOW" signal)
    rt_ewma_ms: float = 0.0
    #: host-estimated in-flight entries (admitted minus completed)
    inflight: float = 0.0
    #: cluster RPC failures per second (all kinds), windowed
    rpc_fail_rate: float = 0.0
    #: device-stage p99 from the obs histogram (0 when tracing is off)
    device_p99_ms: float = 0.0
    #: host sample (utils/system_status.py)
    sys_load: float = 0.0
    sys_cpu: float = 0.0


class SignalCollector:
    """Lock-light EWMA / windowed-extrema state behind ``SystemSignals``."""

    def __init__(self, ewma_alpha: float = 0.2):
        self.alpha = float(ewma_alpha)
        self.rt_ewma_ms = 0.0
        self.inflight = 0.0
        self._pass_total = 0
        self._block_total = 0
        self._comp_total = 0
        self._rpc_fail_prev = 0.0
        # per-tick rings: (now_ms, cumulative pass, cumulative block) for
        # rates, per-tick completion RT minima for the windowed floor
        self._rate_ring = [(0, 0, 0)] * _RING
        self._rate_i = 0
        self._rt_min_ring = [float("inf")] * _RING
        self._rt_i = 0
        self._last_now_ms = 0
        # last device telemetry row's windowed RT floor / pass sum
        # (runtime/client feeds these from TickOutput.stats; they back the
        # ring-based floor when no completion batch fed it this window)
        self._dev_min_rt = 0.0
        self._dev_win_pass = 0.0
        # the labeled cluster RPC failure counters already on the global
        # registry; get-or-create returns the live instances
        self._rpc_fail_counters = [
            _OBS.counter(
                "sentinel_cluster_rpc_failures_total",
                "token-server round-trips that degraded, by failure kind "
                "(connect|send|timeout|conn_lost|decode)",
                labels={"kind": k},
            )
            for k in ("connect", "send", "timeout", "conn_lost", "decode")
        ]
        self._dev_hist = _OBS.histogram(
            "sentinel_tick_device_ms",
            "dispatch to verdicts-host-visible per tick (device compute + "
            "transfer; includes pipeline queue wait)",
        )

    # -- feeders (tick thread / resolver pool) -------------------------------

    def note_resolved(self, passed: int, blocked: int) -> None:
        """Per-tick verdict counts from the resolver (any thread)."""
        self._pass_total += int(passed)
        self._block_total += int(blocked)

    def note_device_stats(self, row) -> None:
        """One device telemetry row (ops/engine.STAT_* float32 vector,
        already host-resident — runtime/client reads it back with the
        verdicts).  The on-device ENTRY-window RT floor and pass sum are
        kept as fallbacks: a verdict-only workload (no completion batches)
        otherwise never feeds the BBR minRT input."""
        from sentinel_tpu_torch.ops import engine as E
        from sentinel_tpu_torch.ops import window as W

        mn = float(row[E.STAT_WIN_RT_MIN])
        self._dev_min_rt = 0.0 if mn >= W.RT_MIN_INIT else mn
        self._dev_win_pass = float(row[E.STAT_WIN_PASS])

    def note_completions(self, n: int, rt_min_ms: float) -> None:
        """Completion batch summary from the tick loop's batch assembly."""
        self._comp_total += int(n)
        if n > 0:
            a = self.alpha
            self.rt_ewma_ms = (
                rt_min_ms
                if self.rt_ewma_ms == 0.0
                else (1 - a) * self.rt_ewma_ms + a * rt_min_ms
            )
            i = self._rt_i
            self._rt_min_ring[i & (_RING - 1)] = float(rt_min_ms)
            self._rt_i = i + 1

    # -- snapshot (tick thread, once per tick) -------------------------------

    def observe_tick(
        self,
        now_ms: int,
        queue_depth: int,
        pipeline_occupancy: int,
        resolver_queue_depth: int,
        sys_load: float,
        sys_cpu: float,
    ) -> SystemSignals:
        i = self._rate_i
        ring = self._rate_ring
        ring[i & (_RING - 1)] = (int(now_ms), self._pass_total, self._block_total)
        self._rate_i = i + 1
        # windowed rates against the OLDEST ring sample ≤1 s back (engine
        # time); the ring naturally spans less when ticks are sparse
        anchor_ms, anchor_pass, anchor_blk = ring[(i + 1) & (_RING - 1)]
        span_ms = max(now_ms - anchor_ms, 1)
        if span_ms > 1000:
            # walk forward to the newest sample still ≥1 s old so a long
            # idle gap doesn't dilute the rate to ~0 and unlearn capacity
            for k in range(2, _RING):
                t_ms, p, b = ring[(i + k) & (_RING - 1)]
                if now_ms - t_ms <= 1000:
                    break
                anchor_ms, anchor_pass, anchor_blk = t_ms, p, b
            span_ms = max(now_ms - anchor_ms, 1)
        pass_rate = (self._pass_total - anchor_pass) * 1000.0 / span_ms
        block_rate = (self._block_total - anchor_blk) * 1000.0 / span_ms
        # max pass rate: best adjacent-sample rate in the ring window
        # (maxSuccessQps's "best bucket" shape, host side)
        max_rate = pass_rate
        prev = None
        for k in range(1, _RING):
            t_ms, p, _b = ring[(i + k) & (_RING - 1)]
            if prev is not None and t_ms > prev[0] and now_ms - t_ms <= 1000:
                r = (p - prev[1]) * 1000.0 / (t_ms - prev[0])
                if r > max_rate:
                    max_rate = r
            prev = (t_ms, p)
        rt_floor = min(self._rt_min_ring)
        rpc_now = sum(c.value for c in self._rpc_fail_counters)
        rpc_rate = (rpc_now - self._rpc_fail_prev) * 1000.0 / max(
            now_ms - self._last_now_ms, 1
        ) if self._last_now_ms else 0.0
        self._rpc_fail_prev = rpc_now
        self._last_now_ms = int(now_ms)
        self.inflight = max(float(self._pass_total - self._comp_total), 0.0)
        return SystemSignals(
            now_ms=int(now_ms),
            queue_depth=int(queue_depth),
            pipeline_occupancy=int(pipeline_occupancy),
            resolver_queue_depth=int(resolver_queue_depth),
            pass_rate=pass_rate,
            block_rate=block_rate,
            max_pass_rate=max_rate,
            min_rt_ms=(
                self._dev_min_rt if rt_floor == float("inf") else rt_floor
            ),
            rt_ewma_ms=self.rt_ewma_ms,
            inflight=self.inflight,
            rpc_fail_rate=max(rpc_rate, 0.0),
            device_p99_ms=(
                self._dev_hist.quantile(0.99) if self._dev_hist.count else 0.0
            ),
            sys_load=float(sys_load),
            sys_cpu=float(sys_cpu),
        )
