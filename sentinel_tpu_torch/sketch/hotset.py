"""Hot-set manager: the host half of the sketch tier's promotion loop.

The port's copy of ``sentinel_tpu/sketch/hotset.py``.  The device tick
emits the wire's hot block (``TickOutput.hot``) — the top-K sketched resource
ids of each batch by windowed pass estimate (engine._device_hot_
candidates).  This manager folds those rows into a small candidate map,
and on a fixed cadence:

  PROMOTE   sketched resources whose estimate holds above
            ``hotset_promote_qps`` claim an exact row
            (Registry.promote_resource) — exact windows, exact rule
            enforcement, every grade servable.
  DEMOTE    rows the manager promoted whose EXACT windowed pass falls
            below ``hotset_demote_qps`` for two consecutive evaluations
            return to the sketch tail; the freed row quarantines until
            its window state has rotated out, then feeds later
            promotions.

Flap damping reuses ``adaptive.degrade.Hysteresis``: a demotion arms a
``hotset-cooldown`` per resource, and promotion is skipped while it
cools — the same enter/cooldown/exit shape every other degrade site in
the tree shares.  Promotions, failed promotions and cooldowns are counted
on the metrics and journalled in the flight recorder (``obs/flight.py``:
``hotset.promote``, ``hotset.promote_fail``, ``hotset-cooldown.enter`` /
``.exit``).

Failure contract (chaos-verified, ``runtime.hotset.promote``): a failed
promotion fails OPEN for statistics — the resource simply stays in the
sketch tier, still observed — and CLOSED for tail-rule verdicts — its
rules keep enforcing from the tail threshold tables, whose CMS
overestimate blocks early, never late.  Promotion is an optimization;
its failure must never widen admission.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import numpy as np

from sentinel_tpu_torch.adaptive.degrade import Hysteresis
from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.time_source import mono_s

_FP_PROMOTE = FP.register(
    "runtime.hotset.promote",
    "hot-set promotion of a sketched resource into the exact tier; a "
    "raise fails the promotion (stats fail open, tail verdicts stay "
    "closed)",
)

_C_PROMOTIONS = _OBS.counter(
    "sentinel_sketch_promotions_total",
    "sketched resources promoted into the exact tier (hot-set manager + rule loads)",
)
_C_PROMOTE_FAIL = _OBS.counter(
    "sentinel_sketch_promotion_failures_total",
    "failed promotions (injected or real); the resource stays sketched — "
    "stats fail open, tail-rule verdicts stay closed",
)
_C_DEMOTIONS = _OBS.counter(
    "sentinel_sketch_demotions_total",
    "cold promoted rows returned to the sketch tail",
)
_G_CANDIDATES = _OBS.gauge(
    "sentinel_sketch_hot_candidates",
    "sketched resources currently tracked as promotion candidates",
)
_G_MERGED = _OBS.gauge(
    "sentinel_sketch_merged_words",
    "salsa counter words above int8 width (saturation merges) across the sketch",
)
_G_EPS = _OBS.gauge(
    "sentinel_sketch_epsilon",
    "current per-read CMS error bound as a fraction of window volume "
    "(e / effective_width; effective width shrinks as words merge)",
)


def guarded_promote(registry, name: str) -> Optional[int]:
    """Registry.promote_resource behind the ``runtime.hotset.promote``
    failpoint — the ONE promotion entry point (hot-set manager and
    rule-load promotion both route here).  On failure the resource stays
    sketched: statistics fail OPEN (sketch keeps observing it) and
    tail-rule verdicts stay CLOSED (the tail tables keep enforcing)."""
    was = registry.peek_resource_id(name)
    try:
        FP.hit(_FP_PROMOTE)
        row = registry.promote_resource(name)
    except Exception:  # promotion is an optimization: the resource keeps its sketch id
        _C_PROMOTE_FAIL.inc()
        FL.note("hotset.promote_fail", resource=name)
        return None
    if (
        row is not None
        and was is not None
        and registry.is_sketch_id(was)
        and not registry.is_sketch_id(row)
    ):
        _C_PROMOTIONS.inc()
        FL.note("hotset.promote", resource=name, row=row)
    return row


class HotSetManager:
    """Folds device hot-candidate rows and runs the promote/demote loop.

    ``fold`` runs on the tick-resolver hot path (a handful of dict writes
    under one lock); ``maybe_evaluate`` is a cheap cadence gate called
    once per tick iteration; the real work happens at ``hotset_eval_s``
    intervals."""

    def __init__(self, client):
        from sentinel_tpu_torch.ops import engine as E

        self._c = client
        cfg = client.cfg
        self._lock = threading.Lock()
        self._eval_lock = threading.Lock()  # serializes evaluate_now bodies
        self._cand: Dict[int, float] = {}  # sketch id -> folded estimate (QPS)
        self._cap = max(8 * int(cfg.hotset_k), 64)
        # TickOutput.hot carries WINDOWED pass sums; candidates are kept in
        # QPS so hotset_promote_qps and the demote side's passQps read
        # (both per-second) stay in one unit regardless of sketch window
        self._interval_s = E.sketch_config(cfg).interval_ms / 1000.0
        self._last_eval = 0.0
        self._cool: Dict[str, Hysteresis] = {}
        self._cold: Dict[str, int] = {}  # consecutive cold evaluations
        self._eval_n = 0
        self._promoted_at: Dict[str, int] = {}  # name -> promoting eval
        #: names this manager promoted -> exact row (only these demote)
        self.promoted: Dict[str, int] = {}
        # quarantine must outlive every window holding the old occupant
        # AND any in-flight entries on the old row (their completion would
        # land on the row's new tenant).  2x the longest window interval
        # plus a flat margin covers both with headroom; entries that
        # outlive even that are clamped to >= 0 by the release path, so
        # the residual skew is bounded and one-sided (under-concurrency)
        spans = [cfg.second_sample_count * cfg.second_window_ms / 1000.0]
        if cfg.enable_minute_window:
            spans.append(cfg.minute_sample_count * cfg.minute_window_ms / 1000.0)
        self._quarantine_s = 2.0 * max(spans) + 30.0

    # -- tick-path fold ------------------------------------------------------

    def fold(self, hot: np.ndarray) -> None:
        """Fold one TickOutput.hot matrix ([K, 2]: id, estimate).

        Fast-attack / slow-decay: a candidate's folded value jumps to any
        higher estimate immediately and halves once per evaluation, so a
        one-tick spike can promote but a faded resource drops out."""
        node_rows = self._c.cfg.node_rows
        with self._lock:
            for rid_f, est in hot:
                if est <= 0.0 or rid_f < node_rows:
                    continue
                rid = int(rid_f)
                qps = float(est) / self._interval_s
                if qps > self._cand.get(rid, 0.0):
                    self._cand[rid] = qps
            if len(self._cand) > self._cap:
                keep = sorted(
                    self._cand.items(), key=lambda kv: kv[1], reverse=True
                )[: self._cap]
                self._cand = dict(keep)

    # -- evaluation loop -----------------------------------------------------

    def maybe_evaluate(self) -> None:
        # check-and-stamp under the lock: sync-mode clients call tick_once
        # (and so this) from many request threads, and two winners would
        # run concurrent promote/demote passes
        now = mono_s()
        with self._lock:
            if now - self._last_eval < self._c.cfg.hotset_eval_s:
                return
            self._last_eval = now
        self.evaluate_now()

    def evaluate_now(self) -> None:
        """One promote/demote pass (tests call this directly — the cadence
        gate above uses real time, which virtual-time tests bypass).
        Serialized on its own lock: the body mutates the promote/demote
        bookkeeping outside ``self._lock`` (which fold's hot path takes)."""
        with self._eval_lock:
            self._evaluate_locked()  # stlint: disable=blocking-under-lock — hot-set promotion is an off-tick maintenance pass single-flighted by _eval_lock; its recompile must be atomic vs a concurrent evaluate

    def _evaluate_locked(self) -> None:
        c = self._c
        cfg = c.cfg
        reg = c.registry
        with self._lock:
            snapshot = sorted(
                self._cand.items(), key=lambda kv: kv[1], reverse=True
            )
            # decay toward zero so candidates must keep re-earning heat
            self._cand = {
                rid: v / 2.0 for rid, v in self._cand.items() if v >= 1.0
            }
        _G_CANDIDATES.set(len(snapshot))

        self._eval_n += 1
        recompile = False
        for rid, est in snapshot:
            if est < cfg.hotset_promote_qps:
                break  # sorted — nothing colder qualifies
            name = reg.resource_name(rid)
            if name is None or not reg.is_sketch_id(
                reg.peek_resource_id(name) or 0
            ):
                continue  # renamed away or already promoted (rule load)
            hys = self._cool.get(name)
            if hys is not None and hys.cooling:
                continue  # demoted recently; let the cooldown lapse
            row = guarded_promote(reg, name)
            if row is None or reg.is_sketch_id(row):
                continue  # reserve spent or promotion failed — stays tail
            self.promoted[name] = row
            self._promoted_at[name] = self._eval_n
            self._cold.pop(name, None)
            if hys is not None:
                hys.exit()
            if self._is_ruled(name):
                recompile = True

        recompile = self._demote_cold() or recompile
        if recompile:
            # move rules between the tail tables and exact rows
            c._recompile_rules()
        # bound the per-name bookkeeping: cooldowns that lapsed on names
        # no longer promoted, and cold/promoted-at stamps for rows that
        # left the hot set, would otherwise grow for the process lifetime
        for name in [
            n for n, h in self._cool.items()
            if not h.cooling and n not in self.promoted
        ]:
            self._cool.pop(name, None)
        for d in (self._cold, self._promoted_at):
            for name in [n for n in d if n not in self.promoted]:
                d.pop(name, None)
        self._publish_sketch_health()

    def _is_ruled(self, name: str) -> bool:
        c = self._c
        return any(
            r.resource == name
            for r in c.flow_rules.get() + c.degrade_rules.get()
        )

    def _demote_cold(self) -> bool:
        """Demote promoted rows cold for two consecutive evaluations.
        Returns True when a ruled resource moved (caller recompiles)."""
        c = self._c
        cfg = c.cfg
        moved = False
        for name in list(self.promoted):
            rid = c.registry.peek_resource_id(name)
            if rid is None or c.registry.is_sketch_id(rid):
                self.promoted.pop(name, None)  # demoted elsewhere
                continue
            if self._promoted_at.get(name, 0) >= self._eval_n:
                # promoted THIS evaluation: the exact row has not had a
                # window to accumulate stats yet — grade it next time
                continue
            try:
                qps = float(c.stats.resource(name).get("passQps", 0.0))
            except Exception:  # skips this check only: the row stays exact
                continue
            if qps >= cfg.hotset_demote_qps:
                self._cold.pop(name, None)
                continue
            cold = self._cold.get(name, 0) + 1
            self._cold[name] = cold
            if cold < 2:
                continue
            new_id = c.registry.demote_resource(name, self._quarantine_s)
            if new_id is None or not c.registry.is_sketch_id(new_id):
                continue
            self.promoted.pop(name, None)
            self._cold.pop(name, None)
            _C_DEMOTIONS.inc()
            hys = self._cool.get(name)
            if hys is None:
                hys = self._cool[name] = Hysteresis(
                    "hotset-cooldown",
                    cfg.hotset_cooldown_s,
                    attrs={"resource": name},
                )
            hys.enter()
            if self._is_ruled(name):
                moved = True
        return moved

    def _publish_sketch_health(self) -> None:
        """Merged-word + error-bound gauges (salsa tier only): effective
        width shrinks as words merge, widening eps = e / width_eff."""
        cfg = self._c.cfg
        if not cfg.sketch_salsa:
            _G_EPS.set(math.e / cfg.sketch_width)
            return
        try:
            from sentinel_tpu_torch.ops import engine as E
            from sentinel_tpu_torch.sketch import salsa as SA

            # computed under _engine_lock like every host-side gs reader (the
            # tick updates the sketch's ring in place); read back after it:
            # a later tick's updates queue behind the histogram on the stream
            with self._c._engine_lock:
                hist = SA.level_histogram(self._c._state.gs, E.sketch_config(cfg))
            hist = hist.cpu().numpy()
        except Exception:  # health gauges only
            return
        n0, n1, n2 = (float(x) for x in hist)
        total = max(n0 + n1 + n2, 1.0)
        width_eff = cfg.sketch_width * (n0 + n1 / 2.0 + n2 / 4.0) / total
        _G_MERGED.set(n1 + n2)
        _G_EPS.set(math.e / max(width_eff, 1.0))
