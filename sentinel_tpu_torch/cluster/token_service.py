"""Cluster token decision service.

The port of ``sentinel_tpu/cluster/token_service.py``.  The reference's
token server answers requestToken(flowId, count, priority) with a verdict
from a per-rule ClusterMetric sliding window
(DefaultTokenService.java:34-44 → ClusterFlowChecker.acquireClusterToken:55-88).

Here each cluster flowId is interned as a resource (``$cluster/flow/<id>``)
on a dedicated decision ``SentinelClient``, and token verdicts ride that
client's device: by default the batched token column
(``TokenColumnBatcher``, ops/token_col.py — one decision call per chunk
of 256 entries, the column's state on ``decision_client.device``), or,
with ``use_token_column=False``, the decision client's own engine
(``submit_acquire`` / ``check_batch``), where concurrent requests from
many connections coalesce into one micro-batch tick.  The global
threshold ``count × (1 if thresholdType==GLOBAL else connectedCount) ×
exceedCount`` (ClusterFlowChecker.java:38,68) is recomputed and pushed
whenever rules or the connection census change.

Host-side pieces (naturally request-scoped, not tensor-shaped):
  * GlobalRequestLimiter — per-namespace QPS guard
    (GlobalRequestLimiter.java:28, RequestLimiter.java:29-39)
  * ConcurrentTokenManager — cluster-wide concurrency tokens with TTL expiry
    (ConcurrentClusterFlowChecker.java:34-81, CurrentConcurrencyManager,
    TokenCacheNodeManager, RegularExpireStrategy)

A failed decision is STATUS_FAIL at every caller: the caller degrades to
its local rules, never passes.  The column's state is claimed in the
memory ledger (``obs/profile``) as the reference claims it.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.cluster.rules import (
    ClusterFlowRuleManager,
    ClusterParamFlowRuleManager,
    ClusterServerConfigManager,
    flow_resource,
    param_resource,
)
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.obs import profile as PROF
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.host_window import HostWindow

def _torch():
    """torch, imported where the column runs: the codec and the client
    import this module, and need no torch."""
    import torch

    return torch


_H_DECISION = _OBS.histogram(
    "sentinel_token_decision_ms",
    "engine-backed token decision latency (request to verdict)",
)
_C_DECISIONS = _OBS.counter(
    "sentinel_token_decisions_total", "token verdicts served by this process"
)
_C_SHED = _OBS.counter(
    "sentinel_token_shed_total",
    "token requests shed before the engine (namespace guard or backpressure)",
)
_C_BATCHED = _OBS.counter(
    "sentinel_cluster_batched_decisions_total",
    "token entries decided by the device column kernel (ops/token_col.py)",
)

#: chaos failpoint on the decision path: a raise here exercises every
#: caller's STATUS_FAIL conversion (request_token's catch, the TCP
#: server's _flow_and_reply/_process catches) — degrade, never PASS
_FP_DECIDE = FP.register(
    "cluster.token.decide", "token service decision entry", FP.HIT_ACTIONS
)


#: engine stages the cluster token decision path exercises: flow checks
#: (with occupy-ahead for prioritized SHOULD_WAIT grants) and hot-param
#: token checks.  The decision client's resources are interned flowIds —
#: no ctx/origin node fan-out, no circuit breakers, no authority/system
#: rules ever bind to them.
DECISION_FEATURES = frozenset({"flow", "occupy", "param"})


@dataclass
class TokenResult:
    status: int
    remaining: int = 0
    wait_ms: int = 0
    token_id: int = 0
    # deny provenance (protocol v3 _T_PROV, obs/explain.py): populated on
    # STATUS_BLOCKED by services that know WHY — verdict kind, blamed rule
    # (flow id), observed usage at decision time, and the limit it hit.
    # None on OK results, on pre-v3 peers, and on transport failures, so
    # every consumer must treat provenance as best-effort.
    prov_kind: Optional[int] = None
    prov_rule: Optional[int] = None
    prov_observed: Optional[float] = None
    prov_limit: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.status == C.STATUS_OK

    @property
    def blocked(self) -> bool:
        return self.status == C.STATUS_BLOCKED


class TokenService:
    """Abstract token service (cluster/TokenService.java:26-62)."""

    #: lease validity window granted to holders; implementations with a
    #: configured TTL (``DefaultTokenService``) shadow this per instance
    lease_ttl_ms: int = C.DEFAULT_LEASE_TTL_MS

    def request_token(self, flow_id: int, count: int = 1, prioritized: bool = False) -> TokenResult:
        raise NotImplementedError

    def request_token_batch(self, flow_id: int, units: int) -> TokenResult:
        """Partial-grant acquire: ask for ``units`` single tokens, receive
        granted k in ``remaining`` (0..units).  Default maps onto the
        all-or-nothing request_token for foreign implementations."""
        r = self.request_token(flow_id, units, False)
        if r.status == C.STATUS_OK:
            return TokenResult(C.STATUS_OK, remaining=units, wait_ms=r.wait_ms)
        if r.status == C.STATUS_BLOCKED:
            return TokenResult(C.STATUS_BLOCKED, remaining=0)
        return r

    def request_param_token(self, flow_id: int, count: int, params: List[Any]) -> TokenResult:
        raise NotImplementedError

    def request_concurrent_token(self, flow_id: int, count: int = 1) -> TokenResult:
        raise NotImplementedError

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        raise NotImplementedError

    def request_lease(self, flow_id: int, units: int) -> TokenResult:
        """Bounded-slack budget lease (cluster/shard.py): grant up to
        ``units`` tokens spendable by the holder for one validity window
        (``remaining`` = granted k, ``wait_ms`` = window ms).  The grant
        rides the partial-grant batch acquire — debited from the SAME
        global budget as ordinary tokens, which is what makes the
        holder's offline spending conserve it — so any TokenService can
        serve as a lease source.  Units clamp to ``MAX_LEASE_UNITS``
        here, for EVERY implementation: a hostile/miscalibrated request
        must not stall the decision backend."""
        r = self.request_token_batch(flow_id, min(units, C.MAX_LEASE_UNITS))
        if r.status == C.STATUS_OK:
            return TokenResult(
                C.STATUS_OK, remaining=r.remaining, wait_ms=self.lease_ttl_ms
            )
        return r


class GlobalRequestLimiter:
    """Per-namespace request-QPS guard in front of the decision engine."""

    def __init__(self, config: ClusterServerConfigManager):
        self._config = config
        self._windows: Dict[str, HostWindow] = {}
        self._lock = threading.Lock()

    def _window(self, namespace: str, cfg) -> HostWindow:
        # a pushed config is unvalidated: round interval up to a multiple of
        # sample_count instead of letting HostWindow's divisibility assert
        # fire on the request hot path
        sample_count = max(int(cfg.sample_count), 1)
        interval_ms = max(int(cfg.interval_ms), sample_count)
        interval_ms = ((interval_ms + sample_count - 1) // sample_count) * sample_count
        w = self._windows.get(namespace)
        if w is None or (w.sample_count, w.interval_ms) != (sample_count, interval_ms):
            # (re)build to the configured shape; a config push that reshapes
            # the window restarts its accounting, like the reference's
            # per-namespace RequestLimiter re-creation
            with self._lock:
                w = self._windows.get(namespace)
                if w is None or (w.sample_count, w.interval_ms) != (
                    sample_count,
                    interval_ms,
                ):
                    w = HostWindow(sample_count, interval_ms)
                    self._windows[namespace] = w
        return w

    def try_pass(self, namespace: str, now_ms: int) -> bool:
        cfg = self._config.flow_config(namespace)
        return self._window(namespace, cfg).try_pass(now_ms, cfg.max_allowed_qps)

    def current_qps(self, namespace: str, now_ms: int) -> float:
        w = self._windows.get(namespace)
        return w.qps(now_ms) if w else 0.0


class ConcurrentTokenManager:
    """Cluster-wide concurrency tokens with TTL expiry."""

    def __init__(self, ttl_ms: int = 5000):
        self.ttl_ms = ttl_ms
        self._lock = threading.Lock()
        self._current: Dict[int, int] = {}  # flowId -> concurrency in flight
        self._tokens: Dict[int, tuple] = {}  # tokenId -> (flowId, count, deadline)
        self._ids = itertools.count(1)

    def acquire(self, flow_id: int, count: int, limit: float, now_ms: int) -> Optional[int]:
        with self._lock:
            cur = self._current.get(flow_id, 0)
            if cur + count > limit:
                return None
            self._current[flow_id] = cur + count
            tid = next(self._ids)
            self._tokens[tid] = (flow_id, count, now_ms + self.ttl_ms)
            return tid

    def release(self, token_id: int) -> bool:
        with self._lock:
            node = self._tokens.pop(token_id, None)
            if node is None:
                return False
            fid, count, _ = node
            self._current[fid] = max(self._current.get(fid, 0) - count, 0)
            return True

    def current(self, flow_id: int) -> int:
        return self._current.get(flow_id, 0)

    def expire(self, now_ms: int) -> int:
        """Drop expired tokens (RegularExpireStrategy sweep). Returns count."""
        with self._lock:
            dead = [tid for tid, (_, _, dl) in self._tokens.items() if dl <= now_ms]
            for tid in dead:
                fid, count, _ = self._tokens.pop(tid)
                self._current[fid] = max(self._current.get(fid, 0) - count, 0)
            return len(dead)


class TokenColumnBatcher:
    """Coalesces token decisions into one device column call a chunk.

    Every decision entry path — the blocking API, the thread-free TCP
    FLOW path, and whole protocol-v2 BATCH frames from many connections
    — submits ``(flow_id, units, partial)`` entries here; a worker
    thread drains the queue and answers each chunk of up to ``CAPACITY``
    entries with ONE ``ops/token_col.decide_batch`` call on the decision
    client's device.  All paths therefore debit the SAME device-resident
    budget ledger (the per-slot sliding window IS the ledger), so
    coalescing can never double-admit against a separate account.

    A chunk crosses the bus twice: its five int32 input columns go up in
    one copy, and ``granted`` with ``observed`` (as int32 bits) come back
    in one; ``decide_batch`` itself makes no host sync.  Entries are
    presorted by slot host-side (native batch_sort3, stable), and the
    rebased prefix sums make one coalesced batch admit exactly what
    sequential requests would have.

    Slot assignment is stable across rule pushes: retained flows keep
    their row (the standing ledger survives a reprojection, as the engine
    tier's windows persist across rule reloads); dropped flows release
    their row with its ledger zeroed before reuse.
    """

    #: entries per device call; bigger drains chunk sequentially (the
    #: same-slot carry is exact: the window is updated between chunks)
    CAPACITY = 256

    def __init__(self, service: "DefaultTokenService"):
        from sentinel_tpu_torch.native import ring as NR
        from sentinel_tpu_torch.obs import timeline as TLM
        from sentinel_tpu_torch.ops import token_col as TC

        self._TC = TC
        self._NR = NR
        self._TLM = TLM
        self.svc = service
        #: the decision client's device: the column's state lives there
        self.device = service.client.device
        # per-window cumulative [TL_COLS] rows fed to the decision
        # client's TimelineRecorder: the column answers off-engine, so it
        # lands the per-second `$cluster/flow/<id>` rows the engine's
        # top-K matrix would (worker thread only)
        self._tl_wid = -1
        self._tl_acc: Dict[int, np.ndarray] = {}
        self._tl_rids: Dict[int, int] = {}
        self._q_lock = threading.Lock()
        self._cv = threading.Condition(self._q_lock)
        self._pending: List[tuple] = []  # (flow_id, units, partial, forced, Future)
        self._s_lock = threading.Lock()  # slots + device state
        self._slots: Dict[int, int] = {}
        self._free: List[int] = []
        self._next_slot = 0
        # flow id -> projected global threshold, for deny provenance
        # (replaced wholesale in project(); the dict swap is atomic, so the
        # worker thread reads it lock-free)
        self._limits_by_fid: Dict[int, float] = {}
        self._cap = 8
        self._state = TC.init_state(self._cap, self.device)
        # memory ledger (obs/profile.py): the column's device state under a
        # per-batcher owner, so close() releases exactly this claim
        self._ledger_name = f"tokencol:{id(self):x}"
        with PROF.ledger_owner(self._ledger_name):
            PROF.LEDGER.track("tokens", "token_col.state", self._state)
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="sentinel-token-col", daemon=True
        )
        self._worker.start()

    def pending_entries(self) -> int:
        return len(self._pending)

    def submit(
        self, flow_id: int, units: int, partial: bool, forced: bool = False
    ) -> "Future":
        """Enqueue one decision entry; resolves to ``(granted, observed,
        limit)`` — granted units plus the window usage and threshold the
        entry was decided against (deny provenance, obs/explain.py).  A
        flow whose rule dropped between guard and decide grants 0 — fail
        closed, like every ambiguity on this path.  ``forced`` charges
        unconditionally (the occupy-ahead emulation)."""
        f: Future = Future()
        with self._cv:
            if self._closed:
                f.set_exception(RuntimeError("token column batcher closed"))
                return f
            self._pending.append((flow_id, units, partial, forced, f))
            self._cv.notify()
        return f

    def ms_to_next_bucket(self, now_ms: int) -> int:
        return self._TC.ms_to_next_bucket(int(now_ms))

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        PROF.LEDGER.drop_owner(self._ledger_name)

    def warm(self) -> None:
        """Run one all-padding decision at the current time, as the
        reference does to pay its compile off the request path; here it
        builds nothing, but it rotates the window as the reference's does,
        so the two ledgers stay leaf for leaf equal."""
        with self._s_lock:
            self._warm_locked()

    def _warm_locked(self) -> None:
        cols = np.zeros((5, self.CAPACITY), np.int32)
        cols[2] = np.arange(self.CAPACITY, dtype=np.int32)
        self._run_column(cols, int(self.svc.client.time.now_ms()))

    def _run_column(self, cols: np.ndarray, now: int):
        """One decision call on the chunk's input columns (int32 [5, CAP]:
        slots, units, heads, partial, forced): one upload, one readback.
        Returns host (granted int32 [CAP], observed float32 [CAP])."""
        torch = _torch()
        dev = torch.from_numpy(cols).to(self.device)
        g, obs, self._state = self._TC.decide_batch(
            self._state, now, dev[0], dev[1], dev[2], dev[3] != 0, dev[4] != 0
        )
        out = torch.stack([g, obs.view(torch.int32)]).cpu().numpy()  # stlint: disable=blocking-under-lock — the column's decision is read back under _s_lock, which serializes its state, as the reference's np.asarray readback is
        return out[0], out[1].view(np.float32)

    def project(self, thresholds: Dict[int, float]) -> None:
        """Rebuild slot map + per-slot limits from a rule/census push.
        Retained flows keep their slot AND their standing window ledger;
        recycled and grown rows start zeroed.  The rows are rebuilt on the
        device (the reference round-trips them through numpy): the same
        state."""
        torch = _torch()
        W = self._TC.W
        with self._s_lock:
            zero_rows: List[int] = []
            for fid in [f for f in self._slots if f not in thresholds]:
                s = self._slots.pop(fid)
                self._free.append(s)
            for fid in thresholds:
                if fid not in self._slots:
                    if self._free:
                        s = self._free.pop()
                        zero_rows.append(s)  # no inherited ledger
                    else:
                        s = self._next_slot
                        self._next_slot += 1
                    self._slots[fid] = s
            cap = self._cap
            while cap < self._next_slot:
                cap *= 2
            grew = cap != self._cap
            if zero_rows or grew:
                old = self._cap
                zr = torch.tensor(zero_rows, dtype=torch.int64, device=self.device)

                def rows(t, fill):
                    out = torch.full((cap,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=self.device)
                    out[:old] = t
                    out[zr] = fill
                    return out

                w = self._state.win
                win = w._replace(
                    counts=rows(w.counts, 0),
                    rt_sum=rows(w.rt_sum, 0.0),
                    rt_min=rows(w.rt_min, W.RT_MIN_INIT),
                    run=rows(w.run, 0),
                    run_rt=rows(w.run_rt, 0.0),
                    run_rt_min=rows(w.run_rt_min, W.RT_MIN_INIT),
                )
                self._state = self._TC.TokenColState(win=win, limits=self._state.limits)
                self._cap = cap
                with PROF.ledger_owner(self._ledger_name):
                    PROF.LEDGER.track("tokens", "token_col.state", self._state)
            limits = np.zeros(cap, np.float32)
            for fid, thr in thresholds.items():
                limits[self._slots[fid]] = thr
            self._limits_by_fid = dict(thresholds)
            self._state = self._TC.set_limits(self._state, torch.from_numpy(limits).to(self.device))
            if grew:
                # as the reference: a grown ledger is warmed at the push
                self._warm_locked()

    # -- worker -------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    # bounded: the predicate loop makes the timeout free,
                    # and a lost notify degrades to a 1 s idle poll
                    # instead of wedging this thread and close() forever
                    self._cv.wait(timeout=1.0)
                if not self._pending and self._closed:
                    return
                batch, self._pending = self._pending, []
            try:
                now = int(self.svc.client.time.now_ms())
                with self._s_lock:
                    for i in range(0, len(batch), self.CAPACITY):
                        self._decide_chunk(batch[i : i + self.CAPACITY], now)
            except Exception as e:  # stlint: disable=fail-open — a failed future is STATUS_FAIL at every caller: degrade, never PASS
                for *_, f in batch:
                    if not f.done():
                        f.set_exception(e)

    def _decide_chunk(self, chunk: List[tuple], now: int) -> None:
        n = len(chunk)
        raw_slots = np.zeros(n, np.int32)
        raw_units = np.zeros(n, np.int32)
        raw_partial = np.zeros(n, bool)
        raw_forced = np.zeros(n, bool)
        for i, (fid, u, p, fo, _f) in enumerate(chunk):
            s = self._slots.get(fid, -1)
            if s >= 0 and u > 0:
                raw_slots[i] = s
                raw_units[i] = u  # unknown/dropped flows keep units 0 → granted 0
            raw_partial[i] = bool(p)
            raw_forced[i] = bool(fo)
        z = np.zeros(n, np.int32)
        order, _ = self._NR.batch_sort3(raw_slots, z, z, want_inv=False)
        s_sorted = raw_slots[order]
        cols = np.zeros((5, self.CAPACITY), np.int32)
        cols[2] = np.arange(self.CAPACITY, dtype=np.int32)
        cols[0, :n] = s_sorted
        cols[1, :n] = raw_units[order]
        cols[3, :n] = raw_partial[order]
        cols[4, :n] = raw_forced[order]
        if n:
            newseg = np.ones(n, bool)
            newseg[1:] = s_sorted[1:] != s_sorted[:-1]
            cols[2, :n] = np.maximum.accumulate(np.where(newseg, np.arange(n), 0))
        g, obs = self._run_column(cols, now)
        granted = np.empty(n, np.int32)
        granted[order] = g[:n]
        observed = np.empty(n, np.float32)
        observed[order] = obs[:n]
        _C_BATCHED.inc(n)
        self._note_timeline(chunk, granted, now)
        lims = self._limits_by_fid
        for i, (fid, _u, _p, _fo, f) in enumerate(chunk):
            if not f.done():
                f.set_result(
                    (int(granted[i]), float(observed[i]), lims.get(fid, 0.0))
                )

    def _note_timeline(self, chunk: List[tuple], granted: np.ndarray, now: int) -> None:
        """Land this chunk's verdicts in the decision client's timeline.

        The recorder keeps the LATEST cumulative row per (window,
        resource), so this accumulates per-window pass/block counts and
        re-emits the whole current window each call — the contract of the
        engine's device top-K matrix, minus the stages (rt / concurrency)
        a token verdict doesn't have."""
        TLM = self._TLM
        tl = self.svc.client.timeline
        if tl is None:
            return
        wid = int(now) // tl.window_ms
        if wid != self._tl_wid:
            # the recorder already holds the previous window's final
            # cumulative rows; only the open window needs an accumulator
            self._tl_wid = wid
            self._tl_acc.clear()
        for i, (fid, u, p, fo, _f) in enumerate(chunk):
            rid = self._tl_rids.get(fid)
            if rid is None:
                rid = self.svc.client.registry.resource_id(flow_resource(fid))
                if rid is None:
                    continue  # registry exhausted: stats degrade, verdicts don't
                self._tl_rids[fid] = rid
            row = self._tl_acc.get(rid)
            if row is None:
                row = np.zeros(8, np.float32)  # ops/engine TL_COLS layout
                row[TLM.TL_RID] = rid
                row[TLM.TL_RT_MIN] = TLM._RT_MIN_INIT
                self._tl_acc[rid] = row
            g = int(granted[i])
            ok = fo or g >= u or (p and g > 0)
            row[TLM.TL_PASS if ok else TLM.TL_BLOCK] += 1.0
        if self._tl_acc:
            tl.note_tick(
                np.stack(list(self._tl_acc.values())),
                now,
                int(self.svc.client.time.wall_ms(now)) - int(now),
            )

class DefaultTokenService(TokenService):
    """Engine-backed token service.

    ``decision_client`` is a dedicated SentinelClient whose resources are the
    cluster flowIds.  ``connected_count_fn(namespace) -> int`` feeds the
    AVG_LOCAL threshold scaling; the server wires it to its ConnectionManager
    (ConnectionGroup.getConnectedCount), standalone/embedded default is 1.

    Prioritized requests that exceed the current bucket borrow from the next
    one (engine occupy-ahead, DefaultController.tryOccupyNext) and surface as
    STATUS_SHOULD_WAIT with the wait until that bucket starts — the client
    sleeps and enters, matching TokenResultStatus.SHOULD_WAIT semantics.
    """

    def __init__(
        self,
        decision_client,
        config: Optional[ClusterServerConfigManager] = None,
        connected_count_fn: Optional[Callable[[str], int]] = None,
        concurrent_ttl_ms: int = 5000,
        lease_ttl_ms: int = C.DEFAULT_LEASE_TTL_MS,
        use_token_column: bool = True,
    ):
        self.client = decision_client
        self.lease_ttl_ms = lease_ttl_ms
        self.config = config or ClusterServerConfigManager()
        self.connected_count_fn = connected_count_fn or (lambda ns: 1)
        # device column batcher first: _reproject (fired by every rule
        # push below) projects thresholds into it
        self.col = TokenColumnBatcher(self) if use_token_column else None
        self.flow_rules = ClusterFlowRuleManager(on_change=self._reproject)
        self.param_rules = ClusterParamFlowRuleManager(on_change=self._reproject)
        self.limiter = GlobalRequestLimiter(self.config)
        self.concurrent = ConcurrentTokenManager(ttl_ms=concurrent_ttl_ms)
        self.config.add_listener(self._reproject)
        self._lock = threading.Lock()
        if self.col is not None:
            self.col.warm()

    def warm(self) -> None:
        """Run the column's first decision off the request path
        (TokenColumnBatcher.warm)."""
        if self.col is not None:
            self.col.warm()

    def close(self) -> None:
        if self.col is not None:
            self.col.close()

    # -- projection onto the engine ----------------------------------------

    def _global_threshold(self, rule: R.FlowRule, namespace: str) -> float:
        cfg = self.config.flow_config(namespace)
        n = (
            1
            if rule.cluster_threshold_type == C.FLOW_THRESHOLD_GLOBAL
            else max(self.connected_count_fn(namespace), 1)
        )
        return rule.count * n * cfg.exceed_count

    def _reproject(self) -> None:
        """Rebuild the decision client's engine rules from cluster rules."""
        with self._lock:
            flow = []
            thresholds: Dict[int, float] = {}
            for fid in self.flow_rules.all_ids():
                rule = self.flow_rules.get_by_id(fid)
                if rule is None:
                    continue  # unloaded between snapshot and lookup
                ns = self.flow_rules.namespace_of(fid) or C.DEFAULT_NAMESPACE
                thr = self._global_threshold(rule, ns)
                thresholds[fid] = thr
                flow.append(
                    R.FlowRule(
                        resource=flow_resource(fid),
                        count=thr,
                        grade=R.GRADE_QPS,
                    )
                )
            param = []
            for fid in self.param_rules.all_ids():
                rule = self.param_rules.get_by_id(fid)
                if rule is None:
                    continue
                param.append(
                    R.ParamFlowRule(
                        resource=param_resource(fid),
                        count=rule.count,
                        grade=rule.grade,
                        param_idx=0,  # client sends extracted values
                        duration_in_sec=rule.duration_in_sec,
                        param_flow_item_list=rule.param_flow_item_list,
                    )
                )
            # stlint: disable-next-line=blocking-under-lock — _lock serializes projections (a stale one must never overwrite a newer one); the decision client's recompile is the work it serializes, on rule pushes, off the request path
            self.client.flow_rules.load_projection(flow)
            # stlint: disable-next-line=blocking-under-lock — as above: the second half of one projection
            self.client.param_flow_rules.load_projection(param)
            if self.col is not None:
                self.col.project(thresholds)

    def refresh_connected_count(self) -> None:
        """Call when the connection census changes.  Only AVG_LOCAL rules
        scale with the census — with purely GLOBAL rules this is a no-op,
        so a churning client fleet doesn't trigger recompiles."""
        has_avg_local = any(
            r is not None and r.cluster_threshold_type != C.FLOW_THRESHOLD_GLOBAL
            for r in (
                self.flow_rules.get_by_id(fid) for fid in self.flow_rules.all_ids()
            )
        )
        if has_avg_local:
            self._reproject()

    # -- TokenService --------------------------------------------------------

    def request_token(self, flow_id: int, count: int = 1, prioritized: bool = False) -> TokenResult:
        """Blocking token grant — delegates to the async path so the guards
        and verdict mapping live in exactly one place."""
        try:
            return self.request_token_async(flow_id, count, prioritized).result(
                timeout=self.client.entry_timeout_s
            )
        except Exception:  # stlint: disable=fail-open — STATUS_FAIL makes the caller degrade to local enforcement, never PASS
            return TokenResult(C.STATUS_FAIL)

    def request_token_async(self, flow_id: int, count: int = 1, prioritized: bool = False):
        """Non-blocking request_token: returns a concurrent Future of
        TokenResult (or a completed result for no-rule / namespace-guard
        outcomes).  Lets the TCP server keep thousands of token requests
        in flight with no thread per request — they coalesce into the
        decision engine's micro-batches."""
        from concurrent.futures import Future as _F

        FP.hit(_FP_DECIDE)
        done = _F()
        rule = self.flow_rules.get_by_id(flow_id)
        if rule is None:
            done.set_result(TokenResult(C.STATUS_NO_RULE))
            return done
        ns = self.flow_rules.namespace_of(flow_id) or C.DEFAULT_NAMESPACE
        if not self.limiter.try_pass(ns, self.client.time.now_ms()):
            _C_SHED.inc()
            done.set_result(TokenResult(C.STATUS_TOO_MANY_REQUEST))
            return done
        if self.col is not None:
            if self.col.pending_entries() > 4 * TokenColumnBatcher.CAPACITY:
                _C_SHED.inc()
                done.set_result(TokenResult(C.STATUS_TOO_MANY_REQUEST))
                return done
            if count <= 0:  # zero-unit ask: nothing to debit
                _C_DECISIONS.inc()
                done.set_result(TokenResult(C.STATUS_OK))
                return done
            _span = OT.TRACER.begin("token.decision", flow_id=flow_id)
            cf = self.col.submit(flow_id, count, partial=False)

            def _chain_col(fut):
                _C_DECISIONS.inc()
                if _span is not None:
                    OT.stage_ns(
                        "token.decision",
                        _span.t0_ns,
                        OT.now_ns() - _span.t0_ns,
                        _H_DECISION,
                        trace=_span.trace,
                        attrs=_span.attrs,
                    )
                try:
                    granted, observed, limit = fut.result()
                except Exception:  # stlint: disable=fail-open — STATUS_FAIL makes the caller degrade to local enforcement, never PASS
                    done.set_result(TokenResult(C.STATUS_FAIL))
                    return
                if granted >= count:
                    done.set_result(TokenResult(C.STATUS_OK))
                    return
                if not prioritized:
                    done.set_result(
                        TokenResult(
                            C.STATUS_BLOCKED,
                            prov_kind=ERR.BLOCK_FLOW,
                            prov_rule=flow_id,
                            prov_observed=observed,
                            prov_limit=limit,
                        )
                    )
                    return
                # occupy-ahead emulation: charge the ask unconditionally
                # (debits the CURRENT bucket — one earlier than the
                # engine's tryOccupyNext, the conservative direction) and
                # tell the caller to sleep into the next bucket
                f2 = self.col.submit(flow_id, count, partial=False, forced=True)

                def _chain_occ(fut2):
                    try:
                        fut2.result()
                    except Exception:  # stlint: disable=fail-open — STATUS_FAIL makes the caller degrade to local enforcement, never PASS
                        done.set_result(TokenResult(C.STATUS_FAIL))
                        return
                    wait = self.col.ms_to_next_bucket(
                        int(self.client.time.now_ms())
                    )
                    done.set_result(
                        TokenResult(C.STATUS_SHOULD_WAIT, wait_ms=wait)
                    )

                f2.add_done_callback(_chain_occ)

            cf.add_done_callback(_chain_col)
            return done
        # backpressure: with the thread-free TCP path nothing else bounds
        # in-flight requests, so shed load once the acquire queue exceeds a
        # few engine batches (the reference's namespace guard plays this
        # role only when configured tightly)
        if self.client.pending_acquires() > 4 * self.client.cfg.batch_size:
            _C_SHED.inc()
            done.set_result(TokenResult(C.STATUS_TOO_MANY_REQUEST))
            return done
        f = self.client.submit_acquire(
            flow_resource(flow_id), count=count, prioritized=prioritized
        )
        if f is None:
            _C_DECISIONS.inc()  # fast-path verdict is still a served decision
            done.set_result(TokenResult(C.STATUS_OK))
            return done
        # cross-thread span: begun here (adopting the wire trace context
        # the TCP server installed, if any), ended on the resolver/tick
        # thread that fires the engine future — the handle carries the
        # trace id and the caller's span id (attrs["parent"]) across
        _span = OT.TRACER.begin("token.decision", flow_id=flow_id)

        def _chain(fut):
            _C_DECISIONS.inc()
            if _span is not None:
                OT.stage_ns(
                    "token.decision",
                    _span.t0_ns,
                    OT.now_ns() - _span.t0_ns,
                    _H_DECISION,
                    trace=_span.trace,
                    attrs=_span.attrs,
                )
            try:
                verdict, wait_ms = fut.result()
            except Exception:  # stlint: disable=fail-open — STATUS_FAIL makes the caller degrade to local enforcement, never PASS
                done.set_result(TokenResult(C.STATUS_FAIL))
                return
            if verdict == ERR.PASS:
                done.set_result(TokenResult(C.STATUS_OK))
            elif verdict == ERR.PASS_WAIT:
                done.set_result(TokenResult(C.STATUS_SHOULD_WAIT, wait_ms=wait_ms))
            else:
                # engine path: the verdict code names the kind; observed/
                # limit stay unknown (the tick already consumed them)
                done.set_result(
                    TokenResult(
                        C.STATUS_BLOCKED,
                        prov_kind=int(verdict),
                        prov_rule=flow_id,
                    )
                )

        f.add_done_callback(_chain)
        return done

    def request_token_batch(self, flow_id: int, units: int) -> TokenResult:
        """Partial grant: `units` unit-acquires coalesce into one engine
        micro-batch; granted = how many passed (within-tick prefix-sum
        admission makes this bit-exact with sequential acquisition)."""
        FP.hit(_FP_DECIDE)
        rule = self.flow_rules.get_by_id(flow_id)
        if rule is None:
            return TokenResult(C.STATUS_NO_RULE)
        if units <= 0:
            return TokenResult(C.STATUS_BAD_REQUEST)
        ns = self.flow_rules.namespace_of(flow_id) or C.DEFAULT_NAMESPACE
        if not self.limiter.try_pass(ns, self.client.time.now_ms()):
            _C_SHED.inc()
            return TokenResult(C.STATUS_TOO_MANY_REQUEST)
        if self.col is not None:
            with OT.TRACER.span("token.decision_batch", flow_id=flow_id, units=units):
                try:
                    granted, observed, limit = self.col.submit(
                        flow_id, units, partial=True
                    ).result(timeout=self.client.entry_timeout_s)
                    granted = int(granted)
                except Exception:  # stlint: disable=fail-open — STATUS_FAIL makes the caller degrade to local enforcement, never PASS
                    return TokenResult(C.STATUS_FAIL)
            _C_DECISIONS.inc(units)
            if granted == 0:
                return TokenResult(
                    C.STATUS_BLOCKED,
                    remaining=0,
                    prov_kind=ERR.BLOCK_FLOW,
                    prov_rule=flow_id,
                    prov_observed=observed,
                    prov_limit=limit,
                )
            return TokenResult(C.STATUS_OK, remaining=granted)
        with OT.TRACER.span("token.decision_batch", flow_id=flow_id, units=units):
            results = self.client.check_batch([flow_resource(flow_id)] * units)
        _C_DECISIONS.inc(units)
        granted = sum(1 for v, _ in results if v in (ERR.PASS, ERR.PASS_WAIT))
        wait = max((w for v, w in results if v == ERR.PASS_WAIT), default=0)
        if granted == 0:
            return TokenResult(
                C.STATUS_BLOCKED,
                remaining=0,
                prov_kind=ERR.BLOCK_FLOW,
                prov_rule=flow_id,
            )
        return TokenResult(C.STATUS_OK, remaining=granted, wait_ms=wait)

    def request_param_token(self, flow_id: int, count: int, params: List[Any]) -> TokenResult:
        FP.hit(_FP_DECIDE)
        rule = self.param_rules.get_by_id(flow_id)
        if rule is None:
            return TokenResult(C.STATUS_NO_RULE)
        if not params:
            return TokenResult(C.STATUS_BAD_REQUEST)
        ns = self.param_rules.namespace_of(flow_id) or C.DEFAULT_NAMESPACE
        if not self.limiter.try_pass(ns, self.client.time.now_ms()):
            _C_SHED.inc()
            return TokenResult(C.STATUS_TOO_MANY_REQUEST)
        name = param_resource(flow_id)
        with OT.TRACER.span("token.decision_param", flow_id=flow_id):
            results = self.client.check_batch(
                [name] * len(params),
                counts=[count] * len(params),
                params=list(params),
            )
        _C_DECISIONS.inc(len(params))
        if all(v == ERR.PASS for v, _ in results):
            return TokenResult(C.STATUS_OK)
        return TokenResult(
            C.STATUS_BLOCKED, prov_kind=ERR.BLOCK_PARAM, prov_rule=flow_id
        )

    # request_lease: the TokenService base implementation already rides
    # request_token_batch with the MAX_LEASE_UNITS clamp and honors this
    # instance's lease_ttl_ms — no override needed

    def request_concurrent_token(self, flow_id: int, count: int = 1) -> TokenResult:
        rule = self.flow_rules.get_by_id(flow_id)
        if rule is None:
            return TokenResult(C.STATUS_NO_RULE)
        ns = self.flow_rules.namespace_of(flow_id) or C.DEFAULT_NAMESPACE
        limit = self._global_threshold(rule, ns)
        tid = self.concurrent.acquire(
            flow_id, count, limit, self.client.time.now_ms()
        )
        if tid is None:
            return TokenResult(
                C.STATUS_BLOCKED,
                prov_kind=ERR.BLOCK_FLOW,
                prov_rule=flow_id,
                prov_limit=limit,
            )
        return TokenResult(C.STATUS_OK, token_id=tid)

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        ok = self.concurrent.release(token_id)
        return TokenResult(C.STATUS_RELEASE_OK if ok else C.STATUS_ALREADY_RELEASE)

    # -- protocol v2 BATCH frames -------------------------------------------

    def decide_frame(
        self, kinds, ids, counts, flags
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list]:
        """Answer one protocol-v2 BATCH frame's entry columns.

        Host-side guards (rule lookup, namespace limiter, validation) run
        per entry; every surviving entry joins ONE column submission, so a
        frame carrying a hundred flows costs one device decision.  Entry
        kinds map onto the existing verdict surface:

          BATCH_KIND_FLOW        all-or-nothing → OK / BLOCKED
          BATCH_KIND_FLOW_BATCH  partial grant  → OK(remaining=granted) / BLOCKED
          BATCH_KIND_LEASE       MAX_LEASE_UNITS-clamped partial grant;
                                 wait_ms carries the lease TTL

        The prioritized flag has no occupy-ahead on the column path: an
        over-limit prioritized entry is BLOCKED (fail closed), never
        SHOULD_WAIT.  Returns (statuses i8, remainings i32, waits i32,
        token_ids i64, prov) aligned with the request entries; ``prov[i]``
        is ``(kind, rule, observed|None, limit|None)`` on BLOCKED entries
        whose cause is known, else None — the server ships it back only
        when the client set BATCH_FLAG_EXPLAIN (protocol v3 _T_PROV).
        """
        n = len(kinds)
        # seed FAIL, not OK: any entry a bug leaves untouched must read as
        # a failure the client degrades on, never as a grant
        statuses = np.full(n, C.STATUS_FAIL, np.int8)
        remainings = np.zeros(n, np.int32)
        waits = np.zeros(n, np.int32)
        token_ids = np.zeros(n, np.int64)
        prov: List[Optional[Tuple[int, int, Optional[float], Optional[float]]]] = [
            None
        ] * n
        if self.col is None:
            for i in range(n):
                kind, fid, cnt = int(kinds[i]), int(ids[i]), int(counts[i])
                prio = bool(int(flags[i]) & C.BATCH_FLAG_PRIORITIZED)
                if kind == C.BATCH_KIND_FLOW:
                    r = self.request_token(fid, cnt, prio)
                elif kind == C.BATCH_KIND_FLOW_BATCH:
                    r = self.request_token_batch(fid, cnt)
                elif kind == C.BATCH_KIND_LEASE:
                    r = self.request_lease(fid, cnt)
                else:
                    r = TokenResult(C.STATUS_BAD_REQUEST)
                statuses[i] = r.status
                remainings[i] = r.remaining
                waits[i] = r.wait_ms
                token_ids[i] = r.token_id
                if r.prov_kind is not None:
                    prov[i] = (
                        r.prov_kind,
                        r.prov_rule if r.prov_rule is not None else fid,
                        r.prov_observed,
                        r.prov_limit,
                    )
            return statuses, remainings, waits, token_ids, prov
        now = self.client.time.now_ms()
        futs: List[Future] = []
        meta: List[Tuple[int, int, int]] = []
        for i in range(n):
            FP.hit(_FP_DECIDE)
            kind, fid, cnt = int(kinds[i]), int(ids[i]), int(counts[i])
            if kind not in (
                C.BATCH_KIND_FLOW,
                C.BATCH_KIND_FLOW_BATCH,
                C.BATCH_KIND_LEASE,
            ):
                statuses[i] = C.STATUS_BAD_REQUEST
                continue
            rule = self.flow_rules.get_by_id(fid)
            if rule is None:
                statuses[i] = C.STATUS_NO_RULE
                continue
            if cnt <= 0:
                # a zero-unit all-or-nothing ask requests nothing and
                # passes; a zero/negative batch or lease ask is malformed
                statuses[i] = (
                    C.STATUS_OK
                    if kind == C.BATCH_KIND_FLOW and cnt == 0
                    else C.STATUS_BAD_REQUEST
                )
                continue
            ns = self.flow_rules.namespace_of(fid) or C.DEFAULT_NAMESPACE
            if not self.limiter.try_pass(ns, now):
                _C_SHED.inc()
                statuses[i] = C.STATUS_TOO_MANY_REQUEST
                continue
            units = min(cnt, C.MAX_LEASE_UNITS) if kind == C.BATCH_KIND_LEASE else cnt
            futs.append(
                self.col.submit(fid, units, partial=kind != C.BATCH_KIND_FLOW)
            )
            meta.append((i, kind, units, fid))
        timeout = self.client.entry_timeout_s
        for f, (i, kind, units, fid) in zip(futs, meta):
            try:
                granted, observed, limit = f.result(timeout=timeout)
                granted = int(granted)
            except Exception:  # stlint: disable=fail-open — STATUS_FAIL makes the caller degrade to local enforcement, never PASS
                statuses[i] = C.STATUS_FAIL
                continue
            _C_DECISIONS.inc(1 if kind == C.BATCH_KIND_FLOW else units)
            blocked = (
                granted < units if kind == C.BATCH_KIND_FLOW else granted == 0
            )
            if blocked:
                statuses[i] = C.STATUS_BLOCKED
                prov[i] = (ERR.BLOCK_FLOW, fid, observed, limit)
            else:
                statuses[i] = C.STATUS_OK
                if kind != C.BATCH_KIND_FLOW:
                    remainings[i] = granted
                    if kind == C.BATCH_KIND_LEASE:
                        waits[i] = self.lease_ttl_ms
        return statuses, remainings, waits, token_ids, prov
