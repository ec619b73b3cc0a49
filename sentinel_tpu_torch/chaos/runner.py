"""Chaos scenario harness: drive real clients under seeded fault plans.

The port's copy of ``sentinel_tpu/chaos/runner.py``.  Every builder
takes a ``device``: the card (``cuda``, the default — it raises where
there is none) unless the caller asks for the CPU, as the tests do.  On
the card, each client a scenario builds runs its first ticks (which
build the CUDA kernels) before any fault window opens — the port's
counterpart of the reference warming its first XLA compile, else the
build's seconds would race RPC timeouts and scheduled fault indices
would become timing lotteries.

Each built-in scenario assembles REAL product objects — a sync-mode
``SentinelClient`` on virtual time, and where the scenario calls for it a
localhost ``ClusterTokenServer`` / ``ClusterTokenClient`` pair or a
``RemoteShard`` against that server's RES_CHECK path — arms a
``FaultPlan`` derived from the run seed, drives deterministic traffic,
and evaluates its invariant set (``chaos/invariants.py``).

Determinism contract: a scenario's reported ``injected`` counts are a
pure function of its seed.  Schedules are hit-index or ``max_fires``
gated on sites whose hit order the scenario controls (one round-trip per
request, one resolve per tick); sites with timing-dependent hit counts
(reader-thread recv, TCP segmentation) carry only ``max_fires``-pinned
specs.  The CLI's ``--check-determinism`` mode runs everything twice and
diffs the counts.

Scenarios (the acceptance set):

  rpc_error_burst     token RPC send failures + latency bursts against a
                      live server; STATUS_FAIL only where injected
  cluster_partition   cluster-mode client loses the token server, enters
                      degraded local enforcement, heals, exits
  resolver_exception  verdict readback raises; ticks fail CLOSED instead
                      of stranding futures
  seg_overflow_storm  fail-closed segment-capacity overflow + live
                      seg_u grow-and-swap under injected resize delay
  datasource_flap     rule-file refresh loop faults; rules hold, then
                      the post-heal update applies; a second window
                      faults the timeline metric-log writes, which fail
                      OPEN (decisions untouched, failures counted)
  shard_reconnect     mid-window shard partition: answered chunks stay
                      resolved, unanswered degrade, no replay
  shard_failover      fleet shard kill/partition/rejoin: only the dead
                      shard's flows fail over to the bounded-slack lease
                      fallback, per-shard hysteresis pairs up
  overload_storm      flash crowd at 2× backend capacity: the adaptive
                      ladder climbs and sheds (p99 bounded, goodput
                      held) then recovers to NORMAL; the controller-OFF
                      control run demonstrably queue-collapses
  hotset_promote_fail sketch-tier promotion faults: ruled tail resources
                      stay sketched with stats failing OPEN and
                      tail-rule verdicts failing CLOSED; a clean load
                      heals and enforces exactly; a second window proves
                      the profiling plane (shadow audit + deep capture)
                      fails OPEN with exact counter accounting
  explain_fail_open   explain-section decode corrupt/raise: provenance
                      drops and is counted, while the verdict stream is
                      bit-identical to an unfaulted control run — the
                      provenance plane is strictly observational
  tuner_fail_open     workload autotuner faults: a quiet closed loop
                      retunes the operating point live (expected
                      retraces only), then raising tuner steps fail
                      OPEN to the last-good point and dropped generator
                      emissions are counted exactly
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import time as _time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.chaos.invariants import (
    MetricsDelta,
    ScenarioContext,
    Verdict,
    evaluate,
)
from sentinel_tpu_torch.chaos.plans import FaultPlan, FaultSpec
from sentinel_tpu_torch.utils.time_source import mono_s


@dataclass
class ScenarioResult:
    name: str
    seed: int
    ok: bool
    injected: Dict[str, int]
    verdicts: List[Verdict]
    duration_s: float
    notes: str = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "ok": self.ok,
            "injected": dict(sorted(self.injected.items())),
            "invariants": [
                {"name": v.name, "ok": v.ok, "detail": v.detail}
                for v in self.verdicts
            ],
            "duration_s": round(self.duration_s, 3),
            "notes": self.notes,
        }


class _Session:
    """Accumulates injected/hit counts over one or more armed windows —
    scenarios that must observe quiet phases (hit counting) around a
    fault window arm several plans in sequence."""

    def __init__(self):
        self.injected: Dict[str, int] = {}
        self.hits: Dict[str, int] = {}

    @contextmanager
    def window(self, plan: FaultPlan):
        st = FP.arm(plan)
        try:
            yield st
        finally:
            FP.disarm()
            for k, v in st.injected().items():
                self.injected[k] = self.injected.get(k, 0) + v
            for k, v in st.hit_counts().items():
                self.hits[k] = self.hits.get(k, 0) + v


# -- builders ----------------------------------------------------------------


def _make_client(device: str, **kw):
    """Sync-mode SentinelClient on ``device``, the small config + fresh
    virtual time (the deterministic test shape), warmed: its first ticks
    (each batch shape once, no-op items; on the card they build the
    kernels) run before the caller arms anything.  Caller stops it."""
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    kw.setdefault("cfg", small_engine_config())
    kw.setdefault("time_source", VirtualTimeSource(start_ms=1_000))
    kw.setdefault("mode", "sync")
    c = SentinelClient(device=device, **kw)
    c.start()
    if c.mode == "sync":
        c._warm_shapes()  # threaded clients warm in start()
    return c


def _make_token_server(device: str, flow_count: float = 3.0, flow_id: int = 101):
    """Decision client + DefaultTokenService + localhost TCP server."""
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import rules as R

    decision = _make_client(device)
    svc = DefaultTokenService(decision)
    svc.flow_rules.load(
        "default",
        [
            R.FlowRule(
                resource=f"res-{flow_id}",
                count=flow_count,
                cluster_mode=True,
                cluster_flow_id=flow_id,
            )
        ],
    )
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0)
    server.start()
    # warm the decision engine on a throwaway resource BEFORE any scenario
    # traffic (the reference warms its first XLA compile here): a first
    # decision that takes seconds would otherwise race RPC timeouts,
    # turning scheduled fault indices into timing lotteries
    decision.registry.resource_id("chaos/warm")
    f = decision.submit_acquire("chaos/warm")
    if f is not None:
        f.result(timeout=120.0)
    return decision, svc, server


def _drain_entries(client, resource: str, n: int) -> Dict[str, int]:
    """n blocking entries; returns {"passed": .., "blocked": ..} with every
    passing entry exited immediately (no leaked concurrency)."""
    passed = blocked = 0
    for _ in range(n):
        e = client.try_entry(resource)
        if e is not None:
            e.exit()
            passed += 1
        else:
            blocked += 1
    return {"passed": passed, "blocked": blocked}


# -- scenarios ---------------------------------------------------------------


def _scn_rpc_error_burst(seed: int, device: str = "cuda") -> ScenarioResult:
    """Token RPC against a live server under a send-failure burst plus
    injected latency: failed round-trips surface as STATUS_FAIL (never
    OK), every request resolves, failure kinds are labeled.  After the
    armed window the scenario loses the server entirely and drives one
    cluster-mode entry so the runtime's degrade path fires — asserting
    the flight recorder (obs/flight.py) captured a post-mortem bundle
    whose journal holds both the injected failpoint fires and the
    degrade-enter transition."""
    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.state import ClusterStateManager
    from sentinel_tpu_torch.core import rules as R
    from sentinel_tpu_torch.obs.flight import FLIGHT

    t0 = mono_s()
    decision, svc, server = _make_token_server(device, flow_count=3.0)
    tok = ClusterTokenClient("127.0.0.1", server.port, timeout_ms=3000)
    tok.reconnect_interval_s = 0.0  # reconnect on every attempt (chaos pace)
    tok.start()
    metrics = MetricsDelta()
    session = _Session()
    n = 12
    burst = (2, 2)  # send-site hit indices [2, 4) raise
    plan = FaultPlan(
        name="rpc_error_burst",
        seed=seed,
        faults=[
            FaultSpec(
                "cluster.rpc.send", "raise",
                burst_start=burst[0], burst_len=burst[1], exc="OSError",
            ),
            FaultSpec(
                "cluster.rpc.send", "delay",
                every_nth=5, delay_ms=2.0, max_fires=2,
            ),
        ],
    )
    flight_detail = "bundle not captured"
    flight_ok = False
    sm = dead = None
    try:
        with session.window(plan):
            results = [tok.request_token(101) for _ in range(n)]
        # -- black-box phase (outside the armed window: injected counts
        # stay a pure function of the seed).  Kill the server, point the
        # decision client at the dead port in cluster mode, and drive one
        # entry: request_token fails -> degrade-to-local -> the flight
        # recorder triggers a cluster-degrade-enter bundle whose journal
        # already holds this run's failpoint.fire events.
        tok.close()
        server.stop()
        # the lost server's address: a port this process holds bound and
        # never listens on, so every connect is refused.  The stopped
        # server's own port could be taken by any process's next listener
        # (a token server on a loaded host answers NO_RULE, and the client
        # never degrades)
        dead = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        dead.bind(("127.0.0.1", 0))
        sm = ClusterStateManager()
        sm.set_to_client("127.0.0.1", dead.getsockname()[1])
        sm.token_service().reconnect_interval_s = 0.0
        decision.set_cluster(sm)
        decision.flow_rules.load(
            [
                R.FlowRule(
                    resource="chaos/flight",
                    count=100.0,
                    cluster_mode=True,
                    cluster_flow_id=424242,
                    cluster_fallback_to_local=True,
                )
            ]
        )
        FLIGHT.reset_rate_limit()  # a prior scenario's bundle must not mask ours
        e = decision.try_entry("chaos/flight")
        if e is not None:
            e.exit()
        b = FLIGHT.last_bundle()
        if b is not None and b["reason"] == "cluster-degrade-enter":
            kinds = {ev["kind"] for ev in b["journal"]}
            flight_ok = "failpoint.fire" in kinds and "cluster.degrade.enter" in kinds
            flight_detail = f"reason={b['reason']} journal_kinds={sorted(kinds)}"
        elif b is not None:
            flight_detail = f"unexpected bundle reason {b['reason']!r}"
    finally:
        # restore FIRST (even when the black-box phase raised): pair the
        # transition and zero the process-global degrade gauge so the
        # degrade-hysteresis invariant of LATER scenarios stays clean
        try:
            decision._exit_cluster_degraded()
        except Exception:  # noqa: BLE001 — cleanup must reach the stops below
            pass
        tok.close()
        if sm is not None:
            sm.stop()
        if dead is not None:
            dead.close()
        server.stop()
        decision.stop()

    counts = {"requests": n, "ok": 0, "blocked": 0, "failed": 0, "other": 0}
    degraded_passes = 0
    for i, r in enumerate(results):
        if r.status == C.STATUS_OK:
            counts["ok"] += 1
            if burst[0] <= i < burst[0] + burst[1]:
                degraded_passes += 1  # an injected failure must not grant
        elif r.status == C.STATUS_BLOCKED:
            counts["blocked"] += 1
        elif r.status == C.STATUS_FAIL:
            counts["failed"] += 1
        else:
            counts["other"] += 1
    ctx = ScenarioContext(
        metrics=metrics,
        client=decision,
        submitted=n,
        passed=counts["ok"],
        blocked=counts["blocked"],
        degraded=counts["failed"] + counts["other"],
        degraded_passes=degraded_passes,
        injected=session.injected,
        expect_injected={
            "cluster.rpc.send:raise": burst[1],
            "cluster.rpc.send:delay": 2,
        },
        extra={
            "token_counts": counts,
            "expect_token_failures": burst[1],
            "expect_metric_deltas": {
                'sentinel_cluster_rpc_failures_total{kind="send"}': burst[1],
            },
        },
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "token-conservation",
            "no-degraded-pass",
            "metric-deltas",
            "pipeline-drained",
            "injected-as-planned",
        ],
        ctx,
    )
    verdicts.append(Verdict("flight-bundle-captured", flight_ok, flight_detail))
    return _result("rpc_error_burst", seed, session, verdicts, t0)


def _scn_cluster_partition(seed: int, device: str = "cuda") -> ScenarioResult:
    """A cluster-mode SentinelClient loses its token server mid-traffic:
    it must degrade to local enforcement of fallback-enabled rules (one
    enter), hold the cooldown, and exit on the first healthy probe."""
    from sentinel_tpu_torch.cluster.state import ClusterStateManager
    from sentinel_tpu_torch.core import rules as R

    t0 = mono_s()
    decision, svc, server = _make_token_server(device, flow_count=100.0)
    sm = ClusterStateManager()
    # generous RPC timeout: the scenario injects failures explicitly and
    # must never pick up an accidental timeout on a loaded CI box
    sm.client_config.request_timeout_ms = 5000
    sm.set_to_client("127.0.0.1", server.port)
    sm.token_service().reconnect_interval_s = 0.0
    main = _make_client(device)
    main.set_cluster(sm)
    # cooldown far beyond the scenario's span: the degraded phase NEVER
    # probes on its own; the heal step expires the cooldown explicitly so
    # the probe lands on a deterministic entry (no wall-clock sleep race)
    main.cluster_retry_interval_s = 300.0
    main.flow_rules.load(
        [
            R.FlowRule(
                resource="res-101",
                count=2.0,  # local-fallback budget while degraded
                cluster_mode=True,
                cluster_flow_id=101,
                cluster_fallback_to_local=True,
            )
        ]
    )
    metrics = MetricsDelta()
    session = _Session()
    # healthy phase drives exactly 3 send-site hits, so the raise lands
    # on hit 3 — the first partition-phase round-trip
    plan = FaultPlan(
        name="cluster_partition",
        seed=seed,
        faults=[
            FaultSpec(
                "cluster.rpc.send", "raise",
                burst_start=3, burst_len=1, max_fires=1, exc="ConnectionResetError",
            )
        ],
    )
    totals = {"passed": 0, "blocked": 0}
    try:
        with session.window(plan):
            for phase_n in (3, 1, 3):  # healthy, partition hit, degraded local
                got = _drain_entries(main, "res-101", phase_n)
                totals["passed"] += got["passed"]
                totals["blocked"] += got["blocked"]
            # heal: expire the (mono_s-based) cooldown so the very next
            # entry probes the live server and must exit degraded
            with main._cluster_lock:
                main._cluster_degraded_until = 0.0
            got = _drain_entries(main, "res-101", 1)
            totals["passed"] += got["passed"]
            totals["blocked"] += got["blocked"]
    finally:
        main.stop()
        sm.stop()
        server.stop()
        decision.stop()

    ctx = ScenarioContext(
        metrics=metrics,
        client=main,
        submitted=8,
        passed=totals["passed"],
        blocked=totals["blocked"],
        injected=session.injected,
        expect_injected={"cluster.rpc.send:raise": 1},
        extra={
            "expect_degrade_enters": 1,
            "expect_metric_deltas": {
                'sentinel_cluster_rpc_failures_total{kind="send"}': 1,
                'sentinel_cluster_rpc_failures_total{kind="connect"}': 0,
                'sentinel_cluster_rpc_failures_total{kind="timeout"}': 0,
            },
        },
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "degrade-hysteresis",
            "metric-deltas",
            "pipeline-drained",
            "injected-as-planned",
        ],
        ctx,
    )
    return _result("cluster_partition", seed, session, verdicts, t0)


def _scn_resolver_exception(seed: int, device: str = "cuda") -> ScenarioResult:
    """Verdict readback raises inside the resolve path — and, on other
    ticks, the fused packed-wire readback comes back CORRUPTED: both
    failure shapes must fail the affected ticks CLOSED (system block)
    with no stranded futures and no hung pipeline — the _fail_tick
    contract.  The corrupt ticks additionally must be DETECTED by the
    wire checksum (sentinel_packed_decode_failures_total), never fanned
    out as garbage verdicts."""
    from sentinel_tpu_torch.core import errors as ERR

    t0 = mono_s()
    client = _make_client(device)
    resource = "chaos/resolver"
    client.registry.resource_id(resource)
    # prime one tick outside the plan so the first tick's cost and the
    # warmup resolve don't shift the armed hit indices
    f = client.submit_acquire(resource)
    if f is not None:
        f.result(timeout=60.0)
    metrics = MetricsDelta()
    session = _Session()
    n, nth, fires = 12, 3, 3
    # the packed decoder's hit counter advances only on ticks the raise
    # fault lets reach it (the raise fires FIRST in _resolve_tick_inner):
    # raise hits ticks 3/6/9, so decode sees ticks 1,2,4,5,7,8,10,11,12
    # and every_nth=4 corrupts decode-hits 4 and 8 — ticks 5 and 11.
    # Seed-pure: both schedules are counter-driven, not probabilistic.
    corrupt_fires = 2
    plan = FaultPlan(
        name="resolver_exception",
        seed=seed,
        faults=[
            FaultSpec(
                "runtime.resolve.readback", "raise",
                every_nth=nth, max_fires=fires, exc="RuntimeError",
            ),
            FaultSpec(
                "transport.packed.decode", "corrupt",
                every_nth=4, max_fires=corrupt_fires,
            ),
        ],
    )
    futures = []
    try:
        with session.window(plan):
            for _ in range(n):
                futures.append(client.submit_acquire(resource))
            results = [f.result(timeout=60.0) for f in futures]
    finally:
        client.stop()
    passed = sum(1 for v, _w in results if v in (ERR.PASS, ERR.PASS_WAIT))
    blocked = len(results) - passed
    ctx = ScenarioContext(
        metrics=metrics,
        client=client,
        submitted=n,
        passed=passed,
        blocked=blocked,
        futures=futures,
        injected=session.injected,
        expect_injected={
            "runtime.resolve.readback:raise": fires,
            "transport.packed.decode:corrupt": corrupt_fires,
        },
        extra={
            "expect_metric_deltas": {
                # every raise AND every detected corruption fails its tick
                # closed through the same _resolve_tick handler...
                "sentinel_resolve_failures_total": fires + corrupt_fires,
                # ...but only the corruptions are wire-checksum rejections
                "sentinel_packed_decode_failures_total": corrupt_fires,
            },
        },
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "no-stranded-futures",
            "metric-deltas",
            "pipeline-drained",
            "injected-as-planned",
        ],
        ctx,
    )
    if blocked != fires + corrupt_fires:
        verdicts.append(
            Verdict(
                "fail-closed-count",
                False,
                f"blocked={blocked}, expected exactly the "
                f"{fires + corrupt_fires} injected ticks",
            )
        )
    return _result("resolver_exception", seed, session, verdicts, t0)


def _scn_seg_overflow_storm(seed: int, device: str = "cuda") -> ScenarioResult:
    """Fail-closed segment-capacity overflow: a storm of distinct keys
    exceeds seg_u while the FIRST grow-and-swap attempt is made to fail
    (injected raise) — overflow items must fail CLOSED and be counted,
    serving must continue on the old capacity, and the next storm's
    retry resize must succeed and stop the drops.  Runs the fused/
    segment engine: on the card its effects land through the B1 / B3 /
    B4 kernels (``ops/fused.py``, ``ops/segscan.py``)."""
    import numpy as np

    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import small_engine_config

    t0 = mono_s()
    cfg = small_engine_config(
        max_resources=256,  # room for 64 distinct storm keys + reserved rows
        max_nodes=512,
        use_mxu_tables=True,
        fused_effects=True,
        seg_effects=True,
        seg_fallback=False,
        seg_u=16,
        batch_size=64,
        complete_batch_size=64,
    )
    client = _make_client(device, cfg=cfg, entry_timeout_s=120.0)
    rids = np.asarray(
        [client.registry.resource_id(f"chaos/seg{i:02d}") for i in range(64)],
        np.int32,
    )
    metrics = MetricsDelta()
    session = _Session()
    # first resize attempt dies mid-swap; the storm's overflow then
    # drops fail-closed on the undersized engine.  The NEXT overflow
    # retries the resize (only delayed this time) and recovers.
    plan = FaultPlan(
        name="seg_overflow_storm",
        seed=seed,
        faults=[
            FaultSpec(
                "runtime.seg.resize", "raise",
                burst_start=0, burst_len=1, exc="RuntimeError",
            ),
            FaultSpec("runtime.seg.resize", "delay", delay_ms=1.0),
        ],
    )
    counts = {"passed": 0, "blocked": 0}
    storm2 = {"passed": 0, "blocked": 0}
    try:
        with session.window(plan):
            for storm, acc in ((0, counts), (1, storm2)):
                v, _w = client.check_batch_ids(rids, timeout_s=120.0)
                acc["passed"] += int((v == ERR.PASS).sum()) + int(
                    (v == ERR.PASS_WAIT).sum()
                )
                acc["blocked"] += int(
                    ((v != ERR.PASS) & (v != ERR.PASS_WAIT)).sum()
                )
    finally:
        client.stop()
    ctx = ScenarioContext(
        metrics=metrics,
        client=client,
        submitted=128,
        passed=counts["passed"] + storm2["passed"],
        blocked=counts["blocked"] + storm2["blocked"],
        injected=session.injected,
        expect_injected={
            "runtime.seg.resize:raise": 1,
            "runtime.seg.resize:delay": 2,
        },
        extra={
            "expect_seg_drops": True,
            "expect_metric_deltas": {"sentinel_seg_resizes_total": 2},
        },
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "seg-drops-counted",
            "metric-deltas",
            "pipeline-drained",
            "injected-as-planned",
        ],
        ctx,
    )
    if storm2["blocked"]:
        verdicts.append(
            Verdict(
                "post-resize-capacity",
                False,
                f"{storm2['blocked']} drops AFTER the seg_u grow-and-swap",
            )
        )
    return _result("seg_overflow_storm", seed, session, verdicts, t0)


def _scn_datasource_flap(seed: int, device: str = "cuda") -> ScenarioResult:
    """The rule-file refresh loop faults for a burst: the loaded rule set
    must hold (enforcement unchanged), and the first healthy refresh must
    apply the update that accumulated during the flap.  A second fault
    window then breaks the TIMELINE metric-log's disk writes
    (``datasource.metriclog.write``): the timeline fails OPEN — entry
    verdicts are untouched, every failed flush is counted in
    ``sentinel_timeline_write_failures_total``, and the injected counts
    stay a pure function of the seed (flushes fire on virtual-time
    second boundaries the scenario controls)."""
    import json as _json

    from sentinel_tpu_torch.core import rules as R
    from sentinel_tpu_torch.datasource.base import FileRefreshableDataSource

    t0 = mono_s()
    tl_dir = tempfile.mkdtemp(prefix="sentinel_chaos_timeline_")
    client = _make_client(device, timeline_log=True, timeline_dir=tl_dir)
    vt = client.time
    resource = "chaos/ds"

    def parser(s):
        return [R.FlowRule(resource=resource, count=float(_json.loads(s)["count"]))]

    fd, path = tempfile.mkstemp(prefix="sentinel_chaos_rules_", suffix=".json")
    os.close(fd)
    ds = None
    metrics = MetricsDelta()
    session = _Session()
    plan = FaultPlan(
        name="datasource_flap",
        seed=seed,
        faults=[
            FaultSpec(
                "datasource.refresh.read", "raise",
                burst_start=0, burst_len=3, exc="OSError",
            )
        ],
    )
    totals = {"passed": 0, "blocked": 0}
    extra = {}
    try:
        with open(path, "w") as f:
            f.write('{"count": 2}')
        # refresh_ms is huge: the daemon poll never fires; the scenario
        # calls refresh() itself so hit indices are exact
        ds = FileRefreshableDataSource(path, parser, refresh_ms=3_600_000)
        client.flow_rules.register_property(ds.get_property())
        with session.window(plan):
            got = _drain_entries(client, resource, 4)  # limit 2 -> 2/2
            totals["passed"] += got["passed"]
            totals["blocked"] += got["blocked"]
            with open(path, "w") as f:
                f.write('{"count": 5}')
            for _ in range(3):  # faulted refreshes: rules must hold
                ds.refresh()
            intact = [r.count for r in client.flow_rules.get()] == [2.0]
            vt.advance(1100)
            got = _drain_entries(client, resource, 4)
            intact = intact and got == {"passed": 2, "blocked": 2}
            extra["rules_intact_during_fault"] = intact
            totals["passed"] += got["passed"]
            totals["blocked"] += got["blocked"]
            ds.refresh()  # healed: the count-5 update applies
            extra["rules_updated_after_heal"] = [
                r.count for r in client.flow_rules.get()
            ] == [5.0]
            vt.advance(1100)
            got = _drain_entries(client, resource, 6)  # limit 5 -> 5/1
            totals["passed"] += got["passed"]
            totals["blocked"] += got["blocked"]
        # phase 2: timeline metric-log disk writes fail — the timeline
        # must fail OPEN.  Each virtual-second advance makes the next
        # tick flush exactly one completed second of rows, so the site's
        # hit order (and therefore the injected count) is seed-pure.
        plan_tl = FaultPlan(
            name="datasource_flap_timeline",
            seed=seed + 1,
            faults=[
                FaultSpec(
                    "datasource.metriclog.write", "raise",
                    burst_start=0, burst_len=2, exc="OSError",
                )
            ],
        )
        with session.window(plan_tl):
            for _ in range(2):  # two flushes, both injected to fail
                vt.advance(1100)
                got = _drain_entries(client, resource, 6)  # limit 5 -> 5/1
                extra["timeline_fall_open_decisions"] = (
                    extra.get("timeline_fall_open_decisions", True)
                    and got == {"passed": 5, "blocked": 1}
                )
                totals["passed"] += got["passed"]
                totals["blocked"] += got["blocked"]
    finally:
        if ds is not None:
            ds.close()
        os.unlink(path)
        client.stop()
        import shutil

        shutil.rmtree(tl_dir, ignore_errors=True)
    extra["expect_metric_deltas"] = {
        "sentinel_timeline_write_failures_total": 2,
    }
    ctx = ScenarioContext(
        metrics=metrics,
        client=client,
        submitted=26,
        passed=totals["passed"],
        blocked=totals["blocked"],
        injected=session.injected,
        expect_injected={
            "datasource.refresh.read:raise": 3,
            "datasource.metriclog.write:raise": 2,
        },
        extra=extra,
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "rules-intact",
            "pipeline-drained",
            "injected-as-planned",
            "metric-deltas",
        ],
        ctx,
    )
    verdicts.append(
        Verdict(
            "timeline-fails-open",
            bool(extra.get("timeline_fall_open_decisions")),
            "entry verdicts must not change while metric-log writes fail",
        )
    )
    return _result("datasource_flap", seed, session, verdicts, t0)


def _scn_shard_reconnect(seed: int, device: str = "cuda") -> ScenarioResult:
    """Mid-window shard partition: with chunks pipelined, the transport
    dies between dispatch and reply.  Answered chunks keep their remote
    verdicts, written-but-unanswered chunks degrade to the fallback, the
    shard host never sees a chunk twice, and a later batch reconnects."""
    from sentinel_tpu_torch.parallel.remote_shard import RemoteShard

    t0 = mono_s()
    decision, svc, server = _make_token_server(device, flow_count=100.0)
    fallback = _make_client(device)
    shard = RemoteShard(
        "127.0.0.1",
        server.port,
        timeout_s=2.0,
        fallback=fallback,
        retry_interval_s=0.1,
    )
    shard.CHUNK = 4
    names = [f"chaos/shard{i}" for i in range(12)]
    metrics = MetricsDelta()
    session = _Session()
    observe = FaultPlan(name="observe", seed=seed, faults=[])
    partition = FaultPlan(
        name="partition",
        seed=seed,
        faults=[FaultSpec("parallel.shard.recv", "drop", max_fires=1)],
    )
    results = {}
    server_hits = 0

    def _await_server_chunks(st, want: int):
        # the server processes written chunks asynchronously (worker
        # pool); the count converges — only its final value is asserted
        deadline = mono_s() + 10.0
        while st.hit_counts().get("cluster.server.process", 0) < want:
            if mono_s() > deadline:
                break
            _time.sleep(0.01)
        return st.hit_counts().get("cluster.server.process", 0)

    try:
        with session.window(observe) as st:
            results["a"] = shard.check_batch(names)  # 3 chunks answered
            server_hits += _await_server_chunks(st, 3)
        with session.window(partition) as st:
            # chunks dispatched, then the first reply read is dropped ->
            # peer-closed -> all in-flight chunks forfeited, no replay
            results["b"] = shard.check_batch(names)
            server_hits += _await_server_chunks(st, 3)
        _time.sleep(0.15)  # past retry_interval_s: the shard may reconnect
        with session.window(observe) as st:
            results["c"] = shard.check_batch(names[:4])  # 1 chunk, remote again
            server_hits += _await_server_chunks(st, 1)
    finally:
        shard.close()
        fallback.stop()
        server.stop()
        decision.stop()

    from sentinel_tpu_torch.core import errors as ERR

    submitted = sum(len(v) for v in results.values())
    passed = sum(
        1
        for out in results.values()
        for v, _w in out
        if v in (ERR.PASS, ERR.PASS_WAIT)
    )
    ctx = ScenarioContext(
        metrics=metrics,
        client=fallback,
        submitted=submitted,
        passed=passed,
        blocked=submitted - passed,
        injected=session.injected,
        expect_injected={"parallel.shard.recv:drop": 1},
        extra={
            "chunks_written": 7,  # 3 + 3 + 1
            "server_chunks_processed": server_hits,
            "expect_metric_deltas": {
                "sentinel_shard_chunks_total": 4,
                "sentinel_shard_chunks_degraded_total": 3,
            },
        },
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "no-chunk-replay",
            "metric-deltas",
            "pipeline-drained",
            "injected-as-planned",
        ],
        ctx,
    )
    return _result("shard_reconnect", seed, session, verdicts, t0)


def _scn_shard_failover(seed: int, device: str = "cuda") -> ScenarioResult:
    """Shard-kill / partition / rejoin against a real 2-shard fleet
    (cluster/shard.py), under protocol-v2 LEASE-FIRST admission: after
    the first remote decision bootstraps the standing lease, healthy
    repeats admit locally with zero RPCs, so the injected route failure
    is delivered through a param-token request (param budgets never
    lease, every one routes — the hit index stays a pure function of
    the seed).  One shard partitions; its flows drain the bounded-slack
    lease (local admits, then metered fallback) and fail CLOSED at
    exhaustion while the other shard is untouched; an injected
    ``cluster.lease.refresh_async`` raise drops exactly one
    ahead-of-exhaustion top-up (the lease keeps draining, the next
    trigger refills); a REAL kill + rejoin exercises the same protocol
    over an actual dead socket.  Token conservation: every local admit
    and fallback pass debits a lease the owner granted out of the
    global budget beforehand."""
    from sentinel_tpu_torch.cluster import constants as CC
    from sentinel_tpu_torch.cluster.shard import ShardFleet
    from sentinel_tpu_torch.core import rules as R

    t0 = mono_s()
    decisions = []

    def factory():
        c = _make_client(device)
        decisions.append(c)
        return c

    fleet = ShardFleet(
        factory,
        n_shards=2,
        lease_slack=0.5,
        retry_interval_s=300.0,  # heal is explicit, never a wall-clock race
        lease_ttl_ms=600_000,
        timeout_ms=5000,
        reconnect_interval_s=0.0,
    )
    # one flow per shard, found through the ring itself so the scenario
    # never hardcodes placement; big budget => healthy phases always pass
    fid_a = next(f for f in range(101, 500) if fleet.client.owner_of(f) == "shard-0")
    fid_b = next(f for f in range(101, 500) if fleet.client.owner_of(f) == "shard-1")
    fleet.load_flow_rules(
        "default",
        [
            R.FlowRule(
                resource=f"res-{fid}",
                count=100.0,
                cluster_mode=True,
                cluster_flow_id=fid,
                cluster_threshold_type=1,
            )
            for fid in (fid_a, fid_b)
        ],
    )
    metrics = MetricsDelta()
    session = _Session()
    # lease-first leaves exactly 2 route hits in the healthy phase (one
    # bootstrap decision per shard — repeats admit locally), so the
    # param-token partition probe is route hit 2.  The refresh_async
    # raise fires on that site's FIRST hit: the drain below crosses the
    # refresh threshold (remaining <= 50%) once at used=25.
    plan = FaultPlan(
        name="shard_failover",
        seed=seed,
        faults=[
            FaultSpec(
                "cluster.shard.route", "raise",
                burst_start=2, burst_len=1, max_fires=1, exc="ConnectionResetError",
            ),
            FaultSpec(
                "cluster.lease.refresh_async", "raise",
                max_fires=1, exc="RuntimeError",
            ),
        ],
    )
    counts = {"requests": 0, "ok": 0, "blocked": 0, "failed": 0, "other": 0}

    def drive(fid, n=1):
        for _ in range(n):
            r = fleet.client.request_token(fid)
            counts["requests"] += 1
            if r.status == CC.STATUS_OK:
                counts["ok"] += 1
            elif r.status == CC.STATUS_BLOCKED:
                counts["blocked"] += 1
            elif r.status == CC.STATUS_FAIL:
                counts["failed"] += 1
            else:
                counts["other"] += 1

    sh_a = fleet.client._shards["shard-0"]
    sh_b = fleet.client._shards["shard-1"]
    try:
        with session.window(plan):
            drive(fid_a, 2)          # route hit 0 + lease grant 50; repeat = local admit
            drive(fid_b, 2)          # route hit 1 + lease grant 50; repeat = local admit
            # param budgets never lease -> always route: hit 2 raises
            r = fleet.client.request_param_token(fid_a, 1, ["chaos"])
            counts["requests"] += 1
            counts["blocked" if r.status == CC.STATUS_BLOCKED else "other"] += 1
            failover_one_window = sh_a.degraded_active  # within ONE hysteresis window
            drive(fid_a, 3)          # degraded: metered lease-fallback passes, no route hits
            drive(fid_b, 2)          # other shard untouched: local admits, no route hits
            with sh_a.lock:          # heal: expire the cooldown explicitly
                sh_a.degraded_until = 0.0
            drive(fid_a, 1)          # probe (route hit 3) -> healthy -> exit degraded
            healed = not sh_a.degraded_active
            # drain fid_b toward the refresh threshold: used 3 -> 25
            # triggers top-up #1 (the injected raise eats it: lease
            # keeps draining), used 26 triggers top-up #2, which
            # refills inline (armed => deterministic) to granted=50
            drive(fid_b, 23)
        # -- real-kill phase (outside the armed window: injected counts
        # stay a pure function of the seed).  shard-1's server dies for
        # real; lease-first keeps its flow passing LOCALLY for exactly
        # the refilled slack (50), then fail-CLOSED; shard-0's flow is
        # untouched; rejoin on the ORIGINAL port + explicit cooldown
        # expiry brings it back.
        fleet.kill("shard-1")
        _time.sleep(0.2)  # let the client's reader observe the close
        drive(fid_b, 50)             # exactly-slack local admits against the dead owner
        drive(fid_b, 1)              # spent -> remote -> dead socket -> degraded, fail closed
        killed_over = sh_b.degraded_active
        drive(fid_b, 1)              # degraded + spent lease: still fail closed
        drive(fid_a, 1)              # shard-0 untouched: local admit
        fleet.rejoin("shard-1")
        with sh_b.lock:
            sh_b.degraded_until = 0.0
        drive(fid_b, 1)              # probe the rejoined server -> exit
        rejoined = not sh_b.degraded_active
        # quiesce the background refresher (disarmed kill-phase admits
        # may have queued async top-ups against the dead socket)
        fleet.client.flush_lease_refresh(5.0)
    finally:
        fleet.stop()
        for c in decisions:
            c.stop()

    lease_cap = 50  # ceil(100 * lease_slack); passes beyond it would be unmetered
    fallback_passes = int(
        metrics.delta('sentinel_shard_fallback_total{shard="shard-0",verdict="pass"}')
        + metrics.delta('sentinel_shard_fallback_total{shard="shard-1",verdict="pass"}')
    )
    local_admits = int(
        metrics.delta('sentinel_lease_local_admits_total{shard="shard-0"}')
        + metrics.delta('sentinel_lease_local_admits_total{shard="shard-1"}')
    )
    ctx = ScenarioContext(
        metrics=metrics,
        client=decisions[0],
        submitted=counts["requests"],
        passed=counts["ok"],
        blocked=counts["blocked"],
        degraded=counts["failed"] + counts["other"],
        # local admits + fallback passes both spend lease units: beyond
        # 2 × (cap + one top-up refill) they would be unmetered grants
        degraded_passes=max(fallback_passes + local_admits - 2 * lease_cap - 26, 0),
        injected=session.injected,
        expect_injected={
            "cluster.shard.route:raise": 1,
            "cluster.lease.refresh_async:raise": 1,
        },
        extra={
            "token_counts": counts,
            "expect_token_failures": 0,
            "expect_shard_transitions": {"shard-0": (1, 1), "shard-1": (1, 1)},
            "expect_metric_deltas": {
                'sentinel_shard_fallback_total{shard="shard-0",verdict="pass"}': 3,
                'sentinel_shard_fallback_total{shard="shard-0",verdict="block"}': 1,
                'sentinel_shard_fallback_total{shard="shard-1",verdict="pass"}': 0,
                'sentinel_shard_fallback_total{shard="shard-1",verdict="block"}': 2,
                'sentinel_shard_lease_tokens_total{shard="shard-0"}': lease_cap,
                # bootstrap grant (50) + the surviving top-up (26)
                'sentinel_shard_lease_tokens_total{shard="shard-1"}': lease_cap + 26,
                'sentinel_lease_local_admits_total{shard="shard-0"}': 2,
                # 1 healthy + 2 untouched + 23 drain + 50 exactly-slack
                'sentinel_lease_local_admits_total{shard="shard-1"}': 76,
            },
        },
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "token-conservation",
            "no-degraded-pass",
            "shard-degrade-hysteresis",
            "metric-deltas",
            "pipeline-drained",
            "injected-as-planned",
        ],
        ctx,
    )
    for nm, ok in (
        ("failover-within-one-window", failover_one_window),
        ("healed-on-first-probe", healed),
        ("real-kill-failover", killed_over),
        ("rejoin-restores-remote", rejoined),
    ):
        verdicts.append(Verdict(nm, ok, "" if ok else "expected transition missing"))
    return _result("shard_failover", seed, session, verdicts, t0)


def _scn_overload_storm(seed: int, device: str = "cuda") -> ScenarioResult:
    """Flash crowd at 2× backend capacity against the adaptive plane
    (adaptive/simload.py — a real sync client on virtual time over a
    fixed-capacity FIFO backend):

    * controller ON: the degrade ladder climbs rung by rung, excess
      admissions shed CLOSED, storm p99 stays bounded (< 10× healthy),
      goodput holds ≥ 50% of healthy, and recovery walks the ladder
      back to NORMAL — every transition monotone and journaled in the
      flight recorder;
    * controller OFF: the identical offered schedule demonstrably
      queue-collapses (p99 ≥ 10× healthy).

    A seeded ``runtime.client.admit`` raise-burst rides along: chaos on
    the admission check itself must shed CLOSED, never admit."""
    import sentinel_tpu_torch.runtime.client  # noqa: F401 — registers the admit/watchdog failpoints before the plan validates
    from sentinel_tpu_torch.adaptive.degrade import NORMAL
    from sentinel_tpu_torch.adaptive.simload import (
        run_overload_sim,
        storm_controller_preset,
    )
    from sentinel_tpu_torch.obs.flight import FLIGHT

    t0 = mono_s()
    metrics = MetricsDelta()
    session = _Session()
    fires = 3
    plan = FaultPlan(
        name="overload_storm",
        seed=seed,
        faults=[
            FaultSpec(
                "runtime.client.admit", "raise",
                every_nth=50, max_fires=fires, exc="RuntimeError",
            )
        ],
    )
    # SLO burn-rate phase (obs/slo.py): a shed-ratio objective anchored
    # BEFORE the storm must page on the storm's registry deltas and land
    # an auto-captured flight bundle.  Evaluation is registry reads only
    # — it crosses no failpoint site, so injected counts stay seed-pure.
    from sentinel_tpu_torch.obs.slo import CounterSum, SloEngine, SloSpec

    slo_spec = SloSpec(
        "shed_ratio",
        objective=0.999,  # ≤0.1% shed budget: the 2× storm must page
        bad=CounterSum(("sentinel_shed_total",)),
        total=CounterSum(
            ("sentinel_shed_total", "sentinel_device_verdicts_total")
        ),
    )
    slo = SloEngine(specs=(slo_spec,))
    slo.step(0)  # pre-storm anchor snapshot
    seq0 = FLIGHT.recorded_total()
    with session.window(plan):
        # the preset is shared with bench.adaptive_overload_bench so the
        # gated experiment and the BENCH_r0N numbers stay one experiment
        on = run_overload_sim(
            adaptive=True, adaptive_cfg=storm_controller_preset(), device=device
        )
    FLIGHT.reset_rate_limit()  # pin bundle capture (prior scenarios may
    # have triggered within the min-interval window)
    slo_status = slo.step(6_000_000)[0]
    slo_bundle = FLIGHT.last_bundle()
    slo.close()
    off = run_overload_sim(adaptive=False, device=device)
    journal = [
        e
        for e in FLIGHT.events()
        if e["seq"] >= seq0 and e["kind"] == "adaptive.ladder"
    ]
    ctx = ScenarioContext(
        metrics=metrics,
        submitted=on.submitted,
        passed=on.passed,
        blocked=on.blocked,
        injected=session.injected,
        expect_injected={"runtime.client.admit:raise": fires},
        extra={
            "ladder_transitions": on.ladder_transitions,
            "expect_ladder_climb": True,
            "goodput_floor": on.goodput_floor,
        },
    )
    verdicts = evaluate(
        ["verdict-accounting", "ladder-monotone", "injected-as-planned"],
        ctx,
    )
    checks = [
        (
            "p99-bounded-on",
            on.p99_storm_ms <= 10 * max(on.p99_healthy_ms, 1.0),
            f"storm p99 {on.p99_storm_ms:.0f}ms vs healthy "
            f"{on.p99_healthy_ms:.0f}ms",
        ),
        (
            "goodput-held-on",
            on.goodput_storm >= 0.5 * on.goodput_healthy,
            f"storm {on.goodput_storm:.2f}/step vs healthy "
            f"{on.goodput_healthy:.2f}/step",
        ),
        (
            "queue-collapse-off",
            off.p99_storm_ms >= 10 * max(off.p99_healthy_ms, 1.0),
            f"controller OFF storm p99 {off.p99_storm_ms:.0f}ms vs healthy "
            f"{off.p99_healthy_ms:.0f}ms — no collapse means the storm "
            "proves nothing",
        ),
        (
            "ladder-recovered",
            on.final_level == NORMAL,
            f"final level {on.final_level}",
        ),
        (
            "ladder-journaled",
            len(journal) == len(on.ladder_transitions)
            and len(journal) > 0,
            f"{len(journal)} flight events vs "
            f"{len(on.ladder_transitions)} transitions",
        ),
        (
            "slo-burn-alert-fired",
            slo_status.fired and slo_status.alerting,
            f"shed-ratio burn {max(slo_status.burn.values(), default=0.0):.1f}"
            f" never crossed the page thresholds",
        ),
        (
            "slo-bundle-captured",
            slo_bundle is not None
            and slo_bundle.get("reason") == "slo-burn-shed_ratio"
            and "slo" in (slo_bundle.get("providers") or {})
            and any(
                e["kind"] == "slo.alert" and e["seq"] >= seq0
                for e in FLIGHT.events()
            ),
            "no auto-captured slo-burn bundle with an slo provider section",
        ),
    ]
    for nm, ok, detail in checks:
        verdicts.append(Verdict(nm, bool(ok), "" if ok else detail))
    return _result("overload_storm", seed, session, verdicts, t0)


def _scn_hotset_promote_fail(seed: int, device: str = "cuda") -> ScenarioResult:
    """Hot-set promotion failures (``runtime.hotset.promote`` raises):
    the ruled tail resources must stay sketched with stats failing OPEN
    (the sketch keeps observing them) and tail-rule verdicts failing
    CLOSED (the CMS threshold tables keep blocking).  After the armed
    window — all traffic is appended AFTER it, keeping injected counts a
    pure function of the seed (one promotion attempt per ruled tail
    resource in the load) — a clean rule load proves promotion heals and
    the healed resource enforces exactly.

    A second armed window exercises the profiling plane's failpoints
    (obs/profile.py): ``sketch.audit.shadow`` raising on every shadow
    tick must fail OPEN into ``sentinel_sketch_audit_failures_total``
    with EXACT seed-pure counts (no check/underestimate/eps counter
    moves), and ``obs.profile.capture`` raising must return an error
    payload with the tracer's enabled state restored; both heal on the
    first un-armed call."""
    import numpy as np

    from sentinel_tpu_torch.core import rules as R
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.obs import profile as PROF
    from sentinel_tpu_torch.obs import trace as OT

    t0 = mono_s()
    # tiny exact space (1-row promotion reserve) + sketch tail; the
    # manager's own promote loop is parked far above any scenario volume
    # so every runtime.hotset.promote hit comes from the rule loads
    client = _make_client(
        device,
        cfg=small_engine_config(
            max_resources=8, max_nodes=16, sketch_stats=True,
            sketch_width=256, hotset_promote_qps=1.0e9,
        )
    )
    vt = client.time
    metrics = MetricsDelta()
    session = _Session()
    totals = {"passed": 0, "blocked": 0}
    extra = {}
    try:
        # exhaust organic exact rows; two ruled + one heal resource intern
        # as sketch ids
        i = 0
        while not client.registry.is_sketch_id(
            client.registry.resource_id(f"burn-{i}")
        ):
            i += 1
        for n in ("tail-a", "tail-b"):
            assert client.registry.is_sketch_id(client.registry.resource_id(n))
        plan = FaultPlan(
            name="hotset_promote_fail",
            seed=seed,
            faults=[
                FaultSpec(
                    "runtime.hotset.promote", "raise",
                    burst_start=0, burst_len=2, exc="RuntimeError",
                )
            ],
        )
        with session.window(plan):
            # the ONLY armed-site traffic: one promotion attempt per
            # ruled tail resource, in load order — both injected to fail
            client.flow_rules.load(
                [
                    R.FlowRule(resource="tail-a", count=2.0),
                    R.FlowRule(resource="tail-b", count=2.0),
                ]
            )
        still_tail = all(
            client.registry.is_sketch_id(client.registry.peek_resource_id(n))
            for n in ("tail-a", "tail-b")
        )
        extra["stayed_sketched"] = still_tail
        # appended after the window: verdicts fail CLOSED (tail tables
        # enforce the un-promoted rules) ...
        closed = True
        for n in ("tail-a", "tail-b"):
            got = _drain_entries(client, n, 6)
            totals["passed"] += got["passed"]
            totals["blocked"] += got["blocked"]
            closed = closed and 1 <= got["passed"] <= 2
        extra["tail_verdicts_closed"] = closed
        # ... and stats fail OPEN (the sketch kept observing them)
        extra["stats_open"] = all(
            client.stats.resource(n)["passQps"] >= 1 for n in ("tail-a", "tail-b")
        )
        # heal: a CLEAN reload retries promotion — the first rule in load
        # order claims the one reserve row and enforces EXACTLY; the
        # other stays on its conservative tail fallback
        client.flow_rules.load(
            [
                R.FlowRule(resource="tail-a", count=2.0),
                R.FlowRule(resource="tail-b", count=2.0),
            ]
        )
        healed = not client.registry.is_sketch_id(
            client.registry.peek_resource_id("tail-a")
        ) and client.registry.is_sketch_id(
            client.registry.peek_resource_id("tail-b")
        )
        vt.advance(1_100)
        got = _drain_entries(client, "tail-a", 4)
        totals["passed"] += got["passed"]
        totals["blocked"] += got["blocked"]
        extra["heal_promotes_and_enforces"] = healed and got == {
            "passed": 2,
            "blocked": 2,
        }
        # -- profiling-plane fault window (obs/profile.py) ----------------
        # standalone shadow audit: every observe under the armed raise
        # burst fails OPEN (failure counter only — check/underestimate/
        # eps counters must not move), and one armed capture returns an
        # error payload with tracer state restored.  Counts are a pure
        # function of the loop bounds — seed-pure by construction.
        AUDIT_TICKS = 4
        audit = PROF.SketchAudit(
            node_rows=8, window_ms=500, sample_count=2, slack_buckets=1,
            width=256, k=1, period=2,
        )
        a_res = np.asarray([9], np.int32)
        a_cnt = np.asarray([1], np.int32)
        tracer_was = OT.TRACER.enabled
        plan2 = FaultPlan(
            name="profile_plane_fail",
            seed=seed,
            faults=[
                FaultSpec(
                    "sketch.audit.shadow", "raise",
                    burst_start=0, burst_len=AUDIT_TICKS, exc="RuntimeError",
                ),
                FaultSpec(
                    "obs.profile.capture", "raise",
                    burst_start=0, burst_len=1, exc="RuntimeError",
                ),
            ],
        )
        with session.window(plan2):
            for i in range(AUDIT_TICKS):
                audit.observe(1_000 + i, a_res, a_cnt)
            cap = PROF.capture_profile(
                ms=1.0, min_interval_s=0.0, sleep=lambda _s: None
            )
        extra["capture_failed_open"] = (
            "error" in cap and OT.TRACER.enabled == tracer_was
        )
        # heal: the first un-armed observe folds (shadow admits the id)
        # and a clean capture returns a chrome trace
        audit.observe(2_000, a_res, a_cnt)
        cap2 = PROF.capture_profile(
            ms=1.0, min_interval_s=0.0, sleep=lambda _s: None
        )
        extra["profile_plane_heals"] = (
            len(audit._tracked) == 1
            and "chrome_trace" in cap2
            and OT.TRACER.enabled == tracer_was
        )
    finally:
        client.stop()
    extra["expect_metric_deltas"] = {
        "sentinel_sketch_promotion_failures_total": 2,
        # profiling-plane window: EXACT fail-open accounting — the raise
        # burst lands only in the failure counter, never in the audit's
        # comparison counters
        "sentinel_sketch_audit_failures_total": float(AUDIT_TICKS),
        "sentinel_sketch_audit_checks_total": 0.0,
        "sentinel_sketch_underestimates_total": 0.0,
        "sentinel_sketch_eps_violations_total": 0.0,
        'sentinel_profile_captures_total{result="error"}': 1.0,
        'sentinel_profile_captures_total{result="ok"}': 1.0,
    }
    ctx = ScenarioContext(
        metrics=metrics,
        client=client,
        submitted=16,
        passed=totals["passed"],
        blocked=totals["blocked"],
        injected=session.injected,
        expect_injected={
            "runtime.hotset.promote:raise": 2,
            "sketch.audit.shadow:raise": 4,
            "obs.profile.capture:raise": 1,
        },
        extra=extra,
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "pipeline-drained",
            "injected-as-planned",
            "metric-deltas",
        ],
        ctx,
    )
    for nm, key, detail in (
        ("promote-fails-stay-sketched", "stayed_sketched",
         "failed promotions must leave resources on sketch ids"),
        ("tail-verdicts-fail-closed", "tail_verdicts_closed",
         "un-promoted tail rules must still block from the CMS tables"),
        ("stats-fail-open", "stats_open",
         "the sketch must keep observing resources promotion failed for"),
        ("heal-promotes-exactly", "heal_promotes_and_enforces",
         "a clean load must promote into the reserve and enforce exactly"),
        ("profile-capture-fails-open", "capture_failed_open",
         "an injected capture fault must return an error payload and "
         "restore the tracer's enabled state"),
        ("profile-plane-heals", "profile_plane_heals",
         "the first un-armed audit tick and capture must succeed"),
    ):
        verdicts.append(Verdict(nm, bool(extra.get(key)), detail))
    return _result("hotset_promote_fail", seed, session, verdicts, t0)


def _scn_tuner_fail_open(seed: int, device: str = "cuda") -> ScenarioResult:
    """Workload autotuner chaos (workload/tuner.py + generator.py).

    Phase 1 (quiet): a seeded flash-crowd closed loop retunes the live
    operating point at least once — expected retraces only, HBM breach
    counter flat.  Phase 2 (armed): ``workload.tuner.step`` raises on a
    hit-index burst and ``workload.gen.emit`` drops seeded generator
    steps.  A raising tuner step must fail OPEN — serving verdicts
    untouched (accounting stays exact), the point rolled back to
    last-good, failures counted exactly in
    ``sentinel_tuner_step_failures_total`` — and dropped emissions land
    only in ``sentinel_workload_emit_drops_total`` (never offered, so
    verdict accounting is green by construction).  All injected counts
    are hit-index/max_fires gated on single-threaded sites: seed-pure."""
    from sentinel_tpu_torch.obs import profile as PROF
    from sentinel_tpu_torch.workload import (
        TunerConfig,
        flash_crowd_2x,
        run_closed_loop,
        sim_default_op,
    )

    t0 = mono_s()
    metrics = MetricsDelta()
    session = _Session()
    surprises0 = PROF.RETRACE.surprise_count()
    client = _make_client(device)
    op0 = sim_default_op()
    cands = [
        op0.replace(batch_size=16, complete_batch_size=16),
        op0.replace(batch_size=8, complete_batch_size=8),
    ]
    tcfg = TunerConfig(settle_steps=3, warmup_steps=1)
    extra = {}
    try:
        # -- phase 1: quiet closed loop — the tuner must actually move --
        quiet = run_closed_loop(
            client,
            flash_crowd_2x(seed=seed, base=3.0, steps=60, start_step=10),
            op0,
            cands,
            tune=True,
            tune_every=4,
            tcfg=tcfg,
        )
        extra["retuned_live"] = any(
            d["action"] == "applied" for d in quiet.decisions
        )
        # -- phase 2: armed window -------------------------------------
        tuner_fires, emit_fires = 2, 2
        plan = FaultPlan(
            name="tuner_fail_open",
            seed=seed,
            faults=[
                FaultSpec(
                    "workload.tuner.step", "raise",
                    burst_start=1, burst_len=tuner_fires,
                    exc="RuntimeError",
                ),
                FaultSpec(
                    "workload.gen.emit", "raise",
                    every_nth=7, max_fires=emit_fires, exc="RuntimeError",
                ),
            ],
        )
        with session.window(plan):
            armed = run_closed_loop(
                client,
                flash_crowd_2x(
                    seed=seed + 1, base=3.0, steps=40, start_step=8
                ),
                op0.replace(
                    batch_size=client.cfg.batch_size,
                    complete_batch_size=client.cfg.complete_batch_size,
                ),
                cands,
                tune=True,
                tune_every=4,
                tcfg=tcfg,
            )
        fail_opens = [
            d for d in armed.decisions if d["action"] == "fail_open"
        ]
        best = armed.converged_op
        extra["fail_open_exact"] = len(fail_opens) == tuner_fires
        # fail-open target: the engine must END the armed phase ON the
        # tuner's last-good point, not stranded on a mid-walk candidate
        extra["on_last_good"] = (
            client.cfg.batch_size == best.batch_size
            and client.cfg.complete_batch_size == best.complete_batch_size
        )
        extra["zero_surprise_retraces"] = (
            PROF.RETRACE.surprise_count() == surprises0
        )
        submitted = quiet.submitted + armed.submitted
        passed = quiet.passed + armed.passed
        blocked = quiet.blocked + armed.blocked
    finally:
        client.stop()
    extra["expect_metric_deltas"] = {
        "sentinel_tuner_step_failures_total": float(tuner_fires),
        "sentinel_workload_emit_drops_total": float(emit_fires),
        # retuning must never trade latency for capacity headroom
        "sentinel_hbm_capacity_breaches_total": 0.0,
    }
    ctx = ScenarioContext(
        metrics=metrics,
        client=client,
        submitted=submitted,
        passed=passed,
        blocked=blocked,
        injected=session.injected,
        expect_injected={
            "workload.tuner.step:raise": tuner_fires,
            "workload.gen.emit:raise": emit_fires,
        },
        extra=extra,
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "pipeline-drained",
            "injected-as-planned",
            "metric-deltas",
        ],
        ctx,
    )
    for nm, key, detail in (
        ("retuned-live", "retuned_live",
         "the quiet phase must apply at least one live retune"),
        ("fail-open-exact", "fail_open_exact",
         "each injected tuner-step raise must journal exactly one "
         "fail-open decision"),
        ("fail-open-to-last-good", "on_last_good",
         "after the armed window the engine must sit on the tuner's "
         "last-good operating point"),
        ("zero-surprise-retraces", "zero_surprise_retraces",
         "every retune recompile must journal an expected_retrace cause"),
    ):
        verdicts.append(Verdict(nm, bool(extra.get(key)), detail))
    return _result("tuner_fail_open", seed, session, verdicts, t0)


def _scn_explain_fail_open(seed: int, device: str = "cuda") -> ScenarioResult:
    """The verdict provenance plane is strictly observational: with the
    ``obs.explain.decode`` failpoint mangling (corrupt window) and then
    raising inside (raise window) the explain-section decode, the verdict
    stream must be BIT-IDENTICAL to an unfaulted control run over the
    same traffic — explanation loss is counted
    (``sentinel_explain_decode_failures_total``) and records demonstrably
    go missing from the plane, but no decision ever changes."""
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core import rules as R

    t0 = mono_s()
    resource = "chaos/explain"
    rule = [R.FlowRule(resource=resource, count=2.0)]
    ticks, per_tick = 6, 4

    def _drive(client):
        """Identical deterministic traffic: one warm tick, then `ticks`
        batches inside one unadvanced window so the filled window keeps
        every later item BLOCKED (explain records on every tick)."""
        client.flow_rules.load(rule)
        client.check_batch([resource])  # warm tick outside the windows
        out = []
        for _ in range(ticks):
            out.extend(client.check_batch([resource] * per_tick))
        return out

    metrics = MetricsDelta()
    session = _Session()
    control = _make_client(device)
    faulted = _make_client(device)
    corrupt_fires, raise_fires = 2, 1
    try:
        baseline = _drive(control)
        control_explained = control.explain_coverage()["explained"]
        faulted.flow_rules.load(rule)
        faulted.check_batch([resource])  # same warm tick, outside windows
        got = []
        # window 1: mangled section bytes on decode hits 2 and 4
        plan = FaultPlan(
            name="explain-corrupt", seed=seed,
            faults=[FaultSpec(
                "obs.explain.decode", "corrupt",
                every_nth=2, max_fires=corrupt_fires,
            )],
        )
        with session.window(plan):
            for _ in range(4):
                got.extend(faulted.check_batch([resource] * per_tick))
        # window 2: the decode path itself raises (same fail-open contract)
        plan = FaultPlan(
            name="explain-raise", seed=seed,
            faults=[FaultSpec(
                "obs.explain.decode", "raise",
                max_fires=raise_fires, exc="RuntimeError",
            )],
        )
        with session.window(plan):
            for _ in range(2):
                got.extend(faulted.check_batch([resource] * per_tick))
    finally:
        control.stop()
        faulted.stop()
    passed = sum(1 for v, _w in got if v in (ERR.PASS, ERR.PASS_WAIT))
    blocked = len(got) - passed
    ctx = ScenarioContext(
        metrics=metrics,
        client=faulted,
        submitted=ticks * per_tick,
        passed=passed,
        blocked=blocked,
        injected=session.injected,
        expect_injected={
            "obs.explain.decode:corrupt": corrupt_fires,
            "obs.explain.decode:raise": raise_fires,
        },
        extra={
            "expect_metric_deltas": {
                # every injected mangle/raise is one dropped section —
                # and zero of them touched the verdict decode path
                "sentinel_explain_decode_failures_total": (
                    corrupt_fires + raise_fires
                ),
                "sentinel_packed_decode_failures_total": 0,
                "sentinel_resolve_failures_total": 0,
            },
        },
    )
    verdicts = evaluate(
        [
            "verdict-accounting",
            "metric-deltas",
            "pipeline-drained",
            "injected-as-planned",
        ],
        ctx,
    )
    verdicts.append(
        Verdict(
            "verdicts-bit-identical",
            got == baseline,
            f"faulted run diverged from control: {got} != {baseline}"
            if got != baseline else "",
        )
    )
    verdicts.append(
        Verdict(
            "blocks-under-fault",
            blocked > 0,
            f"blocked={blocked}: the armed windows must cover real blocks",
        )
    )
    lost = control_explained - faulted.explain_coverage()["explained"]
    verdicts.append(
        Verdict(
            "explanations-actually-lost",
            lost > 0,
            f"control explained {control_explained}, faulted explained "
            f"{control_explained - lost} — the faults must cost records",
        )
    )
    return _result("explain_fail_open", seed, session, verdicts, t0)


def _result(name, seed, session, verdicts, t0) -> ScenarioResult:
    return ScenarioResult(
        name=name,
        seed=seed,
        ok=all(v.ok for v in verdicts),
        injected=dict(sorted(session.injected.items())),
        verdicts=verdicts,
        duration_s=mono_s() - t0,
    )


# -- registry ----------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """One built-in scenario.  ``eager`` is the reference's flag (it runs
    the scenario under ``jax.disable_jit``, interpret-mode Pallas); the
    port keeps it, with the same values, for the listing, and it changes
    nothing here: the port's engine has no jit to disable."""

    name: str
    fn: Callable[[int, str], ScenarioResult]
    description: str
    fast: bool = True  # tier-1 CI subset member
    eager: bool = False


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            "rpc_error_burst",
            _scn_rpc_error_burst,
            "token RPC send-failure + latency burst against a live server",
            fast=False,
        ),
        Scenario(
            "cluster_partition",
            _scn_cluster_partition,
            "token-server partition: degrade to local, hold, heal, exit",
        ),
        Scenario(
            "resolver_exception",
            _scn_resolver_exception,
            "readback raises + fused-wire corruption; ticks fail closed, "
            "nothing strands",
        ),
        Scenario(
            "seg_overflow_storm",
            _scn_seg_overflow_storm,
            "fail-closed segment overflow + live seg_u grow-and-swap",
            fast=False,
            eager=True,
        ),
        Scenario(
            "datasource_flap",
            _scn_datasource_flap,
            "rule-file refresh faults; rules hold, post-heal update applies",
        ),
        Scenario(
            "shard_reconnect",
            _scn_shard_reconnect,
            "mid-window shard partition: degrade forfeited chunks, no replay",
        ),
        Scenario(
            "shard_failover",
            _scn_shard_failover,
            "fleet shard kill/partition/rejoin: lease fallback, per-shard hysteresis",
        ),
        Scenario(
            "overload_storm",
            _scn_overload_storm,
            "2x-capacity flash crowd: ladder climbs, sheds, recovers; OFF collapses",
        ),
        Scenario(
            "hotset_promote_fail",
            _scn_hotset_promote_fail,
            "hot-set promotion + profiling-plane faults: stats/audit/capture "
            "fail open, tail verdicts fail closed",
        ),
        Scenario(
            "explain_fail_open",
            _scn_explain_fail_open,
            "explain-section decode faults: provenance drops (counted), "
            "verdicts bit-identical to the unfaulted control run",
        ),
        Scenario(
            "tuner_fail_open",
            _scn_tuner_fail_open,
            "workload autotuner faults: raising steps fail OPEN to the "
            "last-good operating point, dropped emissions counted exactly",
            eager=True,
        ),
    )
}


def run_scenario(name: str, seed: int, device: str = "cuda") -> ScenarioResult:
    """One scenario on ``device`` (the card unless the caller asks for the
    CPU; raises where CUDA is asked for and absent)."""
    return SCENARIOS[name].fn(seed, device)


def run_all(
    seed: int,
    names: Optional[List[str]] = None,
    fast_only: bool = False,
    device: str = "cuda",
) -> List[ScenarioResult]:
    picked = names or [
        n for n, s in SCENARIOS.items() if (s.fast or not fast_only)
    ]
    return [run_scenario(n, seed, device) for n in picked]


def report(results: List[ScenarioResult], as_json: bool = False) -> str:
    if as_json:
        return json.dumps([r.to_dict() for r in results], indent=2, sort_keys=True)
    lines = []
    for r in results:
        mark = "PASS" if r.ok else "FAIL"
        lines.append(f"[{mark}] {r.name} (seed={r.seed}, {r.duration_s:.2f}s)")
        inj = ", ".join(f"{k}={v}" for k, v in sorted(r.injected.items())) or "none"
        lines.append(f"       injected: {inj}")
        for v in r.verdicts:
            lines.append(
                f"       {'ok ' if v.ok else 'RED'} {v.name}"
                + (f" — {v.detail}" if (v.detail and not v.ok) else "")
            )
    total = sum(1 for r in results if r.ok)
    lines.append(f"{total}/{len(results)} scenarios green")
    return "\n".join(lines)
