"""sentinel_tpu_torch.obs.slo and obs.fleet against the JAX package's.

The counterparts of tests/test_fleet_slo.py's SLO and fleet-merge cases:
each scenario runs once through each package's modules (registries,
flight recorders, SLO engines and fleet merges of its own) on the same
counter sequence, and the two outcomes must be equal — ``SloStatus
.to_dict()`` at every step, the rendered merged expositions, the merged
timelines, the ``sentinel_fleet_shard_info`` topology lines — beside the
reference test's own assertions.  (The live four-shard fleet case is
tests/test_torch_shard_fleet.py::test_metrics_fleet_over_a_live_four_shard_fleet.)

Then the port's serving client: every metric name ``default_slos()``
reads must exist in the port's registry after a serving run, a sharded
token fleet's requests and a router's failed leg, as it does in the
reference — a spec over a counter nobody registers reads 0 and would
hide a burn — and the three series ``fleet_error_budget`` reads move as
the reference's do on the same sequence.

Tolerances: everything compared here is an integer count, a string, or a
float computed by the same host arithmetic on equal inputs: equal.
"""

from __future__ import annotations

import importlib
import re

import pytest

from sentinel_tpu.obs import fleet as JF
from sentinel_tpu.obs import slo as JS
from sentinel_tpu.obs.flight import FlightRecorder as JFlight
from sentinel_tpu.obs.registry import MetricRegistry as JReg

from sentinel_tpu_torch.obs import fleet as TF
from sentinel_tpu_torch.obs import slo as TS
from sentinel_tpu_torch.obs.flight import FlightRecorder as TFlight
from sentinel_tpu_torch.obs.registry import MetricRegistry as TReg

#: (package label, slo module, fleet module, registry class, flight class)
PKGS = {
    "jax": (JS, JF, JReg, JFlight),
    "torch": (TS, TF, TReg, TFlight),
}

#: the exposition-lines grammar the repo pins (tests/test_obs.py)
_LINE_PAT = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9][0-9a-zA-Z+.e-]*$")


def _assert_wellformed(text: str) -> None:
    for line in text.strip().split("\n"):
        if line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE ", "# EXEMPLAR ")), line
        else:
            assert _LINE_PAT.match(line), line


def _member_registry(Reg, i: int, hot: int = 0):
    """A synthetic per-process registry (tests/test_fleet_slo.py's): scrape
    id, per-shard counters, a shared counter, a histogram, a gauge."""
    r = Reg()
    r.gauge("sentinel_scrape_id", "id", labels={"id": f"proc-{i}"}).set(1)
    r.counter("sentinel_shard_requests_total", "reqs", labels={"shard": f"shard-{i}"}).inc(100 * (i + 1))
    r.counter("sentinel_token_decisions_total", "dec").inc(7)
    h = r.histogram("sentinel_cluster_rpc_ms", "rpc")
    for _ in range(100 - hot):
        h.observe(1.0)
    for _ in range(hot):
        h.observe(100.0)
    r.gauge("sentinel_pipeline_occupancy", "occ").set(float(i))
    return r


def _both(fn):
    out = {name: fn(*mods) for name, mods in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- fleet merge ---------------------------------------------------------------


def test_fleet_merge_counter_sums_and_histogram_quantiles():
    def run(S, F, Reg, Flight):
        texts = [_member_registry(Reg, i, hot=50 * i).exposition() for i in range(3)]
        merged = F.merge_scrapes([F.parse_exposition(t) for t in texts])
        out = F.render_exposition(merged)
        back = F.parse_exposition(out)
        return merged.members, merged.duplicates, merged.skipped_series, out, back.hists

    members, dups, skipped, out, hists = _both(run)
    assert members == 3 and dups == 0 and skipped == 0
    _assert_wellformed(out)
    assert 'sentinel_shard_requests_total{shard="shard-0"} 100' in out
    assert 'sentinel_shard_requests_total{shard="shard-2"} 300' in out
    assert "sentinel_token_decisions_total 21" in out
    assert "sentinel_pipeline_occupancy 2" in out
    h = hists[("sentinel_cluster_rpc_ms", ())]
    assert h["count"] == 300 and h["sum"] == pytest.approx(150 * 1.0 + 150 * 100.0)
    by_bound = sorted(h["buckets"].items(), key=lambda kv: TF._le_sort_key(kv[0]))
    assert next(cum for le, cum in by_bound if float(le) >= 1.0) == 150
    assert by_bound[-1][1] == 300


def test_fleet_merge_drops_same_process_duplicate():
    def run(S, F, Reg, Flight):
        t = _member_registry(Reg, 0).exposition()
        merged = F.merge_scrapes([F.parse_exposition(t), F.parse_exposition(t)])
        return merged.members, merged.duplicates, F.render_exposition(merged)

    members, dups, out = _both(run)
    assert members == 1 and dups == 1
    assert 'sentinel_shard_requests_total{shard="shard-0"} 100' in out
    assert "sentinel_scrape_id" not in out


def test_fleet_exposition_counts_errors_and_members():
    def run(S, F, Reg, Flight):
        t1 = _member_registry(Reg, 1).exposition()

        def fetch(url):
            if "dead" in url:
                raise OSError("connection refused")
            return t1

        local = _member_registry(Reg, 0)
        # a live sharded token client (never started: its shards read as
        # unconnected, healthy) renders as the topology info lines
        shard = importlib.import_module(F.__name__.replace("obs.fleet", "cluster.shard"))
        client = shard.ShardedTokenClient({"shard-0": ("127.0.0.1", 1), "shard-1": ("127.0.0.1", 2)},
                                          namespace="slo-fleet")
        try:
            return F.fleet_exposition(targets=["peer:1", "dead:2"], fetch=fetch, registry=local)
        finally:
            client.close()

    text = _both(run)
    _assert_wellformed(text)
    assert "sentinel_fleet_members 2" in text  # local + peer
    assert "sentinel_fleet_scrape_errors 1" in text
    info = [ln for ln in text.splitlines() if ln.startswith("sentinel_fleet_shard_info")]
    assert info == [f'sentinel_fleet_shard_info{{addr="127.0.0.1:{i + 1}",degraded="0",fleet="slo-fleet",'
                    f'shard="shard-{i}"}} 1' for i in range(2)]


def test_fleet_target_registry_and_env(monkeypatch):
    def run(S, F, Reg, Flight):
        F.set_fleet_targets([])
        F.add_fleet_target("a:1")
        F.add_fleet_target("a:1")  # idempotent
        monkeypatch.setenv("SENTINEL_FLEET_TARGETS", "b:2, a:1")
        got = F.fleet_targets()
        monkeypatch.delenv("SENTINEL_FLEET_TARGETS")
        F.set_fleet_targets([])
        return got, F._normalize_url("a:1"), F._normalize_url("http://a:1/metrics")

    targets, u1, u2 = _both(run)
    assert targets == ["a:1", "b:2"]
    assert u1 == u2 == "http://a:1/metrics"


def test_fleet_timelines_merge_per_second_with_provenance():
    rows = {
        "shard-a": [
            {"ts": 1000, "resource": "r", "pass": 3, "block": 1, "success": 3, "exception": 0, "rt_sum": 9.0,
             "concurrency": 1, "rt_min": 2.0},
            {"ts": 2000, "resource": "r", "pass": 1, "block": 0, "success": 1, "exception": 0, "rt_sum": 1.0,
             "concurrency": 0, "rt_min": 0.0},
        ],
        "shard-b": [
            {"ts": 1000, "resource": "r", "pass": 2, "block": 2, "success": 2, "exception": 1, "rt_sum": 4.0,
             "concurrency": 2, "rt_min": 1.5},
        ],
    }
    merged = _both(lambda S, F, Reg, Flight: F.merge_timelines(rows))
    assert merged[0]["pass"] == 5 and merged[0]["rt_min"] == 1.5
    assert merged[0]["sources"] == {"shard-a": 4.0, "shard-b": 4.0}
    assert merged[1]["rt_min"] == 0.0


# -- SLO engine ------------------------------------------------------------------


def _shed_spec(S):
    return S.SloSpec(
        "shed_ratio",
        objective=0.99,
        bad=S.CounterSum(("sentinel_shed_total",)),
        total=S.CounterSum(("sentinel_shed_total", "sentinel_device_verdicts_total")),
    )


def test_slo_burn_alert_fires_bundles_and_clears():
    def run(S, F, Reg, Flight):
        reg, greg, fl = Reg(), Reg(), Flight()
        good = reg.counter("sentinel_device_verdicts_total", "v", labels={"verdict": "pass"})
        shed = reg.counter("sentinel_shed_total", "s", labels={"stage": "admit", "reason": "queue_full"})
        eng = S.SloEngine(specs=(_shed_spec(S),), registry=reg, flight=fl, gauge_registry=greg)
        seq = []
        for now, dg, ds in ((0, 100, 0), (60_000, 1000, 0), (120_000, 600, 400), (180_000, 60, 40),
                            (4_000_000, 5000, 0)):
            good.inc(dg)
            shed.inc(ds)
            st = eng.step(now)[0]
            seq.append((st.to_dict(), st.fired, dict(st.burn)))
        b = fl.last_bundle()
        kinds = [e["kind"] for e in fl.events()]
        burn = greg.get("sentinel_slo_burn_rate", {"slo": "shed_ratio", "window": "300s"})
        budget = greg.get("sentinel_slo_budget_remaining", {"slo": "shed_ratio"})
        eng.close()
        return (seq, b["reason"], b["providers"]["slo"], kinds.count("slo.alert"),
                kinds.count("slo.alert.clear"), float(burn.value), float(budget.value))

    seq, reason, prov, n_alert, n_clear, burn, budget = _both(run)
    assert not seq[0][0]["alerting"] and seq[0][0]["budget_remaining"] == 1.0
    assert not seq[1][0]["alerting"] and not seq[1][1]
    assert seq[2][1] and seq[2][0]["alerting"] and max(seq[2][2].values()) > 14.4
    assert seq[3][0]["alerting"] and not seq[3][1]  # an alert is a transition
    assert not seq[4][0]["alerting"]
    assert reason == "slo-burn-shed_ratio" and prov["shed_ratio"]["alerting"] is True
    assert n_alert == 1 and n_clear == 1


def test_slo_latency_spec_histogram_over():
    def run(S, F, Reg, Flight):
        reg, greg, fl = Reg(), Reg(), Flight()
        h = reg.histogram("sentinel_tick_device_ms", "d")
        spec = S.SloSpec("req_p99", objective=0.99, latency=S.HistogramOver("sentinel_tick_device_ms", 10.0),
                         auto_bundle=False)
        eng = S.SloEngine(specs=(spec,), registry=reg, flight=fl, gauge_registry=greg)
        eng.step(0)
        for v in [1.0] * 50 + [100.0] * 50:
            h.observe(v)
        st = eng.step(60_000)[0]
        eng.close()
        return st.to_dict(), st.fired, fl.last_bundle() is None

    d, fired, no_bundle = _both(run)
    assert d["alerting"] and fired and no_bundle


def test_slo_default_specs_cover_the_six_objectives():
    specs = _both(lambda S, F, Reg, Flight: [
        (s.name, s.objective, s.windows, s.budget_window_ms, s.auto_bundle,
         None if s.bad is None else s.bad.names, None if s.total is None else s.total.names,
         None if s.latency is None else (s.latency.name, s.latency.threshold_ms))
        for s in S.default_slos()
    ])
    assert {s[0] for s in specs} == {
        "req_p99", "shed_ratio", "fail_closed", "fleet_error_budget", "sketch_eps", "hbm_capacity",
    }
    for s in specs:
        assert 0.0 < s[1] < 1.0 and s[2]


def test_slo_no_total_traffic_means_no_burn():
    def run(S, F, Reg, Flight):
        eng = S.SloEngine(specs=(_shed_spec(S),), registry=Reg(), flight=Flight(), gauge_registry=Reg())
        eng.step(0)
        st = eng.step(60_000)[0]
        eng.close()
        return st.to_dict(), dict(st.burn)

    d, burn = _both(run)
    assert not d["alerting"] and d["budget_remaining"] == 1.0
    assert all(v == 0.0 for v in burn.values())


#: the counters default_slos() reads that only the sharded token client
#: (cluster/shard.py) and the shard router (parallel/router.py) register
FLEET_BUDGET_NAMES = {
    "sentinel_shard_requests_total",
    "sentinel_shard_route_failures_total",
    "sentinel_shard_fallback_total",
}


class _DeadShard:
    def check_batch(self, resources, **kw):
        raise TimeoutError("shard leg timed out")


def _fleet_budget_run(pkg: str) -> dict:
    """The fleet_error_budget series' moves over one sequence: a one-shard
    fleet (a sync decision client on virtual time; the port's on the CPU)
    answers four tokens of a flow of threshold 2 (no lease), its shard
    dies and two more fail closed, then a router's leg times out twice."""
    import numpy as np

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    st, REG = importlib.import_module(pkg), mod("obs.registry").REGISTRY
    vt = mod("utils.time_source").VirtualTimeSource(1_000)

    def factory():
        kw = dict(device="cpu") if pkg == "sentinel_tpu_torch" else {}
        c = mod("runtime.client").SentinelClient(cfg=mod("core.config").small_engine_config(), time_source=vt,
                                                 mode="sync", **kw)
        if pkg == "sentinel_tpu":
            upload = c._dev_col  # a private copy per upload (ROADMAP.md Queue C: jnp.asarray may alias)
            c._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
        c.start()
        made.append(c)
        return c

    def series() -> dict:
        return {k: v for k, v in REG.snapshot().items() if k.split("{")[0] in FLEET_BUDGET_NAMES}

    made = []
    before = series()
    fleet = mod("cluster.shard").ShardFleet(factory, n_shards=1, lease_slack=0.0, retry_interval_s=300.0,
                                            timeout_ms=5000, reconnect_interval_s=0.0)
    try:
        fleet.load_flow_rules("default", [st.FlowRule(resource="r", count=2, cluster_mode=True,
                                                      cluster_flow_id=101, cluster_threshold_type=1)])
        statuses = [fleet.client.request_token(101).status for _ in range(4)]
        fleet.kill("shard-0")
        statuses += [fleet.client.request_token(101).status for _ in range(2)]
        router = mod("parallel.router").ShardRouter([made[0], _DeadShard()])
        other = next(f"x{i}" for i in range(100) if router.ring.owner(f"x{i}") == "1")
        verdicts = [v for _ in range(2) for v, _w in router.check_batch([other])]
    finally:
        fleet.stop()
        for svc in fleet.services.values():
            svc.close()
        for c in made:
            c.stop()
    after = series()
    return dict(statuses=statuses, verdicts=verdicts,
                moved={k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)})


def _slo_names(S) -> set:
    names = set()
    for s in S.default_slos():
        if s.latency is not None:
            names.add(s.latency.name)
        for cs in (s.bad, s.total):
            if cs is not None:
                names.update(cs.names)
    return names


def test_every_counter_default_slos_reads_exists_after_a_serving_run():
    """A spec whose counter the port never registers reads 0 and hides a
    burn: after a serving run (the sketch tier with its audit on, a
    capacity set, a shed), a sharded fleet's tokens and a router's failed
    leg, every name default_slos() reads is in the port's registry; the
    three the fleet and the router bring moved as the reference's did on
    the same sequence."""
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core.config import platform_config, small_engine_config
    from sentinel_tpu_torch.obs import profile as PROF
    from sentinel_tpu_torch.obs.registry import REGISTRY
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    assert _slo_names(TS) == _slo_names(JS)
    cfg = platform_config(**dict(dataclass_small(small_engine_config()), sketch_stats=True, sketch_width=256))
    cap0 = PROF.LEDGER.snapshot()["capacity_bytes"]
    PROF.LEDGER.set_capacity(1 << 40)
    c = st.SentinelClient(cfg=cfg, time_source=VirtualTimeSource(1_000), mode="sync", device="cpu",
                          sketch_audit_k=4, sketch_audit_period=2, admission_queue_limit=1)
    try:
        c.start()
        c.flow_rules.load([st.FlowRule(resource="r0", count=2)])
        for i in range(24):
            try:
                c.entry(f"r{i % 3}").exit()
            except st.BlockException:
                pass
            c.time.advance(5)
        c.mode = "threaded"  # queue two: the second is past the admission bound
        c.submit_acquire("r1")
        c.submit_acquire("r2")
        c.mode = "sync"
        c.tick_once()
    finally:
        c.stop()
        PROF.LEDGER.set_capacity(cap0)
    missing = {n for n in _slo_names(TS) if not REGISTRY.series(n)}
    assert missing <= FLEET_BUDGET_NAMES
    port = _fleet_budget_run("sentinel_tpu_torch")
    assert not {n for n in _slo_names(TS) if not REGISTRY.series(n)}
    assert port == _fleet_budget_run("sentinel_tpu")
    assert port["statuses"] == [0, 0, 2, 2, 2, 2]  # OK, OK, BLOCKED; dead: BLOCKED (fail closed)
    assert port["moved"] == {
        'sentinel_shard_requests_total{shard="shard-0"}': 6,
        'sentinel_shard_fallback_total{shard="shard-0",verdict="block"}': 2,
        'sentinel_shard_route_failures_total{kind="timeout",shard="1"}': 2,
    }


def dataclass_small(cfg) -> dict:
    """The small config's widths (core/config.small_engine_config), to lay
    over platform_config()'s flags."""
    keys = ("max_resources", "max_nodes", "max_flow_rules", "max_degrade_rules", "max_param_rules",
            "batch_size", "complete_batch_size", "param_width")
    return {k: getattr(cfg, k) for k in keys}
