"""sentinel_tpu_torch.chaos — the port's failpoint catalog, scenario runner
and CLI, mirroring tests/test_chaos.py.

The catalog over the port's source (every ``FP.register`` literal, the
<layer>.<component>.<operation> scheme, the witness's
``runtime.lock.contend`` among the sites, each site as the reference
registers it); the port's ``seg_overflow_storm`` and ``rpc_error_burst``
(the two scenarios that are not ``fast``) green on the CPU with
``injected-as-planned``; the CLI's ``--list`` / ``--sites`` and
``--check-determinism``; and the three faults the scenarios found in the
port, each held against the reference.  The ``fast`` scenarios against
the reference's are in test_torch_chaos_scenarios.py and
test_torch_chaos_tuner.py.
"""

from __future__ import annotations

import ast
import os
import re

import numpy as np
import pytest

from sentinel_tpu.chaos import failpoints as JFP
from sentinel_tpu_torch.chaos import failpoints as TFP
from sentinel_tpu_torch.chaos.plans import FaultPlan, FaultSpec

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm_guard():
    """No test may leak an armed plan into the rest of the suite."""
    yield
    TFP.disarm()
    JFP.disarm()


def _import_instrumented_modules():
    """Import every module of both packages that registers failpoints."""
    import importlib

    for mod in (
        "analysis.concurrency.witness", "chaos.runner", "cluster.client", "cluster.front_door",
        "cluster.server", "cluster.shard", "datasource.stores", "obs.profile", "obs.timeline",
        "parallel.remote_shard", "runtime.client", "sketch.hotset", "transport.heartbeat",
        "transport.http_server", "workload.generator", "workload.tuner",
    ):
        importlib.import_module(f"sentinel_tpu_torch.{mod}")
        importlib.import_module(f"sentinel_tpu.{mod}")


_SCHEME = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")
_LAYERS = {"transport", "cluster", "runtime", "parallel", "datasource", "obs", "sketch", "workload"}


def test_catalog_sites_unique_registered_and_scheme_conformant():
    """Every site of the port follows the scheme, the layer set is closed,
    the port's source ``register()`` literals match its live catalog, and
    each site is the reference's: same name, description and actions."""
    _import_instrumented_modules()
    cat = TFP.catalog()
    assert "runtime.lock.contend" in cat
    for name, site in cat.items():
        assert _SCHEME.match(name), f"{name!r} violates the naming scheme"
        assert name.split(".")[0] in _LAYERS
        assert site.kinds, f"{name!r} registered without action kinds"
    registered_in_source = set()
    for dirpath, _dirs, files in os.walk(os.path.join(REPO_ROOT, "sentinel_tpu_torch")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "register"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "FP"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                ):
                    registered_in_source.add(node.args[0].value)
    assert registered_in_source == set(cat), registered_in_source ^ set(cat)
    ref = JFP.catalog()
    assert set(cat) == set(ref)
    assert {n: (s.desc, s.kinds) for n, s in cat.items()} == {n: (s.desc, s.kinds) for n, s in ref.items()}


@pytest.mark.parametrize("name", ["seg_overflow_storm", "rpc_error_burst"])
def test_the_two_slow_scenarios_are_green_on_the_cpu(name):
    """The scenarios outside the ``fast`` set, on the port at seed 7: every
    invariant green, the injected counts as planned."""
    from sentinel_tpu_torch.chaos.runner import SCENARIOS, report, run_scenario

    assert not SCENARIOS[name].fast
    r = run_scenario(name, seed=7, device="cpu")
    assert r.ok, report([r])
    verdicts = {v.name: v.ok for v in r.verdicts}
    assert verdicts["injected-as-planned"] and verdicts["no-order-violations"]


def test_scenario_determinism_fast():
    """Two same-seed runs of a scenario inject identical event counts."""
    from sentinel_tpu_torch.chaos.runner import run_scenario

    a = run_scenario("datasource_flap", seed=11, device="cpu")
    b = run_scenario("datasource_flap", seed=11, device="cpu")
    assert a.injected == b.injected and a.injected


def test_cli_check_determinism_on_the_fast_set(capsys):
    from sentinel_tpu_torch.chaos.__main__ import main

    assert main(["--fast", "--check-determinism", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "determinism: two runs injected identical per-scenario counts" in out
    assert "9/9 scenarios green" in out


def test_cli_list_and_sites(capsys):
    from sentinel_tpu.chaos.__main__ import main as ref_main
    from sentinel_tpu_torch.chaos.__main__ import main

    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert ref_main(["--list"]) == 0
    assert capsys.readouterr().out == out
    for name in ("rpc_error_burst", "seg_overflow_storm", "shard_reconnect"):
        assert name in out
    assert main(["--sites"]) == 0
    out = capsys.readouterr().out
    assert "cluster.rpc.send" in out and "runtime.resolve.readback" in out
    assert "runtime.lock.contend" in out


def test_cli_plan_validates_against_the_sites(tmp_path, capsys):
    from sentinel_tpu_torch.chaos.__main__ import main

    p = tmp_path / "plan.json"
    p.write_text(FaultPlan(name="p", seed=3, faults=[FaultSpec("cluster.rpc.send", "raise")]).to_json())
    assert main(["--plan", str(p)]) == 0
    assert "1 fault spec(s) — valid against" in capsys.readouterr().out


def test_the_entry_points_run_on_the_card_unless_asked():
    from sentinel_tpu_torch.chaos.runner import run_scenario

    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario("explain_fail_open", seed=7)


# ---------------------------------------------------------------------------
# faults the scenarios found in the port (each fails on the tree before it)
# ---------------------------------------------------------------------------


def _clients():
    from sentinel_tpu.core.config import small_engine_config as jcfg
    from sentinel_tpu.runtime.client import SentinelClient as JClient
    from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    jc = JClient(cfg=jcfg(), time_source=JVT(1_000), mode="sync")
    tc = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    jc.start()
    tc.start()
    return jc, tc


def test_the_cluster_degrade_cooldown_can_be_lapsed_as_on_the_reference():
    """``cluster_partition`` heals by writing ``_cluster_degraded_until``
    (and the harness may write ``_cluster_degraded_active``): the port's
    views of the hysteresis had no setters."""
    jc, tc = _clients()
    try:
        for c in (jc, tc):
            c._enter_cluster_degraded()
            assert c._cluster_degraded_active and c._cluster_degraded_until > 0.0
            with c._cluster_lock:
                c._cluster_degraded_until = 0.0
            assert c._cluster_hy.until == 0.0
            c._cluster_degraded_active = False
            assert not c._cluster_hy.active
    finally:
        for c in (jc, tc):
            c._exit_cluster_degraded()
            c.stop()


def test_a_corrupt_wire_counts_as_a_resolve_failure_as_on_the_reference():
    """A corrupted packed readback fails its tick CLOSED through the same
    handler as any resolve error: ``sentinel_resolve_failures_total`` and
    ``sentinel_packed_decode_failures_total`` move by one each in both
    packages (the port failed the tick itself and left the first one)."""
    from sentinel_tpu.chaos.plans import FaultPlan as JPlan
    from sentinel_tpu.chaos.plans import FaultSpec as JSpec
    from sentinel_tpu.core import errors as JERR
    from sentinel_tpu.obs.registry import REGISTRY as JREG
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.obs.registry import REGISTRY as TREG

    jc, tc = _clients()
    out = {}
    try:
        for name, c, fp, plan, spec, reg, errors in (
            ("ref", jc, JFP, JPlan, JSpec, JREG, JERR),
            ("port", tc, TFP, FaultPlan, FaultSpec, TREG, ERR),
        ):
            c.registry.resource_id("chaos/wire")
            assert c.submit_acquire("chaos/wire").result(timeout=60.0)[0] == errors.PASS
            keys = ("sentinel_resolve_failures_total", "sentinel_packed_decode_failures_total")
            before = [reg.get(k).value for k in keys]
            with fp.armed(plan(seed=4, faults=[spec("transport.packed.decode", "corrupt", max_fires=1)])):
                got = c.submit_acquire("chaos/wire").result(timeout=60.0)[0]
            out[name] = (int(got), [reg.get(k).value - b for k, b in zip(keys, before)])
    finally:
        jc.stop()
        tc.stop()
    assert out["port"] == out["ref"] == (int(ERR.BLOCK_SYSTEM), [1.0, 1.0])


class _Event:
    """A CUDA event stand-in: ``query()`` says whether it completed."""

    def __init__(self, done: bool):
        self.done = done

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        raise AssertionError("the host waited for the card")


def test_the_system_column_upload_never_waits_for_the_card():
    """``_adaptive_step`` uploads the controller's five scalars under the
    engine lock; a staging slot whose last copy has not run is passed
    over, and the ring grows when every slot is busy, instead of waiting
    on the card there (the reference's upload is asynchronous too)."""
    from sentinel_tpu_torch.ops.engine import ScalarStage

    st = ScalarStage("cpu")
    n = len(st._bufs)
    st._events = [_Event(False), _Event(True)] + [_Event(False)] * (n - 2)
    assert st._free_slot() == 1
    st._events = [_Event(False)] * n
    assert st._free_slot() == n and len(st._bufs) == n + 1 and st._events[n] is None
    assert np.array_equal(st.upload([1, 2, 3, 4, 5]).numpy(), np.arange(1, 6, dtype=np.float32))


def test_rpc_error_burst_stays_green_when_the_lost_servers_port_is_taken(monkeypatch):
    """On a loaded host another process's next listener may take the port
    a stopped token server freed: a token server there answers NO_RULE,
    the decision client never degrades, and no flight bundle is captured
    (the scenario went red in a parallel suite that way).  The scenario's
    lost server is a port it holds and never listens on, so a live token
    server on the stopped server's port changes nothing."""
    from sentinel_tpu_torch.chaos.runner import report, run_scenario
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer

    stop = ClusterTokenServer.stop
    taken = []

    def stop_and_reuse(self):
        port = self.port
        stop(self)
        if not taken:  # the first stop: the scenario's server, mid-run
            other = ClusterTokenServer(self.service, host="127.0.0.1", port=port)
            other.start()
            taken.append(other)

    monkeypatch.setattr(ClusterTokenServer, "stop", stop_and_reuse)
    try:
        r = run_scenario("rpc_error_burst", seed=7, device="cpu")
    finally:
        for other in taken:
            stop(other)
    assert taken, "the scenario stopped no token server"
    assert r.ok, report([r])


def test_token_server_stop_leaves_no_census_refresh_running():
    """A census change submits the token service's ``refresh_connected_count``
    to the server's pool, and that reprojects the service's rules onto its
    decision client.  One still running after ``stop()`` returned reprojected
    over the rules the caller loaded next: ``rpc_error_burst`` lost its
    black-box phase's cluster rule so on a loaded host (no degrade, no
    flight bundle).  ``stop()`` now waits out the running refresh and drops
    the queued ones."""
    import threading
    import time
    from types import SimpleNamespace

    from sentinel_tpu_torch.cluster.rules import ClusterServerConfigManager
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer

    running, ran = threading.Event(), []

    def refresh():
        running.set()
        time.sleep(0.3)
        ran.append(1)

    svc = SimpleNamespace(
        config=ClusterServerConfigManager(),
        connected_count_fn=None,
        refresh_connected_count=refresh,
        concurrent=SimpleNamespace(expire=lambda now_ms: None),
        client=SimpleNamespace(time=SimpleNamespace(now_ms=lambda: 0)),
    )
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0)
    server.start()
    try:
        server.connections.register(1, "default")  # a census change
        assert running.wait(5.0)
    finally:
        server.stop()
    at_stop = len(ran)
    time.sleep(0.5)
    assert at_stop == len(ran) == 1, "a census refresh ran on after stop() returned"
