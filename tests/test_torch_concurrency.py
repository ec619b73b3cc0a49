"""sentinel_tpu_torch.analysis.concurrency — the port's tier-3 concurrency
analyzer and its lock witness, mirroring tests/test_concurrency_analysis.py.

1. Every pass on fixture trees, each run through both packages' analyzers
   on the same source: the same findings (rule, file, line, severity and
   message, the golden command's name aside).  The port's device syncs
   (``torch.cuda.synchronize``, a stream's or an event's
   ``synchronize()``, a tensor's ``.item()`` / ``.cpu()`` / ``.tolist()``
   / ``.numpy()``) each get a fixture beside the reference's
   ``block_until_ready``.
2. The gate over ``sentinel_tpu_torch/``: the port's own golden
   (``lock_order.json``) exists, equals the tree's edges and is acyclic,
   and the four passes report nothing unsuppressed.  Lock names are
   package-relative, so every lock the reference creates in a module the
   port mirrors has the same name in both.
3. The witness: records and inversions, the self-deadlock guard, RLock /
   Condition, and a threaded port client witnessed with no violation.
"""

from __future__ import annotations

import json
import os
import textwrap
import threading
import time

import pytest

from sentinel_tpu.analysis.concurrency import passes as JP
from sentinel_tpu.analysis.concurrency.summaries import build_db as ref_build_db
from sentinel_tpu_torch.analysis import REPO_ROOT
from sentinel_tpu_torch.analysis.concurrency import (
    LOCK_ORDER_PATH,
    current_edges,
    load_lock_order,
    run_concurrency_analysis,
    save_lock_order,
    update_lock_order,
)
from sentinel_tpu_torch.analysis.concurrency import passes as TP
from sentinel_tpu_torch.analysis.concurrency.passes import GRAPH_PATH, _sccs
from sentinel_tpu_torch.analysis.concurrency.summaries import build_db

PASSES = {
    "cycle": "LockOrderCyclePass",
    "new-edge": "LockOrderNewEdgePass",
    "blocking": "BlockingUnderLockPass",
    "thread": "ThreadLifecyclePass",
}
#: the golden's re-bless command, as each package's message names it
_REF_CMD = "`python -m sentinel_tpu.analysis --update-lock-order`"
_PORT_CMD = "`update_lock_order()`"


def _write(root, files):
    for name, src in files.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _key(f):
    return (f.rule, f.path, f.line, f.col, f.severity, f.message.replace(_PORT_CMD, _REF_CMD))


def _both(tmp_path, files, kind, golden=None, ref=True):
    """The port's findings of one pass over a fixture tree; with ``ref``,
    asserted equal to the reference's over the same tree."""
    _write(tmp_path, files)
    db = build_db([str(tmp_path)], str(tmp_path), cached=False)
    got = list(getattr(TP, PASSES[kind])().run(db, golden))
    if ref:
        rdb = ref_build_db([str(tmp_path)], str(tmp_path), cached=False)
        want = list(getattr(JP, PASSES[kind])().run(rdb, golden))
        assert [_key(f) for f in got] == [_key(f) for f in want]
    return got


CYCLE_SRC = """
    import threading

    A = threading.Lock()
    B = threading.Lock()

    def ab():
        with A:
            with B:
                pass

    def ba():
        with B:
            with A:
                pass
"""


# ---------------------------------------------------------------------------
# lock-order-cycle / lock-order-new-edge
# ---------------------------------------------------------------------------


def test_two_lock_cycle_is_reported_with_both_stacks(tmp_path):
    found = _both(tmp_path, {"twist.py": CYCLE_SRC}, "cycle")
    assert len(found) == 1, found
    f = found[0]
    assert f.rule == "lock-order-cycle" and f.path == GRAPH_PATH
    assert "twist.A" in f.message and "twist.B" in f.message
    assert "ab" in f.message and "ba" in f.message


def test_consistent_order_is_clean(tmp_path):
    src = """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def one():
            with A:
                with B:
                    pass

        def two():
            with A:
                with B:
                    pass
    """
    assert _both(tmp_path, {"calm.py": src}, "cycle") == []


def test_interprocedural_cycle_through_helper(tmp_path):
    src = """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def _grab_b():
            with B:
                pass

        def outer():
            with A:
                _grab_b()

        def reverse():
            with B:
                with A:
                    pass
    """
    found = _both(tmp_path, {"twist.py": src}, "cycle")
    assert len(found) == 1 and "_grab_b" in found[0].message


FRESH_SRC = """
    import threading

    A = threading.Lock()
    B = threading.Lock()

    def pair():
        with A:
            with B:
                pass
"""


def test_new_edge_vs_golden_fails_with_site(tmp_path):
    found = _both(tmp_path, {"fresh.py": FRESH_SRC}, "new-edge", golden=set())
    assert len(found) == 1
    f = found[0]
    assert (f.rule, f.severity, f.path) == ("lock-order-new-edge", "error", "fresh.py")
    assert "fresh.A -> fresh.B" in f.message and "update_lock_order()" in f.message


def test_stale_golden_edge_warns_and_blessed_edge_is_silent(tmp_path):
    golden = {"fresh.A -> fresh.B", "fresh.GONE -> fresh.B"}
    found = _both(tmp_path, {"fresh.py": FRESH_SRC}, "new-edge", golden=golden)
    assert len(found) == 1
    assert found[0].severity == "warning" and "fresh.GONE" in found[0].message
    assert found[0].path == GRAPH_PATH


def test_no_golden_skips_the_edge_diff(tmp_path):
    assert _both(tmp_path, {"fresh.py": CYCLE_SRC}, "new-edge", golden=None) == []


def test_golden_round_trip(tmp_path):
    path = str(tmp_path / "lock_order.json")
    edges = ["m.B -> m.C", "m.A -> m.B", "m.A -> m.B"]
    save_lock_order(edges, path)
    assert load_lock_order(path) == {"m.A -> m.B", "m.B -> m.C"}
    raw = open(path).read()
    assert raw.endswith("\n")
    data = json.loads(raw)
    assert data["edges"] == sorted(set(edges))
    assert "update_lock_order()" in data["comment"]


def test_load_lock_order_missing_file_is_none(tmp_path):
    assert load_lock_order(str(tmp_path / "absent.json")) is None


def test_update_lock_order_scoping(tmp_path):
    path = str(tmp_path / "lock_order.json")
    sub = os.path.join(REPO_ROOT, "sentinel_tpu_torch", "cluster")
    n = update_lock_order(path=path, roots=[sub])
    scoped = load_lock_order(path)
    assert n == len(scoped) > 0
    full = set(current_edges())
    assert scoped <= full and scoped < full


# ---------------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------------


def test_blocking_call_through_helper_is_found(tmp_path):
    src = """
        import socket
        import threading

        L = threading.Lock()

        def _dial(host):
            return socket.create_connection((host, 80))

        def _fetch(host):
            return _dial(host)

        def serve(host):
            with L:
                return _fetch(host)
    """
    found = _both(tmp_path, {"svc.py": src}, "blocking")
    assert len(found) == 1, found
    f = found[0]
    assert (f.rule, f.path) == ("blocking-under-lock", "svc.py")
    assert "svc.L" in f.message and "_fetch" in f.message and "_dial" in f.message


def test_blocking_without_lock_is_clean(tmp_path):
    src = """
        import socket
        import threading

        L = threading.Lock()

        def _dial(host):
            return socket.create_connection((host, 80))

        def serve(host):
            with L:
                pass
            return _dial(host)
    """
    assert _both(tmp_path, {"svc.py": src}, "blocking") == []


def test_source_site_suppression_kills_transitive_findings(tmp_path):
    src = """
        import socket
        import threading

        L = threading.Lock()

        def _dial(host):
            return socket.create_connection((host, 80))  # stlint: disable=blocking-under-lock — fixture rationale

        def serve(host):
            with L:
                return _dial(host)
    """
    assert _both(tmp_path, {"svc.py": src}, "blocking") == []


def test_timeoutless_future_result_under_lock(tmp_path):
    src = """
        import threading

        L = threading.Lock()

        def wait_all(futs):
            with L:
                return [f.result() for f in futs]
    """
    found = _both(tmp_path, {"pool.py": src}, "blocking")
    assert len(found) == 1 and "future-result" in found[0].message


def test_each_package_finds_its_own_device_sync(tmp_path):
    """The reference's kind is ``block_until_ready``; the port's, on the
    same fixture written for torch, is found as the same finding."""
    src = """
        import threading

        L = threading.Lock()

        def publish(x):
            with L:
                x.{sync}()
    """
    _write(tmp_path / "ref", {"dev.py": src.format(sync="block_until_ready")})
    _write(tmp_path / "port", {"dev.py": src.format(sync="cpu")})
    rdb = ref_build_db([str(tmp_path / "ref")], str(tmp_path / "ref"), cached=False)
    pdb = build_db([str(tmp_path / "port")], str(tmp_path / "port"), cached=False)
    want = [_key(f) for f in JP.BlockingUnderLockPass().run(rdb, None)]
    got = [_key(f) for f in TP.BlockingUnderLockPass().run(pdb, None)]
    assert len(want) == 1 and "blocking device-sync (x.block_until_ready)" in want[0][5]
    assert got == [k[:5] + (k[5].replace("block_until_ready", "cpu"),) for k in want]
    # and neither package takes the other's sync for one
    assert list(TP.BlockingUnderLockPass().run(build_db([str(tmp_path / "ref")], str(tmp_path / "ref"),
                                                        cached=False), None)) == []


#: the port's device syncs: each a host wait for the card
PORT_SYNCS = {
    "cuda-synchronize": ("import torch", "torch.cuda.synchronize()", "torch.cuda.synchronize"),
    "stream-synchronize": ("import torch", "torch.cuda.current_stream().synchronize()", "(...).synchronize"),
    "event-synchronize": ("", "ev.synchronize()", "ev.synchronize"),
    "item": ("", "n = t.item()", "t.item"),
    "cpu": ("", "h = t.cpu()", "t.cpu"),
    "tolist": ("", "xs = t.tolist()", "t.tolist"),
    "numpy": ("", "a = t.numpy()", "t.numpy"),
}


@pytest.mark.parametrize("kind", sorted(PORT_SYNCS))
def test_the_ports_device_syncs_under_a_lock_are_found(tmp_path, kind):
    imp, stmt, detail = PORT_SYNCS[kind]
    src = f"""
        import threading
        {imp}

        L = threading.Lock()

        def _read(t, ev):
            {stmt}

        def serve(t, ev):
            with L:
                _read(t, ev)

        def outside(t, ev):
            {stmt}
    """
    found = _both(tmp_path, {"dev.py": src}, "blocking", ref=False)
    assert len(found) == 1, found
    f = found[0]
    assert f.path == "dev.py" and "dev.L" in f.message and "blocking device-sync" in f.message
    assert detail is None or f"{detail})" in f.message


def test_a_sync_is_not_a_readback_with_an_argument_or_of_a_name(tmp_path):
    """``.cpu()`` / ``.tolist()`` and friends count only as methods called
    with no positional argument (``h.item(0)`` is numpy's indexed read,
    ``item()`` alone a function of the module)."""
    src = """
        import threading

        L = threading.Lock()

        def item():
            return 0

        def serve(h):
            with L:
                h.item(0)
                item()
    """
    assert _both(tmp_path, {"dev.py": src}, "blocking", ref=False) == []


# ---------------------------------------------------------------------------
# thread-lifecycle
# ---------------------------------------------------------------------------


def test_unjoined_non_daemon_thread_is_reported(tmp_path):
    src = """
        import threading

        class Svc:
            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                pass
    """
    found = _both(tmp_path, {"svc.py": src}, "thread")
    assert len(found) == 1 and found[0].rule == "thread-lifecycle" and found[0].path == "svc.py"


def test_daemon_or_joined_threads_are_clean(tmp_path):
    src = """
        import threading

        class Daemonic:
            def start(self):
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()

            def _run(self):
                pass

        class Joined:
            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                pass

            def stop(self):
                self._t.join()
    """
    assert _both(tmp_path, {"svc.py": src}, "thread") == []


@pytest.mark.parametrize("wait, n", [("self._cv.wait()", 1), ("self._cv.wait(timeout=1.0)", 0)])
def test_timeoutless_wait_under_lock_is_reported(tmp_path, wait, n):
    src = f"""
        import threading

        class W:
            def __init__(self):
                self._cv = threading.Condition()

            def pump(self):
                with self._cv:
                    {wait}
    """
    found = _both(tmp_path, {"svc.py": src}, "thread")
    assert len(found) == n and all("timeout" in f.message for f in found)


# ---------------------------------------------------------------------------
# THE gate over the port's source
# ---------------------------------------------------------------------------


def test_repo_gate_zero_findings_and_acyclic_blessed_graph():
    golden = load_lock_order(LOCK_ORDER_PATH)
    assert golden, "the port's lock_order.json is missing or empty: re-bless and commit"
    assert set(current_edges()) == golden
    succ = {}
    for e in golden:
        a, _, b = e.partition(" -> ")
        succ.setdefault(a, set()).add(b)
        succ.setdefault(b, set())
    assert _sccs(set(succ), succ) == []
    findings = run_concurrency_analysis()
    assert findings == [], "\n".join(f"{f.path}:{f.line} [{f.rule}] {f.message}" for f in findings)


def test_lock_names_are_the_references_where_the_port_mirrors_it():
    """Package-relative names: every lock the reference creates in a module
    the port also has is created under the same name in the port, and the
    canonical runtime order (``_tick_mutex`` outer, ``_cluster_lock``
    inner) holds in the port's graph as in the reference's."""
    port = build_db([os.path.join(REPO_ROOT, "sentinel_tpu_torch")], REPO_ROOT)
    ref = ref_build_db([os.path.join(REPO_ROOT, "sentinel_tpu")], REPO_ROOT)
    mine = set(port.creation_sites.values())
    mirrored = {
        n for (path, _line), n in ref.creation_sites.items()
        if os.path.exists(os.path.join(REPO_ROOT, path.replace("sentinel_tpu/", "sentinel_tpu_torch/", 1)))
    }
    # ops/fused.py's eager-Pallas lock serializes the reference's interpret
    # mode, which the port's hand-written kernels do not have
    mirrored.discard("ops.fused._EAGER_PALLAS_LOCK")
    assert len(mirrored) > 60 and mirrored <= mine, sorted(mirrored - mine)
    assert "cluster.client.ClusterTokenClient._lock" in mine
    edges = set(current_edges())
    tm = "runtime.client.SentinelClient._tick_mutex"
    cl = "runtime.client.SentinelClient._cluster_lock"
    assert f"{tm} -> {cl}" in edges and f"{cl} -> {tm}" not in edges


def test_worker_waits_carry_timeouts():
    import ast

    for rel in ("sentinel_tpu_torch/cluster/shard.py", "sentinel_tpu_torch/cluster/token_service.py"):
        tree = ast.parse(open(os.path.join(REPO_ROOT, rel)).read())
        bare = [
            node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "wait" and not node.args and not node.keywords
        ]
        assert bare == [], f"{rel}: timeout-less wait() at lines {bare}"


# ---------------------------------------------------------------------------
# the runtime lock witness
# ---------------------------------------------------------------------------


@pytest.fixture()
def witness():
    from sentinel_tpu_torch.analysis.concurrency import witness as W

    W.install()
    W.reset()
    try:
        yield W
    finally:
        W.uninstall()
        W.reset()


def test_witness_records_and_inverts(witness):
    from sentinel_tpu_torch.obs.registry import REGISTRY

    W = witness
    c = REGISTRY.get("sentinel_lock_order_violations_total")
    before = c.value
    a = W.WitnessLock(W._REAL_LOCK(), "fix.A._lock", reentrant=False)
    b = W.WitnessLock(W._REAL_LOCK(), "fix.B._lock", reentrant=False)
    with a:
        with b:
            pass
    assert ("fix.A._lock", "fix.B._lock") in W.dynamic_edges()
    assert W.violations() == []
    with b:
        with a:
            pass
    assert any("order inversion" in v for v in W.violations())
    assert c.value == before + 1
    ok, detail = W.verdict()
    assert not ok and "violation" in detail


def test_witness_same_instance_reacquire_raises(witness):
    W = witness
    a = W.WitnessLock(W._REAL_LOCK(), "fix.A._lock", reentrant=False)
    with a:
        with pytest.raises(RuntimeError, match="self-deadlock"):
            a.acquire()
    assert any("re-acquire" in v for v in W.violations())


def test_witness_rlock_reentry_and_condition_are_clean(witness):
    W = witness
    r = W.WitnessRLock(W._REAL_RLOCK(), "fix.C._rlock")
    with r:
        with r:
            pass
    cv = threading.Condition(r)

    def poke():
        with cv:
            cv.notify()

    with cv:
        t = threading.Thread(target=poke)
        t.start()
        cv.wait(timeout=2.0)
        t.join()
    assert W.violations() == []
    assert W._held_stack() == []


def test_witness_contend_failpoint_delays_an_acquisition(witness):
    """``runtime.lock.contend`` is a delay site at every witnessed
    acquisition, and ``sentinel_lock_wait_ms`` observes each wait."""
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.chaos.plans import FaultPlan, FaultSpec
    from sentinel_tpu_torch.obs.registry import REGISTRY

    W = witness
    h = REGISTRY.get("sentinel_lock_wait_ms")
    n0 = h.count
    a = W.WitnessLock(W._REAL_LOCK(), "fix.A._lock", reentrant=False)
    plan = FaultPlan(seed=1, faults=[FaultSpec("runtime.lock.contend", "delay", delay_ms=20.0, max_fires=1)])
    with FP.armed(plan) as st:
        t0 = time.perf_counter()
        with a:
            pass
        assert time.perf_counter() - t0 >= 0.015
        assert st.injected() == {"runtime.lock.contend:delay": 1}
    assert h.count > n0  # the delayed acquisition and the witness's own


def test_witnessed_client_smoke_no_violations(witness):
    """A threaded port client built under the witness: zero violations,
    zero dynamic edges the static graph missed, and the run took the
    client's witnessed locks."""
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.core.rules import FlowRule
    from sentinel_tpu_torch.runtime.client import SentinelClient

    W = witness
    c = SentinelClient(cfg=small_engine_config(), mode="threaded", tick_interval_ms=2.0, device="cpu")
    c.flow_rules.load([FlowRule(resource="res-w", count=100.0)])
    c.start()
    try:
        for _ in range(3):
            with c.entry("res-w"):
                pass
            time.sleep(0.01)
    finally:
        c.stop()
    assert W.violations() == []
    assert W.edges_unknown_to_static() == []
    assert any(
        "runtime.client.SentinelClient" in a or "runtime.client.SentinelClient" in b
        for a, b in W.dynamic_edges()
    )
    ok, detail = W.verdict()
    assert ok, detail


def test_chaos_invariant_is_universal_and_green_when_inactive():
    from sentinel_tpu.chaos import invariants as JI
    from sentinel_tpu_torch.chaos.invariants import CATALOG, MetricsDelta, ScenarioContext, evaluate

    assert list(CATALOG) == list(JI.CATALOG) and len(CATALOG) == 14
    out = evaluate(["verdict-accounting"], ScenarioContext(metrics=MetricsDelta()))
    ref = JI.evaluate(["verdict-accounting"], JI.ScenarioContext(metrics=JI.MetricsDelta()))
    assert [(v.name, v.ok, v.detail) for v in out] == [(v.name, v.ok, v.detail) for v in ref]
    v = next(v for v in out if v.name == "no-order-violations")
    assert v.ok and "inactive" in v.detail


def test_a_red_verdict_triggers_the_ports_flight_bundle():
    from sentinel_tpu_torch.chaos.invariants import MetricsDelta, ScenarioContext, evaluate
    from sentinel_tpu_torch.obs.flight import FLIGHT

    FLIGHT.reset_rate_limit()
    out = evaluate(["verdict-accounting", "no-such-check"], ScenarioContext(metrics=MetricsDelta(), submitted=1))
    assert [(v.name, v.ok) for v in out] == [
        ("verdict-accounting", False), ("no-such-check", False), ("no-order-violations", True)]
    b = FLIGHT.last_bundle()
    assert b is not None and b["reason"] == "invariant-breach"
    assert any(e["kind"] == "invariant.breach" and e["fields"]["invariants"] == ["verdict-accounting", "no-such-check"]
               for e in b["journal"])
