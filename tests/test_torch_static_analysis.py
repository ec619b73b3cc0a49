"""sentinel_tpu_torch.analysis — the port's tier-1 linter and its CLI.

Counterparts of tests/test_static_analysis.py, held against the JAX
package where the pass is the same:

1. fail-open, time-source and unguarded-global are the reference's
   passes: every fixture source of the reference's tests runs through
   both packages' passes, which must give the same findings (rule, line,
   column, message), the port's file scopes naming the port's files;
2. host-sync and jit-recompile carry the reference's intent over torch
   code: each has fixtures it flags and fixtures it leaves clean;
3. the suppression machinery (the shared framework) through both;
4. THE CI GATE: the five passes over ``sentinel_tpu_torch/`` report
   nothing against the port's empty ``baseline.json``, and the
   reference's linter over the port reports nothing either;
5. the CLI (``python -m sentinel_tpu_torch.analysis``): exit codes
   0 / 1 / 2, SARIF, the scoped ``--update-baseline`` round trip, and the
   four tier-4 tests that tests/test_torch_spmd_analysis.py left for it.

Pure AST work except the tier-4 tests, which share one run of the ranks
on the CPU (gloo) per process.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap

from sentinel_tpu.analysis import passes as ref_passes
from sentinel_tpu.analysis.concurrency import summaries as ref_summaries
from sentinel_tpu.analysis.framework import ParsedModule as RefParsedModule
from sentinel_tpu.analysis.framework import parse_suppressions as ref_parse_suppressions
from sentinel_tpu_torch.analysis import (
    ALL_PASSES,
    DEFAULT_BASELINE,
    REPO_ROOT,
    load_baseline,
    rule_catalog,
    run_repo_analysis,
)
from sentinel_tpu_torch.analysis.framework import ParsedModule, format_sarif, parse_suppressions
from sentinel_tpu_torch.analysis.passes import (
    FailOpenPass,
    HostSyncPass,
    JitRecompilePass,
    TimeSourcePass,
    UnguardedGlobalPass,
)

#: the reference's pass for each copied port pass
_REF = {
    "time-source": ref_passes.TimeSourcePass,
    "fail-open": ref_passes.FailOpenPass,
    "unguarded-global": ref_passes.UnguardedGlobalPass,
}

DEVICE = "cpu"  # the tier-4 ranks run on the CPU here


def _mod(source: str, path: str = "sentinel_tpu_torch/runtime/client.py", cls=ParsedModule, parse=parse_suppressions):
    source = textwrap.dedent(source)
    line_disables, file_disables = parse(source)
    return cls(
        path=path,
        abspath="/" + path,
        source=source,
        tree=ast.parse(source),
        line_disables=line_disables,
        file_disables=file_disables,
    )


def _run(p, mod):
    # the runner's filter (framework.run_passes): the suppression covers the
    # finding's whole anchor span
    return [f for f in p.run(mod) if not mod.suppressed(f.rule, *f.span())]


def _both(port_pass, source: str, path: str = "sentinel_tpu/runtime/client.py"):
    """Run a copied pass on the reference test's fixture through both
    packages (the port's at the port's path); assert they agree and return
    the port's findings."""
    ref_pass = _REF[port_pass.name]()
    # the reference's entry-lock cache is keyed by id(tree), and ids are
    # reused once a fixture's tree is freed: start it empty
    ref_summaries.invalidate_cache()
    want = _run(ref_pass, _mod(source, path, RefParsedModule, ref_parse_suppressions))
    got = _run(port_pass, _mod(source, path.replace("sentinel_tpu/", "sentinel_tpu_torch/", 1)))
    key = lambda f: (f.rule, f.line, f.col, f.message)  # noqa: E731
    assert [key(f) for f in got] == [key(f) for f in want]
    return got


# ---------------------------------------------------------------------------
# time-source (the reference's pass)
# ---------------------------------------------------------------------------


def test_time_source_triggers_on_raw_clock_and_aliases():
    got = _both(
        TimeSourcePass(),
        """
        import time as _time
        from time import monotonic as mono

        def deadline():
            return _time.time() + mono()
        """,
    )
    assert len(got) == 2 and all(f.rule == "time-source" for f in got)


def test_time_source_allows_helpers_perf_counter_and_own_module():
    clean = """
        import time
        from sentinel_tpu.utils.time_source import mono_s

        def f():
            t0 = time.perf_counter()  # profiling-only: allowed
            time.sleep(0.01)          # not a clock READ
            return mono_s() - t0
        """
    assert _both(TimeSourcePass(), clean) == []
    own = "import time\n\ndef now():\n    return time.time()\n"
    assert _both(TimeSourcePass(), own, path="sentinel_tpu/utils/time_source.py") == []


def test_time_source_allowlists_tracer_read_point_only():
    src = "import time\n\ndef now_ns():\n    return time.monotonic_ns()\n"
    assert _both(TimeSourcePass(), src, path="sentinel_tpu/obs/trace.py") == []
    got = _both(TimeSourcePass(), src, path="sentinel_tpu/obs/registry.py")
    assert len(got) == 1 and got[0].rule == "time-source"
    assert _both(TimeSourcePass(), src, path="sentinel_tpu/chaos/failpoints.py") == []
    assert len(_both(TimeSourcePass(), src, path="sentinel_tpu/chaos/runner.py")) == 1
    # the port's tracer keeps exactly ONE raw-clock call site, as the reference's
    from sentinel_tpu_torch.analysis import astutil as A

    with open(os.path.join(REPO_ROOT, "sentinel_tpu_torch", "obs", "trace.py")) as f:
        tree = ast.parse(f.read())
    aliases = A.import_aliases(tree)
    raw = [
        n for n in ast.walk(tree)
        if isinstance(n, ast.Call)
        and A.resolve_call(n, aliases) in ("time.monotonic_ns", "time.monotonic", "time.time", "time.time_ns")
    ]
    assert len(raw) == 1


# ---------------------------------------------------------------------------
# fail-open (the reference's pass)
# ---------------------------------------------------------------------------


def test_fail_open_triggers_on_broad_swallow_in_admission_path():
    got = _both(
        FailOpenPass(),
        """
        def check(item):
            try:
                return engine_verdict(item)
            except Exception:
                return PASS
        """,
    )
    assert len(got) == 1 and got[0].rule == "fail-open"


def test_fail_open_ignores_reraise_cleanup_and_out_of_scope_files():
    src = """
        def check(item):
            try:
                return engine_verdict(item)
            except Exception:
                log()
                raise

        def teardown(sock):
            try:
                sock.close()
            except Exception:
                pass
        """
    assert _both(FailOpenPass(), src) == []
    other = """
        def render(x):
            try:
                return fmt(x)
            except Exception:
                return ""
        """
    assert _both(FailOpenPass(), other, path="sentinel_tpu/dashboard/ui.py") == []


def test_fail_open_suppression_with_rationale():
    src = """
        def check(item):
            try:
                return consult_token_service(item)
            except Exception:  # stlint: disable=fail-open — degrades to local rules
                return degrade_to_local(item)
        """
    assert _both(FailOpenPass(), src) == []


# ---------------------------------------------------------------------------
# host-sync (the reference's intent over torch)
# ---------------------------------------------------------------------------


def test_host_sync_triggers_on_the_dispatch_path():
    mod = _mod(
        """
        import numpy as np
        import torch

        def _run_tick(self, acq):
            out = self._tick(acq)
            torch.cuda.synchronize()
            wire = np.asarray(out.wire)
            return out.verdict.item(), out.wait_ms.cpu()
        """
    )
    got = _run(HostSyncPass(), mod)
    assert {f.rule for f in got} == {"host-sync"}
    msgs = " | ".join(f.message for f in got)
    assert len(got) == 4
    for what in ("torch.cuda.synchronize()", "numpy.asarray()", "out.verdict.item()", "out.wait_ms.cpu()"):
        assert what in msgs, msgs


def test_host_sync_zone_extends_to_callees_and_stops_at_the_readback_point():
    mod = _mod(
        """
        def _tick_once_locked(self, now):
            p = self._prepare(now)
            self._resolve_tick(p)

        def _prepare(self, now):
            return self._last.tolist()     # a callee of a root: flagged

        def _resolve_tick(self, p):
            return p.out.wire.cpu().numpy()  # THE readback point: legal

        def snapshot(self):
            return self._state.item()      # reached from no root
        """
    )
    got = _run(HostSyncPass(), mod)
    assert len(got) == 1, [f.message for f in got]
    assert "_prepare" in got[0].message and ".tolist()" in got[0].message


def test_host_sync_clean_dispatch_is_clean():
    mod = _mod(
        """
        import numpy as np
        import torch

        def _run_tick(self, acq):
            cols = np.zeros(len(acq), np.int32)       # host batch assembly: fine
            ids = np.asarray(cols)                    # a bare local: host data
            # stlint: disable-next-line=host-sync — fixture: a sanctioned host-side call
            n = self._host_count.item()
            return self._tick(torch.from_numpy(ids).to(self.device, non_blocking=True), n)
        """
    )
    assert _run(HostSyncPass(), mod) == []
    # the same calls outside the client / token-service files are out of scope
    assert _run(HostSyncPass(), _mod("def _run_tick(self):\n    return self.x.item()\n", path="sentinel_tpu_torch/obs/trace.py")) == []


# ---------------------------------------------------------------------------
# jit-recompile (the reference's intent: make_tick's cache)
# ---------------------------------------------------------------------------


def test_jit_recompile_triggers_on_per_call_and_loop_bindings_and_churning_keys():
    mod = _mod(
        """
        import dataclasses
        import functools
        from sentinel_tpu_torch.ops import engine as E

        def per_call(state, args, cfg):
            return functools.partial(E.tick, cfg=cfg)(state, *args)

        def in_loop(cfgs):
            return [functools.partial(E.tick, cfg=c) for c in cfgs for _ in range(2)]

        def sweep(cfg, sizes):
            for b in sizes:
                fn = E.make_tick(dataclasses.replace(cfg, batch_size=b))
            return fn
        """,
        path="sentinel_tpu_torch/runtime/client.py",
    )
    got = _run(JitRecompilePass(), mod)
    msgs = " | ".join(f.message for f in got)
    assert "invoked at its own call site" in msgs
    assert "functools.partial(tick, ...) inside a loop" in msgs
    assert "make_tick(...) inside a loop with a key built in the loop" in msgs
    assert len(got) == 3


def test_jit_recompile_flags_mutable_keys_and_state_read_in_the_tick():
    mod = _mod(
        """
        import threading

        _RULES = {}
        _TICK_CACHE = {}
        _TICK_CACHE_LOCK = threading.Lock()

        def tick(state, acq, cfg, features):
            return state * len(_RULES)

        def make_tick(cfg, features):
            with _TICK_CACHE_LOCK:
                return _TICK_CACHE.get((cfg, features))

        def bind(cfg):
            return make_tick(cfg, {"flow", "degrade"})

        def lookup(cfg):
            return _TICK_CACHE.get((cfg, ["flow"]))
        """,
        path="sentinel_tpu_torch/ops/engine.py",
    )
    got = _run(JitRecompilePass(), mod)
    msgs = [f.message for f in got]
    assert sum("cache key built from a mutable value" in m for m in msgs) == 2
    assert sum("reads module-level mutable '_RULES'" in m for m in msgs) == 1
    assert len(got) == 3


def test_jit_recompile_clean_cached_factory_is_clean():
    mod = _mod(
        """
        import threading

        _TICK_CACHE = {}
        _TICK_CACHE_LOCK = threading.Lock()
        ALL_FEATURES = frozenset({"flow"})

        def tick(state, acq, cfg, features):
            return state if cfg.flag else state * 2

        def make_tick(cfg, features=ALL_FEATURES):
            key = (cfg, features)
            with _TICK_CACHE_LOCK:
                fn = _TICK_CACHE.get(key)
                if fn is None:

                    def fn(state, acq):
                        return tick(state, acq, cfg, features)

                    _TICK_CACHE[key] = fn
            return fn

        def warm(cfgs):
            for cfg in cfgs:                     # one binding per config: warm-up
                make_tick(cfg, frozenset({"flow"}))
        """,
        path="sentinel_tpu_torch/ops/engine.py",
    )
    assert _run(JitRecompilePass(), mod) == []


def test_the_real_make_tick_cache_is_clean():
    """The port's own tick factory and tick closure pass the rule."""
    from sentinel_tpu_torch.analysis import framework as F

    mod = F.parse_module(os.path.join(REPO_ROOT, "sentinel_tpu_torch", "ops", "engine.py"), REPO_ROOT)
    assert _run(JitRecompilePass(), mod) == []
    assert "make_tick" in mod.source and "_TICK_CACHE_LOCK" in mod.source


# ---------------------------------------------------------------------------
# unguarded-global (the reference's pass)
# ---------------------------------------------------------------------------


def test_unguarded_global_triggers_on_lockless_registry_write():
    got = _both(
        UnguardedGlobalPass(),
        """
        _HANDLERS = {}
        _ORDER: list = []

        def register(name, fn):
            _HANDLERS[name] = fn
            _ORDER.append(name)
        """,
    )
    assert len(got) == 2 and all(f.rule == "unguarded-global" for f in got)


def test_unguarded_global_lock_guarded_and_local_shadows_are_clean():
    src = """
        import threading

        _HANDLERS = {}
        _lock = threading.Lock()

        def register(name, fn):
            with _lock:
                _HANDLERS[name] = fn

        def local_work():
            tmp = {}
            tmp["k"] = 1      # local, not the module global
            return tmp
        """
    assert _both(UnguardedGlobalPass(), src) == []


def test_unguarded_global_catches_global_rebind():
    got = _both(
        UnguardedGlobalPass(),
        """
        _EXTS: list = []

        def clear():
            global _EXTS
            _EXTS = []
        """,
    )
    assert len(got) == 1 and "rebound" in got[0].message


def test_unguarded_global_lockset_mismatch_reports_both_sites():
    got = _both(
        UnguardedGlobalPass(),
        """
        import threading

        _CACHE = {}
        _LOCK_A = threading.Lock()
        _LOCK_B = threading.Lock()

        def put(k, v):
            with _LOCK_A:
                _CACHE[k] = v

        def evict(k):
            with _LOCK_B:
                _CACHE.pop(k, None)
        """,
    )
    assert len(got) == 2 and all("disjoint locksets" in f.message for f in got)
    assert "_LOCK_B" in got[0].message and "_LOCK_A" in got[1].message


def test_unguarded_global_consistent_lock_and_nesting_are_clean():
    src = """
        import threading

        _CACHE = {}
        _LOCK = threading.Lock()
        _OTHER = threading.Lock()

        def put(k, v):
            with _LOCK:
                _CACHE[k] = v

        def evict(k):
            with _OTHER:
                with _LOCK:          # nested: _LOCK still held
                    _CACHE.pop(k, None)
        """
    assert _both(UnguardedGlobalPass(), src) == []


def test_unguarded_global_single_guarded_site_never_mismatches():
    src = """
        import threading

        _CACHE = {}
        _only_lock = threading.Lock()

        def put(k, v):
            with _only_lock:
                _CACHE[k] = v
        """
    assert _both(UnguardedGlobalPass(), src) == []


def test_unguarded_global_call_rooted_lock_still_counts():
    src = """
        _CACHE = {}

        def put(reg, k, v):
            with reg().lock:
                _CACHE[k] = v
        """
    assert _both(UnguardedGlobalPass(), src) == []


# ---------------------------------------------------------------------------
# suppression machinery (the shared framework)
# ---------------------------------------------------------------------------


def test_suppression_next_line_and_file_scope():
    src = """
        # stlint: disable-file=time-source reason: fixture file
        import time

        def a():
            return time.time()

        def b():
            try:
                return check()
            # stlint: disable-next-line=fail-open
            except Exception:
                return 0
        """
    assert _both(TimeSourcePass(), src) == []
    assert _both(FailOpenPass(), src) == []


def test_suppression_shares_comment_with_noqa():
    src = """
        import time

        def f():
            return time.time()  # noqa: X100  # stlint: disable=time-source — fixture
        """
    assert _both(TimeSourcePass(), src) == []


def test_suppression_anchors_on_multiline_statement_tail():
    src = """
        import time

        def f():
            return time.time(
            )  # stlint: disable=time-source — fixture: multi-line call
        """
    assert _both(TimeSourcePass(), src) == []
    unrelated = """
        import time

        def f():
            t = time.time()
            # stlint: disable=time-source
            return t
        """
    assert len(_both(TimeSourcePass(), unrelated)) == 1


def test_suppression_anchors_on_decorator_and_def_line():
    from sentinel_tpu_torch.analysis.framework import Pass

    class DefPass(Pass):
        name = "def-probe"

        def run(self, mod):
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.FunctionDef):
                    yield self.finding(mod, node, "probe")

    on_decorator = """
        import functools

        @functools.cache  # stlint: disable=def-probe — fixture
        def f():
            return 1
        """
    assert _run(DefPass(), _mod(on_decorator)) == []
    on_def = """
        import functools

        @functools.cache
        def f():  # stlint: disable=def-probe — fixture
            return 1
        """
    assert _run(DefPass(), _mod(on_def)) == []
    in_body = """
        import functools

        @functools.cache
        def f():
            return 1  # stlint: disable=def-probe — body lines are NOT the header
        """
    assert len(_run(DefPass(), _mod(in_body))) == 1


def test_suppression_span_does_not_leak_across_statements():
    src = """
        import time

        def f():
            a = time.time()
            # stlint: disable-next-line=time-source — only the SECOND read
            b = time.time()
            return a + b
        """
    got = _both(TimeSourcePass(), src)
    assert len(got) == 1 and got[0].line == 5


# ---------------------------------------------------------------------------
# the CI gate
# ---------------------------------------------------------------------------


def test_repo_is_clean_vs_baseline():
    """THE gate: the five passes over the port, nothing beyond its baseline
    — and the baseline is empty."""
    findings, new = run_repo_analysis()
    assert new == [], "NEW lint findings:\n" + "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in new
    )
    assert findings == [] and load_baseline(DEFAULT_BASELINE) == {}


def test_the_references_linter_finds_nothing_in_the_port():
    """The reference's AST tier over the port: zero findings (the launch
    counters and caches hold their module's lock, the launcher reads the
    clock through utils/time_source)."""
    from sentinel_tpu.analysis import ALL_PASSES as REF_PASSES
    from sentinel_tpu.analysis import framework as RF

    # the reference's runner (framework.run_passes), with every parsed
    # module kept alive until the end: its entry-lock cache is keyed by
    # id(tree), and a freed tree's id reused by the next file would serve
    # that file a stale answer
    ref_summaries.invalidate_cache()
    mods = [RF.parse_module(p, REPO_ROOT) for p in RF.iter_py_files(os.path.join(REPO_ROOT, "sentinel_tpu_torch"))]
    got = [
        f for m in mods if m is not None for p in REF_PASSES for f in p.run(m) if not m.suppressed(f.rule, *f.span())
    ]
    assert got == [], [f"{f.path}:{f.line} [{f.rule}]" for f in got]


def test_the_scan_covers_the_tier1_passes_the_metric_lint_and_the_cli():
    """The new modules import with neither jax nor the JAX package, and the
    import scan of tests/test_torch_imports.py walks them."""
    import pkgutil

    import sentinel_tpu_torch as st

    mods = [
        "analysis.passes", "analysis.passes.fail_open", "analysis.passes.host_sync",
        "analysis.passes.jit_recompile", "analysis.passes.time_source", "analysis.passes.unguarded_global",
        "analysis.metrics_catalog", "analysis.__main__", "analysis.jaxpr", "analysis.jaxpr.framework",
        "analysis.jaxpr.entrypoints", "analysis.jaxpr.passes", "analysis.jaxpr.passes.transfer_guard",
        "analysis.jaxpr.passes.dtype_overflow", "analysis.jaxpr.passes.const_hoist",
        "analysis.jaxpr.passes.fingerprint", "analysis.jaxpr.passes.cost_budget",
    ]
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    assert {f"sentinel_tpu_torch.{m}" for m in mods} <= walked
    code = (
        "import sys\n"
        + "".join(f"import sentinel_tpu_torch.{m}\n" for m in mods)
        + "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'sentinel_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _env():
    return {**os.environ, "PYTHONPATH": REPO_ROOT, "CUDA_VISIBLE_DEVICES": ""}


def _cli(*args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "sentinel_tpu_torch.analysis", *map(str, args)],
        capture_output=True, text=True, env=_env(), timeout=timeout, cwd=REPO_ROOT,
    )


def _bad_client(tmp_path):
    bad = tmp_path / "sentinel_tpu_torch" / "runtime"
    bad.mkdir(parents=True)
    snippet = bad / "client.py"
    snippet.write_text("import time\n\ndef f():\n    return time.time()\n")
    return snippet


def test_cli_exit_codes(tmp_path):
    """1 on a seeded violation, 0 on the clean port, 2 on a usage error;
    the device-bound tiers raise without a card unless --device cpu."""
    snippet = _bad_client(tmp_path)
    r = _cli(snippet, "--json")
    assert r.returncode == 1, r.stdout + r.stderr
    report = json.loads(r.stdout)
    assert report["new"] == 1 and report["findings"][0]["rule"] == "time-source"

    for tier in ("ast", "metrics", "concurrency"):
        r2 = _cli("--tier", tier)
        assert r2.returncode == 0, r2.stdout + r2.stderr

    r3 = _cli("--tier", "nope")
    assert r3.returncode == 2
    r4 = _cli("--tier", "jaxpr")
    assert r4.returncode != 0 and "device='cpu'" in r4.stderr


def test_cli_sarif_output(tmp_path):
    snippet = _bad_client(tmp_path)
    r = _cli(snippet, "--sarif")
    assert r.returncode == 1, r.stdout + r.stderr
    sarif = json.loads(r.stdout)
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert run["tool"]["driver"]["name"] == "stlint"
    results = run["results"]
    assert len(results) == 1 and results[0]["ruleId"] == "time-source" and results[0]["level"] == "error"
    assert results[0]["locations"][0]["physicalLocation"]["region"]["startLine"] == 4
    assert [ru["id"] for ru in run["tool"]["driver"]["rules"]] == ["time-source"]
    assert _cli(snippet, "--sarif", "--json").returncode == 2


def test_cli_zero_pass_selection_is_usage_error(tmp_path):
    snippet = tmp_path / "probe.py"
    snippet.write_text("import time\n\ndef f():\n    return time.time()\n")
    r = _cli(snippet, "--rules", "const-hoist")
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no pass selected for tier(s) ast" in r.stderr
    assert _cli(snippet, "--rules", "no-such-rule").returncode == 2


def test_scoped_update_baseline_preserves_out_of_scope_debt(tmp_path):
    tree = tmp_path / "sentinel_tpu_torch" / "runtime"
    tree.mkdir(parents=True)
    a, b = tree / "a.py", tree / "b.py"
    a.write_text("import time\n\ndef f():\n    return time.time()\n")
    b.write_text("import time\n\ndef g():\n    return time.time()\n")
    base = tmp_path / "baseline.json"
    r = _cli(a, b, "--baseline", base, "--update-baseline")
    assert r.returncode == 0, r.stdout + r.stderr
    accepted = json.loads(base.read_text())["accepted"]
    assert len(accepted) == 2
    r2 = _cli(a, "--baseline", base, "--update-baseline")
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert json.loads(base.read_text())["accepted"] == accepted
    assert _cli(a, b, "--baseline", base).returncode == 0


def test_rule_catalog_spans_both_tiers():
    cat = rule_catalog()
    assert {
        "fail-open", "host-sync", "jit-recompile", "time-source", "unguarded-global",
        "transfer-guard", "dtype-overflow", "const-hoist", "recompile-fingerprint", "flops-bytes-budget",
    } <= set(cat)
    assert all(desc for desc in cat.values())
    # the reference's rule ids, tier by tier
    from sentinel_tpu.analysis.jaxpr.passes import ALL_JAXPR_PASSES as REF_JAXPR
    from sentinel_tpu_torch.analysis.jaxpr.passes import ALL_JAXPR_PASSES

    assert [p.name for p in ALL_PASSES] == [p.name for p in ref_passes.ALL_PASSES]
    assert [p.name for p in ALL_JAXPR_PASSES] == [p.name for p in REF_JAXPR]


def test_cli_update_baseline_roundtrip(tmp_path):
    snippet = _bad_client(tmp_path)
    base = tmp_path / "baseline.json"
    r = _cli(snippet, "--baseline", base, "--update-baseline")
    assert r.returncode == 0, r.stdout + r.stderr
    assert _cli(snippet, "--baseline", base).returncode == 0
    assert _cli(snippet, "--baseline", base, "--no-baseline").returncode == 1


# ---------------------------------------------------------------------------
# tier 4 through the CLI surface (left out of tests/test_torch_spmd_analysis.py)
# ---------------------------------------------------------------------------


def test_update_collectives_round_trip(tmp_path):
    """update_collectives writes a reviewable golden that a fresh
    build_program round-trips to zero ledger findings."""
    from sentinel_tpu_torch.analysis.spmd import build_program, update_collectives
    from sentinel_tpu_torch.analysis.spmd.passes import CollectiveLedgerPass
    from sentinel_tpu_torch.parallel.meshspec import mesh_spec

    path = str(tmp_path / "collectives.json")
    assert update_collectives(path, device=DEVICE, refresh=False) == 3
    data = json.loads(open(path).read())
    assert "--update-collectives" in data["comment"]
    assert data["mesh"] == {"axis": mesh_spec().axis, "n_devices": mesh_spec().n_devices}
    assert set(data["entries"]) == {"tick/sketch-salsa", "window/add-batch", "cluster/token-col"}
    assert list(CollectiveLedgerPass().run(build_program(golden_path=path, device=DEVICE))) == []


def test_update_baseline_scoped_to_spmd_preserves_other_tiers(tmp_path):
    from sentinel_tpu_torch.analysis.__main__ import main
    from sentinel_tpu_torch.analysis.spmd.passes import ALL_SPMD_PASSES

    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"accepted": {"fail-open:sentinel_tpu_torch/foo.py": 2}}))
    assert main(["--tier", "spmd", "--update-baseline", "--baseline", str(path), "--device", DEVICE]) == 0
    kept = json.loads(path.read_text())["accepted"]
    assert kept.get("fail-open:sentinel_tpu_torch/foo.py") == 2
    spmd_rules = {p.name for p in ALL_SPMD_PASSES}
    assert [k for k in kept if k.split(":")[0] in spmd_rules] == []


def test_rule_catalog_spans_four_tiers():
    from sentinel_tpu_torch.analysis.concurrency.passes import ALL_CONCURRENCY_PASSES
    from sentinel_tpu_torch.analysis.spmd.passes import ALL_SPMD_PASSES

    cat = rule_catalog()
    for p in tuple(ALL_SPMD_PASSES) + tuple(ALL_CONCURRENCY_PASSES):
        assert p.name in cat and cat[p.name]
    assert len(ALL_SPMD_PASSES) == 5 and len(cat) == 19


def test_sarif_spmd_pseudo_paths_claim_no_uri_base():
    from sentinel_tpu_torch.analysis.spmd.framework import (
        Collective,
        ConfigCase,
        LeafPlacement,
        ShardedEntry,
        SpmdProgram,
    )
    from sentinel_tpu_torch.analysis.spmd.passes import ALL_SPMD_PASSES
    from sentinel_tpu_torch.parallel.meshspec import mesh_spec

    n = mesh_spec().n_devices
    leaf = LeafPlacement(name=".w", dtype="float32", shape=(137,), spec=("res",), global_bytes=137 * 4,
                         shard_bytes=-(-137 // n) * 4)
    prog = SpmdProgram(
        n_devices=n, axis=mesh_spec().axis,
        entries=[ShardedEntry(name="tick/fix", collectives=[Collective("all-gather", "f32", (1 << 16,))])],
        configs=[ConfigCase(name="engine/odd", placements=[leaf])],
        golden=None,
    )
    findings = [f for p in ALL_SPMD_PASSES for f in p.run(prog)]
    assert findings
    doc = json.loads(format_sarif(findings, findings, rule_catalog()))
    run = doc["runs"][0]
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {"collective-ledger", "implicit-reshard", "shard-divisibility"} <= rule_ids
    locs = [r["locations"][0]["physicalLocation"]["artifactLocation"] for r in run["results"]]
    pseudo = [loc for loc in locs if loc["uri"].startswith("spmd://")]
    assert pseudo and all("uriBaseId" not in loc for loc in pseudo)
