"""sentinel_tpu_torch stands alone: it imports neither jax nor anything of
the JAX package (nor the TPU probes under ``benchmarks/``), and its entry
points default to the card."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sentinel_tpu_torch"


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys, importlib, pkgutil\n"
        "import sentinel_tpu_torch as st\n"
        "for m in pkgutil.walk_packages(st.__path__, 'sentinel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'sentinel_tpu' or n.startswith('sentinel_tpu.'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "for make in (lambda: st.SentinelClient(), lambda: st.init()):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('an entry point ran without CUDA')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("top", ["jax", "jaxlib", "sentinel_tpu", "benchmarks"])
def test_no_source_file_imports_the_reference(top):
    """Neither the package nor chip_smoke.py (the card's check) imports
    jax or the JAX package."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [
        (str(p.relative_to(ROOT)), mod)
        for p in files
        for mod in _imports(p)
        if mod == top or mod.startswith(top + ".")
    ]
    assert not offenders


def test_the_scan_covers_the_probes_package_and_the_param_module():
    """The checks above walk every module of the package: the probes
    package and ops/param.py are among them, and import on the CPU."""
    import importlib
    import pkgutil

    import sentinel_tpu_torch as st

    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"probes/__init__.py", "probes/kernels.py", "probes/floor.py", "probes/hist.py",
            "probes/timing.py", "ops/param.py"} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in ("probes", "probes.kernels", "probes.floor", "probes.hist", "probes.timing", "ops.param"):
        assert f"sentinel_tpu_torch.{mod}" in walked
        importlib.import_module(f"sentinel_tpu_torch.{mod}")


def test_the_scan_covers_the_obs_and_chaos_packages():
    """The host planes the readback feeds are the port's own copies: obs/
    (registry, timeline, explain), chaos/ (failpoints, plans) and
    utils/record_log.py are walked by the checks above and import on the
    CPU without the JAX package."""
    import importlib
    import pkgutil
    import sys

    import sentinel_tpu_torch as st

    mods = ("obs", "obs.registry", "obs.timeline", "obs.explain", "chaos", "chaos.failpoints",
            "chaos.plans", "utils.record_log")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    # the port's failpoints and metrics are its own objects, never the
    # reference's (which this test process may also have loaded)
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.obs import registry as REG

    for name in ("sentinel_tpu.chaos.failpoints", "sentinel_tpu.obs.registry"):
        ref = sys.modules.get(name)
        assert ref is None or ref not in (FP, REG)


def test_the_scan_covers_the_sketch_tier():
    """The sketch tier is the port's own: ops/gsketch.py, sketch/ (salsa,
    hotset) and adaptive/degrade.py (the hot-set manager's hysteresis) are
    walked by the checks above and import on the CPU without the JAX
    package."""
    import importlib
    import pkgutil

    import sentinel_tpu_torch as st

    mods = ("ops.gsketch", "sketch", "sketch.salsa", "sketch.hotset", "adaptive", "adaptive.degrade")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    from sentinel_tpu_torch.sketch import hotset

    assert hotset.Hysteresis.__module__ == "sentinel_tpu_torch.adaptive.degrade"


def test_the_scan_covers_the_native_library_the_metrics_spi_and_the_tracer():
    """The client's host surface is the port's own: native/ (the loader,
    the ring and interner wrappers, and the C++ source they build),
    metrics/ (the extension SPI), runtime/slots.py and obs/trace.py are
    walked by the checks above and import on the CPU without the JAX
    package; the native source is a file of the port, not the reference's."""
    import importlib
    import pkgutil
    import sys

    import sentinel_tpu_torch as st

    mods = ("native", "native.loader", "native.ring", "metrics", "metrics.extension", "runtime.slots",
            "obs.trace")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*") if p.is_file()}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    assert "native/sentinel_host.cpp" in files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    from sentinel_tpu_torch.native import loader
    from sentinel_tpu_torch.obs import trace

    assert loader._SRC == PKG / "native" / "sentinel_host.cpp"
    ref = sys.modules.get("sentinel_tpu.obs.trace")
    assert ref is None or ref.TRACER is not trace.TRACER


def test_the_scan_covers_the_cluster_layer():
    """The cluster token layer is the port's own: cluster/ (constants,
    protocol, rules, the token service, server, client and state manager),
    ops/token_col.py and utils/host_window.py are walked by the checks
    above and import on the CPU without the JAX package; the codec, the
    rules and the client import without torch (the column imports it where
    it runs); the wire counters are the port's registry's."""
    import importlib
    import pkgutil
    import sys

    import sentinel_tpu_torch as st

    mods = ("cluster", "cluster.constants", "cluster.protocol", "cluster.rules", "cluster.token_service",
            "cluster.server", "cluster.client", "cluster.state", "ops.token_col", "utils.host_window")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    code = (
        "import sys\n"
        "import sentinel_tpu_torch.cluster as CL\n"
        "import sentinel_tpu_torch.cluster.protocol, sentinel_tpu_torch.utils.host_window\n"
        "assert 'torch' not in sys.modules, 'the cluster codec pulled torch in'\n"
        "assert not [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'sentinel_tpu.'))]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    from sentinel_tpu_torch.cluster import protocol as P
    from sentinel_tpu_torch.obs.registry import REGISTRY

    assert REGISTRY.get("sentinel_wire_bytes_total", {"path": "cluster", "direction": "tx"}) is P._C_WIRE_TX
    ref = sys.modules.get("sentinel_tpu.cluster.protocol")
    assert ref is None or ref._C_WIRE_TX is not P._C_WIRE_TX


def test_the_scan_covers_the_control_plane():
    """The control plane is the port's own: transport/ (the command
    registry, the handlers, the HTTP command center, the heartbeat, the
    write-back registry), metrics/ (the line codec, the writer, searcher
    and timer), datasource/ (property, base, converters) and
    utils/authn.py, utils/record_log.py are walked by the checks above and
    import on the CPU without the JAX package; their failpoints are the
    port's registry's, their loggers the port's, and the datasource
    package exports what the reference's exports (the remote and redis
    datasources among them, ported since)."""
    import importlib
    import pkgutil
    import sys

    import sentinel_tpu_torch as st

    mods = ("transport", "transport.command", "transport.handlers", "transport.http_server",
            "transport.heartbeat", "transport.writable_registry", "metrics.node", "metrics.writer",
            "metrics.searcher", "metrics.timer", "datasource", "datasource.property", "datasource.base",
            "datasource.converters", "utils.authn", "utils.record_log")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    from sentinel_tpu_torch import datasource
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.utils import record_log

    for site in ("transport.command.dispatch", "transport.http.request", "transport.heartbeat.send",
                 "datasource.refresh.read", "datasource.file.read"):
        assert site in FP.catalog()
    assert record_log.record_log().name == "sentinel_tpu_torch.record"
    assert record_log.command_center_log().name == "sentinel_tpu_torch.command"
    assert set(datasource.__all__) == {
        "SentinelProperty", "DynamicSentinelProperty", "NoOpSentinelProperty", "PropertyListener",
        "SimplePropertyListener", "ReadableDataSource", "WritableDataSource", "AbstractDataSource",
        "CallbackDataSource", "HttpDataSource", "AutoRefreshDataSource", "FileRefreshableDataSource",
        "FileWritableDataSource", "Converter", "json_rule_converter", "json_rule_encoder", "RedisConnection",
        "RedisDataSource", "RespError"}
    assert st.__version__ == "0.1.0"
    ref = sys.modules.get("sentinel_tpu.transport.command")
    assert ref is None or ref.CommandRegistry is not importlib.import_module(
        "sentinel_tpu_torch.transport.command").CommandRegistry


def test_the_scan_covers_overload_protection():
    """Overload protection is the port's own: adaptive/ (the controller,
    the signals, the degrade ladder, the overload simulator), obs/flight.py,
    metrics/block_log.py and workload/operating_point.py are walked by the
    checks above and import on the CPU without the JAX package; the
    client's admission and watchdog failpoints are the port's registry's,
    and its shed / watchdog / ladder metrics live on the port's registry."""
    import importlib
    import pkgutil

    import sentinel_tpu_torch as st

    mods = ("adaptive", "adaptive.controller", "adaptive.signals", "adaptive.degrade", "adaptive.simload",
            "obs.flight", "metrics.block_log", "workload", "workload.operating_point")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    importlib.import_module("sentinel_tpu_torch.runtime.client")
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.obs import flight
    from sentinel_tpu_torch.obs.registry import REGISTRY

    for site in ("runtime.client.admit", "runtime.watchdog.stall"):
        assert site in FP.catalog()
    for name in ("sentinel_shed_total", "sentinel_watchdog_fired_total", "sentinel_adaptive_level",
                 "sentinel_adaptive_ceiling"):
        assert REGISTRY.series(name), name
    assert flight.FLIGHT.__class__.__module__ == "sentinel_tpu_torch.obs.flight"


def test_the_scan_covers_the_operations_plane():
    """The operations plane is the port's own: obs/slo.py, obs/fleet.py,
    obs/profile.py and workload/ (shapes, generator, tuner, and the adapter
    drivers since the adapters are ported) are walked by the checks above
    and import on the CPU without the JAX package; their failpoints and the
    ledger's counters are the port's registry's; the profiling plane
    imports without torch (the cluster codec imports it)."""
    import importlib
    import pkgutil
    import sys

    import sentinel_tpu_torch as st

    mods = ("obs.slo", "obs.fleet", "obs.profile", "workload", "workload.shapes", "workload.generator",
            "workload.tuner")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    from sentinel_tpu_torch import obs, workload
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.obs.registry import REGISTRY

    for site in ("obs.profile.capture", "sketch.audit.shadow", "workload.gen.emit", "workload.tuner.step"):
        assert site in FP.catalog()
    for name in ("sentinel_hbm_capacity_checks_total", "sentinel_hbm_capacity_breaches_total"):
        assert REGISTRY.series(name), name
    assert {"drive_gateway", "drive_asgi", "drive_streaming", "drive_grpc"} <= set(workload.__all__)
    assert {"LEDGER", "RETRACE", "SketchAudit", "capture_profile", "FLIGHT"} <= set(obs.__all__)
    ref = sys.modules.get("sentinel_tpu.obs.profile")
    assert ref is None or ref.LEDGER is not obs.LEDGER
    code = (
        "import sys\n"
        "import sentinel_tpu_torch.obs.profile, sentinel_tpu_torch.obs.slo, sentinel_tpu_torch.obs.fleet\n"
        "assert 'torch' not in sys.modules, 'the profiling plane pulled torch in'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_scan_covers_the_front_doors_and_the_adapters():
    """The front doors and the adapters are the port's own:
    cluster/front_door.py, rls/ (the rule model, the protoc module and the
    gRPC server) and adapters/ (gRPC interceptors included: this box has
    grpcio and protobuf) are walked by the checks above and import on the
    CPU without the JAX package; the rule model imports without grpc and
    protobuf, as the reference's does; the client's four tick-loop
    failpoints and the front-door, RLS, rotation and tick-build metrics are
    the port's registry's; the packages export what the reference's do."""
    import importlib
    import pkgutil
    import sys

    import sentinel_tpu_torch as st

    mods = ("cluster.front_door", "rls", "rls.rules", "rls.rls_pb2", "rls.server", "adapters",
            "adapters._common", "adapters.decorator", "adapters.wsgi", "adapters.asgi", "adapters.streaming",
            "adapters.http_client", "adapters.rpc", "adapters.gateway", "adapters.grpc_adapter")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    importlib.import_module("sentinel_tpu_torch.runtime.client")
    from sentinel_tpu_torch import adapters, rls
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.obs.registry import REGISTRY

    for site in ("runtime.tick.clock", "runtime.resolve.readback", "runtime.resolve.fanout",
                 "runtime.seg.resize"):
        assert site in FP.catalog()
    for name in ("sentinel_front_door_unenforceable_rules", "sentinel_rls_decision_ms",
                 "sentinel_rls_requests_total", "sentinel_window_rotations_total",
                 "sentinel_window_slack_skips_total", "sentinel_engine_tick_builds_total"):
        assert REGISTRY.series(name), name
    ref_adapters = {"sentinel_resource", "SentinelWSGIMiddleware", "SentinelASGIMiddleware", "SentinelHttpClient",
                    "consumer_call", "consumer_entry", "provider_call", "provider_entry", "guard_aiter",
                    "guard_awaitable", "guard_stream", "guarded_urlopen", "default_url_resource", "ApiDefinition",
                    "ApiDefinitionManager", "ApiPredicateItem", "GatewayAdapter", "GatewayFlowRule",
                    "GatewayParamFlowItem", "GatewayParamParser", "GatewayRuleManager", "RequestAttributes",
                    "convert_to_param_rule"}
    assert set(adapters.__all__) == ref_adapters
    assert set(rls.__all__) == {"EnvoyRlsRule", "EnvoyRlsRuleManager", "RlsKeyValue", "RlsResourceDescriptor"}
    ref = sys.modules.get("sentinel_tpu.cluster.front_door")
    assert ref is None or ref._C_UNENFORCEABLE is not importlib.import_module(
        "sentinel_tpu_torch.cluster.front_door")._C_UNENFORCEABLE
    code = (
        "import sys\n"
        "import sentinel_tpu_torch.rls, sentinel_tpu_torch.adapters\n"
        "bad = [n for n in sys.modules if n.split('.')[0] == 'grpc' or n.startswith('google.protobuf')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_scan_covers_the_dashboard_and_the_store_datasources():
    """The operator's plane is the port's own: dashboard/ (api client,
    discovery, fetcher, repository, server, ui) and the remote, redis,
    zookeeper and store datasources are walked by the checks above and
    import on the CPU without jax or the JAX package, in a fresh process;
    the fetcher's two series and the store watch failpoint are the port's
    registry's; the packages export what the reference's do."""
    import importlib
    import pkgutil

    import sentinel_tpu_torch as st

    mods = ("dashboard", "dashboard.api_client", "dashboard.discovery", "dashboard.metric_fetcher",
            "dashboard.repository", "dashboard.server", "dashboard.ui", "datasource.remote", "datasource.redis",
            "datasource.zookeeper", "datasource.stores")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if "." in m} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    from sentinel_tpu_torch import dashboard, datasource
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.obs.registry import REGISTRY

    assert "datasource.store.watch" in FP.catalog()
    for name in ("sentinel_dashboard_fetch_total", "sentinel_dashboard_last_success_ms"):
        assert REGISTRY.series(name), name
    assert set(dashboard.__all__) == {"SentinelApiClient", "AppManagement", "MachineInfo", "MetricFetcher",
                                      "InMemoryMetricsRepository", "DashboardServer", "DynamicRuleProvider",
                                      "DynamicRulePublisher"}
    assert {"CallbackDataSource", "HttpDataSource", "RedisConnection", "RedisDataSource", "RespError"} <= set(
        datasource.__all__)
    code = (
        "import sys\n"
        "import " + ", ".join(f"sentinel_tpu_torch.{m}" for m in mods) + "\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'sentinel_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_the_scan_covers_the_sharded_cluster_and_the_router():
    """The sharded cluster and the host-layer router are the port's own:
    cluster/ring.py, cluster/shard.py, parallel/router.py and
    parallel/remote_shard.py are walked by the checks above and import on
    the CPU without jax or the JAX package, in a fresh process; their
    failpoints and series are the port's registry's; cluster/ exports
    what the reference's does.  Then tests/test_torch_multihost.py, run
    as a script as its tests run it, serves as a shard host (it prints its
    port) without importing jax or the JAX package either."""
    import importlib
    import pkgutil

    import sentinel_tpu_torch as st

    mods = ("cluster.ring", "cluster.shard", "parallel", "parallel.router", "parallel.remote_shard")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"cluster/ring.py", "cluster/shard.py", "parallel/__init__.py", "parallel/router.py",
            "parallel/remote_shard.py"} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    from sentinel_tpu_torch import cluster
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.obs.registry import REGISTRY

    assert {"cluster.shard.route", "cluster.shard.probe", "cluster.shard.lease", "cluster.lease.refresh_async",
            "parallel.shard.connect", "parallel.shard.send", "parallel.shard.recv"} <= set(FP.catalog())
    for name in ("sentinel_shard_chunk_ms", "sentinel_shard_chunks_total", "sentinel_shard_chunks_degraded_total"):
        assert REGISTRY.series(name), name
    assert {"HashRing", "flow_key", "ShardFleet", "ShardedTokenClient"} <= set(dir(cluster))
    code = (
        "import sys\n"
        "import " + ", ".join(f"sentinel_tpu_torch.{m}" for m in mods) + "\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'sentinel_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    host = ROOT / "tests" / "test_torch_multihost.py"
    code = (
        "import os, runpy, sys, threading\n"
        "class Served(Exception):\n"
        "    pass\n"
        "real_wait = threading.Event.wait\n"
        "def wait(self, timeout=None):\n"
        "    if sys._getframe(1).f_code.co_name == 'shard_host_main':\n"
        "        raise Served  # the host's serve-forever wait: it is up\n"
        "    return real_wait(self, timeout)\n"
        "threading.Event.wait = wait\n"
        f"sys.argv = [{str(host)!r}, '[{{\"resource\": \"r\", \"count\": 1}}]']\n"
        "try:\n"
        f"    runpy.run_path({str(host)!r}, run_name='__main__')\n"
        "except Served:\n"
        "    pass\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'sentinel_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', flush=True)\n"
        "os._exit(0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("PORT ") and lines[-1] == "ok", proc.stdout


def test_the_scan_covers_the_chaos_plane_the_analyzer_and_the_trace_cli():
    """The chaos plane's runner, invariants and CLI, the analyzer's
    framework with the concurrency tier and the lock witness, and the trace
    CLI are the port's own: walked by the checks above and imported, in a
    fresh process, without jax or the JAX package — the two CLIs run their
    ``--list`` / ``--sites`` and a ``--postmortem`` there, the analyzer
    loads the port's golden and reads the port's source, and the witness
    registers its failpoint and series in the port's registry."""
    import importlib
    import pkgutil

    import sentinel_tpu_torch as st

    mods = ("analysis", "analysis.astutil", "analysis.framework", "analysis.concurrency",
            "analysis.concurrency.summaries", "analysis.concurrency.passes", "analysis.concurrency.witness",
            "chaos.invariants", "chaos.runner", "chaos.__main__", "obs.__main__")
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {m.replace(".", "/") + ".py" for m in mods if m not in ("analysis", "analysis.concurrency")} <= files
    assert {"analysis/__init__.py", "analysis/concurrency/__init__.py"} <= files
    assert (PKG / "analysis" / "concurrency" / "lock_order.json").is_file()
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    code = (
        "import contextlib, io, json, os, sys, tempfile\n"
        "import " + ", ".join(f"sentinel_tpu_torch.{m}" for m in mods) + "\n"
        "from sentinel_tpu_torch.analysis import concurrency as AC\n"
        "from sentinel_tpu_torch.chaos import failpoints as FP\n"
        "from sentinel_tpu_torch.obs.flight import FLIGHT\n"
        "from sentinel_tpu_torch.obs.registry import REGISTRY\n"
        "main = sys.modules['sentinel_tpu_torch.chaos.__main__'].main\n"
        "obs_main = sys.modules['sentinel_tpu_torch.obs.__main__'].main\n"
        "edges = AC.load_lock_order()\n"
        "assert edges and set(AC.current_edges()) == edges\n"
        "assert 'runtime.lock.contend' in FP.catalog()\n"
        "assert REGISTRY.series('sentinel_lock_wait_ms') and REGISTRY.series('sentinel_lock_order_violations_total')\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert main(['--list']) == 0 and main(['--sites']) == 0\n"
        "    path = os.path.join(tempfile.mkdtemp(), 'b.json')\n"
        "    json.dump(FLIGHT.dump_bundle('imports'), open(path, 'w'))\n"
        "    assert obs_main(['--postmortem', path]) == 0\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'sentinel_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_the_scan_covers_the_sharded_engine_and_the_spmd_analyzer():
    """The mesh spec, the sharded engine, its collectives and launcher and
    the tier-4 analyzer are walked by the checks above; each imports on
    the CPU with neither jax nor the JAX package (the meshspec module with
    the stdlib alone), and the sharded entry points default to the card."""
    import importlib
    import pkgutil

    import sentinel_tpu_torch as st

    mods = [
        "parallel.meshspec", "parallel.spmd", "parallel.collectives", "parallel.launch",
        "analysis.spmd", "analysis.spmd.framework", "analysis.spmd.entrypoints",
        "analysis.spmd.passes", "analysis.spmd.runner", "analysis.spmd.worker",
    ]
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*") if p.is_file()}
    assert {m.replace(".", "/") + ".py" for m in mods if m != "analysis.spmd"} <= files
    assert {"analysis/spmd/__init__.py", "analysis/spmd/collectives.json"} <= files
    walked = {m.name for m in pkgutil.walk_packages(st.__path__, "sentinel_tpu_torch.")}
    for mod in mods:
        assert f"sentinel_tpu_torch.{mod}" in walked
        m = importlib.import_module(f"sentinel_tpu_torch.{mod}")
        assert "sentinel_tpu." not in getattr(m, "__file__", "")
    # the mesh spec is stdlib only, as the reference's is
    assert {mod.split(".")[0] for mod in _imports(PKG / "parallel" / "meshspec.py")} <= {
        "__future__", "socket", "dataclasses", "typing",
    }
    code = (
        "import sys\n"
        "import " + ", ".join(f"sentinel_tpu_torch.{m}" for m in mods) + "\n"
        "from sentinel_tpu_torch.parallel import spmd\n"
        "from sentinel_tpu_torch.analysis.spmd import runner\n"
        "for call in (lambda: spmd.make_mesh(), lambda: runner._run_worker(2, 'cuda')):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('a sharded entry point ran without CUDA')\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'sentinel_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
