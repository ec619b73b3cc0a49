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
    package exports only what is ported."""
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
    assert not {"HttpDataSource", "CallbackDataSource", "RedisDataSource"} & set(datasource.__all__)
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
