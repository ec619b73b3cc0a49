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
