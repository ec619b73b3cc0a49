"""sentinel_tpu_torch stands alone: it imports neither jax nor anything of
the JAX package, and its entry points default to the card."""

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


@pytest.mark.parametrize("top", ["jax", "jaxlib", "sentinel_tpu"])
def test_no_source_file_imports_the_reference(top):
    offenders = [
        (str(p.relative_to(ROOT)), mod)
        for p in sorted(PKG.rglob("*.py"))
        for mod in _imports(p)
        if mod == top or mod.startswith(top + ".")
    ]
    assert not offenders
