"""The port's native host library (sentinel_tpu_torch/native) against the
JAX package's copy and numpy.

The library builds with ``g++`` at first use into ``build/native/`` at the
repository root (never at import); these tests need ``g++`` and check
that the native form is the one that ran.  The batch
presort equals ``np.lexsort`` element for element (ties, n = 0 and 1, the
bulk path's B = 131,072); the completion ring, the frame codec and the
interner behave as the reference's.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from sentinel_tpu.native import ring as JRING

from sentinel_tpu_torch.native import EventRing, NativeInterner, load_native
from sentinel_tpu_torch.native import ring as TRING
from sentinel_tpu_torch.runtime import presort as PS

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_the_library_builds_from_the_checkout_into_build_native():
    lib = load_native()
    assert lib is not None and PS.sort_kind() == "native"
    so = pathlib.Path(lib._name)
    assert so.parent == ROOT / "build" / "native"
    assert so.name.startswith("_sentinel_host-") and so.suffix == ".so"
    assert so.read_bytes()[:4] == b"\x7fELF"


def test_importing_the_package_builds_nothing():
    code = (
        "import importlib, pkgutil\n"
        "import sentinel_tpu_torch as st\n"
        "for m in pkgutil.walk_packages(st.__path__, 'sentinel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from sentinel_tpu_torch.native import loader\n"
        "assert loader._LIB is None and not loader._TRIED\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_concurrent_builds_leave_one_library_and_no_partial_file(tmp_path):
    """Test workers may build at once: each compiles to its own temporary
    name and renames into place, so every process loads a whole library."""
    code = (
        "import pathlib, sys\n"
        "from sentinel_tpu_torch.native import loader\n"
        "loader.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "lib = loader.load_native()\n"
        "assert lib is not None and lib.sx_batch_sort3 is not None\n"
        "print(pathlib.Path(lib._name).name)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _o, e in outs]
    names = {o.strip() for o, _e in outs}
    assert len(names) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(names)


def _keys(rng, n, highs):
    return [rng.integers(-2, h, n).astype(np.int32) for h in highs]


@pytest.mark.parametrize("n", [0, 1, 2, 257, 5_000, 131_072])
def test_batch_sort_equals_lexsort_and_the_reference(n):
    rng = np.random.default_rng(n)
    keys = _keys(rng, n, (40, 3, 5, 2, 4))  # few distinct values: many ties
    order, inv = PS.batch_sort5(*keys)
    want = np.lexsort(tuple(reversed(keys)))
    assert order.dtype == np.int32 and inv.dtype == np.int32
    np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(inv[order], np.arange(n))
    jorder, jinv = JRING.batch_sort5(*keys)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(inv, jinv)
    order3, none = PS.batch_sort3(*keys[:3], want_inv=False)
    assert none is None
    np.testing.assert_array_equal(order3, np.lexsort(tuple(reversed(keys[:3]))))
    np.testing.assert_array_equal(order3, JRING.batch_sort3(*keys[:3])[0])
    _o, inv3 = PS.batch_sort3(*keys[:3])
    np.testing.assert_array_equal(inv3[order3], np.arange(n))


def test_the_numpy_form_runs_where_the_library_is_missing(monkeypatch):
    """The reference's contract: no toolchain, the same order from numpy
    (and sort_kind says so, which chip_smoke.py refuses on the card)."""
    monkeypatch.setattr(TRING, "load_native", lambda: None)
    monkeypatch.setattr(PS, "load_native", lambda: None)
    rng = np.random.default_rng(7)
    keys = _keys(rng, 3_000, (30, 3, 4, 2, 3))
    order, inv = PS.batch_sort5(*keys)
    np.testing.assert_array_equal(order, np.lexsort(tuple(reversed(keys))))
    np.testing.assert_array_equal(inv[order], np.arange(3_000))
    assert PS.sort_kind() == "numpy"


def _push_all(ring, rows):
    return [ring.push(*r) for r in rows]


def test_event_ring_push_drain_and_overflow_as_the_reference():
    rows = [
        (i, i % 3 + 1, -1 - i, 7 * i, 4 | (i & 1), 0.125 * i, i % 2, i, i + 1, -i, 3 * i, i % 5)
        for i in range(12)
    ]
    tr, jr = EventRing(8), JRING.EventRing(8)
    assert tr.native and jr.native
    assert _push_all(tr, rows) == _push_all(jr, rows) == [True] * 8 + [False] * 4
    assert len(tr) == len(jr) == 8
    got, want = tr.drain(5), jr.drain(5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    np.testing.assert_array_equal(got[0], np.arange(5))
    np.testing.assert_array_equal(got[5], np.arange(5, dtype=np.float32) * 0.125)
    assert len(tr) == 3 and bool(tr)
    assert _push_all(tr, rows[8:]) == _push_all(jr, rows[8:])
    got, want = tr.drain(100), jr.drain(100)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [5, 6, 7, 8, 9, 10, 11])  # FIFO across the wrap
    assert len(tr) == 0 and len(tr.drain(4)[0]) == 0
    with pytest.raises(AssertionError):
        EventRing(6)


def test_event_ring_fallback_matches_the_native_ring(monkeypatch):
    rows = [(i, 1, -1, 0, 4, float(i), 0, 0, 0, 0, 0, 0) for i in range(6)]
    native = EventRing(4)
    monkeypatch.setattr(TRING, "load_native", lambda: None)
    fallback = EventRing(4)
    assert native.native and not fallback.native
    assert _push_all(native, rows) == _push_all(fallback, rows)
    for g, w in zip(native.drain(10), fallback.drain(10)):
        np.testing.assert_array_equal(g, w)


def test_frame_pack_and_unpack_are_byte_equal_to_the_reference():
    rng = np.random.default_rng(3)
    n = 257
    kinds = rng.integers(0, 4, n).astype(np.uint8)
    ids = rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64)
    counts = rng.integers(-5, 2 ** 20, n).astype(np.int32)
    flags = rng.integers(0, 256, n).astype(np.uint8)
    buf = TRING.pack_batch_entries(kinds, ids, counts, flags)
    assert buf == JRING.pack_batch_entries(kinds, ids, counts, flags)
    assert len(buf) == n * TRING.BATCH_ENTRY_SIZE
    for g, w in zip(TRING.unpack_batch_entries(buf), (kinds, ids, counts, flags)):
        np.testing.assert_array_equal(g, w)
    st = rng.integers(-3, 4, n).astype(np.int8)
    rem = rng.integers(-(2 ** 31), 2 ** 31 - 1, n).astype(np.int32)
    wait = rng.integers(0, 10 ** 6, n).astype(np.int32)
    tok = rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64)
    rbuf = TRING.pack_batch_results(st, rem, wait, tok)
    assert rbuf == JRING.pack_batch_results(st, rem, wait, tok)
    for g, w in zip(TRING.unpack_batch_results(rbuf), (st, rem, wait, tok)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(TRING.unpack_batch_results(rbuf), JRING.unpack_batch_results(rbuf)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        TRING.unpack_batch_entries(buf[:-1])
    with pytest.raises(ValueError):
        TRING.unpack_batch_results(rbuf[:-3])


def test_the_interner_as_the_reference():
    t, j = NativeInterner(capacity_pow2=64, first_id=3, max_ids=8), JRING.NativeInterner(64, 3, 8)
    assert t.native and j.native
    names = ["a", "b", "a", "ünï", "c", "b", "d", "e", "f", "g"]
    assert [t.get(n) for n in names] == [j.get(n) for n in names] == [3, 4, 3, 5, 6, 4, 7, -1, -1, -1]
    assert t.count() == j.count() == 5
