"""The port's row-sharded engine over n gloo ranks on the CPU.

Mirrors tests/test_spmd.py and goes further: the port's sharded tick
(parallel/spmd.make_sharded_tick) runs on 2, 4 and 8 (``mesh_spec()``)
gloo ranks, each world size started ONCE for the module
(``tests/torch_spmd_ranks.drive`` runs every case inside it), and is
held, tick by tick and in the gathered state at the end, against

* the port's single-device tick on the same rules, batches and now_ms
  (exactly: every output tensor, the packed wire byte for byte);
* the JAX package's single-device tick, jitted (integers equal, floats
  within rtol 1e-6 / atol 1e-4).  On the platform config it runs the JAX
  package's plain path, the reference its own equivalence tests hold its
  fused and segment ticks to (its Pallas kernels in interpret mode would
  cost half a minute here); there the stats row's live-segment slot is
  left out, the one value the two paths report differently;
* for ``small_engine_config()``, the JAX package's own sharded tick on
  its 8-device CPU mesh (tests/conftest.py), as tests/test_spmd.py runs it.

Four configs: ``small_engine_config()`` (the plain path), the reference
dry run's config with the minute window on, the tier-4 analyzer's tick
config (SALSA, width-sharded, with sketch ids in the stream) and the
platform flags at small widths (the fused and segment paths, both
branches of the fallback, the packed wire with its explain records, the
kernels' plain versions).

Every rank group has a deadline (``RANK_DEADLINE_S``): a rank that fails
or hangs has every rank killed and the test fails with its traceback.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.core import config as JC
from sentinel_tpu.core import rules as JR
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.runtime.registry import Registry as JaxRegistry
from sentinel_tpu_torch import state as S
from sentinel_tpu_torch.core import config as TCFG
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.parallel import collectives as CL
from sentinel_tpu_torch.parallel import launch, meshspec, spmd
from tests import torch_spmd_ranks as RK

WORLDS = (2, 4, meshspec.mesh_spec().n_devices)
#: one rank group's whole run (every case) must end inside this
RANK_DEADLINE_S = 240.0

#: ATen operations the single-device ticks of each case dispatch
#: (``torch_spmd_ranks.dispatched_ops``), as counted on the tree before
#: the sharded path existed: with no shard context the tick is unchanged
SINGLE_DEVICE_OPS = {"small": 7304, "minute": 7304, "sketch": 9044, "platform": 16328}


@pytest.fixture(scope="module")
def sharded():
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = launch.run_ranks(RK.drive, n, timeout_s=RANK_DEADLINE_S)
        return cache[n]

    return get


@pytest.fixture(scope="module")
def single():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = RK.single(name)
        return cache[name]

    return get


def _jax_inputs(w):
    acq = JE.AcquireBatch(**{k: jnp.asarray(v) for k, v in w["acq"].items()})
    comp = JE.CompleteBatch(**{k: jnp.asarray(v) for k, v in w["comp"].items()})
    return acq, comp


def _jax_run(name, make_tick, init, plain=False):
    """The JAX package's ticks of a case: (outputs per tick, final state
    as the port's numpy tree)."""
    cfg = RK.config(name, JC)
    reg = JaxRegistry(cfg)
    RK.H.intern(reg)
    rules = RK.H.make_rules(JR, param=True)
    rules["system_rules"] = [JR.SystemRule(qps=60)]
    rs = JE.compile_ruleset(cfg, reg, **rules)
    run_cfg = dataclasses.replace(cfg, fused_effects=False, use_mxu_tables=False, seg_effects=False) if plain else cfg
    tick = make_tick(run_cfg)
    st = init(run_cfg)
    outs = []
    for i, now in enumerate(RK.NOWS):
        w = RK.workload(cfg, reg, seed=1000 * (1 + RK.CASES.index(name)) + i)
        st, out = tick(st, rs, *_jax_inputs(w), jnp.int32(now), jnp.float32(0.5), jnp.float32(0.2))
        outs.append({k: np.asarray(v) for k, v in out._asdict().items() if v is not None})
    tcfg = RK.config(name, TCFG)
    return outs, S.to_numpy(S.state_from_numpy(tcfg, jax.tree.map(np.asarray, st), "cpu"))


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_run(
                name, lambda c: JE.make_tick(c, donate=False), JE.init_state, plain=name == "platform"
            )
        return cache[name]

    return get


def _walk(x, path=""):
    if isinstance(x, np.ndarray):
        yield path, x
        return
    for f, v in zip(x._fields, x):
        yield from _walk(v, f"{path}.{f}")


def _same(a, b, what, exact=False):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if exact or a.dtype.kind != "f":
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4, err_msg=what)


def _same_states(a, b, what, exact=False):
    pa, pb = dict(_walk(a)), dict(_walk(b))
    assert pa.keys() == pb.keys()
    for k in pa:
        _same(pa[k], pb[k], f"{what} state {k}", exact)


def _fields(name, out) -> dict:
    """A tick's outputs as comparable fields (the packed wire unpacked)."""
    if "wire" not in out:
        return {k: v for k, v in out.items() if k != "seg_dropped"} | {"seg_dropped": int(out.get("seg_dropped", 0))}
    tcfg = RK.config(name, TCFG)
    f = WIRE.unpack(np.asarray(out["wire"]).tobytes(), WIRE.layout_for(tcfg, tcfg.batch_size))
    d = {k: v for k, v in f._asdict().items() if isinstance(v, np.ndarray)}
    d["seg_dropped"] = f.seg_dropped
    return d


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", RK.CASES)
def test_sharded_tick_matches_both_single_device_ticks(sharded, single, reference, n, name):
    got = sharded(n)[0][name]
    mine = single(name)
    ref_outs, ref_state = reference(name)
    for i, (a, b, r) in enumerate(zip(got["outs"], mine["outs"], ref_outs)):
        assert a.keys() == b.keys()
        for k in a:  # against the port's single device: exact, the wire byte for byte
            _same(a[k], b[k], f"{name} n={n} tick {i} {k}", exact=True)
        fa, fr = _fields(name, a), _fields(name, r)
        if name == "platform":  # the JAX package's plain path reports no live segments
            fa["stats"] = np.delete(fa["stats"], E.STAT_SEG_LIVE)
            fr["stats"] = np.delete(fr["stats"], E.STAT_SEG_LIVE)
        assert fa.keys() == fr.keys(), (fa.keys(), fr.keys())
        for k in fa:
            _same(fa[k], fr[k], f"{name} n={n} tick {i} {k} vs the JAX package")
    _same_states(got["state"], mine["state"], f"{name} n={n}", exact=True)
    _same_states(got["state"], ref_state, f"{name} n={n} vs the JAX package")


def test_verdicts_cover_every_check(single):
    seen = set()
    for name in RK.CASES:
        for out in single(name)["outs"]:
            seen |= set(np.asarray(_fields(name, out)["verdict"]).tolist())
    assert {0, 1, 2, 3, 4, 5, 6} <= seen


def test_small_matches_the_jax_sharded_tick_on_its_mesh(sharded):
    """The JAX package's own make_sharded_tick on its 8-device CPU mesh
    (tests/conftest.py) and the port's on 8 gloo ranks: the same verdicts
    tick for tick and the same state at the end."""
    from sentinel_tpu.parallel import spmd as JS

    n = meshspec.mesh_spec().n_devices
    if len(jax.devices()) < n:
        pytest.fail(f"the JAX package's mesh needs {n} CPU devices (tests/conftest.py forces them)")
    mesh = JS.make_mesh(n)
    ref_outs, ref_state = _jax_run(
        "small", lambda c: JS.make_sharded_tick(c, mesh, donate=False),
        lambda c: JS.shard_state(JE.init_state(c), c, mesh),
    )
    got = sharded(n)[0]["small"]
    for i, (a, r) in enumerate(zip(got["outs"], ref_outs)):
        fa, fr = _fields("small", a), _fields("small", r)
        for k in fa:
            _same(fa[k], fr[k], f"tick {i} {k}")
    _same_states(got["state"], ref_state, "small vs the JAX sharded tick")


@pytest.mark.parametrize("n", WORLDS)
def test_each_rank_holds_its_share_of_every_leaf(sharded, n):
    ranks = sharded(n)
    for name in RK.CASES:
        cfg = RK.config(name, TCFG)
        specs = dict(_walk_specs(spmd.state_partition_specs(cfg)))
        for r in ranks:
            got, whole = r[name]["sizes"], r[name]["whole_sizes"]
            assert got.keys() == whole.keys() == specs.keys()
            for k, ps in specs.items():
                d = ps.sharded_dim()
                want = list(whole[k])
                if d is not None and d < len(want):
                    want[d] //= n
                assert list(got[k]) == want, (name, k, got[k], whole[k])


def _walk_specs(x, path=""):
    if isinstance(x, spmd.PartitionSpec):
        yield path.lstrip("."), x
        return
    for f, v in zip(x._fields, x):
        yield from _walk_specs(v, f"{path}.{f}")


def test_single_device_path_dispatches_what_it_did():
    """With no shard context the tick runs exactly as before the sharded
    path: the same ATen operations, and no collective."""
    with CL.recording() as ledger:
        counts = {name: RK.dispatched_ops(name) for name in RK.CASES}
    assert counts == SINGLE_DEVICE_OPS
    assert ledger == []


def test_an_indivisible_row_count_raises():
    cfg = small_engine_config()  # 136 node rows
    mesh = spmd.Mesh("res", 3, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="does not divide"):
        spmd.make_sharded_tick(cfg, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        spmd.shard_state(E.init_state(cfg, "cpu"), cfg, mesh)
    # divisible over 8 (136 = 8 x 17): no error
    spmd.make_sharded_tick(cfg, spmd.Mesh("res", 8, 0, torch.device("cpu"), "gloo"))


@pytest.mark.parametrize("n", WORLDS)
def test_window_add_batch_and_reads_sharded_match_whole(sharded, n):
    want = RK.window_case(None)
    for r in sharded(n):
        got = r["window"]
        for i, (a, b) in enumerate(zip(got["reads"], want["reads"])):
            for k in a:
                _same(a[k], b[k], f"read {i} {k}", exact=True)
        _same_states(got["state"], want["state"], "window", exact=True)


@pytest.mark.parametrize("n", WORLDS)
def test_token_col_decide_batch_sharded_matches_whole(sharded, n):
    want = RK.token_col_case(None)
    for r in sharded(n):
        got = r["token_col"]
        for (ga, oa), (gb, ob) in zip(got["decided"], want["decided"]):
            _same(ga, gb, "granted", exact=True)
            _same(oa, ob, "observed", exact=True)
        _same_states(got["state"], want["state"], "token column", exact=True)


@pytest.mark.parametrize("n", WORLDS)
def test_timeline_top_k_keeps_the_lower_row_first_across_shards(sharded, n):
    for r in sharded(n):
        t = r["topk_ties"]
        _same(t["sharded"], t["whole"], "top-K rows", exact=True)
        rows = t["whole"][:, E.TL_RID].astype(int).tolist()
        # the one higher score first, then the tied rows (they straddle a
        # shard boundary) ascending, then the zero scores ascending
        per = small_engine_config().node_rows // n
        tied = sorted({r for b in range(per, 64, per) for r in range(b - 2, b + 2)})
        rest = [r for r in range(1, 64) if r not in tied and r != 61]
        assert rows == ([61] + tied + rest)[: len(rows)]


def test_make_mesh_defaults_to_the_card_and_picks_the_backend():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spmd.make_mesh()
    assert spmd._backend_for(torch.device("cpu"), 1) == "gloo"
    assert spmd._backend_for(torch.device("cpu"), 8) == "gloo"


def test_make_mesh_takes_the_recipes_backend(monkeypatch):
    monkeypatch.delenv(meshspec.BACKEND_ENV, raising=False)
    assert spmd._recipe_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setenv(meshspec.BACKEND_ENV, "gloo")
    assert spmd._recipe_backend(torch.device("cpu"), 1) == "gloo"
    monkeypatch.setenv(meshspec.BACKEND_ENV, "nccl")
    with pytest.raises(ValueError, match="asks for nccl"):
        spmd._recipe_backend(torch.device("cpu"), 1)


def test_gated_groups_set_up_at_once_and_run_one_at_a_time():
    import time

    with launch.start_ranks(RK.gated, 2, (0.5,), timeout_s=60.0) as a, \
            launch.start_ranks(RK.gated, 1, (0.2,), timeout_s=60.0) as b:
        a.ready()
        b.ready()
        t = time.monotonic()
        a.go()
        ra = a.wait()
        b.go()
        (rb,) = b.wait()
    assert all(passed >= t for passed, _ in ra)
    assert rb[0] >= max(ended for _, ended in ra)


def test_a_rank_that_fails_before_its_gate_fails_ready():
    import time

    t = time.monotonic()
    with launch.start_ranks(RK.fails_before_its_gate, 1, timeout_s=60.0) as g:
        with pytest.raises(launch.RanksError, match="set-up broke"):
            g.ready()
    assert time.monotonic() - t < 60.0


def test_a_failing_rank_fails_the_group_before_its_deadline():
    import time

    t = time.monotonic()
    with pytest.raises(launch.RanksError, match="rank 1 broke"):
        launch.run_ranks(RK.hang_or_fail, 2, timeout_s=60.0)
    assert time.monotonic() - t < 60.0
