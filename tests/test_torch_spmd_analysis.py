"""sentinel_tpu_torch.analysis.spmd — the port's tier-4 SPMD analyzer.

Mirrors tests/test_spmd_analysis.py, except the four tests that go
through the CLI (``test_update_collectives_round_trip``,
``test_update_baseline_scoped_to_spmd_preserves_other_tiers``,
``test_rule_catalog_spans_four_tiers``,
``test_sarif_spmd_pseudo_paths_claim_no_uri_base``), which wait for the
port's tier-1 slice (``analysis/__main__.py``, ``rule_catalog``):

1. unit-test every pass on synthetic :class:`SpmdProgram` fixtures — one
   triggering and one clean per rule — plus the recorded ledger (in place
   of the reference's HLO parsing) and the golden's grouping;
2. THE CI GATE: run the whole tier against the port on gloo ranks on the
   CPU — zero findings, the committed ``collectives.json`` exactly the
   ranks' current inventory, the 1M-resource per-shard projection under
   the capacity SLO; divisibility and per-shard bytes equal to the
   reference's for the same configs (every leaf's shape and dtype agree);
3. process hygiene: the ranks are child processes, so the calling
   process has no process group after a full tier-4 run.

The fixture tests are plain data; the gate pays one run of the ranks
(about 10 s, cached per process) shared across tests.
"""

from __future__ import annotations

import json
import os

import pytest

from sentinel_tpu_torch.analysis import REPO_ROOT
from sentinel_tpu_torch.analysis.spmd import (
    COLLECTIVES_PATH,
    DEFAULT_CAPACITY_BYTES,
    build_program,
    capacity_slo_bytes,
    run_spmd_analysis,
    update_collectives,
)
from sentinel_tpu_torch.analysis.spmd.framework import (
    Collective,
    ConfigCase,
    ConstInfo,
    LeafPlacement,
    ShardedEntry,
    SpmdProgram,
    collectives_from_ledger,
    group_collectives,
    ledger_bytes,
)
from sentinel_tpu_torch.analysis.spmd.passes import (
    ALL_SPMD_PASSES,
    CollectiveLedgerPass,
    ImplicitReshardPass,
    ReplicationHazardPass,
    ShardDivisibilityPass,
    ShardHbmBudgetPass,
)
from sentinel_tpu_torch.parallel.meshspec import (
    ADDR_ENV,
    BACKEND_ENV,
    PORT_ENV,
    WORLD_ENV,
    force_cpu_mesh_env,
    mesh_spec,
)

#: the analyzer's ranks run on the CPU here (gloo); on the card the
#: default, device="cuda", puts them on the H100
DEVICE = "cpu"

N = mesh_spec().n_devices


def _leaf(name, shape, spec, itemsize=4, dtype="float32"):
    """LeafPlacement with the byte math the real fold performs."""
    g = itemsize
    s = itemsize
    for d, a in zip(shape, spec):
        g *= d
        s *= -(-d // N) if a is not None else d
    return LeafPlacement(
        name=name, dtype=dtype, shape=tuple(shape), spec=tuple(spec),
        global_bytes=g, shard_bytes=s,
    )


def _prog(**kw):
    kw.setdefault("n_devices", N)
    kw.setdefault("axis", mesh_spec().axis)
    return SpmdProgram(**kw)


def _golden_for(*entries):
    """A golden dict that exactly pins the given entries' inventories."""
    out = {}
    for e in entries:
        groups = group_collectives(e.collectives)
        out[e.name] = {
            "collectives": groups,
            "bytes_per_tick": ledger_bytes(groups),
        }
    return {"entries": out}


def _run(p, program):
    return list(p.run(program))


# ---------------------------------------------------------------------------
# the recorded ledger (the reference parses HLO here)
# ---------------------------------------------------------------------------


def test_collectives_from_ledger_kinds_shapes_and_sources():
    records = [
        {"kind": "all-gather", "dtype": "s32", "shape": [504, 9],
         "source": "sentinel_tpu_torch/ops/engine.py", "line": 431},
        {"kind": "all-reduce", "dtype": "f32", "shape": [2, 64],
         "source": "sentinel_tpu_torch/ops/tables.py", "line": 78},
        {"kind": "all-reduce", "dtype": "pred", "shape": [], "source": None, "line": 0},
    ]
    colls = collectives_from_ledger(records)
    assert [(c.kind, c.dtype, c.shape) for c in colls] == [
        ("all-gather", "s32", (504, 9)),
        ("all-reduce", "f32", (2, 64)),
        ("all-reduce", "pred", ()),
    ]
    assert colls[0].source == "sentinel_tpu_torch/ops/engine.py" and colls[0].line == 431
    assert colls[2].source is None and colls[2].nbytes == 1
    assert colls[0].nbytes == 504 * 9 * 4


def test_the_ledger_records_kind_dtype_shape_and_caller():
    """parallel/collectives records every call while recording is on —
    the analyzer's input — with its caller's line in the repo."""
    import torch
    import torch.distributed as dist

    from sentinel_tpu_torch.parallel import collectives as CL
    from sentinel_tpu_torch.parallel.meshspec import free_port

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        with CL.recording() as ledger:
            x = CL.all_reduce(torch.ones((2, 3), dtype=torch.int32))
            y = CL.all_gather(torch.ones((4,)))
            CL.all_reduce(torch.ones(2), op="min")
        with CL.recording() as off:
            pass
    finally:
        dist.destroy_process_group()
    assert x.tolist() == [[1, 1, 1]] * 2 and y.tolist() == [1.0] * 4
    assert [(r.kind, r.dtype, r.shape, r.nbytes) for r in ledger] == [
        ("all-reduce", "s32", (2, 3), 24),
        ("all-gather", "f32", (4,), 16),
        ("all-reduce", "f32", (2,), 8),
    ]
    assert {r.source for r in ledger} == {"tests/test_torch_spmd_analysis.py"}
    assert off == []


def test_group_collectives_merges_and_ignores_source_lines():
    a = Collective("all-gather", "s32", (2, 512), "f.py", 10)
    b = Collective("all-gather", "s32", (2, 512), "g.py", 99)
    groups = group_collectives([a, b])
    assert len(groups) == 1
    assert groups[0]["count"] == 2
    assert groups[0]["bytes_each"] == 4096
    assert ledger_bytes(groups) == 8192


# ---------------------------------------------------------------------------
# collective-ledger
# ---------------------------------------------------------------------------


def _entry(name="tick/fix", colls=()):
    return ShardedEntry(name=name, collectives=list(colls))


def test_ledger_clean_when_inventory_matches_golden():
    e = _entry(colls=[Collective("all-gather", "s32", (2, 512))] * 2)
    prog = _prog(entries=[e], golden=_golden_for(e))
    assert _run(CollectiveLedgerPass(), prog) == []


def test_ledger_new_collective_is_error():
    e = _entry(colls=[Collective("all-gather", "s32", (2, 512))])
    golden = _golden_for(_entry(colls=[]))
    prog = _prog(entries=[e], golden=golden)
    found = _run(CollectiveLedgerPass(), prog)
    new = [f for f in found if "NEW collective" in f.message]
    assert len(new) == 1
    f = new[0]
    assert f.rule == "collective-ledger" and f.severity == "error"
    assert f.path == "spmd://tick/fix"
    assert "all-gather" in f.message
    # the added bytes also blow the pinned total — both angles report
    assert any("bytes/tick" in f.message for f in found)


def test_ledger_count_growth_is_error():
    pinned = _entry(colls=[Collective("all-reduce", "f32", (63,))])
    cur = _entry(colls=[Collective("all-reduce", "f32", (63,))] * 3)
    prog = _prog(entries=[cur], golden=_golden_for(pinned))
    found = _run(CollectiveLedgerPass(), prog)
    # count growth AND the byte total blowing past tolerance
    assert any("count grew 1 -> 3" in f.message for f in found)


def test_ledger_bytes_regression_past_tolerance():
    e = _entry(colls=[Collective("all-gather", "s32", (2, 512))] * 2)
    golden = _golden_for(e)
    # same inventory, but the pinned byte total was smaller: regression
    golden["entries"]["tick/fix"]["bytes_per_tick"] = 1000
    found = _run(CollectiveLedgerPass(), _prog(entries=[e], golden=golden))
    assert len(found) == 1
    assert "bytes/tick" in found[0].message and "ceiling" in found[0].message


def test_ledger_within_tolerance_is_clean():
    e = _entry(colls=[Collective("all-gather", "s32", (2, 512))] * 2)
    golden = _golden_for(e)
    golden["entries"]["tick/fix"]["bytes_per_tick"] = 8000  # 8192 < 8000*1.25
    assert _run(CollectiveLedgerPass(), _prog(entries=[e], golden=golden)) == []


def test_ledger_stale_golden_entry_and_unpinned_entry():
    e = _entry(name="tick/live", colls=[])
    golden = _golden_for(_entry(name="tick/gone", colls=[]))
    found = _run(CollectiveLedgerPass(), _prog(entries=[e], golden=golden))
    msgs = "\n".join(f.message for f in found)
    assert "no pinned collective ledger" in msgs  # tick/live unpinned
    assert "stale pin" in msgs  # tick/gone no longer lowered
    paths = {f.path for f in found}
    assert "spmd://tick/gone" in paths


def test_ledger_missing_golden_is_one_loud_error():
    prog = _prog(entries=[_entry()], golden=None)
    found = _run(CollectiveLedgerPass(), prog)
    assert len(found) == 1
    assert "--update-collectives" in found[0].message


def test_worker_error_surfaces_once_and_quiets_hlo_passes():
    prog = _prog(worker_error="boom: exit 3", golden={"entries": {}})
    found = _run(CollectiveLedgerPass(), prog)
    assert len(found) == 1 and "boom" in found[0].message
    assert found[0].path == "spmd://analyzer"
    assert _run(ImplicitReshardPass(), prog) == []
    # the placement passes still run (they need no HLO)
    assert _run(ShardDivisibilityPass(), prog) == []


# ---------------------------------------------------------------------------
# implicit-reshard
# ---------------------------------------------------------------------------


def test_reshard_full_leaf_rematerialization():
    leaf = _leaf(".tab", (8, 512), (None, "res"))  # 16 KiB global
    e = ShardedEntry(
        name="tick/fix",
        collectives=[
            Collective("all-gather", "f32", (8, 512), "sentinel_tpu/x.py", 7)
        ],
        placements=[leaf],
    )
    found = _run(ImplicitReshardPass(), _prog(entries=[e]))
    assert len(found) == 1
    f = found[0]
    assert f.path == "sentinel_tpu/x.py" and f.line == 7
    assert "re-materializes the full sharded leaf .tab" in f.message


def test_reshard_slice_of_sharded_dim_is_caught():
    """The salsa-read class: the gather result is only a SLICE of the
    leaf, but it spans the sharded dimension at global size."""
    leaf = _leaf(".gs.run", (2, 8, 512), (None, None, "res"), dtype="int32")
    e = ShardedEntry(
        name="tick/fix",
        collectives=[
            Collective("all-gather", "s32", (2, 512), "sentinel_tpu/y.py", 9)
        ],
        placements=[leaf],
    )
    found = _run(ImplicitReshardPass(), _prog(entries=[e]))
    assert len(found) == 1
    f = found[0]
    assert f.path == "sentinel_tpu/y.py" and f.line == 9
    assert "full sharded dimension of .gs.run" in f.message


def test_reshard_small_gather_and_nonmatching_dims_are_clean():
    leaf = _leaf(".gs.run", (2, 8, 512), (None, None, "res"), dtype="int32")
    e = ShardedEntry(
        name="tick/fix",
        collectives=[
            # 256 B: below the match floor even though 64 is a real dim
            Collective("all-gather", "s32", (64,), "sentinel_tpu/z.py", 1),
            # large dims but none is a sharded-dim size: no slice match
            Collective("all-gather", "s32", (3, 100)),
        ],
        placements=[leaf],
    )
    assert _run(ImplicitReshardPass(), _prog(entries=[e])) == []


def test_reshard_big_unmatched_gather_is_flagged():
    e = ShardedEntry(
        name="tick/fix",
        collectives=[Collective("all-gather", "f32", (1 << 16,))],  # 256 KiB
    )
    found = _run(ImplicitReshardPass(), _prog(entries=[e]))
    assert len(found) == 1
    assert "large all-gather" in found[0].message
    assert found[0].path == "spmd://tick/fix"  # no source metadata


# ---------------------------------------------------------------------------
# replication-hazard
# ---------------------------------------------------------------------------


def test_replicated_const_over_threshold_is_error():
    e = ShardedEntry(
        name="tick/fix",
        consts=[ConstInfo("f32", (512, 512), 512 * 512 * 4)],  # 1 MiB
    )
    found = _run(ReplicationHazardPass(), _prog(entries=[e]))
    assert len(found) == 1
    assert "jaxpr const" in found[0].message
    assert found[0].path == "spmd://tick/fix"


def test_small_const_and_sharded_big_leaf_are_clean():
    e = ShardedEntry(name="tick/fix", consts=[ConstInfo("f32", (64,), 256)])
    big_but_sharded = _leaf(".win.counts", (1 << 22, 4), ("res", None))
    case = ConfigCase(name="bench/big", placements=[big_but_sharded])
    prog = _prog(entries=[e], configs=[case])
    assert _run(ReplicationHazardPass(), prog) == []


def test_replicated_big_leaf_at_config_scale_is_error():
    lazy = _leaf(".gs.words", (4, 1 << 21), (None, None))  # 32 MiB replicated
    case = ConfigCase(name="bench/sketch-1m", placements=[lazy])
    found = _run(ReplicationHazardPass(), _prog(configs=[case]))
    assert len(found) == 1
    f = found[0]
    assert f.path == "spmd://config/bench/sketch-1m"
    assert ".gs.words" in f.message and "replicated" in f.message


# ---------------------------------------------------------------------------
# shard-divisibility
# ---------------------------------------------------------------------------


def test_indivisible_sharded_dim_is_error():
    bad = _leaf(".win.counts", (137, 4), ("res", None))
    case = ConfigCase(name="engine/odd", placements=[bad])
    found = _run(ShardDivisibilityPass(), _prog(configs=[case]))
    assert len(found) == 1
    f = found[0]
    assert f.rule == "shard-divisibility"
    assert "137" in f.message and f"{N}-device" in f.message


def test_divisible_and_replicated_dims_are_clean():
    case = ConfigCase(
        name="engine/even",
        placements=[
            _leaf(".a", (136, 4), ("res", None)),
            _leaf(".b", (137, 4), (None, None)),  # odd but replicated
        ],
    )
    assert _run(ShardDivisibilityPass(), _prog(configs=[case])) == []


# ---------------------------------------------------------------------------
# shard-hbm-budget
# ---------------------------------------------------------------------------


def test_budget_overflow_names_the_heaviest_leaves():
    case = ConfigCase(
        name="bench/sketch-1m",
        placements=[
            _leaf(".big", (1 << 20, 8), ("res", None)),  # 4 MiB/shard
            _leaf(".small", (64,), (None,)),
        ],
    )
    prog = _prog(
        configs=[case], budget_config="bench/sketch-1m",
        capacity_bytes=1 << 20,
    )
    found = _run(ShardHbmBudgetPass(), prog)
    assert len(found) == 1
    f = found[0]
    assert f.path == "spmd://config/bench/sketch-1m"
    assert ".big" in f.message and "capacity SLO" in f.message


def test_budget_under_capacity_is_clean_and_missing_case_is_loud():
    case = ConfigCase(
        name="bench/sketch-1m",
        placements=[_leaf(".t", (1024,), ("res",))],
    )
    ok = _prog(
        configs=[case], budget_config="bench/sketch-1m",
        capacity_bytes=1 << 30,
    )
    assert _run(ShardHbmBudgetPass(), ok) == []
    wired_wrong = _prog(configs=[], budget_config="bench/sketch-1m",
                        capacity_bytes=1 << 30)
    found = _run(ShardHbmBudgetPass(), wired_wrong)
    assert len(found) == 1 and "wiring" in found[0].message


# ---------------------------------------------------------------------------
# meshspec: the one shared topology contract
# ---------------------------------------------------------------------------


def test_force_cpu_mesh_env_fresh_environment():
    env = {}
    n = force_cpu_mesh_env(env)
    assert n == N
    assert env[BACKEND_ENV] == "gloo"
    assert env[WORLD_ENV] == str(N)
    assert env[ADDR_ENV] == "127.0.0.1" and 0 < int(env[PORT_ENV]) < 65536


def test_force_cpu_mesh_env_keep_existing_count():
    env = {WORLD_ENV: "4"}
    n = force_cpu_mesh_env(env, keep_existing_count=True)
    assert n == 4
    assert env[WORLD_ENV] == "4" and env[BACKEND_ENV] == "gloo"
    # without the keep flag the blessed width wins
    n2 = force_cpu_mesh_env(env)
    assert n2 == N and env[WORLD_ENV] == str(N)
    # a malformed count is replaced even when kept
    assert force_cpu_mesh_env({WORLD_ENV: "x"}, keep_existing_count=True) == N


def test_runtime_mesh_axis_comes_from_meshspec():
    """Every axis any runtime PartitionSpec names IS the meshspec axis —
    the analyzer and the runtime cannot shard on different names."""
    from sentinel_tpu_torch.analysis.spmd.entrypoints import _spec_leaves
    from sentinel_tpu_torch.core.config import EngineConfig
    from sentinel_tpu_torch.parallel import spmd

    for cfg in (EngineConfig(), EngineConfig(sketch_stats=True), EngineConfig(sketch_stats=True, sketch_salsa=False)):
        leaves = [ps for _p, ps in _spec_leaves(spmd.state_partition_specs(cfg))]
        axes = {a for ps in leaves for a in ps if a is not None}
        assert axes == {mesh_spec().axis}
    assert spmd.make_mesh.__defaults__ == (None, None)  # cuda unless asked


# ---------------------------------------------------------------------------
# the same placements as the reference's
# ---------------------------------------------------------------------------


def test_divisibility_and_shard_bytes_equal_the_references():
    """For every blessed config, the port's leaves fold to the same
    placements as the reference's (``jax.eval_shape`` there, the meta
    device here): every leaf's name, shape, dtype and spec agree, so the
    per-shard bytes and the divisibility findings are the reference's."""
    from sentinel_tpu.analysis.spmd import entrypoints as REP
    from sentinel_tpu.analysis.spmd.passes import ShardDivisibilityPass as RefDiv
    from sentinel_tpu.analysis.spmd.framework import ConfigCase as RefCase
    from sentinel_tpu.analysis.spmd.framework import SpmdProgram as RefProgram
    from sentinel_tpu_torch.analysis.spmd import entrypoints as EP

    ref, mine = dict(REP.config_cases()), dict(EP.config_cases())
    assert ref.keys() == mine.keys()
    for name in ref:
        a = {p.name: p for p in ref[name]}
        b = {p.name: p for p in mine[name]}
        assert a.keys() == b.keys(), name
        for leaf in a:
            x, y = a[leaf], b[leaf]
            assert (x.shape, x.dtype, x.spec, x.global_bytes, x.shard_bytes) == (
                y.shape, y.dtype, y.spec, y.global_bytes, y.shard_bytes
            ), (name, leaf)
        assert sum(p.shard_bytes for p in ref[name]) == ConfigCase(name, mine[name]).shard_bytes
    for n in (N, 3, 5):
        want = RefDiv().run(RefProgram(n_devices=n, axis="res", configs=[RefCase(k, v) for k, v in ref.items()]))
        got = ShardDivisibilityPass().run(_prog(n_devices=n, configs=[ConfigCase(k, v) for k, v in mine.items()]))
        assert [(f.path, f.message) for f in want] == [(f.path, f.message) for f in got]


# ---------------------------------------------------------------------------
# THE repo gate
# ---------------------------------------------------------------------------


def test_repo_gate_zero_findings_golden_matches_and_budget_clears():
    """The CI contract for this tier: the committed collectives.json is
    exactly the ranks' current inventory, every reshard / replication
    hazard is fixed or carries a written rationale, and the 1M-resource
    per-shard projection clears the capacity SLO."""
    program = build_program(device=DEVICE)
    assert program.worker_error is None, program.worker_error

    golden = json.loads(open(COLLECTIVES_PATH).read())
    assert set(golden["entries"]) == {e.name for e in program.entries}
    for e in program.entries:
        g = golden["entries"][e.name]
        cur = group_collectives(e.collectives)
        assert cur == g["collectives"], f"{e.name}: ledger drifted — review, then update_collectives()"
        assert ledger_bytes(cur) == g["bytes_per_tick"]
        assert g["reference"].startswith("sentinel_tpu/analysis/spmd/collectives.json")
    assert golden["mesh"] == {"axis": mesh_spec().axis, "n_devices": N}

    case = program.budget_case()
    assert case is not None and case.shard_bytes > 0
    assert case.shard_bytes < capacity_slo_bytes()

    findings = run_spmd_analysis(program=program)
    assert findings == [], "\n".join(
        f"{f.path}:{f.line} [{f.rule}] {f.message}" for f in findings
    )


def test_update_collectives_writes_what_the_gate_reads(tmp_path):
    """update_collectives re-pins from the (cached) ranks' report; the
    file it writes is the committed golden's inventory."""
    path = str(tmp_path / "collectives.json")
    build_program(device=DEVICE)  # the ranks' report, cached for the process
    assert update_collectives(path, device=DEVICE, refresh=False) == 3
    data = json.loads(open(path).read())
    golden = json.loads(open(COLLECTIVES_PATH).read())
    assert data["entries"] == golden["entries"]
    assert "update_collectives" in data["comment"]
    assert _run(CollectiveLedgerPass(), build_program(golden_path=path, device=DEVICE)) == []


def test_salsa_read_is_shard_local_and_pinned():
    """The hazard the reference's tier found — its salsa running-sum read
    all-gathers the full [depth, width] slice each tick — is the
    shard-local read in the port: a partial gather plus ONE all-reduce of
    the [depth, N] cells.  The golden pins it and has no all-gather of a
    [depth, width] slice, and the read says so at its site."""
    from sentinel_tpu_torch.analysis.spmd.entrypoints import tick_config

    cfg = tick_config()
    golden = json.loads(open(COLLECTIVES_PATH).read())
    tick = golden["entries"]["tick/sketch-salsa"]["collectives"]
    assert not [g for g in tick if g["kind"] == "all-gather" and g["shape"] == [cfg.sketch_depth, cfg.sketch_width]]
    reads = [g for g in tick if g["kind"] == "all-reduce" and g["shape"] == [cfg.sketch_depth, cfg.batch_size]]
    assert reads and reads[0]["dtype"] == "f32"
    src = open(os.path.join(REPO_ROOT, "sentinel_tpu_torch/sketch/salsa.py")).read()
    assert "sentinel_tpu/ops/tables.py:245-252" in src and "implicit-reshard" in src


def test_spmd_gauges_exported_on_registry():
    """The analyzer's measurements ride the port's obs registry."""
    from sentinel_tpu_torch.obs.registry import REGISTRY

    build_program(device=DEVICE)  # cached ranks; idempotent re-export
    series = REGISTRY.series("sentinel_spmd_collective_bytes_per_tick")
    entries = {dict(m.labels)["entry"]: m.value for m in series}
    assert "tick/sketch-salsa" in entries
    assert entries["tick/sketch-salsa"] > 0
    assert entries["window/add-batch"] == 0
    hbm = REGISTRY.get("sentinel_spmd_shard_hbm_projected_bytes")
    assert hbm is not None and 0 < hbm.value < capacity_slo_bytes()


def test_capacity_slo_is_the_h100s_unless_the_env_says(monkeypatch):
    monkeypatch.delenv("SENTINEL_HBM_CAPACITY_BYTES", raising=False)
    assert capacity_slo_bytes() == DEFAULT_CAPACITY_BYTES > (79 << 30)
    monkeypatch.setenv("SENTINEL_HBM_CAPACITY_BYTES", str(1 << 30))
    assert capacity_slo_bytes() == 1 << 30


# ---------------------------------------------------------------------------
# process hygiene: tier-4 leaves the parent with no process group
# ---------------------------------------------------------------------------


def test_parent_has_no_process_group_after_a_tier4_run():
    """The ranks are child processes: the calling process has no process
    group before or after a full tier-4 run, and no CUDA context."""
    import torch
    import torch.distributed as dist

    assert not dist.is_initialized()
    findings = run_spmd_analysis(program=build_program(refresh=True, device=DEVICE))
    assert not dist.is_initialized()
    assert isinstance(findings, list) and findings == []
    assert not torch.cuda.is_initialized()


def test_the_runner_defaults_to_the_card():
    import inspect

    import torch

    from sentinel_tpu_torch.analysis.spmd import runner

    assert inspect.signature(runner.worker_report).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(runner.SpmdWorkerError, match="no CUDA device"):
            runner._run_worker(N, "cuda")


def test_the_tier_runs_the_references_five_passes():
    """The same five rules as the reference's tier 4, each described
    (the rule catalog's input once the port's CLI lands)."""
    from sentinel_tpu.analysis.spmd.passes import ALL_SPMD_PASSES as REF

    assert [p.name for p in ALL_SPMD_PASSES] == [p.name for p in REF]
    assert all(p.description and p.severity == "error" for p in ALL_SPMD_PASSES)
