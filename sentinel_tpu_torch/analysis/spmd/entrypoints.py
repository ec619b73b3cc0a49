"""Blessed SPMD entry points and configs for the tier-4 analyzer.

The port of ``sentinel_tpu/analysis/spmd/entrypoints.py``.  Two
consumers, two process roles:

* the RANKS (worker.py, started by runner.py on the blessed mesh) run
  :func:`sharded_jobs` — the real entry points bound to the shardings
  ``parallel/spmd.py`` declares — while ``parallel/collectives`` records
  every collective they send;
* the PARENT (runner/__init__) folds :func:`entry_placements` and
  :func:`config_cases` — declared PartitionSpecs × the leaf shapes of a
  state built on the ``meta`` device — with NO mesh and NO data:
  divisibility and byte math are pure shape arithmetic.

The shardings themselves are imported from ``parallel/spmd.py`` (never
restated), so what the analyzer blesses is exactly what the runtime binds
to a live mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from sentinel_tpu_torch.analysis.spmd.framework import LeafPlacement
from sentinel_tpu_torch.parallel.meshspec import mesh_spec

#: canonical shapes for the non-tick entries (divisible by the mesh
#: width; the tick entry's shapes come from its EngineConfig)
WINDOW_ROWS = 128
WINDOW_BATCH = 64
TOKEN_SLOTS = 16
TOKEN_BATCH = 32


def tick_config():
    """The analyzer's tick config: the sketch-salsa tier at CI scale.

    sketch_width=512 (not the jaxpr tier's 256): the salsa level bitmap
    packs 16 width-cells per word, so the sharded word axis is width/64 —
    512 is the smallest width whose bitmap still splits 8 ways.
    """
    from sentinel_tpu_torch.core.config import small_engine_config

    return small_engine_config(sketch_stats=True, sketch_width=512, hotset_k=8)


def window_config():
    from sentinel_tpu_torch.ops import window as W

    return W.WindowConfig(sample_count=10, window_ms=100)


def sketch_tier_1m_config():
    """The 1M-ruled-resource sketch-tier operating point (bench.py
    ``sketch_tier_bench``) — the config whose per-shard footprint the
    budget pass projects.  Restated here field-for-field from the
    reference's analyzer; bench.py stays the authority for its numbers."""
    from sentinel_tpu_torch.core.config import EngineConfig

    return EngineConfig(
        max_resources=16368,
        max_nodes=16376,
        batch_size=2048,
        complete_batch_size=2048,
        enable_minute_window=False,  # the sketch carries the minute scale
        sketch_stats=True,
        sketch_salsa=True,
        sketch_depth=2,
        sketch_width=1 << 16,
        sketch_capacity=1 << 21,
        sketch_sample_count=60,
        sketch_window_ms=1000,
        hotset_k=64,
    )


# -- placement math (parent-safe: meta tensors only, no devices) -------------


def _leaves(tree, path=""):
    import torch

    if isinstance(tree, torch.Tensor):
        yield path, tree
        return
    for name, v in zip(tree._fields, tree):
        yield from _leaves(v, f"{path}.{name}")


def _spec_leaves(tree, path=""):
    from sentinel_tpu_torch.parallel.spmd import PartitionSpec

    if isinstance(tree, PartitionSpec):
        yield path, tree
        return
    for name, v in zip(tree._fields, tree):
        yield from _spec_leaves(v, f"{path}.{name}")


def placements_from(specs_tree, shapes_tree) -> List[LeafPlacement]:
    """Fold a PartitionSpec pytree with a (meta) tensor pytree into flat
    per-leaf placements (the divisibility/budget passes' input)."""
    spec = mesh_spec()
    shape_leaves = list(_leaves(shapes_tree))
    spec_leaves = [ps for _p, ps in _spec_leaves(specs_tree)]
    if len(shape_leaves) != len(spec_leaves):
        raise ValueError(
            f"spec tree has {len(spec_leaves)} leaves but state has "
            f"{len(shape_leaves)} — parallel/spmd.py specs out of date?"
        )
    out: List[LeafPlacement] = []
    for (path, leaf), ps in zip(shape_leaves, spec_leaves):
        shape = tuple(int(d) for d in leaf.shape)
        dims = tuple(ps[i] if i < len(ps) else None for i in range(len(shape)))
        itemsize = leaf.element_size()
        global_elems = 1
        shard_elems = 1
        for d, a in zip(shape, dims):
            global_elems *= d
            # ceil-divide: an indivisible dim costs the padded shard
            shard_elems *= -(-d // spec.n_devices) if a == spec.axis else d
        out.append(
            LeafPlacement(
                name=path,
                dtype=str(leaf.dtype).replace("torch.", ""),
                shape=shape,
                spec=dims,
                global_bytes=global_elems * itemsize,
                shard_bytes=shard_elems * itemsize,
            )
        )
    return out


def _tick_state_placements(cfg) -> List[LeafPlacement]:
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.parallel import spmd

    return placements_from(spmd.state_partition_specs(cfg), E._init_state(cfg, "meta"))


def _window_state_placements(rows: int) -> List[LeafPlacement]:
    from sentinel_tpu_torch.ops import window as W
    from sentinel_tpu_torch.parallel import spmd

    return placements_from(spmd.window_partition_specs(True), W.init_window(rows, window_config(), "meta"))


def _token_col_state_placements(slots: int) -> List[LeafPlacement]:
    from sentinel_tpu_torch.ops import token_col as TC
    from sentinel_tpu_torch.parallel import spmd

    return placements_from(spmd.token_col_partition_specs(), TC.init_state(slots, "meta"))


def entry_placements() -> Dict[str, List[LeafPlacement]]:
    """Declared per-leaf placements for each sharded entry's state."""
    return {
        "tick/sketch-salsa": _tick_state_placements(tick_config()),
        "window/add-batch": _window_state_placements(WINDOW_ROWS),
        "cluster/token-col": _token_col_state_placements(TOKEN_SLOTS),
    }


#: name of the ConfigCase the shard-hbm-budget pass projects
BUDGET_CONFIG = "bench/sketch-1m"


def config_cases() -> List[Tuple[str, List[LeafPlacement]]]:
    """(name, placements) for every blessed config — the divisibility
    pass's input; BUDGET_CONFIG doubles as the capacity case."""
    from sentinel_tpu_torch.core.config import EngineConfig

    return [
        ("engine/default", _tick_state_placements(EngineConfig())),
        ("tick/sketch-salsa", _tick_state_placements(tick_config())),
        ("window/add-batch", _window_state_placements(WINDOW_ROWS)),
        ("cluster/token-col", _token_col_state_placements(TOKEN_SLOTS)),
        (BUDGET_CONFIG, _tick_state_placements(sketch_tier_1m_config())),
    ]


# -- sharded jobs (rank-side: needs the live mesh) ----------------------------


def _mk_tick_inputs(cfg, device, n_resources: int = 8):
    """Canonical (state, rules, acq, comp, now, load, cpu) for a config —
    the port's copy of the reference's jaxpr-tier helper
    (``sentinel_tpu/analysis/jaxpr/entrypoints.py:74``), kept here until
    that tier's intent lands.

    The rule set touches every stage class (flow incl. rate-limiter and
    warm-up controllers, degrade both grades, param, authority, system)
    so the sharded run reaches every check the features enable."""
    from sentinel_tpu_torch.core import rules as R
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.runtime.registry import Registry

    reg = Registry(cfg)
    for i in range(1, n_resources + 1):
        reg.resource_id(f"r{i}")
    reg.origin_id("caller-a")
    ruleset = E.compile_ruleset(
        cfg,
        reg,
        flow_rules=[
            R.FlowRule(resource="r1", count=5),
            R.FlowRule(resource="r2", count=3, control_behavior=R.CONTROL_RATE_LIMITER),
            R.FlowRule(resource="r3", count=8, control_behavior=R.CONTROL_WARM_UP),
            R.FlowRule(resource="r4", count=100, grade=R.GRADE_THREAD),
        ],
        degrade_rules=[
            R.DegradeRule(resource="r5", grade=R.CB_STRATEGY_ERROR_COUNT, count=2, time_window=3),
            R.DegradeRule(
                resource="r6", grade=R.CB_STRATEGY_SLOW_REQUEST_RATIO, count=50,
                slow_ratio_threshold=0.5, time_window=2,
            ),
        ],
        param_rules=[R.ParamFlowRule(resource="r7", count=2, param_idx=0)],
        authority_rules=[R.AuthorityRule(resource="r8", limit_app="caller-a", strategy=R.AUTHORITY_BLACK)],
        system_rules=[R.SystemRule(qps=1000)],
        device=device,
    )
    state = E.init_state(cfg, device)
    return (state, ruleset, E.empty_acquire(cfg, device), E.empty_complete(cfg, device), 1_000, 0.1, 0.1)


def sharded_jobs(mesh, device) -> List[Tuple[str, Callable, Tuple[Any, ...]]]:
    """(name, fn, example args) per entry, each fn bound to the rank's
    shard by the SAME constructors the runtime uses
    (``spmd.make_sharded_tick`` / ``spmd.shard_tree``); the args hold the
    rank's shard of the state.  Rank-side only: needs the live mesh."""
    import torch

    from sentinel_tpu_torch.ops import token_col as TC
    from sentinel_tpu_torch.ops import window as W
    from sentinel_tpu_torch.parallel import collectives as CL
    from sentinel_tpu_torch.parallel import spmd

    ctx = mesh.shard_ctx()
    jobs: List[Tuple[str, Callable, Tuple[Any, ...]]] = []

    # 1. the engine tick, sketch-salsa tier — the runtime's own binding
    cfg = tick_config()
    state, *rest = _mk_tick_inputs(cfg, device)
    jobs.append(
        ("tick/sketch-salsa", spmd.make_sharded_tick(cfg, mesh), (spmd.shard_state(state, cfg, mesh), *rest))
    )

    # 2. the window scatter, rows sharded
    wcfg = window_config()
    win = spmd.shard_tree(W.init_window(WINDOW_ROWS, wcfg, device), spmd.window_partition_specs(True), mesh)

    def add_batch(*a, _ctx=ctx, _cfg=wcfg):
        with CL.scope(_ctx):
            return W.add_batch(*a, cfg=_cfg)

    jobs.append((
        "window/add-batch",
        add_batch,
        (
            win, 1_000,
            torch.zeros((WINDOW_BATCH,), dtype=torch.int32, device=device),
            torch.zeros((WINDOW_BATCH, W.NUM_EVENTS), dtype=torch.int32, device=device),
        ),
    ))

    # 3. the cluster token-column decision, flow slots sharded
    tc = spmd.shard_tree(TC.init_state(TOKEN_SLOTS, device), spmd.token_col_partition_specs(), mesh)

    def decide(*a, _ctx=ctx):
        with CL.scope(_ctx):
            return TC.decide_batch(*a, cfg=TC.DEFAULT_CFG)

    jobs.append((
        "cluster/token-col",
        decide,
        (
            tc, 1_000,
            torch.zeros((TOKEN_BATCH,), dtype=torch.int32, device=device),
            torch.ones((TOKEN_BATCH,), dtype=torch.int32, device=device),
            torch.zeros((TOKEN_BATCH,), dtype=torch.int32, device=device),
            torch.zeros((TOKEN_BATCH,), dtype=torch.bool, device=device),
            torch.zeros((TOKEN_BATCH,), dtype=torch.bool, device=device),
        ),
    ))
    return jobs

