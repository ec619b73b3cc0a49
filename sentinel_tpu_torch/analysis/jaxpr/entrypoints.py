"""Canonical recorded entry points of the port's ``jaxpr`` tier.

The port of ``sentinel_tpu/analysis/jaxpr/entrypoints.py``: the
reference's 13 entries, under the same names, built on the port's
functions (``ops.engine.tick``, ``ops.fused.scatter_many``,
``ops.segscan``, ``ops.rank``, ``ops.window``, ``ops.token_col``) with
the reference's canonical inputs on its small configs.  Each entry runs
eagerly under the op recorder (``framework.trace_entry``) on ``cuda``
unless the caller passes ``device="cpu"``, as every entry point of the
port does.

Every entry is budgeted, the kernel-bearing ones too (the reference
exempts its Pallas entries, whose CPU cost model prices the
interpreter): the port's kernels only replace plain ops, so a ceiling
measured on the CPU, where the plain versions run, holds on the card.

``rank/grouped-cumsum-small`` records ``ops/rank.grouped_exclusive_cumsum``
too: the port has one ranking function, which gives both of the
reference's variants' integers.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, List, Optional

from sentinel_tpu_torch.analysis.jaxpr.framework import TracedEntry, trace_entry

#: entry names -> defining module (repo-relative), for finding paths
_ENTRY_MODULES = {
    "tick/plain": "sentinel_tpu_torch/ops/engine.py",
    "tick/mxu": "sentinel_tpu_torch/ops/engine.py",
    "tick/fused-seg": "sentinel_tpu_torch/ops/engine.py",
    "tick/packed-wire": "sentinel_tpu_torch/ops/engine.py",
    "tick/sketch-salsa": "sentinel_tpu_torch/sketch/salsa.py",
    "tick/cluster-token": "sentinel_tpu_torch/cluster/token_service.py",
    "segscan/excl-cumsum": "sentinel_tpu_torch/ops/segscan.py",
    "segscan/incl-min": "sentinel_tpu_torch/ops/segscan.py",
    "fused/scatter-many": "sentinel_tpu_torch/ops/fused.py",
    "rank/grouped-cumsum": "sentinel_tpu_torch/ops/rank.py",
    "rank/grouped-cumsum-small": "sentinel_tpu_torch/ops/rank.py",
    "window/add-batch": "sentinel_tpu_torch/ops/window.py",
    "cluster/token-col": "sentinel_tpu_torch/ops/token_col.py",
}

#: entries that reach a hand-written kernel on the card, with the kernels
#: (launch-counter keys) each reaches: the reference's PALLAS_ENTRIES.  The
#: salsa tick's config is the reference's (no one-hot tables), so it runs
#: the plain path and reaches none
KERNEL_ENTRIES = {
    "tick/fused-seg": ("scatter_many", "gather_many", "seg_build"),
    "segscan/excl-cumsum": ("seg_excl_cumsum",),
    "segscan/incl-min": ("seg_incl_min",),
    "fused/scatter-many": ("scatter_many",),
}

#: positional index of the tick's clock argument
TICK_TIME_ARG = 4

_CACHE: Dict[str, List[TracedEntry]] = {}
_CACHE_LOCK = threading.Lock()


def check_device(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the jaxpr tier runs its entries on cuda, and there is no CUDA device: pass device='cpu'")


def _mk_tick_inputs(cfg, device, n_resources: int = 8):
    """Canonical (state, rules, acq, comp, now, load, cpu) for a config —
    the port's copy of the reference's
    (``sentinel_tpu/analysis/jaxpr/entrypoints.py:74``); the tier-4
    analyzer's ranks take it from here, as the reference's do.

    The rule set touches every stage class (flow incl. rate-limiter and
    warm-up controllers, degrade both grades, param, authority, system)
    so the recorded tick reaches every check the features enable."""
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


def tick_configs() -> Dict[str, tuple]:
    """Tick entry name -> (config, features), the reference's six."""
    from sentinel_tpu_torch.cluster.token_service import DECISION_FEATURES
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.ops import engine as E

    cfg_plain = small_engine_config()
    return {
        "tick/plain": (cfg_plain, E.ALL_FEATURES),
        "tick/mxu": (small_engine_config(use_mxu_tables=True), E.ALL_FEATURES),
        # the sketch statistics tier: salsa counters, running sums, tail
        # rules and the hot-candidate top-K
        "tick/sketch-salsa": (small_engine_config(sketch_stats=True, sketch_width=256, hotset_k=8), E.ALL_FEATURES),
        "tick/fused-seg": (
            small_engine_config(use_mxu_tables=True, fused_effects=True, seg_effects=True), E.ALL_FEATURES,
        ),
        # every readback block folded into the one wire buffer
        "tick/packed-wire": (
            small_engine_config(packed_wire=True, sketch_stats=True, sketch_width=256, hotset_k=8, timeline_k=8),
            E.ALL_FEATURES,
        ),
        # the cluster token service's decision client: the same tick, its
        # feature set
        "tick/cluster-token": (cfg_plain, DECISION_FEATURES),
    }


def _std_args(device) -> Dict[str, callable]:
    """Non-tick entry name -> (fn, make_args, time_arg)."""
    import torch

    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import rank as RK
    from sentinel_tpu_torch.ops import segscan as SS
    from sentinel_tpu_torch.ops import token_col as TC
    from sentinel_tpu_torch.ops import window as W

    n = 512

    def scan_args():
        head = torch.zeros((n,), dtype=torch.bool, device=device)
        head[0] = True
        return head, torch.ones((n,), dtype=torch.float32, device=device)

    def scatter_two_jobs(rows, values):
        return FU.scatter_many([FU.Job("stat", 128, rows, values, (1, 1)), FU.Job("cb", 64, rows, values, (1, 1))])

    def rank_args():
        return (
            torch.zeros((n,), dtype=torch.int32, device=device),
            torch.ones((n,), dtype=torch.float32, device=device),
            torch.ones((n,), dtype=torch.bool, device=device),
        )

    def rank(k, v, e):
        return RK.grouped_exclusive_cumsum(k, [v], e)

    tcn = 64

    def token_args():
        z = torch.zeros((tcn,), dtype=torch.int32, device=device)
        f = torch.zeros((tcn,), dtype=torch.bool, device=device)
        return (TC.init_state(16, device), 1_000, z, torch.ones_like(z), z.clone(), f, f.clone())

    wcfg = W.WindowConfig(2, 500)

    def window_args():
        return (
            W.init_window(64, wcfg, device), 1_000,
            torch.zeros((256,), dtype=torch.int32, device=device),
            torch.ones((256, W.NUM_EVENTS), dtype=torch.int32, device=device),
        )

    return {
        "segscan/excl-cumsum": (SS.seg_excl_cumsum, scan_args, None),
        "segscan/incl-min": (SS.seg_incl_min, scan_args, None),
        "fused/scatter-many": (
            scatter_two_jobs,
            lambda: (
                torch.zeros((1, 256), dtype=torch.int32, device=device),
                torch.ones((2, 256), dtype=torch.int32, device=device),
            ),
            None,
        ),
        "rank/grouped-cumsum": (rank, rank_args, None),
        "rank/grouped-cumsum-small": (rank, rank_args, None),
        # the cluster decision-batch column: slot-run prefix rebase and
        # window charge in one call (cluster/token_service.TokenColumnBatcher)
        "cluster/token-col": (functools.partial(TC.decide_batch, cfg=TC.DEFAULT_CFG), token_args, 1),
        "window/add-batch": (functools.partial(W.add_batch, cfg=wcfg), window_args, 1),
    }


def build_entries(
    device: str = "cuda", names: Optional[List[str]] = None, tick_context: Callable = contextlib.nullcontext
) -> List[TracedEntry]:
    """Record the entries (all, or ``names``) on ``device``, uncached; the
    tick entries' calls run inside ``tick_context()``."""
    import torch

    from sentinel_tpu_torch.obs import profile as PROF
    from sentinel_tpu_torch.ops import engine as E

    check_device(device)
    want = list(_ENTRY_MODULES) if names is None else list(names)
    entries: List[TracedEntry] = []
    ticks = tick_configs()
    std = _std_args(device)
    for name in want:
        if name in ticks:
            cfg, features = ticks[name]
            with PROF.expected_retrace("analysis: jaxpr-tier entries"):
                fn = E.make_tick(cfg, features)  # the binding a client runs
            ent = trace_entry(
                name, _ENTRY_MODULES[name], fn, functools.partial(_mk_tick_inputs, cfg, device), device,
                time_arg=TICK_TIME_ARG, tick=True, call_context=tick_context,
            )
            if cfg.packed_wire:
                # observe the packed tick's readback surface: the TickOutput
                # fields it returned as tensors
                out = ent.outputs[1]
                ent.packed_wire = True
                ent.readback_fields = tuple(f for f in out._fields if isinstance(getattr(out, f), torch.Tensor))
            entries.append(ent)
        else:
            fn, make_args, time_arg = std[name]
            entries.append(trace_entry(name, _ENTRY_MODULES[name], fn, make_args, device, time_arg=time_arg))
    return entries


def trace_entries(device: str = "cuda", refresh: bool = False) -> List[TracedEntry]:
    """The canonical entry list on ``device``, recorded once per process
    (the cache only saves time for in-process callers such as the tests)."""
    with _CACHE_LOCK:
        if device not in _CACHE or refresh:
            _CACHE[device] = build_entries(device)
        return list(_CACHE[device])
