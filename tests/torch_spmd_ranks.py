"""The rank side of tests/test_torch_spmd.py: what each gloo rank runs.

Kept apart from the test module so that a rank imports the port and
numpy only (never the JAX package).  ``drive`` runs every case of a plan
on the rank's shard and returns what the parent compares: each tick's
outputs and the gathered state (rank 0), and every rank's leaf sizes.
"""

from __future__ import annotations

import numpy as np

from tests import torch_harness as H

#: tick timestamps: inside one bucket, across buckets, past an idle gap
NOWS = [1_000, 1_130, 1_610, 4_050]

def config(name: str, R_config):
    """The case's EngineConfig from a config module (either package's
    ``core.config``: the same fields)."""
    if name == "small":
        return R_config.small_engine_config()
    if name == "minute":  # the reference dry run's (__graft_entry__.py:163-170)
        return R_config.EngineConfig(
            max_resources=1024, max_nodes=1024, max_flow_rules=128,
            batch_size=128, complete_batch_size=128, enable_minute_window=True,
        )
    if name == "sketch":  # the tier-4 analyzer's tick config
        return R_config.small_engine_config(sketch_stats=True, sketch_width=512, hotset_k=8)
    if name == "platform":  # platform_config()'s flags at the small widths, single lanes
        return R_config.small_engine_config(
            use_mxu_tables=True, fused_effects=True, seg_effects=True, seg_fallback=True,
            packed_wire=True, **H.SINGLE_LANE,
        )
    raise KeyError(name)


CASES = ("small", "minute", "sketch", "platform")


def setup(name: str, R, R_config, Registry, compile_ruleset, **kw):
    """(cfg, registry, ruleset) of a case in either package (``kw``: the
    port's ``device``)."""
    cfg = config(name, R_config)
    reg = Registry(cfg)
    H.intern(reg)
    rules = H.make_rules(R, param=True)
    rules["system_rules"] = [R.SystemRule(qps=60)]
    return cfg, reg, compile_ruleset(cfg, reg, **rules, **kw)


def workload(cfg, reg, seed: int) -> dict:
    """One tick's numpy columns: torch_harness's workload, plus sketch ids
    (past the exact rows) on the sketch config."""
    w = H.workload(cfg, reg, seed=seed, param=True)
    if cfg.sketch_stats:
        rng = np.random.default_rng(seed + 7)
        a = w["acq"]
        pick = np.flatnonzero(rng.random(a["res"].shape[0]) < 0.3)
        pick = pick[pick >= 2]
        a["res"][pick] = cfg.node_rows + rng.integers(0, 40, pick.shape[0])
        a["origin_node"][pick] = cfg.trash_row
        a["ctx_node"][pick] = cfg.trash_row
        a["origin_id"][pick] = -1
    return w


def outputs_numpy(out) -> dict:
    return {k: v.cpu().numpy() for k, v in out._asdict().items() if v is not None}


def drive(rank: int, n: int, cases=CASES, nows=NOWS, device="cpu") -> dict:
    """Every case on this rank's shard: ``{case: {"outs", "state",
    "sizes", "whole_sizes"}}`` (outs and state on rank 0 only), plus the
    window / token-column / top-K extras."""
    import torch

    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.core import config as C
    from sentinel_tpu_torch.core import rules as TR
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.parallel import spmd
    from sentinel_tpu_torch.runtime.registry import Registry

    mesh = spmd.make_mesh(n, device=device)
    res = {}
    for name in cases:
        cfg, reg, rules = setup(name, TR, C, Registry, E.compile_ruleset, device=device)
        whole = E.init_state(cfg, device)
        state = spmd.shard_state(whole, cfg, mesh)
        sizes = {k: tuple(v.shape) for k, v in S.leaves(state).items()}
        tick = spmd.make_sharded_tick(cfg, mesh)
        outs = []
        for i, now in enumerate(nows):
            w = workload(cfg, reg, seed=1000 * (1 + CASES.index(name)) + i)
            acq = E.AcquireBatch(**{k: torch.as_tensor(v).to(device) for k, v in w["acq"].items()})
            comp = E.CompleteBatch(**{k: torch.as_tensor(v).to(device) for k, v in w["comp"].items()})
            state, out = tick(state, rules, acq, comp, now, 0.5, 0.2)
            outs.append(outputs_numpy(out))
        gathered = S.to_numpy(spmd.gather_state(state, cfg, mesh))
        res[name] = dict(
            outs=outs if rank == 0 else None,
            state=gathered if rank == 0 else None,
            sizes=sizes,
            whole_sizes={k: tuple(v.shape) for k, v in S.leaves(whole).items()},
        )
    res["window"] = window_case(mesh, device)
    res["token_col"] = token_col_case(mesh, device)
    res["topk_ties"] = _topk_ties_case(mesh, device)
    return res


def window_case(mesh, device="cpu") -> dict:
    """add_batch, min_into_row and the gather_window_* reads on the rank's
    rows (``mesh``) or on the whole window (None)."""
    import torch

    from sentinel_tpu_torch.ops import window as W
    from sentinel_tpu_torch.parallel import collectives as CL
    from sentinel_tpu_torch.parallel import spmd

    cfg = W.WindowConfig(sample_count=10, window_ms=100)
    rows = 128
    rng = np.random.default_rng(5)
    whole = W.init_window(rows, cfg, device)
    specs = spmd.window_partition_specs(True)
    mine = whole if mesh is None else spmd.shard_tree(whole, specs, mesh)
    reads = []
    with CL.scope(None if mesh is None else mesh.shard_ctx()):
        for i, now in enumerate([1_000, 1_050, 1_420, 2_600]):
            r = torch.as_tensor(rng.integers(-3, rows + 3, 64).astype(np.int32), device=device)
            d = torch.as_tensor(rng.integers(0, 4, (64, W.NUM_EVENTS)).astype(np.int32), device=device)
            mine = W.add_batch(mine, now, r, d, cfg)
            q = torch.as_tensor(rng.integers(0, rows, 32).astype(np.int32), device=device)
            mine = W.min_into_row(mine, now, 3 * i + 1, torch.tensor(float(10 + i), device=device), cfg)
            rt_tot, rt_min = W.gather_window_rt(mine, now, q, cfg)
            reads.append(dict(
                counts=W.gather_window_counts(mine, now, q, cfg).cpu().numpy(),
                run=W.gather_window_event_run(mine, q, W.EV_PASS).cpu().numpy(),
                rt_tot=rt_tot.cpu().numpy(), rt_min=rt_min.cpu().numpy(),
            ))
    return dict(reads=reads, state=_np(mine if mesh is None else spmd.gather_tree(mine, specs, mesh)))


def token_col_case(mesh, device="cpu") -> dict:
    """decide_batch on the rank's slots (``mesh``) or on all of them (None)."""
    import torch

    from sentinel_tpu_torch.ops import token_col as TC
    from sentinel_tpu_torch.parallel import collectives as CL
    from sentinel_tpu_torch.parallel import spmd

    slots = 16
    specs = spmd.token_col_partition_specs()
    whole = TC.init_state(slots, device)
    whole = TC.set_limits(whole, torch.arange(slots, dtype=torch.float32, device=device) * 2.0 + 1.0)
    mine = whole if mesh is None else spmd.shard_tree(whole, specs, mesh)
    rng = np.random.default_rng(9)
    decided = []
    with CL.scope(None if mesh is None else mesh.shard_ctx()):
        for now in (1_000, 1_040, 1_230, 2_500):
            s = np.sort(rng.integers(0, slots, 32)).astype(np.int32)
            heads = np.array([np.flatnonzero(s == v)[0] for v in s], np.int32)
            args = [torch.as_tensor(x, device=device) for x in (
                s, rng.integers(1, 4, 32).astype(np.int32), heads,
                rng.random(32) < 0.5, rng.random(32) < 0.1,
            )]
            g, o, mine = TC.decide_batch(mine, now, *args)
            decided.append((g.cpu().numpy(), o.cpu().numpy()))
    return dict(decided=decided, state=_np(mine if mesh is None else spmd.gather_tree(mine, specs, mesh)))


def _topk_ties_case(mesh, device) -> dict:
    """The timeline's top K when every row ties and when the tie straddles
    a shard boundary: the merged rows, on the small config."""
    import torch

    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.ops import window as W
    from sentinel_tpu_torch.parallel import collectives as CL
    from sentinel_tpu_torch.parallel import spmd

    cfg = small_engine_config(timeline_k=8)
    whole = E.init_state(cfg, device)
    per = cfg.node_rows // mesh.world
    # equal scores on both sides of every shard boundary inside the
    # resource rows, plus one higher score late in the rows
    score = torch.zeros((cfg.node_rows,), dtype=torch.int32, device=device)
    for b in range(per, cfg.max_resources, per):
        score[b - 2 : b + 2] = 7
    score[cfg.max_resources - 3] = 9
    whole.win_sec.run[:, W.EV_PASS] = score
    out = {"whole": E._device_res_stats(cfg, whole, 1_000).cpu().numpy()}
    mine = spmd.shard_state(whole, cfg, mesh)
    with CL.scope(mesh.shard_ctx()):
        out["sharded"] = E._device_res_stats(cfg, mine, 1_000).cpu().numpy()
    return out


def _np(tree):
    from sentinel_tpu_torch import state as S

    return S.to_numpy(tree)


def single(name: str, nows=NOWS) -> dict:
    """The port's single-device run of a case: ``{"outs", "state"}``."""
    import torch

    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.core import config as C
    from sentinel_tpu_torch.core import rules as TR
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.runtime.registry import Registry

    cfg, reg, rules = setup(name, TR, C, Registry, E.compile_ruleset, device="cpu")
    state = E.init_state(cfg, "cpu")
    tick = E.make_tick(cfg)
    outs = []
    for i, now in enumerate(nows):
        w = workload(cfg, reg, seed=1000 * (1 + CASES.index(name)) + i)
        acq = E.AcquireBatch(**{k: torch.as_tensor(v) for k, v in w["acq"].items()})
        comp = E.CompleteBatch(**{k: torch.as_tensor(v) for k, v in w["comp"].items()})
        state, out = tick(state, rules, acq, comp, now, 0.5, 0.2)
        outs.append(outputs_numpy(out))
    return dict(outs=outs, state=S.to_numpy(state))


def dispatched_ops(name: str, nows=NOWS) -> int:
    """ATen operations the port's single-device ticks of a case dispatch
    (every call, views included), counted with a TorchDispatchMode."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from sentinel_tpu_torch.core import config as C
    from sentinel_tpu_torch.core import rules as TR
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.runtime.registry import Registry

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    cfg, reg, rules = setup(name, TR, C, Registry, E.compile_ruleset, device="cpu")
    # a first pass fills the module-level caches (salsa's shift vectors),
    # so the count does not depend on what the process ran before
    for counted in (False, True):
        state = E.init_state(cfg, "cpu")
        for i, now in enumerate(nows):
            w = workload(cfg, reg, seed=1000 * (1 + CASES.index(name)) + i)
            acq = E.AcquireBatch(**{k: torch.as_tensor(v) for k, v in w["acq"].items()})
            comp = E.CompleteBatch(**{k: torch.as_tensor(v) for k, v in w["comp"].items()})
            if counted:
                with Count():
                    state, _out = E.tick(state, rules, acq, comp, now, 0.5, 0.2, cfg)
            else:
                state, _out = E.tick(state, rules, acq, comp, now, 0.5, 0.2, cfg)
    return Count.n


def hang_or_fail(rank: int, n: int):
    """Rank 1 raises; rank 0 blocks in a collective that waits for it."""
    import torch

    from sentinel_tpu_torch.parallel import collectives as CL
    from sentinel_tpu_torch.parallel import spmd

    spmd.make_mesh(n, device="cpu")
    if rank == 1:
        raise RuntimeError("rank 1 broke")
    CL.all_reduce(torch.ones(4))
    return rank


def gated(rank: int, n: int, hold_s: float):
    """Reach the gate, then hold the group ``hold_s`` seconds: the
    (passed the gate, ended) times on the system-wide monotonic clock."""
    import time

    from sentinel_tpu_torch.parallel import launch

    launch.gate()
    t = time.monotonic()
    time.sleep(hold_s)
    return t, time.monotonic()


def fails_before_its_gate(rank: int, n: int):
    """A rank whose set-up raises before it reaches the gate."""
    raise RuntimeError("set-up broke")
