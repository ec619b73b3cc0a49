#!/usr/bin/env python3
"""Drive sentinel_tpu_torch's admission path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (the first failure stops the script with a nonzero exit):

1. Build the CUDA kernels from ``sentinel_tpu_torch/csrc`` (nvcc, at first
   use) and print the build time and ptxas's register report.
2. Hold each kernel against its plain PyTorch version on the card, on the
   inputs a full-width tick gives it at both of the client's batch shapes
   (2,048 rows, and the 256-row light tick that phase 3 serves) and on
   edge cases (ids -1 and 2**30, values at and above 256**digits, an empty
   job, N not a multiple of the block size, job lists longer than one
   launch carries); exact equality.  Time kernel, plain version and one
   PyTorch library call on the same inputs, beside the least time the card
   could take (bytes over 3.35 TB/s).
3. The main path: a threaded ``SentinelClient`` on ``cuda`` at the default
   ``EngineConfig`` widths (2^17 resources, 2^18 node rows, the minute
   window on, batch 2,048, 4 flow lanes a resource) with 4,000 flow rules,
   1,000 degrade rules, an authority black list and a system QPS rule
   answers >= 20,000 ``entry()`` calls from 8 request threads (Zipf(1.1)
   over 100,000 resource names) with real exits.  Each thread waits for
   its verdict, so a tick carries at most 8 acquires and runs at the
   client's 256-row light shape.  Launch counts are reset
   just before and read just after; both kernels must have launched, and
   flow rules must have blocked some entries.
4. The tick against itself: one seeded B=2,048 batch stream from one
   state, once with the kernels and once with every kernel swapped for its
   plain version (this phase only); verdicts, wire bytes and integer state
   must be equal.  The kernel run forbids host syncs inside the tick
   (``torch.cuda.set_sync_debug_mode("error")``; the readback is outside).
   Prints ms per tick and decisions/s.

The last lines: the run's fuller numbers (``[report] {...}``), the
kernels' JSON record, the card's name and power limit (nvidia-smi), and
``{"ok": true, "device": {...}}``.  A profile of the tick (top device ops)
is printed before them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 (data sheet)
SEED = 20261016
N_THREADS = 8
N_NAMES = 100_000
MIN_ENTRIES = 20_000


def log(*a):
    print(*a, flush=True)


def check(ok, what) -> None:
    """A phase's pass/fail condition (raises; not an ``assert``, which
    ``python -O`` would strip)."""
    if not ok:
        raise AssertionError(what)


# -- timing helpers ---------------------------------------------------------


def time_ms(fn, reps: int = 50, flush_bytes: int = 64 << 20) -> tuple:
    """(device ms, host ms) of one call of ``fn``.

    Device ms: the mean over ``reps`` calls, each bracketed by CUDA events
    after a write of ``flush_bytes`` evicts the 50 MB L2 (the tick's other
    passes over the window ring leave it cold too).  Each call is queued
    behind a ``torch.cuda._sleep`` longer than the host needs to enqueue
    it, so the events bracket device work only, not the host's Python
    between launches.  Host ms: the median wall time one call takes to
    enqueue, over 11 calls."""
    import torch

    scratch = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    host = []
    for _ in range(11):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    host_s = sorted(host)[len(host) // 2]
    cycles = int(max(4.0 * max(host), 1e-4) * 2.0e9)  # ~2 GHz SM clock
    evs = []
    for _ in range(reps):
        scratch.zero_()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps, host_s * 1e3


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# -- phase 2 helpers ----------------------------------------------------------


def scatter_work(jobs):
    """(bytes moved, operations) of one scatter_many call: each row/value
    plane read once, each output cell written once; one add per (unit,
    item, plane)."""
    N = jobs[0].rows.shape[-1]
    nbytes = ops = 0
    for j in jobs:
        R, P = j.rows.shape[0], j.values.shape[-2]
        nbytes += 4 * N * (R + (R * P if j.values.dim() == 3 else P))
        nbytes += 4 * j.n * P
        ops += R * N * P
    return nbytes, ops


def scatter_library_call(jobs):
    """One PyTorch call computing the same histograms: ``index_add_`` of
    every (unit, item, plane) value into one flat int32 buffer (dropped ids
    to a spare cell).  Index building is set-up, outside the timing."""
    import torch

    idx, val = [], []
    off = 0
    for j in jobs:
        P = j.values.shape[-2]
        for r in range(j.rows.shape[0]):
            k = j.rows[r].to(torch.int64)
            ok = (k >= 0) & (k < j.n)
            v = j.values[r] if j.values.dim() == 3 else j.values
            for p in range(P):
                d = j.digits[p]
                vv = v[p] if d >= 4 else v[p] & ((1 << (8 * d)) - 1)
                idx.append(torch.where(ok, off + k * P + p, -1))
                val.append(vv.to(torch.int32))
        off += j.n * P
    idx = torch.cat(idx)
    idx = torch.where(idx < 0, off, idx)
    val = torch.cat(val)
    buf = torch.zeros(off + 1, dtype=torch.int32, device=idx.device)
    return lambda: buf.index_add_(0, idx, val)


def check_equal(kind, got, want):
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            diff = (g.double() - w.double()).abs().max().item() if g.shape == w.shape else float("inf")
            raise AssertionError(f"{kind}: kernel disagrees with its plain version (max |err| {diff})")
        if g.numel():
            err = max(err, (g.double() - w.double()).abs().max().item())
    return err


def edge_cases(FU, torch):
    """Edge inputs: ids -1 / 2**30 / n, values at and above 256**digits, an
    empty job, N not a multiple of the 256-thread block, and job lists
    longer than one launch carries."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    N = 2048 + 37

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)

    rows = ints(-2, 70_002, (3, N))
    rows[:, :3] = torch.tensor([-1, 2**30, 70_000], dtype=torch.int32, device="cuda")
    vals = ints(0, 1 << 20, (3, N))
    vals[:, :4] = torch.tensor([255, 256, 65535, 65536], dtype=torch.int32, device="cuda")
    jobs = [
        FU.Job("wide", 70_000, rows, vals, (1, 2, 3)),
        FU.Job("small", 900, ints(-3, 903, (4, N)), ints(0, 600, (4, 3, N)), (1, 1, 2)),
        FU.Job("empty", 0, ints(-1, 3, (1, N)), ints(0, 9, (1, N)), (1,)),
        # more row-vectors than one launch carries: two launches, one output
        FU.Job("many", 5000, ints(-1, 5001, (FU._MAX_UNITS + 5, N)), ints(0, 300, (2, N)), (1, 2)),
    ]
    err = check_equal("scatter_many edge cases", FU.scatter_many(jobs), FU.scatter_many_plain(jobs))
    table = ints(0, 2**31 - 1, (5000, 3))
    ids = ints(-3, 5003, (N,))
    ids[:3] = torch.tensor([-1, 2**30, 5000], dtype=torch.int32, device="cuda")
    gj = [FU.GatherJob("t", ids, table, (3, 2, 1)), FU.GatherJob("u", ids[:N], table[:17], (4, 3, 3))]
    gj += [FU.GatherJob(f"x{i}", ids, table[: 100 * i + 1], (i % 4 + 1,) * 3) for i in range(FU._MAX_GATHER_JOBS)]
    err2 = check_equal("gather_many edge cases", FU.gather_many(gj), FU.gather_many_plain(gj))
    return max(err, err2)


# -- the main path ----------------------------------------------------------------


def zipf_probs(np, n, s=1.1):
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def build_rules(st):
    """4,000 flow rules (every 100th a rate limiter, every 100th + 50 a
    warm-up), 1,000 degrade rules (error count and slow ratio), one
    authority black list, one system QPS rule — on the hottest names."""
    flow = []
    for i in range(4000):
        name = f"res-{i}"
        if i % 100 == 0:
            flow.append(st.FlowRule(resource=name, count=20, control_behavior=st.CONTROL_RATE_LIMITER, max_queueing_time_ms=20))
        elif i % 100 == 50:
            flow.append(st.FlowRule(resource=name, count=15, control_behavior=st.CONTROL_WARM_UP, warm_up_period_sec=5))
        else:
            flow.append(st.FlowRule(resource=name, count=5 + (i % 20)))
    degrade = []
    for i in range(1000):
        name = f"res-{i}"
        if i % 2:
            degrade.append(st.DegradeRule(resource=name, grade=st.CB_STRATEGY_SLOW_REQUEST_RATIO, count=2, slow_ratio_threshold=0.5, min_request_amount=5, time_window=1))
        else:
            degrade.append(st.DegradeRule(resource=name, grade=st.CB_STRATEGY_ERROR_COUNT, count=3, min_request_amount=1, time_window=1))
    authority = [st.AuthorityRule(resource="res-3", limit_app="bad", strategy=st.AUTHORITY_BLACK)]
    system = [st.SystemRule(qps=50_000)]
    return flow, degrade, authority, system


def drive_main_path(st, np, FU, torch, cfg):
    client = st.init(cfg=cfg, device="cuda", mode="threaded", entry_timeout_s=30.0)
    flow, degrade, authority, system = build_rules(st)
    st.load_flow_rules(flow)
    st.load_degrade_rules(degrade)
    st.load_authority_rules(authority)
    st.load_system_rules(system)
    probs = zipf_probs(np, N_NAMES)
    names = [f"res-{i}" for i in range(N_NAMES)]
    counts = {}
    lock = threading.Lock()
    done = [0]
    errors = []

    def worker(tid):
        rng = np.random.default_rng(SEED + tid)
        local = {}
        picks = rng.choice(N_NAMES, size=MIN_ENTRIES // N_THREADS + 64, p=probs)
        for k in picks:
            name = names[k]
            try:
                if rng.random() < 0.05:
                    e = client.entry(name, origin="bad", inbound=bool(rng.random() < 0.5))
                else:
                    e = st.entry(name)
                if rng.random() < 0.05:
                    e.trace(RuntimeError("business error"))
                if rng.random() < 0.02:
                    time.sleep(0.003)  # a slow call for the slow-ratio breakers
                e.exit()
                kind = "pass" if not e.wait_ms else "pass_wait"
            except st.BlockException as exc:
                kind = type(exc).__name__
            except Exception as exc:  # recorded and re-raised after join
                errors.append(exc)
                return
            local[kind] = local.get(kind, 0) + 1
        with lock:
            for k, v in local.items():
                counts[k] = counts.get(k, 0) + v
            done[0] += sum(local.values())

    FU.reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "request threads still running after 600 s")
    # the last exits ride one more tick
    deadline = time.perf_counter() + 30
    while (client._completions or client._acquires) and time.perf_counter() < deadline:
        time.sleep(0.01)
    check(not (client._completions or client._acquires), "queued work not drained within 30 s")
    client.tick_once()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(FU.LAUNCHES)
    if errors:
        raise errors[0]
    st.reset()
    return counts, done[0], elapsed, launches


# -- phase 4 --------------------------------------------------------------------------


def batch_stream(E, torch, np, cfg, n_ticks, names_to_rows, B=None, seed=SEED):
    """A seeded stream of acquire + completion batches of B rows (default:
    the full configured batch)."""
    rng = np.random.default_rng(seed)
    B = B or cfg.batch_size
    probs = zipf_probs(np, N_NAMES)
    out = []
    for _ in range(n_ticks):
        res = names_to_rows[rng.choice(N_NAMES, size=B, p=probs)]
        acq = E.empty_acquire(cfg, "cuda", B)._replace(
            res=torch.as_tensor(res, dtype=torch.int32, device="cuda"),
            count=torch.ones(B, dtype=torch.uint8, device="cuda"),
            prio=torch.as_tensor((rng.random(B) < 0.05).astype(np.int8), device="cuda"),
            inbound=torch.as_tensor((rng.random(B) < 0.3).astype(np.int8), device="cuda"),
        )
        cres = names_to_rows[rng.choice(N_NAMES, size=B, p=probs)]
        comp = E.empty_complete(cfg, "cuda", B)._replace(
            res=torch.as_tensor(cres, dtype=torch.int32, device="cuda"),
            rt=torch.as_tensor((rng.integers(1, 80, B) / 8.0).astype(np.float32), device="cuda"),
            success=torch.ones(B, dtype=torch.uint8, device="cuda"),
            error=torch.as_tensor((rng.random(B) < 0.05).astype(np.uint8), device="cuda"),
            inbound=torch.as_tensor((rng.random(B) < 0.3).astype(np.int8), device="cuda"),
        )
        out.append((acq, comp))
    return out


def run_stream(E, S, torch, state, rules, cfg, stream, t0_ms, forbid_sync=False):
    """Run the stream; ``forbid_sync`` makes any host<->device sync inside
    the tick (everything but its one readback) raise."""
    wires, waits, tick_s = [], [], []
    for i, (acq, comp) in enumerate(stream):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if forbid_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, out = E.tick(state, rules, acq, comp, t0_ms + 137 * i, 0.3, 0.2, cfg, E.ALL_FEATURES)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wires.append(out.wire.cpu().numpy().tobytes())  # the one readback
        tick_s.append(time.perf_counter() - t)
        waits.append(out.wait_ms.cpu().numpy())
    return state, wires, waits, tick_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.ops import _build
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import wire as WIRE
    from sentinel_tpu_torch.runtime.registry import Registry

    report = {"torch": torch.__version__, "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi

    # -- 1. build -----------------------------------------------------------
    t = time.perf_counter()
    _build.load_library()
    log(f"[build] kernels ready in {time.perf_counter() - t:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("[build]", line.strip())

    cfg = platform_config(packed_wire=True)
    log(f"[config] max_resources={cfg.max_resources} max_nodes={cfg.max_nodes} "
        f"batch={cfg.batch_size} flow_lanes={cfg.flow_rules_per_resource} minute_window={cfg.enable_minute_window}")

    # -- 2. kernels against their plain versions ------------------------------
    reg = Registry(cfg)
    names_to_rows = np.array([reg.resource_id(f"res-{i}") for i in range(N_NAMES)], dtype=np.int32)
    flow, degrade, authority, system = build_rules(st)
    rules = E.compile_ruleset(
        cfg, reg, flow_rules=flow, degrade_rules=degrade, authority_rules=authority,
        system_rules=system, device="cuda",
    )
    state0 = E.init_state(cfg, "cuda")
    report["state_bytes"] = sum(v.numel() * v.element_size() for v in S.leaves(state0).values())
    stream = batch_stream(E, torch, np, cfg, 13, names_to_rows)
    # the client runs two batch shapes: the full batch, and 256 rows for a
    # light tick (every tick of the closed-loop phase 3 is light)
    light = batch_stream(E, torch, np, cfg, 1, names_to_rows, B=256, seed=SEED + 1)[0]
    real_s, real_g = FU.scatter_many, FU.gather_many

    def capture_tick(state, acq, comp, now_ms):
        """Run one tick; the kernels' inputs (cloned) at each of its calls."""
        calls = {"scatter_many": [], "gather_many": []}

        def rec_s(jobs):
            calls["scatter_many"].append([FU.Job(j.name, j.n, j.rows.clone(), j.values.clone(), j.digits) for j in jobs])
            return real_s(jobs)

        def rec_g(jobs):
            calls["gather_many"].append([FU.GatherJob(j.name, j.ids.clone(), j.table.clone(), j.digits) for j in jobs])
            return real_g(jobs)

        FU.scatter_many, FU.gather_many = rec_s, rec_g
        try:
            state, _ = E.tick(state, rules, acq, comp, now_ms, 0.3, 0.2, cfg, E.ALL_FEATURES)
        finally:
            FU.scatter_many, FU.gather_many = real_s, real_g
        check(len(calls["scatter_many"]) == 2 and len(calls["gather_many"]) == 1, {k: len(v) for k, v in calls.items()})
        return state, calls

    state0, captured = capture_tick(state0, *stream[0], 1_000)
    state0, captured_light = capture_tick(state0, *light, 1_100)

    def measure(name, calls):
        """Hold each call against the plain version; device ms per tick of
        kernel, plain and library call, the bound, the wrapper's host ms."""
        run, plain = (FU.scatter_many, FU.scatter_many_plain) if name == "scatter_many" else (FU.gather_many, FU.gather_many_plain)
        err = ms = plain_ms = lib_ms = host_ms = 0.0
        nbytes_all = ops_all = 0
        for jobs in calls:
            err = max(err, check_equal(name, run(jobs), plain(jobs)))
            d, h = time_ms(lambda: run(jobs))
            ms += d
            host_ms += h
            plain_ms += time_ms(lambda: plain(jobs), reps=10)[0]
            if name == "scatter_many":
                nbytes, ops = scatter_work(jobs)
                call = scatter_library_call(jobs)
            else:
                j = jobs[0]
                n, P = j.table.shape
                uniq = torch.unique(j.ids[(j.ids >= 0) & (j.ids < n)]).numel()
                nbytes, ops = 4 * j.ids.numel() + 4 * uniq * P + 4 * j.ids.numel() * P, j.ids.numel() * P
                ids64 = torch.clamp(j.ids, 0, n - 1).to(torch.int64)
                call = lambda ids64=ids64, tab=j.table: torch.index_select(tab, 0, ids64)
            lib_ms += time_ms(call)[0]
            nbytes_all += nbytes
            ops_all += ops
        bnd, by = bound_ms(nbytes_all, ops_all)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                    bound_by=by, calls_per_tick=len(calls), bytes=nbytes_all, wrapper_host_ms=host_ms)

    kern = {}
    for shape, cap in ((f"B={cfg.batch_size}", captured), ("B=256", captured_light)):
        for name in ("scatter_many", "gather_many"):
            k = measure(name, cap[name])
            kern.setdefault(name, {})[shape] = k
            log(f"[kernel] {name} at {shape}: equal to plain (max |err| {k['max_abs_err']}); per tick "
                f"({k['calls_per_tick']} call(s)), device time: kernel {k['ms']:.4f} ms, plain "
                f"{k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
                f"({k['bound_by']}, {k['bytes']} B); wrapper host enqueue {k['wrapper_host_ms']:.4f} ms")
    err_edge = edge_cases(FU, torch)
    log(f"[kernel] edge cases equal to plain (max |err| {err_edge})")
    for per_shape in kern.values():
        for k in per_shape.values():
            k["max_abs_err"] = max(k["max_abs_err"], err_edge)

    # -- 3. the main path ---------------------------------------------------------
    counts, n_done, elapsed, launches = drive_main_path(st, np, FU, torch, cfg)
    log(f"[main] {n_done} entries from {N_THREADS} threads in {elapsed:.2f} s "
        f"({n_done / elapsed:.0f} entries/s); verdict mix {json.dumps(counts, sort_keys=True)}")
    log(f"[main] kernel launches during the run: {json.dumps(launches)}")
    check(n_done >= MIN_ENTRIES, n_done)
    check(launches["scatter_many"] > 0 and launches["gather_many"] > 0, launches)
    check(counts.get("FlowException", 0) > 0, counts)
    report["main_path"] = dict(entries=n_done, seconds=elapsed, verdicts=counts, launches=launches)

    # -- 4. the tick against itself ----------------------------------------------
    st_a = E.clone_state(state0)
    st_b = E.clone_state(state0)
    ticks = stream[1:]
    st_a, wires_a, waits_a, tick_s = run_stream(E, S, torch, st_a, rules, cfg, ticks, 1_250, forbid_sync=True)
    FU.scatter_many, FU.gather_many = FU.scatter_many_plain, FU.gather_many_plain
    try:
        st_b, wires_b, waits_b, _ = run_stream(E, S, torch, st_b, rules, cfg, ticks, 1_250)
    finally:
        FU.scatter_many, FU.gather_many = real_s, real_g
    lo = WIRE.layout_for(cfg, cfg.batch_size)
    mix = np.zeros(7, np.int64)
    for i, (wa, wb) in enumerate(zip(wires_a, wires_b)):
        check(wa == wb, f"tick {i}: wire bytes differ between kernels and plain versions")
        check(np.array_equal(waits_a[i], waits_b[i]), f"tick {i}: wait_ms differ")
        mix += np.bincount(WIRE.unpack(wa, lo).verdict, minlength=7)
    float_diff = 0.0
    la, lb = S.leaves(st_a), S.leaves(st_b)
    for k in la:
        if la[k].dtype.is_floating_point:
            float_diff = max(float_diff, (la[k] - lb[k]).abs().max().item())
        else:
            check(torch.equal(la[k], lb[k]), f"integer state leaf {k} differs")
    steady = sorted(tick_s[2:])
    ms_tick = 1e3 * steady[len(steady) // 2]
    log(f"[tick] no host sync inside {len(ticks)} ticks (torch.cuda sync debug mode 'error')")
    log(f"[tick] {len(ticks)} ticks at B={cfg.batch_size}: kernels == plain versions (verdicts, "
        f"wire bytes, integer state; float state max |diff| {float_diff}); verdict mix {mix.tolist()}")
    log(f"[tick] median {ms_tick:.3f} ms per tick -> {cfg.batch_size / ms_tick * 1e3:.0f} decisions/s")
    report["tick"] = dict(ms_median=ms_tick, decisions_per_s=cfg.batch_size / ms_tick * 1e3,
                          ticks=len(ticks), float_state_max_diff=float_diff, verdict_mix=mix.tolist())

    # where a tick's time goes (kept for PERF.md; not a pass/fail phase)
    from torch.profiler import ProfilerActivity, profile

    st_c = E.clone_state(st_a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        for i, (acq, comp) in enumerate(ticks[:4]):
            st_c, out = E.tick(st_c, rules, acq, comp, 9_000 + 137 * i, 0.3, 0.2, cfg, E.ALL_FEATURES)
            out.wire.cpu()
        torch.cuda.synchronize()
        wall_prof_us = (time.perf_counter() - t_prof) * 1e6
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15, max_name_column_width=48)
    for line in table.splitlines():
        log("[profile]", line)
    # device work = the kernel / memcpy / memset events (the CPU-side aten
    # rows repeat the same time as their "self CUDA" column)
    from torch.autograd import DeviceType

    dev_events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    dev_us = sum(e.self_device_time_total for e in dev_events)
    n_kernels = sum(e.count for e in dev_events)
    report["profile"] = dict(ticks=4, device_us=dev_us, wall_us=wall_prof_us, device_launches=n_kernels)
    log(f"[profile] 4 ticks under the profiler: device busy {dev_us / 1e3:.3f} ms of "
        f"{wall_prof_us / 1e3:.3f} ms wall (idle share {1 - dev_us / wall_prof_us:.3f}), "
        f"{n_kernels} device launches")

    kernels = []
    for name, src_line in (("scatter_many", 186), ("gather_many", 374)):
        # the full batch's numbers; the 256-row shape's are in the report
        k = kern[name][f"B={cfg.batch_size}"]
        kernels.append(dict(
            name=name, route="cuda", source="sentinel_tpu_torch/csrc/fused.cu",
            replaces=f"sentinel_tpu/ops/fused.py:{src_line}", launches=launches[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=k["library_ms"],
        ))
    report["kernel_detail"] = kern
    log("[report]", json.dumps(report, sort_keys=True))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
