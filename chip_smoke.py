#!/usr/bin/env python3
"""Drive sentinel_tpu_torch's admission paths on one NVIDIA GPU and check them.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Three configurations at the default ``EngineConfig`` widths (2^17
resources, 2^18 node rows, the minute window on, batch 2,048; the
hot-parameter store at depth 2 x 16,384 rows x 8 buckets of 500 ms), and
bench.py's 1M-resource configuration:

- ``fused``: ``platform_config(seg_effects=False)``, the per-item fused
  path — kernels scatter_many (B1) and gather_many (B2);
- ``seg4``: ``platform_config()``, the segment-compacted path at the
  default 4 rule lanes — per-item checks (B2), segment effects (B1) and
  the segment RT minimum seg_incl_min (B4);
- ``seg1``: ``platform_config()`` with single-lane rules — the segment
  check phase, whose ranks are seg_excl_cumsum (B3), plus B1 and B4;
- ``sketch``: bench.py's ``build`` (bench.py:140-170) through
  ``platform_config``: 16,368 resources, 16,376 nodes, single lanes, the
  minute window, the sketch tier at its defaults (SALSA, depth 2 x width
  16,384, capacity 2^22, hot block 32), the segment path with
  ``seg_static_ranks``, ``param_est_digits=2``; bench.py's rules (10,000
  flow rules at 1,000 QPS, 10,000 slow-RT breakers, 128 param rules, 16
  authority black lists, a system QPS rule at 1e9, 2,048 QPS rules at 20
  on sketch ids past the exact space) and traffic (Zipf(1.3) over 2^20
  names, 1/8 with an origin, 1/2 inbound, RT |N(3, 1)|).  The sketch
  lands as ``sketch{d}`` jobs of B1 in both phases, the tail stage ranks
  with one more B3 call, and each tick emits the hot-set candidates.

All three run with the observability planes the reference's serving
config turns on (``platform_config()``'s defaults): the device telemetry
row, the top-128 per-resource timeline rows and up to 32 explain records
a tick, packed into the one readback.  They add no kernel.

The first three run the hot-parameter stage (ParamFlow): 32 param rules on the
16 hottest resources (16 with single lanes, one a resource) — QPS grade
over 1 s and 2 s (two window classes), some THREAD grade, one per-value
exception item each — and every entry carries one argument drawn
Zipf(1.1) from 10,000 values.  Param launches no kernel of its own: its
scatters are ``param{d}`` / ``prel{d}`` jobs of scatter_many (B1), riding
the two existing calls on the fused path and two more, on the item axis,
on the segment paths.

Phases (the first failure stops the script with a nonzero exit):

1. Build the CUDA kernels from ``sentinel_tpu_torch/csrc`` (one nvcc per
   source, all started together, at first use) and print the build time
   and ptxas's register report.
2. Hold each kernel against its plain PyTorch version on the card, on the
   inputs full-width ticks of each configuration give it at both of the
   client's batch shapes (2,048 rows and the 256-row light tick), and on
   edge cases (B1/B2: ids -1 and 2**30, values at and above 256**digits,
   an empty job, N not a multiple of the block size, 200 row-vectors in
   one job, every item on one row, digits-4 values of both signs whose
   running sums return to 0, N = 1, 20 jobs, transposed / permuted /
   uint8 / int64 / expanded operands, gather job lists longer than one
   launch carries; B2's column form with a strided column, a guard on and
   off whose key is the int32 wrap of 2^31, .5 ties, values over the cap,
   N off the 2 items a thread, N = 1 and 0 (no launch), misaligned ids;
   B3/B4: N = 1, 255, 2,049 and 131,072, heads all true
   and only the first, B3 row totals just under 2^31, the wide form with
   segment totals past 2^31, narrow and wide rows in one launch with wide
   values of both signs, B4 with absent items); exact equality.  B1's
   calls launch twice each (three times for 20 jobs) and leave its
   scratch at zero.  Each captured B1 call's device time launch by
   launch (``torch.profiler``) and its host time function by function
   (cProfile) are printed on ``[b1]`` lines; a call may make at most two
   device launches.  B2 on fused and seg4 at 2,048 rows, beside the
   six-launch dense [node_rows, 3] build + table-form gather it replaced,
   on the same state and ids: device ms, device launches and host ms a
   call (``[b2]`` lines).
   Time kernel, plain version and a PyTorch call on the same inputs
   (B1 ``index_add_``, B2 ``index_select``; no PyTorch call computes a
   segmented scan, so for B3/B4 ``torch.cumsum`` over the same values is
   timed as an unsegmented-scan floor), beside the least time the card
   could take (bytes over 3.35 TB/s, or operations over 67 T/s).  The
   tick's three plane functions alone (``_device_stats``,
   ``_device_res_stats``, ``_device_explain``), called again on the
   arguments one tick gave them: device launches, device ms and host
   enqueue ms a call (``[planes]`` lines).  The ``sketch`` configuration's
   B1 calls (its ``sketch{d}`` jobs among them) and B3 calls (the tail
   rank among them) are captured and held the same way at 2,048 and 256
   rows.
3. The main paths: a threaded ``SentinelClient`` on ``cuda`` per
   configuration, 4,000 flow rules (one per resource: 40 rate limiters,
   40 warm-ups, the rest QPS; prioritized traffic borrows ahead), 1,000
   degrade rules, an authority black list and a system QPS rule, 8
   request threads, Zipf(1.1) over 100,000 names, real exits, 3,000
   entries each.  Launch counts
   are reset just before each run and read just after; every kernel of the
   path must have launched, flow rules and param rules must have blocked
   some entries, and once every exit has landed the THREAD-grade param
   concurrency must be back at 0; on ``seg1`` the client must have turned
   ``seg_static_ranks`` on, and no item may have failed closed for
   segment capacity.  Each request thread waits for its verdict, so these
   ticks carry a few acquires; then one open-loop burst per configuration
   through a sync client: 2,048 acquires queued before one tick, their
   exits in the next, a second burst in the third.  There the segment
   client must grow ``seg_u`` from the burst's host segment count, drop
   nothing, and give the fused client's verdicts and waits, item for item
   (``seg1`` against a fused client with single lanes, which keeps the same
   16 param rules); param rules must block some of every burst.  The
   planes on the threaded run: the verdict counters the client folded from
   the telemetry rows (the port's ``obs.registry``) must equal the
   verdicts the futures returned, kind for kind; ``explain_coverage()``
   must count every blocked entry; the timeline must hold rows.
   The ``sketch`` configuration through a threaded client: bench.py's
   names through the registry (res-1 .. res-10000 on exact rows, the
   organic rest burnt, tail-0 .. tail-2047 sketch ids), its rules through
   the managers (the loads promote ruled sketch ids into the reserve rows
   until it is spent), 3,000 entries of its traffic by name from 8
   threads and 64 acquires from 4 more on a tail-ruled name left on its
   sketch id; the tail rule must block some of those, the client must
   have folded hot rows carrying sketch ids, and the promotions and
   demotions are printed.  Its bursts (with 64 acquires on that name
   each) through the segment client must equal, item for item, those of
   a per-item fused client on the same configuration.
   The extension points (``drive_extension_points``): seg4's threaded
   client runs one seeded script of 400 entries twice, from one request
   thread on a stepped clock — plain, and with a no-op entry hook, a no-op
   custom slot and a no-op metric extension loaded; the verdicts must be
   equal, and the hook, the slot's entry and exit sides, and the
   extension's pass + block callbacks must each fire once an entry
   (``on_complete`` once a pass).
4. The tick against itself, per configuration: one seeded, host-presorted
   B = 2,048 stream (``seg_u`` grown from its exact segment count by the
   client's rule) from one state, once with the kernels and once with
   every kernel swapped for its plain version; wire bytes, wait_ms and
   integer state (the param store ``pcms``, ``pcms_epochs``, ``pconc``
   included) must be equal, no tick may drop items, param rules must block
   some, and the kernel run forbids host syncs inside the tick
   (``torch.cuda.set_sync_debug_mode("error")``; the readback is
   outside).  The planes are checked where the JAX reference cannot run:
   the stats row's valid count and verdict mix equal the decoded bitmap's,
   ``n_blocked`` its blocked rows, the explain section's own checksum
   validates, and the timeline rows are a host sort of the readback of
   the windowed pass + block (descending, lower row first on a tie).  The
   same stream with the planes off must give the same verdicts, waits and
   state.  Prints ms per tick and decisions/s with the planes on and off
   (two runs of each from one state, in turns: off, on, on, off), the
   wire's length in words at 2,048 and 256 rows, and, from one profile
   of 4 ticks with the planes off then 4 with them on, device busy time,
   wall time, host CPU time, device launches and the card's idle share —
   and what the planes add to each — with the profile's top rows, B1's
   launches a tick, the profile's launches of the port's kernels and
   memsets, and the device launches a tick beside commit 71b3c5a's.
   The ``sketch`` configuration (``sketch_tick_phase``): at B = 2,048 the
   same equality (the sketch's state leaves included), the planes checked,
   hot rows with sketch ids counted; tick time with the sketch tier on and
   off in turns, a profile of each, and the sketch's functions alone
   (SALSA's refresh and ``_land_words``, the estimate, the tail
   thresholds, the hot candidates: ``[sketch]`` lines); at bench.py's
   batch, B = 131,072, a warm-up tick then 7 ticks with the kernels
   against the plain versions, their times and a profile of 2; the tail
   rules must block some items there.
5. The probes (``sentinel_tpu_torch/probes``): each of the four probe
   kernels — probe_copy, probe_hist_count, probe_hist_planes,
   probe_hist_stat5 (``csrc/probes.cu``) — against its plain version on
   the card at the shapes the probes run them at and on edge cases (ids
   -1, n and 2**30; N = 0, N = 1 and N not a multiple of the block; the
   copy on views 4 and 12 bytes off a 16-byte boundary, into an ``out=``
   aligned as the view or not; every
   id equal; ``n`` not a multiple of ``n_lo``; for the two valued
   histograms' cluster plan also ids on every block's first and last row,
   n = 1, a table past one cluster's shared memory, and an ``out=`` filled
   with NaN), exact equality.  Each valued histogram's call at each of its
   probe shapes, split into its device launches at the end of phase 2
   (``[probe] split`` lines), must be exactly one launch, no memset.  Timed
   like the other kernels, beside ``index_add_`` / ``torch.add``, the bound
   and the time of the kernels' earlier design (``EARLIER_MS``).
   Then the probe run itself — ``probes.floor`` (what a launch costs,
   eager against a CUDA graph) and ``probes.hist`` (the scatter floor at
   the stat-landing shape, against ``index_add_`` and scatter_many) — with
   the probe kernels' launch counts reset just before and read just
   after, printed on ``[probe]`` lines.

6. ``seg_fallback=True`` (platform_config()'s default), the tick's two
   routes: seg4, seg1 and ``sketch`` at full width, with ``seg_u`` grown
   from the exact peak of Zipf ticks, over 12 B = 2,048 ticks of which
   every third acquire side and every fourth completion side is uniform
   over all names (~2,000 live segments, past ``seg_u``): every
   combination of fitting and overflowing sides.  Route A (no host hint:
   both branches of each phase, selected on the card) with the kernels,
   under ``set_sync_debug_mode("error")``, equals route A with the plain
   versions (wire bytes, wait_ms, integer state) and route B (the host's
   exact ``seg_fits``: one branch a side; every state leaf); the verdicts
   and waits equal the per-item fused path's on the same stream; nothing
   is dropped; the card's segment count agrees with the host's; each side
   takes each branch at least once (``[fallback]`` lines: the branch
   counts, ms a tick for each route in turns A, B, B, A, kernel launches
   a tick, and device launches, busy time and idle share from a profile
   of 4 ticks of each).
7. bench.py's ``client_bench`` (bench.py:311-520) through the port's
   client, at B = 131,072 and 2,048: ``platform_config`` at bench.py's
   shape (so ``seg_fallback=True``), its names and rules through the
   public surface, ``pipeline_depth=4``, ``seg_u`` with bench.py's
   headroom.  First the same blocks through two clients on a virtual
   clock, at depth 4 and 0 (pinned staging): equal verdicts and waits.
   Then 32 blocks with depth + 4 in flight, fed closed-loop from the
   resolver's callbacks while this thread drives ``tick_once``; kernel
   launch counts reset just before and read just after; run twice, the
   span tracer off and then on.  ``[client_bench]`` lines: ``dps``,
   ``effective_tick_ms``, ``req_p50_ms``, ``req_p99_ms`` (submit to
   resolve), the verdict mix, the ticks that took the per-item branch;
   ``host_build_ms_avg``, the upload (tx) and readback (rx) bytes and the
   skipped columns a tick, which host sort ran (it must be the native
   library's), dps with the tracer off beside on; and
   ``stage_breakdown_ms``, the p50 / p99 / mean of each ``tick.*`` stage
   span (assemble, presort, dispatch, device, readback, resolve) — all
   beside the card's name and power limit.
8. Cluster flow control (``cluster_phase``).  The token column
   (``ops/token_col.py``, plain PyTorch: the reference has no kernel
   there) through two ``TokenColumnBatcher`` instances, one on the card
   and one on the CPU: 48 chunks of 256 entries over 1,024 flow slots with
   thresholds from the seed, Zipf(1.1) slots, partial / strict / forced
   entries, across bucket boundaries, and one re-projection halfway that
   drops 128 flows and adds 256 (recycled rows, growth to 2,048): granted,
   observed and every state leaf equal after every chunk; the chunk's ms
   (median), ``decide_batch`` alone by CUDA events, and the device
   launches and copies a chunk.  Then, once with ``use_token_column=True``
   and once with ``False`` (the decision client's engine): a threaded
   decision client on ``platform_config()`` with ``DefaultTokenService``
   and a ``ClusterTokenServer`` on 127.0.0.1, and a threaded serving
   client on ``platform_config()`` attached through
   ``ClusterStateManager.set_to_client`` (token timeout 1,000 ms,
   ``CLUSTER_REQUEST_TIMEOUT_MS``); 1,000 cluster flow rules (half
   GLOBAL, half AVG_LOCAL) and 32 cluster param rules; 480 ``entry()``
   calls from 8 threads, Zipf(1.1) over the ruled resources, one argument
   each, 10 % prioritized, then one ``check_batch`` call at B = 2,048.
   Checked: HELLO reached v2 (v3) and BATCH frames were counted; no flow
   was granted past its threshold in any window of the decision path
   other than by occupy-ahead (the server's decisions replayed with the
   time each was made at); no token call failed; the kernel counts of
   the run show B1, B2 and B4; stopping the server degrades the serving
   client to its local fallback rules (they block), restarting it brings
   the client back.  ``[cluster]`` lines: tokens/s, the decision round
   trip p50 / p99, the verdict counts, cluster tx / rx bytes, and the
   decision path's device launches a tick (a column call) and which of
   B1-B4 it launched, from a profile with the serving client idle.

9. The control plane (``control_phase``): a threaded serving client on
   ``platform_config()`` at the default widths with phase 3's rules, the
   flow rules pushed through a ``FileRefreshableDataSource`` into a
   ``DynamicSentinelProperty`` the flow manager is registered on; all
   100,000 names interned; 8 closed-loop request threads (Zipf(1.1), one
   argument from 10,000 values, 1 in 20 on the 50 hottest names from
   origin "bad", no prioritized entries); ``start_command_center`` on
   127.0.0.1 driven over real HTTP under that traffic: ``clusterNode``
   (every resource: all 100,000 must be listed), ``jsonTree``, ``origin``,
   ``topParams``, ``rtQuantiles``, ``systemStatus`` and ``getRules``,
   each command's round trip p50 / p99; ``MetricTimerListener.run_once``
   once a wall second for 5 s, then ``metric`` must serve back the
   written lines, line for line; ``update_window_shape(sample_count=4,
   window_ms=250)`` and a ``register_window_property`` push back to 2 x
   500 ms under the traffic (the whole swap's ms and the engine lock's
   hold; every DEFAULT flow resource's windowed pass within its threshold
   in snapshots around both swaps); ``setRules`` with a new 0 QPS rule,
   which must block the next entry; no entry lost, concurrency back to 0,
   B1, B2 and B4 launched; ``setSwitch=false`` (200 entries pass, no tick,
   no launch), then ``true``; one ``HeartbeatSender.send_once`` to a
   local receiver; the readers (``snapshot``, ``origin``, ``entry_node``,
   ``rt_quantiles``) on the card's state against a CPU copy of it at one
   frozen time, and ``snapshot``'s device ms (CUDA events), lock wait and
   hold, readback and dict ms at 100,000 resources.  Then bench.py's
   sketch configuration through a sync client with every one of the 2^20
   names interned and six client_bench blocks with their exits: the
   readers against a CPU copy (the sketch ids' estimates included) and
   ``snapshot``'s parts at ~1M sketch ids (``[control]`` lines).

10. Overload protection and the plain effects path (``overload_phase``).
   (a) The plain path at the default widths, B = 2,048:
   ``platform_config(fused_effects=False, seg_effects=False)`` and
   ``platform_config(use_mxu_tables=False)`` on a stream with counts of
   1-65,535, every tick held to the CPU's (readback verdicts and integers
   equal, float planes and float state within rtol 1e-6 / atol 1e-4,
   integer state equal; run under the sync-debug mode "error"); none of
   B1-B4 launched; ms a tick, device busy and device launches beside the
   fused path's on the same stream (counts clamped to 255).  (b)
   ``adaptive.simload.run_overload_sim`` with the controller on and off,
   on the card and on the CPU, in four processes of their own beside (a)
   and (c): each ``SimResult`` equal field for field; healthy and storm
   p99, goodput and the ladder's transitions.  (c) A threaded serving
   client on ``platform_config()`` with ``enable_adaptive()``, the
   watchdog armed, 8 request threads then a 2x burst (16 threads and a
   bulk feeder), deadlines on a quarter of the entries, the steady ticks
   under the sync-debug mode "error": shed counts by reason, the adaptive
   step's host µs, the ceiling's trajectory, B1 / B2 / B4 launched; then
   one 1.5 s stall through the ``runtime.watchdog.stall`` failpoint: the
   time to fail closed, ``sentinel_watchdog_fired_total`` up by exactly
   one, one fan-out (``[overload]`` lines).

Phases 2-5 run the segment paths with ``seg_fallback=False``, as PRs 1-9
measured them (``configs``; ``sketch_cfg`` is bench.py's ``build``, which
turns the fallback off).

``python3 chip_smoke.py --b2`` runs only B2's and probe_copy's numbers
against what they replaced (``b2_main``), with whatever package lies
beside the script: copied into an older checkout it measures that one.
``python3 chip_smoke.py --ops`` needs no card: it counts, on the CPU, the
PyTorch operations of one ``sketch`` tick with the sketch tier on and off
(``ops_main``).  ``python3 chip_smoke.py --cluster`` runs the build and
phase 8 alone (``cluster_main``), ``python3 chip_smoke.py --control`` the
build and phase 9 (``control_main``), ``python3 chip_smoke.py --overload``
the build and phase 10 (``overload_main``).

The last lines: the run's fuller numbers, every kernel shape included
(``[report] {...}``), the kernels' JSON record, the card's name and power
limit (nvidia-smi), and ``{"ok": true, "device": {...}}``.
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
#: entries per threaded main-path run
MAIN_ENTRIES = 3_000
#: distinct argument values of the hot-parameter traffic, Zipf(1.1)
N_VALUES = 10_000
#: kernels each configuration's tick must launch
PATH_KERNELS = {
    "fused": ("scatter_many", "gather_many"),
    "seg4": ("scatter_many", "gather_many", "seg_incl_min"),
    "seg1": ("scatter_many", "seg_excl_cumsum", "seg_incl_min"),
    "fused1": ("scatter_many", "gather_many"),
    # bench.py's build: the segment check phase and the sketch tier (B1's
    # sketch{d} jobs, B3's tail rank), single lanes
    "sketch": ("scatter_many", "seg_excl_cumsum", "seg_incl_min"),
}
#: (source, Pallas function it replaces) per kernel
KERNEL_SRC = {
    "scatter_many": ("sentinel_tpu_torch/csrc/fused.cu", "sentinel_tpu/ops/fused.py:186"),
    "gather_many": ("sentinel_tpu_torch/csrc/fused.cu", "sentinel_tpu/ops/fused.py:374"),
    "seg_excl_cumsum": ("sentinel_tpu_torch/csrc/segscan.cu", "sentinel_tpu/ops/segscan.py:81"),
    "seg_incl_min": ("sentinel_tpu_torch/csrc/segscan.cu", "sentinel_tpu/ops/segscan.py:165"),
    "probe_copy": ("sentinel_tpu_torch/csrc/probes.cu",
                   "benchmarks/probe_pallas_floor.py:49, benchmarks/probe_pallas_floor2.py:45"),
    "probe_hist_count": ("sentinel_tpu_torch/csrc/probes.cu",
                         "benchmarks/probe_pallas_floor.py:68, benchmarks/probe_pallas_floor.py:151"),
    "probe_hist_planes": ("sentinel_tpu_torch/csrc/probes.cu",
                          "benchmarks/pallas_histogram.py:44, benchmarks/probe_pallas_floor.py:106"),
    "probe_hist_stat5": ("sentinel_tpu_torch/csrc/probes.cu",
                         "benchmarks/probe_fused_hist.py:78, benchmarks/probe_fused_hist2.py:59"),
}
#: the kernels of the probe run (phase 5)
PROBE_KERNELS = ("probe_copy", "probe_hist_count", "probe_hist_planes", "probe_hist_stat5")
#: kernel -> (commit, device ms a call) of its design before the last
#: redesign, at its phase-2 (seg4, B = 2,048) or phase-5 shape, printed
#: beside this run's time.  The valued histograms at 923866b (a memset,
#: then float atomics in L2): this file's probe_calls against that commit's
#: package, the mean of two runs.  B2 (a dense [node_rows, 3] table built
#: by the tick, one thread an (item, plane); its ``table alone`` call on
#: seg4) and probe_copy (4-byte accesses) at 3441415: ``--b2`` from a copy
#: of this file in that commit's checkout, two runs in one call (B2 0.0065
#: and 0.0064; probe_copy 0.0062 in both turns of the first run).  All on
#: an NVIDIA H100 80GB HBM3 at 700 W.
EARLIER_MS = {"gather_many": ("3441415", 0.0065), "probe_copy": ("3441415", 0.0062),
              "probe_hist_count": ("923866b", 0.0100), "probe_hist_planes": ("923866b", 0.0169),
              "probe_hist_stat5": ("923866b", 0.0277)}
#: device launches a B = 2,048 tick in phase 4's profile at commit 71b3c5a
#: (NVIDIA H100 80GB HBM3, 700 W), before B2 read the state's columns
EARLIER_LAUNCHES = {"fused": 1454, "seg4": 1706, "seg1": 1560.75}
#: the configuration whose main-path run and B = 2,048 shapes each kernel's
#: JSON record reports (the default platform_config() where it runs)
RECORD_CFG = {"scatter_many": "seg4", "gather_many": "seg4", "seg_excl_cumsum": "seg1", "seg_incl_min": "seg4"}


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


def launch_breakdown(fn, reps: int = 5, flush_bytes: int = 64 << 20) -> list:
    """Device time of each kernel (or memset) one call of ``fn`` launches,
    from ``torch.profiler``'s CUDA activity over ``reps`` calls, each after
    an L2 flush and queued behind a ``torch.cuda._sleep``: [(name, launches
    a call, device ms a call), ...] in launch order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    # a session now and then records no device activity on the card, or
    # only part of it (a kernel recorded in 3 of 5 identical calls): such a
    # session is taken again, up to 5 in all; the first whole one counts,
    # else the one with the most device events (a call that truly launches
    # a varying number of kernels does so in every session)
    best = []
    for _session in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scratch.fill_(1)
                torch.cuda._sleep(200_000)
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and "fill" not in e.name.lower() and "spin" not in e.name.lower()),
                     key=lambda e: e.time_range.start)
        counts = {}
        for e in evs:
            counts[e.name] = counts.get(e.name, 0) + 1
        if evs and all(n % reps == 0 for n in counts.values()):
            best = evs
            break
        if len(evs) > len(best):
            best = evs
    evs = best
    check(evs, "launch breakdown: the profiler saw no device event in 5 sessions")
    out = {}
    for e in evs:
        n, us = out.get(e.name, (0, 0.0))
        out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return [(name, n / reps, us / reps / 1e3) for name, (n, us) in out.items()]


def host_breakdown(fn, reps: int = 20, top: int = 8) -> tuple:
    """(wall ms a call, [(function, own ms a call), ...]) of ``fn`` on the
    host: the median wall time of ``reps`` plain calls, then cProfile's own
    time per function (a ctypes call counts as its Python caller's own
    time) over ``reps`` more, largest first."""
    import cProfile
    import pstats

    import torch

    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        wall.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(((f"{os.path.basename(f)}:{fname}" if f != "~" else fname, tt / reps * 1e3)
                   for (f, _line, fname), (_cc, _nc, tt, _ct, _callers) in pstats.Stats(prof).stats.items()),
                  key=lambda r: -r[1])
    return sorted(wall)[len(wall) // 2] * 1e3, rows[:top]


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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


# -- phase 2: what each kernel moves, does, and is timed against -------------------


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


def strided_copy(torch, t):
    """A copy of ``t`` with its size and strides (``clone`` of a column view
    such as ``run[:, EV_PASS]`` would make it contiguous)."""
    return None if t is None else torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                                      device=t.device).copy_(t)


def gather_job_copy(FU, torch, j):
    """A gather job whose tensors are copies that keep every stride."""
    table = (strided_copy(torch, j.table) if isinstance(j.table, torch.Tensor)
             else tuple(c._replace(src=strided_copy(torch, c.src), guard=strided_copy(torch, c.guard))
                        for c in j.table))
    return j._replace(ids=strided_copy(torch, j.ids), table=table)


def kernel_ops(FU, SC, torch):
    """wrapper function -> (kernel call, plain call, work(args) -> (bytes,
    ops), PyTorch call or None, unsegmented-scan floor call or None), each
    on one captured argument tuple."""

    def gather_work(jobs):
        """4 B an id; for each unique live row, 4 B of each column read
        (guards included); 4 B of output an (item, plane)."""
        nbytes = ops = 0
        for j in jobs:
            n, cols = FU._columns(j)
            reads = len(cols) + sum(c.guard is not None for c in cols)
            uniq = torch.unique(j.ids[(j.ids >= 0) & (j.ids < n)]).numel()
            nbytes += 4 * j.ids.numel() + 4 * uniq * reads + 4 * j.ids.numel() * len(cols)
            ops += j.ids.numel() * len(cols)
        return nbytes, ops

    def gather_library(jobs):
        """``index_select`` of the ids' rows from the stacked [n, P] table
        (the dense table the tick built before; its building is set-up)."""
        def dense(c):
            v = c.src if c.guard is None else torch.where(c.guard == c.key, c.src, 0)
            return torch.clamp_max(v.round().to(torch.int32) if v.is_floating_point() else v, c.cap)

        j = jobs[0]
        n, cols = FU._columns(j)
        stacked = torch.stack([dense(c) for c in cols], dim=1)
        ids64 = torch.clamp(j.ids, 0, n - 1).to(torch.int64)
        return lambda: torch.index_select(stacked, 0, ids64)

    def rows_of(args):
        return [a for a in args[1:] if a is not None]

    def scan_work(args):
        head = args[0]
        n = sum(v.numel() for v in rows_of(args))
        # head read once (1 B an item), values read once, the result written once;
        # one combine per value
        return head.numel() + 4 * n + 4 * n, n

    def cumsum_floor(args):
        v = torch.cat([r.reshape(-1, r.shape[-1]) for r in rows_of(args)])
        return lambda: torch.cumsum(v, dim=-1)

    def listed(out):
        return [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]

    return {
        "scatter_many": (lambda a: FU.scatter_many(a[0]), lambda a: FU.scatter_many_plain(a[0]),
                         lambda a: scatter_work(a[0]), lambda a: scatter_library_call(a[0]), None),
        "gather_many": (lambda a: FU.gather_many(a[0]), lambda a: FU.gather_many_plain(a[0]),
                        lambda a: gather_work(a[0]), lambda a: gather_library(a[0]), None),
        "seg_excl_cumsum": (lambda a: [SC.seg_excl_cumsum(*a)], lambda a: [SC.seg_excl_cumsum_plain(*a)],
                            scan_work, None, cumsum_floor),
        "seg_excl_cumsum_many": (lambda a: listed(SC.seg_excl_cumsum_many(*a)),
                                 lambda a: listed(SC.seg_excl_cumsum_many_plain(*a)), scan_work, None, cumsum_floor),
        "seg_incl_min": (lambda a: [SC.seg_incl_min(*a)], lambda a: [SC.seg_incl_min_plain(*a)],
                         scan_work, None, cumsum_floor),
    }


def scatter_edge_jobs(FU, np, torch):
    """B1 edge inputs, name -> job list: ids -1 / 2**30 / n, values at and
    above 256**digits, an empty job, N not a multiple of the 256-thread
    block; 200 row-vectors in one job (more than the first version's 48 a
    launch); every item on one row (warp aggregation, in global memory and
    in a shared-memory table); digits 4 with values of both signs whose
    running sums return to 0 (the double-convert trap); N = 1 with an empty
    job; 20 jobs (past the 16 one launch carries); operands read
    where they lie (transposed int64 rows, permuted uint8 values, an
    expanded row)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED + 7)
    N = 2048 + 37

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)

    rows = ints(-2, 70_002, (3, N))
    rows[:, :3] = torch.tensor([-1, 2**30, 70_000], dtype=torch.int32, device="cuda")
    vals = ints(0, 1 << 20, (3, N))
    vals[:, :4] = torch.tensor([255, 256, 65535, 65536], dtype=torch.int32, device="cuda")
    one_row = torch.zeros((1, N), dtype=torch.int32, device="cuda")
    signed = torch.as_tensor(np.tile([5, -5, 7, -7, 3], N // 5 + 1)[:N].astype(np.int32)).cuda()
    back_to_zero = torch.as_tensor(np.tile([9, -9], N // 2 + 1)[:N].astype(np.int32)).cuda()
    return {
        "mixed": [
            FU.Job("wide", 70_000, rows, vals, (1, 2, 3)),
            FU.Job("small", 900, ints(-3, 903, (4, N)), ints(0, 600, (4, 3, N)), (1, 1, 2)),
            FU.Job("empty", 0, ints(-1, 3, (1, N)), ints(0, 9, (1, N)), (1,)),
        ],
        "many units": [FU.Job("many", 5000, ints(-1, 5001, (200, N)), ints(0, 300, (2, N)), (1, 2))],
        "one hot row": [FU.Job("hot", 100_000, one_row + 7, ints(0, 256, (2, N)), (1, 1)),
                        FU.Job("hot_small", 40, one_row + 3, ints(0, 1 << 12, (3, N)), (3, 3, 3))],
        "returns to zero": [FU.Job("ret", 100_000, one_row + 11, torch.stack([signed, back_to_zero]), (4, 4)),
                            FU.Job("ret_small", 16, ints(0, 4, (1, N)), torch.stack([back_to_zero] * 2), (4, 4)),
                            FU.Job("spread", 100_000, ints(0, 3, (2, N)), signed[None, :], (4,))],
        "one item and an empty job": [FU.Job("one", 30, ints(0, 30, (2, 1)), ints(0, 9, (2, 1)), (1, 1)),
                                      FU.Job("empty", 0, ints(-1, 3, (1, 1)), ints(0, 9, (1, 1)), (1,))],
        "many jobs": [FU.Job(f"j{i}", 50 + i, ints(-1, 60, (1, 300)), ints(0, 200, (1, 300)), (1,))
                      for i in range(20)],
        "strided operands": [
            FU.Job("t", 70_000, torch.as_tensor(rng.integers(-1, 70_001, (N, 3))).cuda().T,
                   ints(0, 1 << 16, (N, 2)).T, (2, 1)),
            FU.Job("u8", 900, ints(-1, 901, (4, N)),
                   torch.as_tensor(rng.integers(0, 256, (3, 4, N)).astype(np.uint8)).cuda().permute(1, 0, 2),
                   (1, 1, 1)),
            FU.Job("bcast", 64, ints(0, 64, (1, 1)).expand(2, N), ints(0, 9, (1, N)), (1,)),
        ],
    }


def edge_cases(FU, np, torch):
    """B1 and B2 on their edge inputs; B1's calls must each launch twice
    (three times for 20 jobs: a scatter a chunk of 16, one conversion) and
    leave its scratch all zero; B2's once a chunk of 8 jobs, never for N =
    0."""
    err = 0.0
    for case, jobs in scatter_edge_jobs(FU, np, torch).items():
        FU.reset_launches()
        got = FU.scatter_many(jobs)
        check(FU.LAUNCHES["scatter_many"] == (3 if case == "many jobs" else 2),
              f"scatter_many {case}: {FU.LAUNCHES['scatter_many']} launches")
        err = max(err, check_equal(f"scatter_many edge case {case}", got, FU.scatter_many_plain(jobs)))
    check(all(not a.any() and not t.any() for a, t in FU._SCRATCH.values()),
          "scatter_many left its accumulator or bitmap nonzero")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    N = 2048 + 37

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)

    table = ints(0, 2**31 - 1, (5000, 3))
    ids = ints(-3, 5003, (N,))
    ids[:3] = torch.tensor([-1, 2**30, 5000], dtype=torch.int32, device="cuda")
    gj = [FU.GatherJob("t", ids, table, (3, 2, 1)), FU.GatherJob("u", ids[:N], table[:17], (4, 3, 3))]
    gj += [FU.GatherJob(f"x{i}", ids, table[: 100 * i + 1], (i % 4 + 1,) * 3) for i in range(FU._MAX_GATHER_JOBS)]
    FU.reset_launches()
    err2 = check_equal("gather_many edge cases", FU.gather_many(gj), FU.gather_many_plain(gj))
    check(FU.LAUNCHES["gather_many"] == 2, f"gather_many, {len(gj)} jobs: {FU.LAUNCHES['gather_many']} launches")
    # the column form: the flow read's columns (run[:, 0] at stride 5, values
    # over the cap, float tokens with .5 ties guarded by an epoch whose key is
    # the int32 wrap of 2^31), unguarded columns, N off the 2 items a thread,
    # N = 1 and 0, misaligned ids
    cap, key, n = (1 << 24) - 1, -(2**31), 5000
    run = ints(0, 1 << 26, (n, 5))
    tokens = ints(0, 4000, (n,)).float() / 2
    epoch = torch.where(ints(0, 2, (n,)) > 0, key, key + 1).to(torch.int32)
    guarded = (FU.GatherColumn(run[:, 0], cap), FU.GatherColumn(ints(0, 1 << 26, (n,)), cap),
               FU.GatherColumn(tokens, cap, epoch, key))
    unguarded = (FU.GatherColumn(tokens, 1000), FU.GatherColumn(run[:, 3]))
    for N in (8192, 2048 + 37, 133, 3, 1, 0):
        ids = ints(-3, n + 3, (max(N, 3),))
        ids[:3] = torch.tensor([-1, n, 2**30], dtype=torch.int32, device="cuda")
        for name, i in (("", ids[:N]), (", misaligned ids", ints(0, n, (N + 1,))[1:])):
            jobs = [FU.GatherJob("flow", i, guarded, (3, 3, 3)), FU.GatherJob("f", i, unguarded, (2, 4))]
            FU.reset_launches()
            err2 = max(err2, check_equal(f"gather_many columns N={N}{name}", FU.gather_many(jobs),
                                         FU.gather_many_plain(jobs)))
            check(FU.LAUNCHES["gather_many"] == (1 if N else 0),
                  f"gather_many columns N={N}{name}: {FU.LAUNCHES['gather_many']} launches")
    return {"scatter_many": err, "gather_many": err2}


def scan_edge_cases(SC, SG, np, torch):
    """B3/B4 edge inputs: N of 1, 255, 2,049 (one past a tile: the carry
    pass) and 131,072; dense, sparse, all-true and first-only heads; B3
    row totals just under 2^31; the wide form with segment totals past
    2^31; B4 with absent items at 3.0e38."""
    rng = np.random.default_rng(SEED)
    e3 = e4 = 0.0
    for n in (1, 255, 2049, 131_072):
        for kind in ("dense", "sparse", "all", "first"):
            h = {"dense": rng.random(n) < 0.5, "sparse": rng.random(n) < 0.01,
                 "all": np.ones(n, bool), "first": np.zeros(n, bool)}[kind]
            h[0] = True
            head = torch.as_tensor(h).cuda()
            v = rng.integers(0, (2**31 - 1) // n + 1, (2, n)).astype(np.int32)
            v[:, -1] = (2**31 - 1) // n  # row totals at the int32 edge
            v = torch.as_tensor(v).cuda()
            e3 = max(e3, check_equal(f"seg_excl_cumsum N={n} {kind}", [SC.seg_excl_cumsum(head, v)],
                                     [SC.seg_excl_cumsum_plain(head, v)]))
            w = torch.as_tensor(np.full(n, (1 << 24) - 1, np.int32)).cuda()
            got = SC.seg_excl_cumsum_wide(head, w)
            e3 = max(e3, check_equal(f"seg_excl_cumsum_wide N={n} {kind}", [got], [SG.seg_excl_cumsum_wide(head, w)]))
            if n == 131_072 and kind == "first":
                check(got.max().item() > 2**31, "the wide edge case did not pass 2^31")
            # narrow and wide rows in ONE launch; over one segment a wide row
            # of int32 values of both signs, outside the contract, gives the
            # plain version's bits too (the plain version's cumsum minus the
            # running maximum of segment bases is a segmented sum only while
            # its cumulative sums rise, or over one segment)
            odd = rng.integers(-(2**31), 2**31 - 1, n) if kind == "first" else rng.integers(0, 1 << 24, n)
            wide = torch.stack([w, torch.as_tensor(odd.astype(np.int32)).cuda()])
            e3 = max(e3, check_equal(f"seg_excl_cumsum_many N={n} {kind}",
                                     list(SC.seg_excl_cumsum_many(head, v, wide)),
                                     list(SC.seg_excl_cumsum_many_plain(head, v, wide))))
            f = (rng.integers(1, 4000, n) / 8.0).astype(np.float32)
            f[rng.random(n) < 0.2] = 3.0e38
            f = torch.as_tensor(f).cuda()
            e4 = max(e4, check_equal(f"seg_incl_min N={n} {kind}", [SC.seg_incl_min(head, f)],
                                     [SC.seg_incl_min_plain(head, f)]))
    return {"seg_excl_cumsum": e3, "seg_incl_min": e4}


# -- configurations, rules, traffic --------------------------------------------------


def zipf_probs(np, n, s=1.1):
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def configs(platform_config, seg_fallback=False):
    """Phases 2-4's configurations: the segment paths without the per-tick
    fallback (``seg_fallback=False``), as PRs 1-9 measured them; the
    fallback phase passes ``seg_fallback=True``, platform_config()'s own."""
    single = dict(flow_rules_per_resource=1, degrade_rules_per_resource=1, param_rules_per_resource=1)
    seg = dict(packed_wire=True, seg_fallback=seg_fallback)
    return {
        "fused": platform_config(seg_effects=False, packed_wire=True),
        "seg4": platform_config(**seg),
        "seg1": platform_config(**seg, **single),
        # the per-item fused path at seg1's single lanes: what seg1's burst
        # is compared with (the same 16 param rules survive the compile)
        "fused1": platform_config(seg_effects=False, packed_wire=True, **single),
    }


def build_rules(st):
    """4,000 flow rules, one per resource (every 100th a rate limiter,
    every 100th + 50 a warm-up; all DIRECT with the default limitApp),
    1,000 degrade rules (error count and slow ratio), one authority black
    list, one system QPS rule, and 32 param rules, two on each of the 16
    hottest resources, both reading the entry's one argument: QPS grade
    over 1 s and over 2 s (two window classes), every fourth a THREAD-grade
    rule, each with one exception item that gives the second-hottest value
    a larger budget.  With single lanes the compile keeps the first rule of
    each resource: 16."""
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
    param = []
    for i in range(16):
        name = f"res-{i}"
        vip = [st.ParamFlowItem(object=arg_value(1), count=5)]
        thread = st.ParamFlowRule(resource=name, count=1, grade=st.GRADE_THREAD, param_flow_item_list=vip)
        first = st.ParamFlowRule(resource=name, count=1, duration_in_sec=1 + i % 2, param_flow_item_list=vip)
        second = st.ParamFlowRule(resource=name, count=2, duration_in_sec=2 - i % 2, param_flow_item_list=vip)
        param += [thread, second] if i % 4 == 3 else [first, thread] if i % 4 == 1 else [first, second]
    return flow, degrade, authority, system, param


def arg_value(k) -> str:
    """The k-th argument value (a user or product id as ``args[0]``)."""
    return f"user-{int(k)}"


# -- phase 3: the main paths ------------------------------------------------------------

#: the device telemetry row's verdict counters (the port's registry) by the
#: outcome name phase 3's request threads record
FOLDED = {"pass": "pass", "pass_wait": "pass_wait", "AuthorityException": "block_authority",
          "SystemBlockException": "block_system", "ParamFlowException": "block_param",
          "FlowException": "block_flow", "DegradeException": "block_degrade"}


def folded_verdicts() -> dict:
    """outcome name -> the value of its sentinel_device_verdicts_total series"""
    from sentinel_tpu_torch.obs.registry import REGISTRY

    out = {}
    for kind, label in FOLDED.items():
        m = REGISTRY.get("sentinel_device_verdicts_total", {"verdict": label})
        out[kind] = 0 if m is None else m.value
    return out



def drive_main_path(st, np, FU, SC, torch, cfg, n_entries):
    client = st.init(cfg=cfg, device="cuda", mode="threaded", entry_timeout_s=30.0)
    flow, degrade, authority, system, param = build_rules(st)
    st.load_flow_rules(flow)
    st.load_degrade_rules(degrade)
    st.load_authority_rules(authority)
    st.load_system_rules(system)
    st.load_param_flow_rules(param)
    probs = zipf_probs(np, N_NAMES)
    vprobs = zipf_probs(np, N_VALUES)
    names = [f"res-{i}" for i in range(N_NAMES)]
    counts = {}
    lock = threading.Lock()
    done = [0]
    errors = []

    def worker(tid):
        rng = np.random.default_rng(SEED + tid)
        local = {}
        picks = rng.choice(N_NAMES, size=n_entries // N_THREADS + 64, p=probs)
        values = rng.choice(N_VALUES, size=picks.size, p=vprobs)
        for k, v in zip(picks, values):
            name = names[k]
            args = [arg_value(v)]
            try:
                if rng.random() < 0.05:
                    e = client.entry(name, origin="bad", inbound=bool(rng.random() < 0.5), args=args)
                else:
                    e = st.entry(name, prioritized=bool(rng.random() < 0.05), args=args)
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

    folded0 = folded_verdicts()
    FU.reset_launches()
    SC.reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "request threads still running after 600 s")
    # the last exits ride one more tick
    deadline = time.perf_counter() + 30
    while client._has_work() and time.perf_counter() < deadline:
        time.sleep(0.01)
    check(not client._has_work(), "queued work not drained within 30 s")
    client.tick_once()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    folded = {k: v - folded0[k] for k, v in folded_verdicts().items()}
    cov = client.explain_coverage()
    info = dict(seg_static_ranks=client.cfg.seg_static_ranks, seg_u=client.cfg.seg_u,
                seg_dropped_total=client.seg_dropped_total, features=sorted(client._features),
                param_rules=int(client._rules_dev.param.enabled.sum().item()),
                pconc_after_exits=int(client._state.pconc.sum().item()),
                pcms_total=int(client._state.pcms.sum().item()),
                wire_decode_failures=client.wire_decode_failures, folded_verdicts=folded,
                explain_coverage=cov, explain_top_causes=client.explain_top_causes(3),
                timeline_rows=len(client.timeline.find(None, 0, 2**62)))
    if errors:
        raise errors[0]
    st.reset()
    return counts, done[0], elapsed, launches, info


#: entries of the extension-point runs (one request thread, a stepped clock)
EXT_ENTRIES = 400


def drive_extension_points(st, np, torch, cfg):
    """Phase 3's threaded client twice on one seeded script: plain, and with
    a no-op entry hook, a no-op custom slot and a no-op metric extension
    loaded.  One request thread and a stepped clock (not a virtual one, so
    the client keeps its tick thread) make both runs deterministic: every
    entry's tick and the tick that lands its exits run at the same engine
    time in both (the request thread ticks the exits in before it moves
    the clock).
    Returns both runs' verdicts and the callback counts of the second."""
    from sentinel_tpu_torch.metrics import extension as MEXT
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.runtime.slots import ProcessorSlot
    from sentinel_tpu_torch.utils.time_source import TimeSource

    class SteppedClock(TimeSource):
        """Engine time that moves only when the request thread moves it
        (a pacing wait moves it too)."""

        def __init__(self):
            super().__init__()
            self._now = 1_000

        def now_ms(self):
            return self._now

        def sleep_ms(self, ms):
            self._now += int(ms)

    calls = {}

    def bump(k):
        calls[k] = calls.get(k, 0) + 1

    class NoopSlot(ProcessorSlot):
        def on_entry(self, ctx):
            bump("slot_entry")

        def on_exit(self, ctx):
            bump("slot_exit")

    class NoopExtension(MEXT.MetricExtension):
        def on_pass(self, *a):
            bump("on_pass")

        def on_block(self, *a):
            bump("on_block")

        def on_complete(self, *a):
            bump("on_complete")

    def run(loaded):
        client = SentinelClient(cfg=cfg, device="cuda", mode="threaded", time_source=SteppedClock(),
                                entry_timeout_s=30.0)
        client.start()
        flow, degrade, authority, system, param = build_rules(st)
        client.flow_rules.load(flow)
        client.degrade_rules.load(degrade)
        client.authority_rules.load(authority)
        client.system_rules.load(system)
        client.param_flow_rules.load(param)
        ext = NoopExtension()
        if loaded:
            client.entry_hooks.append(lambda resource, origin, args: bump("hook"))
            client.slots.register(NoopSlot())
            MEXT.register_extension(ext)
        rng = np.random.default_rng(SEED + 7)
        picks = rng.choice(N_NAMES, size=EXT_ENTRIES, p=zipf_probs(np, N_NAMES))
        values = rng.choice(N_VALUES, size=EXT_ENTRIES, p=zipf_probs(np, N_VALUES))
        out, held = [], []
        try:
            for k, v in zip(picks, values):
                try:
                    e = client.entry(f"res-{k}", args=[arg_value(v)], origin="bad" if rng.random() < 0.05 else None)
                    out.append(("pass", e.wait_ms))
                    held.append(e)
                except st.BlockException as exc:
                    out.append((type(exc).__name__, 0))
                client.time._now += int(rng.integers(0, 6))
                while held and rng.random() < 0.7:
                    e = held.pop(int(rng.integers(0, len(held))))
                    if rng.random() < 0.05:
                        e.trace(RuntimeError("business error"))
                    e.exit()
                client.tick_once()  # the exits land before the clock moves
            for e in held:
                e.exit()
            client.tick_once()
            torch.cuda.synchronize()
        finally:
            MEXT.unregister_extension(ext)
            client.stop()
        return out

    plain = run(False)
    loaded = run(True)
    return plain, loaded, calls


def drive_burst(st, np, FU, SC, cfg, rules):
    """One open-loop burst through a sync client: a full batch of Zipf
    acquires queued before ONE tick, the exits of those that passed (whole
    ms RTs, 5 % business errors) in the next tick, a second burst in the
    third.  Returns the (verdict, wait) of every acquire, the kernel
    launches of the three ticks and the client's record: its segment
    capacity and the wall ms of each ``tick_once`` (batch build, presort,
    upload, tick, readback, unsort, futures)."""
    from concurrent.futures import Future

    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.runtime.client import AcquireRequest, Completion, SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    client = SentinelClient(cfg=cfg, time_source=VirtualTimeSource(1_000), mode="sync", device="cuda")
    client.start()
    flow, degrade, authority, system, param = rules
    client.flow_rules.load(flow)
    client.degrade_rules.load(degrade)
    client.authority_rules.load(authority)
    client.system_rules.load(system)
    client.param_flow_rules.load(param)
    rng = np.random.default_rng(SEED + 100)
    probs = zipf_probs(np, N_NAMES)
    vprobs = zipf_probs(np, N_VALUES)
    trash = client.cfg.trash_row
    B = client.cfg.batch_size

    tick_ms = []

    def tick():
        t = time.perf_counter()
        client.tick_once()
        tick_ms.append((time.perf_counter() - t) * 1e3)

    def burst():
        reqs = []
        for k, p, v in zip(rng.choice(N_NAMES, size=B, p=probs), rng.random(B) < 0.05,
                           rng.choice(N_VALUES, size=B, p=vprobs)):
            rid = client.registry.resource_id(f"res-{k}")
            check(rid is not None, "burst: the registry ran out of resource rows")
            reqs.append(AcquireRequest(res=rid, count=1, prio=int(p), origin_id=-1, origin_node=trash,
                                       ctx_node=trash, ctx_name=-1, inbound=0, future=Future(),
                                       param_hash=client.param_hashes(f"res-{k}", [arg_value(v)])))
        with client._lock:
            client._acquires.extend(reqs)
        tick()
        return reqs, [r.future.result(timeout=60) for r in reqs]

    FU.reset_launches()
    SC.reset_launches()
    reqs, first = burst()
    client.time.advance(40)
    comps = [Completion(res=r.res, origin_node=trash, ctx_node=trash, inbound=0, rt=float(rng.integers(1, 80)),
                        success=1, error=int(rng.random() < 0.05), param_hash=r.param_hash)
             for r, (v, _w) in zip(reqs, first) if v in (ERR.PASS, ERR.PASS_WAIT)]
    client.mode = "threaded"  # queue the exits on the completion ring for ONE tick
    for c in comps:
        client._submit_completion(c)
    client.mode = "sync"
    tick()
    client.time.advance(40)
    _, second = burst()
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    info = dict(seg_u=client.cfg.seg_u, peak_segments=client._seg_obs_peak,
                seg_dropped_total=client.seg_dropped_total, exits=len(comps), tick_ms=tick_ms,
                param_rules=int(client._rules_dev.param.enabled.sum().item()))
    client.stop()
    return first + second, launches, info


def sketch_counters() -> dict:
    """The hot-set manager's promotion / demotion counters (the port's
    registry)."""
    from sentinel_tpu_torch.obs.registry import REGISTRY

    out = {}
    for k in ("promotions", "promotion_failures", "demotions"):
        m = REGISTRY.get(f"sentinel_sketch_{k}_total")
        out[k] = 0 if m is None else m.value
    return out


def load_sketch_rules(client, st):
    """bench.py's names through the registry and its rules through the
    client's managers, as client_bench does (bench.py:360-400): the rule
    loads promote ruled sketch-id resources into the reserve rows until it
    is spent.  Returns the tail-ruled names left on sketch ids."""
    intern_bench_names(client.registry)
    flow, degrade, authority, system, param = sketch_rules(st)
    client.flow_rules.load(flow)
    client.degrade_rules.load(degrade)
    client.param_flow_rules.load(param)
    client.authority_rules.load(authority)
    client.system_rules.load(system)
    reg = client.registry
    return [f"tail-{r}" for r in range(N_TAIL_RULED) if reg.is_sketch_id(reg.peek_resource_id(f"tail-{r}"))]


def drive_sketch_main(st, np, FU, SC, torch, cfg, n_entries):
    """The sketch configuration through a threaded client: bench.py's
    names and rules through the registry and the managers, 8 request
    threads drawing bench.py's Zipf(1.3) over 2^20 names (1/8 with the
    peer-app origin, 1/2 inbound, an argument on res-1 .. res-128), and
    HAMMER_THREADS more putting HAMMER back-to-back acquires in all on a
    tail-ruled name still on its sketch id (each thread waits for its
    verdicts, so together they outrun the rule's 20 a second)."""
    client = st.init(cfg=cfg, device="cuda", mode="threaded", entry_timeout_s=30.0)
    sk0 = sketch_counters()
    tail_left = load_sketch_rules(client, st)
    check(tail_left, "every tail-ruled name was promoted: nothing is left for the tail tables")
    target = tail_left[-1]
    counts, lock, done, errors = {}, threading.Lock(), [0], []

    def record(local, hammered=False):
        with lock:
            for k, v in local.items():
                counts[k] = counts.get(k, 0) + v
                if hammered:
                    counts[f"hammer {k}"] = counts.get(f"hammer {k}", 0) + v
            if not hammered:
                done[0] += sum(local.values())

    def worker(tid):
        rng = np.random.default_rng(SEED + 200 + tid)
        local = {}
        raws = (rng.zipf(1.3, size=n_entries // N_THREADS + 64) - 1) % (N_TOTAL - 1) + 1
        for raw in raws:
            try:
                e = client.entry(bench_name(int(raw)), origin="peer-app" if rng.random() < 0.125 else None,
                                 inbound=bool(rng.random() < 0.5),
                                 args=[int(rng.integers(1, 1 << 20))] if raw <= 128 else None)
                e.exit()
                kind = "pass" if not e.wait_ms else "pass_wait"
            except st.BlockException as exc:
                kind = type(exc).__name__
            except Exception as exc:  # recorded and re-raised after join
                errors.append(exc)
                return
            local[kind] = local.get(kind, 0) + 1
        record(local)

    def hammer():
        local = {}
        for _ in range(HAMMER // HAMMER_THREADS):
            try:
                e = client.entry(target)
                e.exit()
                kind = "pass" if not e.wait_ms else "pass_wait"
            except st.BlockException as exc:
                kind = type(exc).__name__
            except Exception as exc:
                errors.append(exc)
                return
            local[kind] = local.get(kind, 0) + 1
        record(local, hammered=True)

    folded0 = folded_verdicts()
    FU.reset_launches()
    SC.reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(N_THREADS)]
    threads += [threading.Thread(target=hammer) for _ in range(HAMMER_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "request threads still running after 600 s")
    deadline = time.perf_counter() + 30
    while client._has_work() and time.perf_counter() < deadline:
        time.sleep(0.01)
    client.tick_once()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    folded = {k: v - folded0[k] for k, v in folded_verdicts().items()}
    sk = {k: v - sk0[k] for k, v in sketch_counters().items()}
    reg = client.registry
    info = dict(seg_static_ranks=client.cfg.seg_static_ranks, seg_u=client.cfg.seg_u,
                seg_dropped_total=client.seg_dropped_total, features=sorted(client._features),
                tail_names_left_on_sketch_ids=len(tail_left), hammered=target,
                hot_candidates=len(client.hotset._cand), hot_candidate_ids_sketch=all(
                    reg.is_sketch_id(r) for r in client.hotset._cand),
                sketch_ids_interned=reg._next_sketch - client.cfg.node_rows,
                promotions=sk["promotions"], promotion_failures=sk["promotion_failures"],
                demotions=sk["demotions"], manager_promoted=len(client.hotset.promoted),
                wire_decode_failures=client.wire_decode_failures, folded_verdicts=folded,
                explain_coverage=client.explain_coverage())
    st.reset()
    return counts, done[0], elapsed, launches, info


def drive_sketch_burst(st, np, FU, SC, cfg):
    """Two open-loop bursts of a full batch through a sync client on the
    sketch configuration, as drive_burst: bench.py's names (Zipf(1.3) over
    2^20, half inbound, an argument on res-1 .. res-128) plus HAMMER
    acquires on a tail-ruled name left on its sketch id, the exits of
    those that passed in the tick between.  No origins: the segment
    client presorts by origin within a resource, so with them the two
    clients would rank a resource's items in different orders."""
    from concurrent.futures import Future

    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.runtime.client import AcquireRequest, Completion, SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    client = SentinelClient(cfg=cfg, time_source=VirtualTimeSource(1_000), mode="sync", device="cuda")
    client.start()
    tail_left = load_sketch_rules(client, st)
    target = tail_left[-1]
    reg = client.registry
    rng = np.random.default_rng(SEED + 300)
    trash = client.cfg.trash_row
    B = client.cfg.batch_size
    tick_ms = []

    def tick():
        t = time.perf_counter()
        client.tick_once()
        tick_ms.append((time.perf_counter() - t) * 1e3)

    def burst():
        raws = (rng.zipf(1.3, size=B - HAMMER) - 1) % (N_TOTAL - 1) + 1
        names = [bench_name(int(r)) for r in raws] + [target] * HAMMER
        reqs = []
        for name, inb, v in zip(names, rng.random(B) < 0.5, rng.integers(1, 1 << 20, B)):
            rid = reg.resource_id(name)
            reqs.append(AcquireRequest(
                res=rid, count=1, prio=0, origin_id=-1, origin_node=trash, ctx_node=trash, ctx_name=-1,
                inbound=int(inb), future=Future(),
                param_hash=client.param_hashes(name, [int(v)]) if rid <= 128 else ()))
        with client._lock:
            client._acquires.extend(reqs)
        tick()
        return reqs, [r.future.result(timeout=60) for r in reqs]

    FU.reset_launches()
    SC.reset_launches()
    reqs, first = burst()
    client.time.advance(40)
    comps = [Completion(res=r.res, origin_node=trash, ctx_node=trash, inbound=r.inbound,
                        rt=float(rng.integers(1, 8)), success=1, error=0, param_hash=r.param_hash)
             for r, (v, _w) in zip(reqs, first) if v in (ERR.PASS, ERR.PASS_WAIT)]
    client.mode = "threaded"  # queue the exits on the completion ring for ONE tick
    for c in comps:
        client._submit_completion(c)
    client.mode = "sync"
    tick()
    client.time.advance(40)
    _, second = burst()
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    hammered = [v for (v, _w) in first[B - HAMMER:] + second[B - HAMMER:]]
    info = dict(seg_u=client.cfg.seg_u, peak_segments=client._seg_obs_peak, seg_static_ranks=client.cfg.seg_static_ranks,
                seg_dropped_total=client.seg_dropped_total, exits=len(comps), tick_ms=tick_ms, hammered=target,
                hammer_blocked=sum(v == ERR.BLOCK_FLOW for v in hammered), features=sorted(client._features),
                hot_candidates=len(client.hotset._cand))
    client.stop()
    return first + second, launches, info


# -- phase 4: the tick against itself ---------------------------------------------------


def batch_columns(np, PS, n_ticks, names_to_rows, B, seed, value_hashes, uniform=False):
    """Seeded numpy acquire + completion columns of B rows a tick, presorted
    as the client presorts them (a stable sort: the fused path sees the
    same items, in an order it does not depend on).  Every item carries one
    hashed argument in lane 0 (``value_hashes[k]`` for the k-th value).
    Names are drawn Zipf(1.1), or ``uniform`` over all of them."""
    rng = np.random.default_rng(seed)
    probs = None if uniform else zipf_probs(np, N_NAMES)
    vprobs = zipf_probs(np, N_VALUES)

    def hashes():
        ph = np.zeros((B, 2), np.int32)
        ph[:, 0] = value_hashes[rng.choice(N_VALUES, size=B, p=vprobs)]
        return ph

    out = []
    for _ in range(n_ticks):
        a = dict(
            res=names_to_rows[rng.choice(N_NAMES, size=B, p=probs)],
            prio=(rng.random(B) < 0.05).astype(np.int8),
            inbound=(rng.random(B) < 0.3).astype(np.int8),
            param_hash=hashes(),
        )
        order, _ = PS.batch_sort5(a["res"], np.zeros(B), np.zeros(B), np.zeros(B), np.zeros(B))
        a = {k: v[order] for k, v in a.items()}
        c = dict(
            res=names_to_rows[rng.choice(N_NAMES, size=B, p=probs)],
            rt=(rng.integers(1, 80, B) / 8.0).astype(np.float32),
            error=(rng.random(B) < 0.05).astype(np.uint8),
            inbound=(rng.random(B) < 0.3).astype(np.int8),
            param_hash=hashes(),
        )
        order, _ = PS.batch_sort3(c["res"], np.zeros(B), np.zeros(B))
        c = {k: v[order] for k, v in c.items()}
        out.append((a, c))
    return out


def stream_peak(np, PS, cols, cfg):
    """The stream's largest exact live-segment count in one batch, counted
    on the host as the client counts it."""
    trash = cfg.trash_row
    peak = 0
    for a, c in cols:
        for res in (a["res"], c["res"]):
            peak = max(peak, PS.host_seg_count([res, np.full_like(res, trash)]))
    return peak


def to_batches(E, torch, cfg, cols):
    out = []
    for a, c in cols:
        B = a["res"].shape[0]
        acq = E.empty_acquire(cfg, "cuda", B)._replace(
            res=torch.as_tensor(a["res"], dtype=torch.int32, device="cuda"),
            count=torch.ones(B, dtype=torch.uint8, device="cuda"),
            prio=torch.as_tensor(a["prio"], device="cuda"),
            inbound=torch.as_tensor(a["inbound"], device="cuda"),
            param_hash=torch.as_tensor(a["param_hash"], device="cuda"),
        )
        comp = E.empty_complete(cfg, "cuda", B)._replace(
            res=torch.as_tensor(c["res"], dtype=torch.int32, device="cuda"),
            rt=torch.as_tensor(c["rt"], device="cuda"),
            success=torch.ones(B, dtype=torch.uint8, device="cuda"),
            error=torch.as_tensor(c["error"], device="cuda"),
            inbound=torch.as_tensor(c["inbound"], device="cuda"),
            param_hash=torch.as_tensor(c["param_hash"], device="cuda"),
        )
        out.append((acq, comp))
    return out


def run_stream(E, torch, state, rules, cfg, stream, t0_ms, forbid_sync=False, scores=None, fits=None):
    """Run the stream; ``forbid_sync`` makes any host<->device sync inside
    the tick (everything but its one readback) raise.  ``scores``: a list
    that gets, after each tick (outside it), the readback of the timeline's
    ranking score, windowed pass + block of rows [1, max_resources).
    ``fits``: each tick's ``seg_fits`` (the fallback's route B), or None."""
    wires, waits, tick_s = [], [], []
    for i, (acq, comp) in enumerate(stream):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if forbid_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, out = E.tick(state, rules, acq, comp, t0_ms + 137 * i, 0.3, 0.2, cfg, E.ALL_FEATURES,
                                seg_fits=None if fits is None else fits[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wires.append(out.wire.cpu().numpy().tobytes())  # the one readback
        tick_s.append(time.perf_counter() - t)
        waits.append(out.wait_ms.cpu().numpy())
        if scores is not None:
            run = state.win_sec.run[1 : cfg.max_resources]
            scores.append((run[:, 0] + run[:, 1]).cpu().numpy())
    return state, wires, waits, tick_s


def profile_ticks(E, torch, variants, stream, t0_ms) -> dict:
    """One profiler session over 4 ticks of each variant ``(label, state,
    rules, cfg[, fits])`` in turn (``fits``: each tick's ``seg_fits``), each
    from a copy of its state; per label: (device busy us, wall us, host CPU
    us, device launches, the port's kernels' and the memsets' launches by
    name, top device rows).  Each variant's ticks run inside a
    ``record_function`` range that ends after a synchronize, so an event
    belongs to the variant whose range holds its start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    walls = {}
    torch.cuda.synchronize()
    # a session that records no device activity (see launch_breakdown) is
    # taken again, from copies of the same states
    for _session in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for label, state, rules, cfg, *fits in variants:
                fits = fits[0] if fits else None
                state = E.clone_state(state)
                torch.cuda.synchronize()
                with record_function(f"variant:{label}"):
                    t = time.perf_counter()
                    for i, (acq, comp) in enumerate(stream[:4]):
                        state, out = E.tick(state, rules, acq, comp, t0_ms + 137 * i, 0.3, 0.2, cfg, E.ALL_FEATURES,
                                            seg_fits=None if fits is None else fits[i])
                        out.wire.cpu()
                    torch.cuda.synchronize()
                    walls[label] = (time.perf_counter() - t) * 1e6
                del state
        evs = prof.events()
        if any(e.device_type == DeviceType.CUDA for e in evs):
            break
    check(any(e.device_type == DeviceType.CUDA for e in evs), "profile: no device event in 3 sessions")
    spans = {e.name.split(":", 1)[1]: (e.time_range.start, e.time_range.end) for e in evs
             if e.name.startswith("variant:") and e.device_type == DeviceType.CPU}
    out = {}
    for label, (lo, hi) in spans.items():
        mine = [e for e in evs if lo <= e.time_range.start <= hi and not e.name.startswith("variant:")]
        dev = [e for e in mine if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        cpu_us = sum(e.self_cpu_time_total for e in mine if e.device_type == DeviceType.CPU)
        by_name = {}
        for e in dev:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        ours = {k: n for k, (n, _us) in by_name.items() if any(x in k for x in (
            "scatter_many", "seg_sum", "seg_min", "gather_many", "Memset"))}
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        out[label] = (sum(e.time_range.elapsed_us() for e in dev), walls[label], cpu_us, len(dev), ours, top)
    return out


def planes_off(cfg):
    """The configuration with the three observability planes switched off."""
    import dataclasses

    return dataclasses.replace(cfg, device_telemetry=False, timeline_k=0, explain_k=0)


#: the tick's observability-plane functions (ops/engine.py)
PLANE_FNS = ("_device_stats", "_device_res_stats", "_device_explain")


def plane_report(E, torch, state, rules, cfg, acq, comp, now_ms) -> dict:
    """Each plane function of one tick (on a copy of ``state``), called
    again on the arguments the tick gave it: device ms a call (L2 flushed),
    host enqueue ms and device launches a call."""
    got = {}
    real = {k: getattr(E, k) for k in PLANE_FNS}

    def recorder(k):
        def rec(*args):
            got[k] = args  # the tick reads these and writes none of them afterwards
            return real[k](*args)
        return rec

    for k in PLANE_FNS:
        setattr(E, k, recorder(k))
    try:
        E.tick(E.clone_state(state), rules, acq, comp, now_ms, 0.3, 0.2, cfg, E.ALL_FEATURES)
    finally:
        for k in PLANE_FNS:
            setattr(E, k, real[k])
    check(set(got) == set(PLANE_FNS), f"the tick called the planes {sorted(got)}")
    out = {}
    for k, args in got.items():
        d, h = time_ms(lambda: real[k](*args), reps=20)
        per_launch = launch_breakdown(lambda: real[k](*args))
        out[k] = dict(ms=d, host_ms=h, launches=sum(n for _name, n, _ms in per_launch))
    return out


def check_planes(np, E, WIRE, TX, cfg, wires, scores) -> dict:
    """Card-side checks of the planes, where the JAX reference cannot run:
    the stats row's valid count and verdict mix against the decoded bitmap,
    ``n_blocked`` against its blocked rows, the explain section's own
    checksum, and the timeline rows against a host sort of the readback of
    the windowed pass + block (descending score, ascending row on a tie)."""
    lo = WIRE.layout_for(cfg, cfg.batch_size)
    K = E.timeline_k(cfg)
    ties = 0
    for i, (w, score) in enumerate(zip(wires, scores)):
        fr = WIRE.unpack(w, lo)
        mix = np.bincount(fr.verdict, minlength=7)
        check(fr.stats[E.STAT_VALID] == cfg.batch_size, (i, "STAT_VALID", fr.stats[E.STAT_VALID]))
        for slot, code in zip(range(E.STAT_PASS, E.STAT_BLOCK_DEGRADE + 1), E._STAT_VERDICTS):
            check(fr.stats[slot] == mix[code], (i, "stats slot", slot, fr.stats[slot], mix.tolist()))
        n_blocked, recs = TX.decode_section(fr.expl)  # raises on a bad sec_sum
        check(n_blocked == int(mix[1:6].sum()), (i, "n_blocked", n_blocked, mix.tolist()))
        check(int((recs[:, 0] > 0).sum()) == min(n_blocked, lo.expl_k), (i, "explain records", n_blocked))
        s64 = score.astype(np.int64)
        want = np.lexsort((np.arange(s64.size), -s64))[:K] + 1
        got = fr.res_stats[:, E.TL_RID].astype(np.int64)
        check(np.array_equal(got, want), (i, "timeline rows", got[:8].tolist(), want[:8].tolist()))
        ties += int(np.sum(np.diff(s64[want - 1]) == 0))
    return dict(ticks=len(wires), timeline_k=K, explain_k=lo.expl_k, tied_neighbours_in_top_k=ties)


# -- the sketch configuration: bench.py's 1M-resource build ------------------------------

#: bench.py: exact ruled resources, sketch-tail ruled ids, the name space
N_RULED = 10_000
N_TAIL_RULED = 2_048
N_TOTAL = 1 << 20
#: bench.py's batch, timed for a few ticks in phase 4
BIG_B = 131_072
#: acquires a client run or a burst puts on one tail-ruled name (its rule
#: admits 20 a second)
HAMMER = 64
#: request threads of the client run's hammer
HAMMER_THREADS = 4


def sketch_cfg(platform_config, B=2048, **kw):
    """bench.py's ``build`` configuration (bench.py:140-170) through the
    port's platform_config: 16,368 resources, 16,376 nodes, single rule
    lanes, the minute window, the sketch tier at its defaults (SALSA, depth
    2 x width 16,384, capacity 2^22, hot block 32), the segment path with
    seg_fallback off (as bench.py's ``build`` sets it; ``seg_fallback=True``
    is client_bench's), param_est_digits 2, the packed wire."""
    base = dict(
        max_resources=16368, max_nodes=16376, max_flow_rules=16368, max_degrade_rules=16368,
        max_param_rules=256, param_classes=1, flow_rules_per_resource=1, degrade_rules_per_resource=1,
        param_rules_per_resource=1, batch_size=B, complete_batch_size=B, enable_minute_window=True,
        sketch_stats=True, param_est_digits=2, packed_wire=True, seg_fallback=False)
    base.update(kw)
    return platform_config(**base)


def sketch_rules(st, with_tail_names: bool = True):
    """bench.py's rules (bench.py:181-205) by name: 10,000 flow rules at
    1,000 QPS and 10,000 slow-RT breakers (200 ms over 10 s) on res-1 ..
    res-10000, 128 param rules at 500 on argument 0, 16 authority black
    lists, a system QPS rule at 1e9, and (``with_tail_names``) 2,048 QPS
    rules at 20 on tail-0 .. tail-2047, as client_bench loads them."""
    flow = [st.FlowRule(resource=f"res-{i + 1}", count=1000.0) for i in range(N_RULED)]
    if with_tail_names:
        flow += [st.FlowRule(resource=f"tail-{r}", count=20.0) for r in range(N_TAIL_RULED)]
    degrade = [st.DegradeRule(resource=f"res-{i + 1}", grade=0, count=200.0, time_window=10) for i in range(N_RULED)]
    param = [st.ParamFlowRule(resource=f"res-{i + 1}", param_idx=0, count=500.0) for i in range(128)]
    authority = [st.AuthorityRule(resource=f"res-{i + 1}", limit_app="banned", strategy=st.AUTHORITY_BLACK)
                 for i in range(16)]
    return flow, degrade, authority, [st.SystemRule(qps=1e9)], param


def intern_bench_names(reg):
    """client_bench's interning (bench.py:362-367): res-1 .. res-10000 on
    rows 1 .. 10,000, burner names until the organic exact space is spent,
    then tail-0 .. tail-2047 as sequential sketch ids."""
    for i in range(N_RULED):
        check(reg.resource_id(f"res-{i + 1}") == i + 1, "res-* must take rows 1 .. 10,000")
    k = 0
    while not reg.is_sketch_id(reg.resource_id(f"burn-{k}")):
        k += 1
    for r in range(N_TAIL_RULED):
        check(reg.is_sketch_id(reg.resource_id(f"tail-{r}")), "tail names must intern as sketch ids")


def bench_name(raw: int) -> str:
    """A raw Zipf draw of bench.py's traffic as a name: res-{raw} in the
    ruled exact space, tail-{k} for the 2,048 tail-ruled draws, n-{raw}
    for the rest of the 2^20 names (sketch ids on first use)."""
    if raw <= N_RULED:
        return f"res-{raw}"
    k = raw - N_RULED - 1
    return f"tail-{k}" if k < N_TAIL_RULED else f"n-{raw}"


def sketch_columns(np, PS, n_ticks, B, seed, node_rows, trash, origin_row, origin_id, uniform=False):
    """bench.py's traffic (bench.py:100-134, 212-239): Zipf(1.3) over 2^20
    names (``uniform``: every name alike), ids past 10,000 are sketch ids
    node_rows + raw; 1/8 with the peer-app origin, argument hashes on ids
    <= 128, 1/2 inbound on each side, RT |N(3, 1)| ms; every batch
    presorted by the client's keys.  Returns [(acquire columns, completion
    columns)] and the largest exact live-segment count."""
    rng = np.random.default_rng(seed)
    out, peak = [], 0
    full = np.full(B, trash, np.int32)
    none = np.full(B, -1, np.int32)
    for _ in range(n_ticks):
        if uniform:
            raw = rng.integers(1, N_TOTAL, B).astype(np.int64)
        else:
            z = rng.zipf(1.3, size=B).astype(np.int64)
            raw = (z - 1) % (N_TOTAL - 1) + 1
        ids = np.where(raw <= N_RULED, raw, node_rows + raw).astype(np.int32)
        with_origin = rng.random(B) < 0.125
        ph0 = np.where(ids <= 128, rng.integers(1, 1 << 20, B), 0).astype(np.int32)
        inb_a = (rng.random(B) < 0.5).astype(np.int8)
        inb_c = (rng.random(B) < 0.5).astype(np.int8)
        rt = np.abs(rng.normal(3.0, 1.0, B)).astype(np.float32)
        onode = np.where(with_origin, origin_row, trash).astype(np.int32)
        oid = np.where(with_origin, origin_id, -1).astype(np.int32)
        order, _ = PS.batch_sort5(ids, full, onode, oid, none)
        ph = np.stack([ph0, np.zeros(B, np.int32)], axis=1)[order]
        a = dict(res=ids[order], origin_node=onode[order], origin_id=oid[order], inbound=inb_a[order], param_hash=ph)
        c = dict(res=ids[order], rt=rt[order], inbound=inb_c[order], param_hash=ph)
        peak = max(peak, PS.host_seg_count([a["res"], full, a["origin_node"], a["origin_id"], none]),
                   PS.host_seg_count([c["res"], full, full]))
        out.append((a, c))
    return out, peak


def sketch_batches(E, torch, cfg, cols, device="cuda"):
    out = []
    for a, c in cols:
        B = a["res"].shape[0]

        def dev(x):
            return torch.as_tensor(x, device=device)

        acq = E.empty_acquire(cfg, device, B)._replace(
            res=dev(a["res"]), count=torch.ones(B, dtype=torch.uint8, device=device),
            origin_id=dev(a["origin_id"]), origin_node=dev(a["origin_node"]), inbound=dev(a["inbound"]),
            param_hash=dev(a["param_hash"]))
        comp = E.empty_complete(cfg, device, B)._replace(
            res=dev(c["res"]), rt=dev(c["rt"]), success=torch.ones(B, dtype=torch.uint8, device=device),
            inbound=dev(c["inbound"]), param_hash=dev(c["param_hash"]))
        out.append((acq, comp))
    return out


def prepare_sketch(np, st, E, torch, device="cuda") -> dict:
    """bench.py's build on the card: the rules compiled as bench.py
    compiles them (the exact rules through a registry holding res-1 ..
    res-10000, the tail table from (node_rows + r, 20) for the 2,048 ruled
    ids), 13 ticks at B = 2,048, one 256-row light tick and 4 ticks at B =
    131,072, with seg_u grown from each stream's exact segment count and
    seg_static_ranks on (the batches are presorted, the rules DIRECT)."""
    import dataclasses

    from sentinel_tpu_torch.core import rule_tensors as RT
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.runtime.client import grown_seg_u
    from sentinel_tpu_torch.runtime.registry import Registry

    base = sketch_cfg(platform_config)
    reg = Registry(base)
    for i in range(N_RULED):
        reg.resource_id(f"res-{i + 1}")
    origin = (reg.origin_node_row("res-1", "peer-app"), reg.origin_id("peer-app"))
    nr, trash = base.node_rows, base.trash_row
    cols, peak = sketch_columns(np, PS, 13, 2048, SEED + 9, nr, trash, *origin)
    light_cols, peak_l = sketch_columns(np, PS, 1, 256, SEED + 10, nr, trash, *origin)
    big_cols, peak_b = sketch_columns(np, PS, 8, BIG_B, SEED + 11, nr, trash, *origin)
    cfg = dataclasses.replace(base, seg_u=grown_seg_u(base, max(peak, peak_l)), seg_static_ranks=True)
    big = sketch_cfg(platform_config, B=BIG_B)
    cfg_big = dataclasses.replace(big, seg_u=grown_seg_u(big, peak_b), seg_static_ranks=True)
    flow, degrade, authority, system, param = sketch_rules(st, with_tail_names=False)
    rules = E.compile_ruleset(cfg, reg, flow_rules=flow, degrade_rules=degrade, param_rules=param,
                              authority_rules=authority, system_rules=system, device=device)
    tail = [(nr + r, 20.0) for r in range(N_RULED + 1, N_RULED + 1 + N_TAIL_RULED)]
    rules = rules._replace(tail=RT.to_device(RT.compile_tail_flow_rules(tail, cfg), device))
    log(f"[config] sketch: bench.py's build — max_resources={cfg.max_resources} max_nodes={cfg.max_nodes} "
        f"minute_window={cfg.enable_minute_window} sketch {cfg.sketch_depth} x {cfg.sketch_width} (salsa="
        f"{cfg.sketch_salsa}, capacity {cfg.sketch_capacity}, hotset_k {cfg.hotset_k}); seg_u {cfg.seg_u} at "
        f"B=2048 (peak {max(peak, peak_l)} live segments), {cfg_big.seg_u} at B={BIG_B} (peak {peak_b}); "
        f"{N_TAIL_RULED} tail rules at 20 QPS, {int((rules.tail.thr < RT.TAIL_UNRULED / 2).sum().item())} "
        f"ruled cells")
    return dict(cfg=cfg, cfg_big=cfg_big, rules=rules, origin=origin, stream=sketch_batches(E, torch, cfg, cols, device),
                light=sketch_batches(E, torch, cfg, light_cols, device)[0],
                big=sketch_batches(E, torch, cfg_big, big_cols, device),
                ruled=list(range(nr + N_RULED + 1, nr + N_RULED + 1 + N_TAIL_RULED)),
                segments=dict(peak=max(peak, peak_l), peak_big=peak_b, seg_u=cfg.seg_u, seg_u_big=cfg_big.seg_u))


def sketch_outcome(np, E, WIRE, TX, cfg, wires, acqs, ruled) -> dict:
    """From the readbacks of a run of ticks: items blocked on a tail rule
    (BLOCK_FLOW on a ruled sketch id), hot rows carrying sketch ids, and
    explain records with the sketch flag."""
    from sentinel_tpu_torch.core import errors as ERR

    lo = WIRE.layout_for(cfg, acqs[0].res.shape[0])
    tail_blocked = hot_ids = flagged = 0
    ruled = np.asarray(ruled)
    for w, acq in zip(wires, acqs):
        fr = WIRE.unpack(w, lo)
        res = acq.res.cpu().numpy()
        tail_blocked += int(np.sum((fr.verdict == ERR.BLOCK_FLOW) & np.isin(res, ruled)))
        hot_ids += int(np.sum(fr.hot[:, 0] >= cfg.node_rows))
        _n, recs = TX.decode_section(fr.expl)
        flagged += sum(1 for row in recs if (rec := TX.decode_record(row)) is not None and rec.sketch_tier)
    return dict(tail_blocked=tail_blocked, hot_rows_with_sketch_ids=hot_ids, explain_sketch_records=flagged)


#: the sketch tier's functions timed alone (module, name)
SKETCH_FNS = (("SA", "refresh"), ("SA", "_land_words"), ("SA", "estimate_plane_mxu"),
              ("E", "tail_thresholds"), ("E", "_device_hot_candidates"))


def sketch_fn_report(E, SA, torch, state, rules, cfg, acq, comp, now_ms) -> dict:
    """Each of the sketch tier's functions in one tick (on a copy of
    ``state``), called again on the arguments the tick gave it: calls a
    tick, device ms a call (L2 flushed), host enqueue ms and device
    launches a call.  SALSA's ``refresh`` (its expiry and its landing,
    both computed and selected) includes ``_land_words``."""
    mods = {"SA": SA, "E": E}
    got, calls = {}, {}
    real = {(m, k): getattr(mods[m], k) for m, k in SKETCH_FNS}

    def recorder(m, k):
        def rec(*args, **kw):
            calls[k] = calls.get(k, 0) + 1
            got.setdefault(k, (args, kw))
            return real[(m, k)](*args, **kw)
        return rec

    for m, k in SKETCH_FNS:
        setattr(mods[m], k, recorder(m, k))
    try:
        E.tick(E.clone_state(state), rules, acq, comp, now_ms, 0.3, 0.2, cfg, E.ALL_FEATURES)
    finally:
        for (m, k), fn in real.items():
            setattr(mods[m], k, fn)
    check(set(got) == {k for _m, k in SKETCH_FNS}, f"the sketch tick called {sorted(got)}")
    out = {}
    for m, k in SKETCH_FNS:
        args, kw = got[k]
        fn = real[(m, k)]
        d, h = time_ms(lambda: fn(*args, **kw), reps=20)
        per_launch = launch_breakdown(lambda: fn(*args, **kw))
        out[k] = dict(calls_a_tick=calls[k], ms=d, host_ms=h, launches=sum(n for _name, n, _ms in per_launch))
    return out


def sketch_off(E, torch, cfg, state):
    """The configuration and a copy of ``state`` with the sketch tier off
    (its placeholder leaf): the same tick without the sketch's work."""
    import dataclasses

    from sentinel_tpu_torch.ops import gsketch as GS

    off = dataclasses.replace(cfg, sketch_stats=False)
    dev = state.concurrency.device
    gs = GS.SketchState(counts=torch.zeros((1, 1, 1, GS.PLANES), dtype=torch.int32, device=dev),
                        epochs=torch.full((1,), -2, dtype=torch.int32, device=dev))
    return off, E.clone_state(state)._replace(gs=gs)


def sketch_tick_phase(np, E, WIRE, TX, S, FU, SC, SA, torch, install, real, plain, sk) -> dict:
    """Phase 4 on the sketch configuration.  At B = 2,048: the stream with
    the kernels (no host sync inside) against the plain versions — wire
    bytes, wait_ms and every integer state leaf, the sketch's included —,
    the planes checked on the card, tail blocks and hot rows counted; tick
    time with the sketch tier on and off in turns (off, on, on, off), one
    profile of 4 ticks of each, and the sketch's functions alone.  At B =
    131,072 (bench.py's batch): a warm-up tick, then 3 ticks with the
    kernels against the plain versions, their times and a profile of 2."""
    cfg, rules = sk["cfg"], sk["rules"]
    ticks = sk["stream"][1:]
    out = {}
    st_a, st_b = E.clone_state(sk["state0"]), E.clone_state(sk["state0"])
    FU.reset_launches()
    SC.reset_launches()
    scores = []
    st_a, wires_a, waits_a, _ = run_stream(E, torch, st_a, rules, cfg, ticks, 1_250, forbid_sync=True, scores=scores)
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    for kname in PATH_KERNELS["sketch"]:
        check(launches[kname] > 0, ("sketch", "tick", kname, launches))
    install(plain)
    try:
        st_b, wires_b, waits_b, _ = run_stream(E, torch, st_b, rules, cfg, ticks, 1_250)
    finally:
        install(real)
    for i, (wa, wb) in enumerate(zip(wires_a, wires_b)):
        check(wa == wb, f"sketch tick {i}: wire bytes differ between kernels and plain versions")
        check(np.array_equal(waits_a[i], waits_b[i]), f"sketch tick {i}: wait_ms differ")
        check(WIRE.unpack(wa, WIRE.layout_for(cfg, cfg.batch_size)).seg_dropped == 0, f"sketch tick {i}: dropped")
    la, lb = S.leaves(st_a), S.leaves(st_b)
    for k in la:
        if not la[k].dtype.is_floating_point:
            check(torch.equal(la[k], lb[k]), f"sketch: integer state leaf {k} differs")
    del st_b, la, lb
    planes = check_planes(np, E, WIRE, TX, cfg, wires_a, scores)
    seen = sketch_outcome(np, E, WIRE, TX, cfg, wires_a, [a for a, _c in ticks], sk["ruled"])
    check(seen["hot_rows_with_sketch_ids"] > 0, ("sketch: no hot row carried a sketch id", seen))
    out["b2048"] = dict(launches=launches, planes_checked=planes, **seen)
    # the sketch tier on against off, in turns, from the same state
    cfg_off, st_off = sketch_off(E, torch, cfg, sk["state0"])
    turns = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        c, s = (cfg, E.clone_state(sk["state0"])) if label == "on" else (cfg_off, E.clone_state(st_off))
        _s, _w, _wt, ts_turn = run_stream(E, torch, s, rules, c, ticks, 1_250, forbid_sync=True)
        turns[label] += ts_turn[2:]
        del _s
    prof = profile_ticks(E, torch, [("off", st_off, rules, cfg_off), ("on", st_a, rules, cfg)], ticks, 9_000)
    med = {k: 1e3 * sorted(v)[len(v) // 2] for k, v in turns.items()}
    for label in ("on", "off"):
        dev_us, wall_us, cpu_us, n_launch, ours, top = prof[label]
        out["b2048"][label] = dict(ms_median=med[label], decisions_per_s=cfg.batch_size / med[label] * 1e3,
                                   tick_ms=[1e3 * s for s in turns[label]], device_us=dev_us, wall_us=wall_us,
                                   host_cpu_us=cpu_us, idle_share=1 - dev_us / wall_us, device_launches=n_launch,
                                   profile_kernel_launches=ours, top=top)
    on, off = out["b2048"]["on"], out["b2048"]["off"]
    log(f"[tick] sketch: {len(ticks)} ticks at B={cfg.batch_size}, no host sync inside; kernels == plain versions "
        f"(wire bytes, wait_ms, integer state, the sketch's leaves included); launches {json.dumps(launches)}; "
        f"tail rules blocked {seen['tail_blocked']} items, hot rows with sketch ids {seen['hot_rows_with_sketch_ids']}, "
        f"explain records with the sketch flag {seen['explain_sketch_records']}; planes {json.dumps(planes)}")
    log(f"[tick] sketch: median {on['ms_median']:.3f} ms per tick -> {on['decisions_per_s']:.0f} decisions/s "
        f"(sketch tier off {off['ms_median']:.3f} ms -> {off['decisions_per_s']:.0f}; off / on / on / off); "
        f"profile of 4 ticks: device busy {on['device_us'] / 1e3:.3f} ms of {on['wall_us'] / 1e3:.3f} ms wall "
        f"(idle share {on['idle_share']:.3f}), host CPU {on['host_cpu_us'] / 1e3:.3f} ms, "
        f"{on['device_launches']} device launches ({on['device_launches'] / 4:g} a tick); the sketch tier adds "
        f"{(on['device_launches'] - off['device_launches']) / 4:g} device launches, "
        f"{(on['device_us'] - off['device_us']) / 4e3:.4f} ms device busy, "
        f"{(on['host_cpu_us'] - off['host_cpu_us']) / 4e3:.4f} ms host CPU and "
        f"{on['ms_median'] - off['ms_median']:.3f} ms median tick a tick; scatter_many launches a tick "
        f"{launches['scatter_many'] / len(ticks):g}, seg_excl_cumsum {launches['seg_excl_cumsum'] / len(ticks):g}")
    for row_name, (n, us) in on["top"]:
        log(f"[profile] sketch: {row_name[:60]:60s} x{n:5d} {us / 1e3:9.3f} ms (4 ticks)")
    fns = sketch_fn_report(E, SA, torch, sk["state0"], rules, cfg, *sk["stream"][1], 1_150)
    out["b2048"]["sketch_fns"] = fns
    log("[sketch] the sketch tier's functions alone, a call at B=2048: " + "; ".join(
        f"{k} ({v['calls_a_tick']} a tick) {v['launches']:g} device launches, device {v['ms']:.4f} ms, host "
        f"enqueue {v['host_ms']:.4f} ms" for k, v in fns.items()))
    del st_a

    # bench.py's batch, B = 131,072
    cfg_b = sk["cfg_big"]
    s0 = E.init_state(cfg_b, "cuda")
    s0, _ = E.tick(s0, rules, *sk["big"][0], 1_000, 0.3, 0.2, cfg_b, E.ALL_FEATURES)
    torch.cuda.synchronize()
    FU.reset_launches()
    SC.reset_launches()
    st_a, wires_a, waits_a, ts_a = run_stream(E, torch, E.clone_state(s0), rules, cfg_b, sk["big"][1:], 1_250,
                                              forbid_sync=True)
    big_launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    install(plain)
    try:
        st_b, wires_b, waits_b, _ = run_stream(E, torch, E.clone_state(s0), rules, cfg_b, sk["big"][1:], 1_250)
    finally:
        install(real)
    for i, (wa, wb) in enumerate(zip(wires_a, wires_b)):
        check(wa == wb, f"sketch B={BIG_B} tick {i}: wire bytes differ between kernels and plain versions")
        check(np.array_equal(waits_a[i], waits_b[i]), f"sketch B={BIG_B} tick {i}: wait_ms differ")
        check(WIRE.unpack(wa, WIRE.layout_for(cfg_b, BIG_B)).seg_dropped == 0, f"sketch B={BIG_B}: dropped")
    la, lb = S.leaves(st_a), S.leaves(st_b)
    for k in la:
        if not la[k].dtype.is_floating_point:
            check(torch.equal(la[k], lb[k]), f"sketch B={BIG_B}: integer state leaf {k} differs")
    del st_a, st_b, la, lb
    seen_b = sketch_outcome(np, E, WIRE, TX, cfg_b, wires_a, [a for a, _c in sk["big"][1:]], sk["ruled"])
    check(seen_b["tail_blocked"] > 0, ("sketch: no item was blocked on a tail rule at B=131072", seen_b))
    _s, _w, _wt, ts_b = run_stream(E, torch, E.clone_state(s0), rules, cfg_b, sk["big"][1:], 1_250, forbid_sync=True)
    del _s
    prof_b = profile_ticks(E, torch, [("on", s0, rules, cfg_b)], sk["big"][1:3], 9_000)
    dev_us, wall_us, cpu_us, n_launch, ours, top = prof_b["on"]
    times = sorted(1e3 * s for s in ts_a + ts_b)
    ms_b = times[len(times) // 2]
    out[f"b{BIG_B}"] = dict(ms_median=ms_b, decisions_per_s=BIG_B / ms_b * 1e3, tick_ms=times, launches=big_launches,
                            device_us=dev_us / 2, wall_us=wall_us / 2, host_cpu_us=cpu_us / 2,
                            idle_share=1 - dev_us / wall_us, device_launches=n_launch / 2,
                            profile_kernel_launches=ours, top=top, **seen_b)
    log(f"[tick] sketch: {len(sk['big']) - 1} ticks at B={BIG_B} (bench.py's batch), no host sync inside; kernels == "
        f"plain versions; tail rules blocked {seen_b['tail_blocked']} items, hot rows with sketch ids "
        f"{seen_b['hot_rows_with_sketch_ids']}; median {ms_b:.3f} ms per tick -> {BIG_B / ms_b * 1e3:.0f} "
        f"decisions/s (ticks {', '.join(f'{t:.3f}' for t in times)} ms); profile of 2 ticks: device busy "
        f"{dev_us / 2e3:.3f} ms a tick of {wall_us / 2e3:.3f} ms wall (idle share {1 - dev_us / wall_us:.3f}), "
        f"{n_launch / 2:g} device launches a tick; launches {json.dumps(big_launches)}")
    for row_name, (n, us) in top:
        log(f"[profile] sketch B={BIG_B}: {row_name[:60]:60s} x{n:5d} {us / 1e3:9.3f} ms (2 ticks)")
    return out


# -- phase 6: seg_fallback=True, the tick's two routes ---------------------------------

#: ticks of the fallback phase's stream: every third acquire side and every
#: fourth completion side uniform over all names (past seg_u), the rest Zipf
FALLBACK_TICKS = 12


def mixed_stream(np, zipf, unif):
    """Tick i takes its acquire side from ``unif`` when i % 3 == 2 and its
    completion side when i % 4 == 3, else from ``zipf``: every combination
    of fitting and overflowing sides occurs."""
    return [(unif[i][0] if i % 3 == 2 else zipf[i][0], unif[i][1] if i % 4 == 3 else zipf[i][1])
            for i in range(len(zipf))]


def host_fits(np, PS, cols, U, acq_keys, comp_keys):
    """Each tick's ``seg_fits`` as the client computes it: the exact live
    segments of each side on the engine's keys against the capacity."""
    out = []
    for a, c in cols:
        segs_a = PS.host_seg_count([a[k] for k in acq_keys])
        segs_c = PS.host_seg_count([c[k] for k in comp_keys])
        out.append((segs_c <= U, segs_a <= U))
    return out


def fallback_run(np, E, WIRE, S, FU, SC, torch, install, real, plain, name, cfg, ref_cfg, rules, stream, fits,
                 kernels) -> dict:
    """One configuration with seg_fallback=True over a stream of fitting and
    overflowing ticks: route A (both branches, selected on the card) with
    the kernels, under set_sync_debug_mode("error"), against route A with
    the plain versions (wire bytes, wait_ms, integer state) and against
    route B (the host's seg_fits: one branch a side; every state leaf);
    verdicts and waits against the per-item fused path's (``ref_cfg``);
    both branches taken on each side; ms a tick (routes in turns A, B, B,
    A), kernel launches a tick and a profile of 4 ticks of each route."""
    from sentinel_tpu_torch.core import errors as ERR

    n = len(stream)
    state0 = E.init_state(cfg, "cuda")
    state0, _ = E.tick(state0, rules, *stream[0], 900, 0.3, 0.2, cfg, E.ALL_FEATURES)  # a warm-up tick
    lo = WIRE.layout_for(cfg, cfg.batch_size)
    out = {}
    launches = {}
    for route, f in (("A", None), ("B", fits)):
        FU.reset_launches()
        SC.reset_launches()
        st_k, wires, waits, _ = run_stream(E, torch, E.clone_state(state0), rules, cfg, stream, 1_250,
                                           forbid_sync=True, fits=f)
        launches[route] = {k: v / n for k, v in dict(FU.LAUNCHES, **SC.LAUNCHES).items()}
        out[route] = (st_k, wires, waits)
    st_a, wires_a, waits_a = out["A"]
    for kname in kernels:
        check(launches["A"][kname] > 0, (name, "fallback route A", kname, launches["A"]))
    install(plain)
    try:
        st_p, wires_p, waits_p, _ = run_stream(E, torch, E.clone_state(state0), rules, cfg, stream, 1_250)
    finally:
        install(real)
    st_b, wires_b, waits_b = out["B"]
    la, lp, lb = S.leaves(st_a), S.leaves(st_p), S.leaves(st_b)
    float_diff = 0.0
    for i in range(n):
        check(wires_a[i] == wires_p[i], f"fallback {name} tick {i}: wire bytes differ between kernels and plain")
        check(np.array_equal(waits_a[i], waits_p[i]), f"fallback {name} tick {i}: wait_ms differ (plain)")
        check(wires_a[i] == wires_b[i], f"fallback {name} tick {i}: route A and route B wires differ")
        check(np.array_equal(waits_a[i], waits_b[i]), f"fallback {name} tick {i}: wait_ms differ (route B)")
    for k in la:
        check(torch.equal(la[k], lb[k]), f"fallback {name}: route A and route B differ in state leaf {k}")
        if la[k].dtype.is_floating_point:
            float_diff = max(float_diff, (la[k] - lp[k]).abs().max().item())
        else:
            check(torch.equal(la[k], lp[k]), f"fallback {name}: integer state leaf {k} differs (plain)")
    del st_p, st_b, lp, lb, out
    # the per-item fused path on the same stream: the same verdicts and waits
    st_r, wires_r, waits_r, _ = run_stream(E, torch, E.init_state(ref_cfg, "cuda"), rules, ref_cfg,
                                           stream[:1], 900)
    st_r, wires_r, waits_r, _ = run_stream(E, torch, st_r, rules, ref_cfg, stream, 1_250)
    lo_r = WIRE.layout_for(ref_cfg, ref_cfg.batch_size)
    mix = np.zeros(7, np.int64)
    acq_over = comp_over = 0
    for i in range(n):
        fa, fr = WIRE.unpack(wires_a[i], lo), WIRE.unpack(wires_r[i], lo_r)
        check(np.array_equal(fa.verdict, fr.verdict) and np.array_equal(waits_a[i], waits_r[i]),
              f"fallback {name} tick {i}: verdicts or waits differ from the per-item fused path's")
        check(fa.seg_dropped == 0, f"fallback {name} tick {i}: {fa.seg_dropped} items dropped")
        over = int(fa.stats[E.STAT_SEG_LIVE]) > cfg.seg_u
        check(over == (not fits[i][1]), f"fallback {name} tick {i}: the card's segment count disagrees with the host's")
        acq_over += over
        comp_over += not fits[i][0]
        mix += np.bincount(fa.verdict, minlength=7)
    del st_r
    branches = dict(acquire=dict(segment=n - acq_over, per_item=acq_over),
                    completion=dict(segment=n - comp_over, per_item=comp_over))
    check(min(min(v.values()) for v in branches.values()) > 0, (name, "a branch was never taken", branches))
    check(mix[ERR.BLOCK_FLOW] > 0 and mix[ERR.PASS] > 0, (name, mix.tolist()))
    # ms a tick, the routes in turns from the same state
    turns = {"A": [], "B": []}
    for route in ("A", "B", "B", "A"):
        _s, _w, _wt, ts_turn = run_stream(E, torch, E.clone_state(state0), rules, cfg, stream, 1_250,
                                          forbid_sync=True, fits=fits if route == "B" else None)
        turns[route] += ts_turn[2:]
        del _s
    prof = profile_ticks(E, torch, [("A", state0, rules, cfg), ("B", state0, rules, cfg, fits)], stream, 9_000)
    res = dict(ticks=n, seg_u=cfg.seg_u, branches=branches, verdict_mix=mix.tolist(), float_state_max_diff=float_diff)
    for route in ("A", "B"):
        dev_us, wall_us, cpu_us, n_launch, ours, _top = prof[route]
        ms = 1e3 * sorted(turns[route])[len(turns[route]) // 2]
        res[route] = dict(ms_median=ms, tick_ms=[1e3 * x for x in turns[route]], kernel_launches_a_tick=launches[route],
                          device_us_4=dev_us, wall_us_4=wall_us, host_cpu_us_4=cpu_us, device_launches_4=n_launch,
                          idle_share=1 - dev_us / wall_us, profile_kernel_launches=ours)
    log(f"[fallback] {name}: {n} ticks at B={cfg.batch_size}, seg_u {cfg.seg_u}; branches taken "
        f"{json.dumps(branches)}; no host sync inside; route A kernels == plain (wire bytes, wait_ms, integer "
        f"state; float max |diff| {float_diff}) == route B (wire bytes, every state leaf); verdicts and waits == "
        f"the per-item fused path's; seg_dropped 0; verdict mix {mix.tolist()}")
    for route in ("A", "B"):
        r = res[route]
        log(f"[fallback] {name} route {route}: median {r['ms_median']:.3f} ms a tick (in turns A, B, B, A); kernel "
            f"launches a tick {json.dumps(r['kernel_launches_a_tick'])}; profile of 4 ticks: "
            f"{r['device_launches_4'] / 4:g} device launches a tick, device busy {r['device_us_4'] / 4e3:.4f} ms a "
            f"tick, wall {r['wall_us_4'] / 4e3:.4f} ms, idle share {r['idle_share']:.3f}")
    return res


def fallback_phase(np, st, E, WIRE, S, FU, SC, torch, install, real, plain, setups, sk) -> dict:
    """seg4, seg1 and sketch with seg_fallback=True (platform_config()'s
    default): seg_u grown from the Zipf ticks' exact peak, so that they fit
    and the uniform ticks (~2,000 live segments) overflow."""
    import dataclasses

    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.core.rule_tensors import hash_param
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.runtime.client import grown_seg_u
    from sentinel_tpu_torch.runtime.registry import Registry

    cf = configs(platform_config, seg_fallback=True)
    reg = Registry(cf["seg4"])
    names_to_rows = np.array([reg.resource_id(f"res-{i}") for i in range(N_NAMES)], dtype=np.int32)
    value_hashes = np.array([hash_param(arg_value(k)) for k in range(N_VALUES)], dtype=np.int32)
    B = cf["seg4"].batch_size
    zipf = batch_columns(np, PS, FALLBACK_TICKS, names_to_rows, B, SEED + 20, value_hashes)
    unif = batch_columns(np, PS, FALLBACK_TICKS, names_to_rows, B, SEED + 21, value_hashes, uniform=True)
    cols = mixed_stream(np, zipf, unif)
    seg_u = grown_seg_u(cf["seg4"], stream_peak(np, PS, zipf, cf["seg4"]))
    fits = host_fits(np, PS, cols, seg_u, ("res",), ("res",))  # the other keys are constant here
    out = {}
    for name, ref in (("seg4", "fused"), ("seg1", "fused1")):
        cfg = dataclasses.replace(cf[name], seg_u=seg_u, seg_static_ranks=name == "seg1")
        stream = to_batches(E, torch, cfg, cols)
        kernels = ("scatter_many", "gather_many", "seg_incl_min") + (("seg_excl_cumsum",) if name == "seg1" else ())
        out[name] = fallback_run(np, E, WIRE, S, FU, SC, torch, install, real, plain, name, cfg, cf[ref],
                                 setups[name][1], stream, fits, kernels)
        del stream
        torch.cuda.empty_cache()
    # bench.py's build with the fallback on; the uniform ticks spread over
    # the 2^20 names
    base = sk["cfg"]
    nr, trash = base.node_rows, base.trash_row
    zipf, _p = sketch_columns(np, PS, FALLBACK_TICKS, B, SEED + 22, nr, trash, *sk["origin"])
    unif, _p = sketch_columns(np, PS, FALLBACK_TICKS, B, SEED + 23, nr, trash, *sk["origin"], uniform=True)
    cols = mixed_stream(np, zipf, unif)
    fits = host_fits(np, PS, cols, base.seg_u, ("res", "origin_node", "origin_id"), ("res",))
    cfg = dataclasses.replace(base, seg_fallback=True)
    from sentinel_tpu_torch.core.config import platform_config as pc

    out["sketch"] = fallback_run(np, E, WIRE, S, FU, SC, torch, install, real, plain, "sketch", cfg,
                                 sketch_cfg(pc, seg_effects=False), sk["rules"], sketch_batches(E, torch, cfg, cols),
                                 fits, ("scatter_many", "gather_many", "seg_excl_cumsum", "seg_incl_min"))
    torch.cuda.empty_cache()
    return out


# -- phase 7: bench.py's client_bench through the port's client ---------------------------

#: client_bench's blocks a batch shape and pipeline depth (bench.py:311, :359)
CB_BLOCKS = 32
CB_DEPTH = 4


def bench_traffic(np, PS, c, B, tail_ids):
    """client_bench's 6 seeded batches (bench.py:406-439): Zipf(1.3) over
    2^20 names, the tail-ruled draws on their CURRENT registry ids (some
    promoted at rule load), the rest of the tail as raw sketch ids; 1/8
    from peer-app, argument hashes on ids <= 128, 1/2 inbound, RT |N(3, 1)|.
    Returns the batches and their largest exact live-segment count."""
    cfg = c.cfg
    rng = np.random.default_rng(1)
    origin_row = c.registry.origin_node_row("res-1", "peer-app")
    origin_id = c.registry.origin_id("peer-app")
    traffic, max_segs = [], 0
    for _ in range(6):
        z = rng.zipf(1.3, size=B).astype(np.int64)
        raw = (z - 1) % (N_TOTAL - 1) + 1
        tail_k = raw - N_RULED - 1
        ids = np.where(raw <= N_RULED, raw, np.where(
            tail_k < N_TAIL_RULED, tail_ids[np.clip(tail_k, 0, N_TAIL_RULED - 1)], cfg.node_rows + tail_k,
        )).astype(np.int32)
        with_origin = rng.random(B) < 0.125
        onode = np.where(with_origin, origin_row, cfg.trash_row).astype(np.int32)
        oid = np.where(with_origin, origin_id, -1).astype(np.int32)
        ph = np.zeros((B, cfg.param_dims), np.int32)
        ph[:, 0] = np.where(ids <= 128, rng.integers(1, 1 << 20, B), 0)
        inb = (rng.random(B) < 0.5).astype(np.int32)
        rt = np.abs(rng.normal(3.0, 1.0, B)).astype(np.float32)
        traffic.append((ids, onode, oid, ph, inb, rt))
        order = np.lexsort((oid, onode, ids))
        max_segs = max(max_segs, PS.host_seg_count([ids[order], onode[order], oid[order]]))
    return traffic, max_segs


def bench_client(st, SentinelClient, cfg, depth, time_source=None):
    """client_bench's client (bench.py:359-398): names interned and rules
    loaded through the public surface; the client turns seg_static_ranks
    on itself."""
    c = SentinelClient(cfg=cfg, mode="threaded", pipeline_depth=depth, time_source=time_source)
    intern_bench_names(c.registry)
    flow, degrade, authority, system, param = sketch_rules(st)
    c.flow_rules.load(flow)
    c.degrade_rules.load(degrade)
    c.param_flow_rules.load(param)
    c.authority_rules.load(authority)
    c.system_rules.load(system)
    check(c.cfg.seg_static_ranks, "client_bench: the client did not turn seg_static_ranks on")
    return c


def client_bench_phase(np, st, FU, SC, torch, B, smi) -> dict:
    """bench.py's client_bench (bench.py:311-520) through the port's client
    at batch B: platform_config (seg_fallback=True) at bench.py's shape,
    pipeline_depth 4, seg_u with bench.py's headroom (:443-448).  First the
    same blocks (two batches each, with their completion blocks) through
    two clients on a virtual clock, at depth 4 and at 0: equal verdicts.
    Then the measured loop (``measured_bench_run``) twice on one client,
    the span tracer off and then on: dps, effective_tick_ms, the p50 / p99
    of submit -> resolve, the verdict mix, the ticks that took the
    per-item branch, and a tick's upload and readback bytes, skipped
    columns and host build ms; with the tracer on, the stage breakdown.
    The host presort must have been the native library's."""
    import dataclasses

    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.ops import engine_seg as ES
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    cfg = sketch_cfg(platform_config, B=B, seg_fallback=True)
    c = bench_client(st, SentinelClient, cfg, CB_DEPTH)
    tail_ids = np.array([c.registry.peek_resource_id(f"tail-{r}") for r in range(N_TAIL_RULED)], np.int64)
    promoted = int((tail_ids < cfg.node_rows).sum())
    traffic, max_segs = bench_traffic(np, PS, c, B, tail_ids)
    want_u = min(B, -(-int(max_segs * 1.3 + 256) // 128) * 128)
    if want_u > ES.seg_capacity(c.cfg, B):
        c._resize_seg_u(want_u)
    seg_u = c.cfg.seg_u

    # depth 4 against depth 0 on a virtual clock (the hot-set manager's real
    # clock cadence held off, so both see the same rule set throughout)
    verdicts = {}
    for depth in (CB_DEPTH, 0):
        vc = bench_client(st, SentinelClient, dataclasses.replace(c.cfg, hotset_eval_s=1e9), depth,
                          VirtualTimeSource(1_000_000))
        got = []
        for k in range(4):
            parts = [traffic[(2 * k) % 6], traffic[(2 * k + 1) % 6]]
            ids, onode, oid, ph, inb, rt = (np.concatenate(x) for x in zip(*parts))
            fut = vc.submit_block(ids, origin_node=onode, origin_id=oid, param_hash=ph, inbound=inb)
            vc.submit_completion_block(ids, rt, inbound=inb, param_hash=ph)
            got.append(fut.result(timeout=60))
            vc.time.advance(250)
        verdicts[depth] = got
        check(vc.seg_dropped_total == 0 and vc.wire_decode_failures == 0, ("client_bench virtual", depth))
        vc.stop()
        del vc
    for (va, wa), (vb, wb) in zip(verdicts[CB_DEPTH], verdicts[0]):
        check(np.array_equal(va, vb) and np.array_equal(wa, wb),
              f"client_bench B={B}: verdicts at pipeline_depth {CB_DEPTH} differ from depth 0 (virtual clock)")
    virtual_mix = np.bincount(np.concatenate([v for v, _w in verdicts[0]]), minlength=7).tolist()
    del verdicts
    torch.cuda.empty_cache()

    c._warm_shapes()
    off = measured_bench_run(np, FU, SC, torch, c, traffic, trace=False)
    on = measured_bench_run(np, FU, SC, torch, c, traffic, trace=True)
    info = dict(seg_dropped_total=c.seg_dropped_total, wire_decode_failures=c.wire_decode_failures,
                readback_buffers=c._readback.allocated, host_sort=c.host_sort,
                host_build_ms_avg_since_start=c.host_build_ms_avg)
    c.stop()
    del c
    torch.cuda.empty_cache()
    out = dict(batch=B, blocks=CB_BLOCKS, pipeline_depth=CB_DEPTH, inflight=CB_DEPTH + 4, seg_u=seg_u,
               max_segments=max_segs, promoted_tail=promoted, virtual_clock_mix=virtual_mix,
               tracer_off=off, tracer_on=on, **info)
    # the untraced run is the measurement; the traced one splits it
    out.update({k: off[k] for k in ("dps", "effective_tick_ms", "req_p50_ms", "req_p99_ms", "verdict_mix",
                                      "launches", "fallback_ticks")})
    for run in (off, on):
        for kname in ("scatter_many", "seg_excl_cumsum", "seg_incl_min"):
            check(run["launches"][kname] > 0, ("client_bench", B, kname, run["launches"]))
        mix = run["verdict_mix"]
        check(mix[0] > 0 and sum(mix[1:6]) > 0, ("client_bench", B, mix))
        check(run["wire_tx_bytes_a_tick"] > 0 and run["wire_rx_bytes_a_tick"] > 0, ("client_bench wire", B, run))
    check(info["seg_dropped_total"] == 0 and info["wire_decode_failures"] == 0, ("client_bench", B, info))
    check(info["host_sort"] == "native",
          f"client_bench B={B}: the host presort ran {info['host_sort']!r}, not the native library")
    stages = on["stage_breakdown_ms"]
    check(set(stages) == {"tick.assemble", "tick.presort", "tick.dispatch", "tick.device", "tick.readback",
                          "tick.resolve"}, ("client_bench stage spans", B, sorted(stages)))
    check(off["stage_breakdown_ms"] == {}, ("client_bench: spans recorded with the tracer off", B))
    log(f"[client_bench] B={B}: dps {off['dps']:.0f}, effective_tick_ms {off['effective_tick_ms']:.3f}, "
        f"req_p50_ms {off['req_p50_ms']:.3f}, req_p99_ms {off['req_p99_ms']:.3f} ({CB_BLOCKS} blocks, "
        f"pipeline_depth {CB_DEPTH}, {CB_DEPTH + 4} in flight, tracer off; {smi}); verdict mix "
        f"{off['verdict_mix']}; ticks that took the per-item branch {off['fallback_ticks']}; seg_u {seg_u} "
        f"(peak {max_segs}); {promoted} tail names promoted; kernel launches {json.dumps(off['launches'])}; "
        f"depth {CB_DEPTH} == depth 0 on a virtual clock (8 ticks, verdict mix {virtual_mix})")
    log(f"[client_bench] B={B}: tracer on: dps {on['dps']:.0f} (off {off['dps']:.0f}), effective_tick_ms "
        f"{on['effective_tick_ms']:.3f}; host_build_ms_avg {on['host_build_ms_avg']:.3f} (off "
        f"{off['host_build_ms_avg']:.3f}); a tick: wire tx {on['wire_tx_bytes_a_tick']:.0f} B, rx "
        f"{on['wire_rx_bytes_a_tick']:.0f} B, columns skipped {on['cols_skipped_a_tick']:.2f}; host sort "
        f"{info['host_sort']}; {on['ticks']} ticks ({smi})")
    log(f"[client_bench] B={B}: stage_breakdown_ms (p50 / p99 / mean, {on['ticks']} ticks): " + "; ".join(
        f"{k} {v['p50_ms']} / {v['p99_ms']} / {v['mean_ms']}" for k, v in stages.items()))
    return out


def measured_bench_run(np, FU, SC, torch, c, traffic, trace: bool) -> dict:
    """client_bench's measured loop (bench.py:472-516): 32 blocks with
    depth + 4 in flight, fed closed-loop from the resolver's callbacks
    while this thread drives tick_once; kernel launch counts reset just
    before and read just after.  With ``trace`` the span tracer is on for
    the run (the stage breakdown: p50 / p99 / mean ms of each tick.*
    stage); the upload and readback bytes, skipped columns and host build
    time are deltas over the run, a tick."""
    from sentinel_tpu_torch import obs
    from sentinel_tpu_torch.runtime import client as TCL

    wire = (TCL._C_WIRE["tx"], TCL._C_WIRE["rx"], TCL._C_COLS_SKIPPED)
    c.seg_fallback_ticks = 0
    feed_lock = threading.Lock()
    progress = {"done": 0, "next": 0}
    lat, results, t_submit = [], [], {}

    def feed():
        with feed_lock:
            k = progress["next"]
            if k >= CB_BLOCKS:
                return
            progress["next"] = k + 1
        ids, onode, oid, ph, inb, rt = traffic[k % 6]
        t_submit[k] = time.perf_counter()
        fut = c.submit_block(ids, origin_node=onode, origin_id=oid, param_hash=ph, inbound=inb)
        c.submit_completion_block(ids, rt, inbound=inb, param_hash=ph)

        def on_done(f, k=k):
            # runs on the resolver thread: everything shared is locked
            with feed_lock:
                lat.append(time.perf_counter() - t_submit[k])
                progress["done"] += 1
                results.append(f.result()[0])
            feed()

        fut.add_done_callback(on_done)

    inflight = CB_DEPTH + 4
    torch.cuda.synchronize()
    obs.TRACER.reset()
    if trace:
        obs.enable()
    w0 = [m.value for m in wire]
    b0 = (c._build_ms_sum, c._build_ticks)
    FU.reset_launches()
    SC.reset_launches()
    try:
        t0 = time.perf_counter()
        for _ in range(min(inflight, CB_BLOCKS)):
            feed()
        while progress["done"] < CB_BLOCKS:
            c.tick_once()
        wall = time.perf_counter() - t0
    finally:
        obs.disable()
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    ticks = c._build_ticks - b0[1]
    tx, rx, skipped = (m.value - v for m, v in zip(wire, w0))
    stages = obs.summarize(obs.TRACER.snapshot(), prefix="tick.")
    obs.TRACER.reset()
    lat_ms = np.sort(np.array(lat[inflight:] or lat)) * 1000.0
    return dict(dps=CB_BLOCKS * len(traffic[0][0]) / wall, effective_tick_ms=wall / CB_BLOCKS * 1000.0,
                req_p50_ms=float(lat_ms[len(lat_ms) // 2]), req_p99_ms=float(lat_ms[int(len(lat_ms) * 0.99)]),
                verdict_mix=np.bincount(np.concatenate(results), minlength=7).tolist(), launches=launches,
                fallback_ticks=c.seg_fallback_ticks, ticks=ticks,
                host_build_ms_avg=(c._build_ms_sum - b0[0]) / max(ticks, 1),
                wire_tx_bytes_a_tick=tx / max(ticks, 1), wire_rx_bytes_a_tick=rx / max(ticks, 1),
                cols_skipped_a_tick=skipped / max(ticks, 1), stage_breakdown_ms=stages)


# -- phase 8: cluster flow control (the token column, server and clients) --------------

#: the token column's stream: flow slots, chunks, and the step it is re-projected at
COLUMN_SLOTS = 1_024
COLUMN_CHUNKS = 48
COLUMN_PUSH_AT = 24
#: the serving run: cluster flow rules (half GLOBAL, half AVG_LOCAL), cluster
#: param rules on the hottest resources, entry() calls over N_THREADS threads
#: (each with one argument), and check_batch calls at B = 2,048 (no argument:
#: one token round trip a distinct resource)
CLUSTER_FLOWS = 1_000
CLUSTER_PARAMS = 32
CLUSTER_ENTRIES = 480
CLUSTER_BULK = (1, 2_048)
#: the serving client's token request timeout.  The default, 200 ms
#: (cluster/constants.DEFAULT_REQUEST_TIMEOUT_MS), is shorter than the
#: port's engine-backed decisions take at the tail on the card: a param
#: token waits for one to two eager decision-client ticks while the
#: serving client's ticks share the host (a run at 200 ms timed out 14 of
#: 126 param tokens and degraded the client for 5 s each time).  The run
#: sets it through the client config and counts the calls past 200 ms.
CLUSTER_REQUEST_TIMEOUT_MS = 1_000


def _column_service(time_source, device):
    """What a column batcher reads of its token service: the decision
    client's clock and device (no timeline, no registry)."""
    import types

    client = types.SimpleNamespace(time=time_source, timeline=None, registry=None, device=device)
    return types.SimpleNamespace(client=client)


def _decide_now(batcher, entries, now) -> list:
    """Decide ``entries`` as one drain of the batcher's worker does (chunks
    of CAPACITY, presorted by slot), on this thread, so the chunks are the
    same on both devices; returns each entry's (granted, observed, limit)."""
    from concurrent.futures import Future

    queued = [(*e, Future()) for e in entries]
    with batcher._s_lock:
        for i in range(0, len(queued), batcher.CAPACITY):
            batcher._decide_chunk(queued[i : i + batcher.CAPACITY], now)
    return [q[-1].result(timeout=0) for q in queued]


def column_entries(np, rng, fids, n):
    """n column entries (flow id, units, partial, forced): Zipf(1.1) over
    ``fids``, asks 1..8, 40 % partial grants, 5 % forced (occupy-ahead)."""
    w = 1.0 / np.arange(1, len(fids) + 1) ** 1.1
    pick = rng.choice(len(fids), size=n, p=w / w.sum())
    units = rng.integers(1, 9, n)
    kind = rng.random(n)
    return [(int(fids[k]), int(u), bool(x < 0.4), bool(x > 0.95)) for k, u, x in zip(pick, units, kind)]


def column_phase(np, torch, S, TTS, VirtualTimeSource, device="cuda") -> dict:
    """The token column's stream on ``device`` and on the CPU: equal
    answers and state leaves after every chunk; the card's ms a chunk and
    device launches a chunk."""
    rng = np.random.default_rng(SEED + 8)
    vt = VirtualTimeSource(10_000)
    thr_a = {f: float(rng.integers(20, 400)) for f in range(1, COLUMN_SLOTS + 1)}
    # the push: 128 flows dropped, 256 added (recycled rows, then growth to
    # 2,048 slots), the others re-thresholded
    kept = [f for f in thr_a if f > 128]
    thr_b = {f: float(rng.integers(20, 400)) for f in kept + list(range(5_001, 5_257))}
    cols = {k: TTS.TokenColumnBatcher(_column_service(vt, torch.device(d))) for k, d in (("dev", device), ("cpu", "cpu"))}
    chunk_ms, now, granted, denied = [], vt.now_ms(), 0, 0
    try:
        for b in cols.values():
            b.project(thr_a)
        for i in range(COLUMN_CHUNKS):
            if i == COLUMN_PUSH_AT:
                for b in cols.values():
                    b.project(thr_b)
            fids = sorted(thr_b if i >= COLUMN_PUSH_AT else thr_a)
            entries = column_entries(np, rng, fids, TTS.TokenColumnBatcher.CAPACITY)
            t = time.perf_counter()
            got = _decide_now(cols["dev"], entries, now)
            chunk_ms.append((time.perf_counter() - t) * 1e3)
            want = _decide_now(cols["cpu"], entries, now)
            check(got == want, f"token column chunk {i}: the card's answers differ from the CPU's")
            la, lb = S.leaves(cols["dev"]._state), S.leaves(cols["cpu"]._state)
            for k in la:
                check(torch.equal(la[k].cpu(), lb[k]), f"token column chunk {i}: state leaf {k} differs")
            granted += sum(1 for g, _o, _l in got if g > 0)
            denied += sum(1 for g, _o, _l in got if g == 0)
            now += int(rng.choice([0, 13, 60, 100, 170]))
        check(granted > 0 and denied > 0, ("token column: no grant or no deny", granted, denied))
        out = dict(chunks=COLUMN_CHUNKS, entries_a_chunk=TTS.TokenColumnBatcher.CAPACITY, slots_final=cols["dev"]._cap,
                   granted=granted, denied=denied, chunk_ms=chunk_ms,
                   chunk_ms_median=sorted(chunk_ms[2:])[len(chunk_ms[2:]) // 2])
        if device == "cuda":
            out.update(column_device_report(np, torch, cols["dev"], rng, sorted(thr_b), now))
        return out
    finally:
        for b in cols.values():
            b.close()


def column_device_report(np, torch, batcher, rng, fids, now) -> dict:
    """One chunk's decision on the card: ``decide_batch`` alone (device ms
    by CUDA events, on a copy of the state) and the whole chunk's device
    launches and copies (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.ops import token_col as TC

    cap = batcher.CAPACITY
    entries = column_entries(np, rng, fids, cap)
    slots = np.sort(rng.integers(0, batcher._next_slot, cap)).astype(np.int32)
    args = [torch.from_numpy(x).cuda() for x in (
        slots, rng.integers(1, 9, cap).astype(np.int32),
        np.maximum.accumulate(np.where(np.r_[True, slots[1:] != slots[:-1]], np.arange(cap), 0)).astype(np.int32),
    )] + [torch.from_numpy(rng.random(cap) < p).cuda() for p in (0.4, 0.05)]
    base = E.clone_state(batcher._state)

    def decide():
        TC.decide_batch(base, now, *args)

    dev_ms, host_ms = time_ms(decide, reps=30)
    evs = []
    for _session in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                _decide_now(batcher, entries, now)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if evs:
            break
    check(evs, "token column: the profiler saw no device event in 3 sessions")
    copies = sum(1 for e in evs if "memcpy" in e.name.lower())
    return dict(decide_device_ms=dev_ms, decide_host_ms=host_ms, device_launches_a_chunk=(len(evs) - copies) / 4,
                copies_a_chunk=copies / 4, device_us_a_chunk=sum(e.time_range.elapsed_us() for e in evs) / 4)


def cluster_rules(np, st, C):
    """1,000 cluster flow rules (``cres-<i>``, flow id i + 1, half GLOBAL,
    half AVG_LOCAL, counts 5..59 from the seed) and 32 cluster param rules
    on the 32 hottest (flow id 10,001 + i, 2..5 a value a second)."""
    rng = np.random.default_rng(SEED + 81)
    flow = [st.FlowRule(resource=f"cres-{i}", count=int(rng.integers(5, 60)), cluster_mode=True,
                        cluster_flow_id=i + 1,
                        cluster_threshold_type=C.FLOW_THRESHOLD_GLOBAL if i % 2 else C.FLOW_THRESHOLD_AVG_LOCAL)
            for i in range(CLUSTER_FLOWS)]
    param = [st.ParamFlowRule(resource=f"cres-{i}", count=int(rng.integers(2, 6)), cluster_mode=True,
                              cluster_flow_id=10_001 + i) for i in range(CLUSTER_PARAMS)]
    return flow, param


def windows_within(events, bucket_ms, n_buckets, limits) -> tuple:
    """events: (now_ms, key, units).  The largest sum of units of one key
    over ``n_buckets`` consecutive buckets, against its limit: (violations,
    the largest sum over limit seen)."""
    per = {}
    for now, key, u in events:
        b = per.setdefault(key, {})
        k = int(now) // bucket_ms
        b[k] = b.get(k, 0) + u
    bad, worst = [], 0.0
    for key, buckets in per.items():
        for k in buckets:
            total = sum(buckets.get(k - j, 0) for j in range(n_buckets))
            worst = max(worst, total / limits[key] if limits[key] > 0 else float(total > 0))
            if total > limits[key]:
                bad.append((key, k, total, limits[key]))
    return bad, worst


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def cluster_serving_run(np, st, FU, SC, torch, cfg, use_col, device="cuda", n_entries=CLUSTER_ENTRIES,
                        bulk=CLUSTER_BULK, request_timeout_ms=CLUSTER_REQUEST_TIMEOUT_MS) -> dict:
    """A decision client with a DefaultTokenService and a ClusterTokenServer
    on 127.0.0.1, a serving client attached through ClusterStateManager,
    both threaded on ``device`` at ``cfg``: entry() traffic from N_THREADS
    threads, then the bulk check_batch; the thresholds held in every
    window; HELLO at v3 and BATCH frames counted; the server stopped (the
    serving client degrades to its local fallback rules) and restarted
    (it comes back).  ``request_timeout_ms``: the token client's timeout
    (None: the default, 200 ms; see CLUSTER_REQUEST_TIMEOUT_MS)."""
    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster import server as SRV
    from sentinel_tpu_torch.cluster import state as STM
    from sentinel_tpu_torch.cluster import token_service as TS
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.obs.registry import REGISTRY

    flow, param = cluster_rules(np, st, C)
    dec = st.SentinelClient(cfg=cfg, mode="threaded", device=device)
    dec.start()
    svc = TS.DefaultTokenService(dec, use_token_column=use_col)
    svc.flow_rules.load("default", flow)
    svc.param_rules.load("default", param)
    srv = SRV.ClusterTokenServer(svc, host="127.0.0.1", port=0)
    srv.start()
    app = st.SentinelClient(cfg=cfg, mode="threaded", device=device)
    app.start()
    mgr = STM.ClusterStateManager()
    if request_timeout_ms is not None:
        mgr.client_config.request_timeout_ms = request_timeout_ms
    out = {"use_token_column": use_col, "request_timeout_ms": mgr.client_config.request_timeout_ms}
    try:
        mgr.set_to_client("127.0.0.1", srv.port)
        app.set_cluster(mgr)
        app.flow_rules.load(flow)
        app.param_flow_rules.load(param)
        tok = mgr.token_service()
        deadline = time.monotonic() + 10
        while tok.peer_version < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        out["peer_version"] = tok.peer_version
        check(tok.peer_version >= 2, f"cluster: HELLO did not reach v2 ({tok.peer_version})")

        # the serving side's token calls, timed, with their statuses
        calls = {"request_token": [], "request_param_token": [], "request_token_batch": []}
        lock = threading.Lock()

        def timed(name):
            real = getattr(tok, name)

            def call(*a, **kw):
                t = time.perf_counter()
                r = real(*a, **kw)
                ms = (time.perf_counter() - t) * 1e3
                units = a[1] if len(a) > 1 else kw.get("count", kw.get("units", 1))
                with lock:
                    calls[name].append((ms, r.status, int(units), t - t_start[0]))
                return r
            return call

        t_start = [time.perf_counter()]
        for name in calls:
            setattr(tok, name, timed(name))
        # the server's decisions with the time each was decided at
        decided = []
        if use_col:
            real_col = svc.col._run_column

            def cap_col(cols, now):
                g, o = real_col(cols, now)
                decided.append((now, cols.copy(), g.copy()))
                return g, o
            svc.col._run_column = cap_col
        else:
            real_tick = dec._run_tick

            def cap_tick(acq, comp, now_ms, blocks=()):
                p = real_tick(acq, comp, now_ms, blocks=blocks)
                decided.append((p.now_ms, list(p.acq)))
                return p
            dec._run_tick = cap_tick

        wire = {d: REGISTRY.get("sentinel_wire_bytes_total", {"path": "cluster", "direction": d}) for d in ("tx", "rx")}
        frames = REGISTRY.get("sentinel_cluster_batch_frames_total", {"direction": "tx"})
        w0 = {d: c.value for d, c in wire.items()}
        f0 = frames.value if frames is not None else 0.0
        rng = np.random.default_rng(SEED + 82)
        zipf = zipf_probs(np, CLUSTER_FLOWS)
        vals = zipf_probs(np, N_VALUES)
        per_thread = n_entries // N_THREADS
        plan = [(rng.choice(CLUSTER_FLOWS, size=per_thread, p=zipf), rng.choice(N_VALUES, size=per_thread, p=vals),
                 rng.random(per_thread) < 0.1) for _ in range(N_THREADS)]
        outcomes = {}

        def worker(picks, values, prios):
            mine = {}
            for r, v, pr in zip(picks, values, prios):
                try:
                    app.entry(f"cres-{int(r)}", prioritized=bool(pr), args=[arg_value(int(v))]).exit()
                    k = "pass"
                except ERR.BlockException as e:
                    k = type(e).__name__
                mine[k] = mine.get(k, 0) + 1
            with lock:
                for k, n in mine.items():
                    outcomes[k] = outcomes.get(k, 0) + n

        FU.reset_launches()
        SC.reset_launches()
        threads = [threading.Thread(target=worker, args=p) for p in plan]
        t0 = t_start[0] = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        t_entries = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "cluster: a request thread did not finish")
        n_bulk, b = bulk
        bulk_mix = np.zeros(7, np.int64)
        t1 = time.perf_counter()
        for _ in range(n_bulk):
            picks = rng.choice(CLUSTER_FLOWS, size=b, p=zipf)
            res = app.check_batch([f"cres-{int(r)}" for r in picks])
            bulk_mix += np.bincount([v for v, _w in res], minlength=7)
        t_bulk = time.perf_counter() - t1
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        # the thresholds: a flow's units granted other than by occupy-ahead
        # stay within its threshold in every window of the decision path
        limits = {}
        if use_col:
            svc.col._run_column = real_col
            slot_limit = {svc.col._slots[f]: thr for f, thr in svc.col._limits_by_fid.items()}
            events = []
            for now, cols, g in decided:
                live = cols[1] > 0
                for s, gr, fo in zip(cols[0][live], g[live], cols[4][live]):
                    if not fo:
                        events.append((now, int(s), int(gr)))
            limits = slot_limit
            bad, worst = windows_within(events, 100, 10, limits)
        else:
            dec._run_tick = real_tick
            fid_of = {dec.registry.peek_resource_id(f"$cluster/flow/{r.cluster_flow_id}"): r.cluster_flow_id
                      for r in flow}
            thr = {r.cluster_flow_id: float(r.count) for r in flow}
            events = []
            for now, acq in decided:
                for a in acq:
                    fid = fid_of.get(a.res)
                    if fid is not None and a.future.done() and a.future.result()[0] == ERR.PASS:
                        events.append((now, fid, a.count))
            limits = thr
            bad, worst = windows_within(events, cfg.second_window_ms, cfg.second_sample_count, limits)
        check(not bad, f"cluster: a flow was granted past its threshold in a window: {bad[:5]}")
        check(events, "cluster: the server decided no flow token")
        statuses = {}
        for name, rows in calls.items():
            for _ms, stt, _u, _t in rows:
                statuses[f"{name}:{stt}"] = statuses.get(f"{name}:{stt}", 0) + 1
        failed = [(name, round(t, 3), round(ms, 3)) for name, rows in calls.items()
                  for ms, stt, _u, t in rows if stt == C.STATUS_FAIL]
        slow = sorted(((round(ms, 3), name, round(t, 3)) for name, rows in calls.items() for ms, _s, _u, t in rows),
                      reverse=True)[:10]
        check(not failed, ("cluster: token calls failed (call, s into the run, ms)", failed[:20], statuses,
                           "slowest calls (ms, call, s into the run)", slow))
        check(not app._cluster_degraded_active, "cluster: the serving client degraded during the run")
        frames_tx = (frames.value if frames is not None else 0.0) - f0
        check(frames_tx > 0, "cluster: no v2 BATCH frame was sent")
        lat = [ms for ms, *_r in calls["request_token"]]
        bulk_lat = [ms for ms, *_r in calls["request_token_batch"]]
        param_lat = [ms for ms, *_r in calls["request_param_token"]]
        units_entries = sum(u for rows in (calls["request_token"], calls["request_param_token"]) for _m, _s, u, _r in rows)
        units_bulk = sum(u for _m, _s, u, _r in calls["request_token_batch"])
        out.update(
            entries=n_entries, entry_outcomes=outcomes, entries_s=t_entries, bulk_calls=n_bulk, bulk_b=b,
            bulk_mix=bulk_mix.tolist(), bulk_s=t_bulk,
            tokens_per_s_entries=units_entries / t_entries, tokens_per_s_bulk=units_bulk / t_bulk,
            decision_p50_ms=_pct(lat, 0.5), decision_p99_ms=_pct(lat, 0.99),
            bulk_call_p50_ms=_pct(bulk_lat, 0.5), bulk_call_p99_ms=_pct(bulk_lat, 0.99),
            param_p50_ms=_pct(param_lat, 0.5), param_p99_ms=_pct(param_lat, 0.99),
            calls_past_200ms={k: sum(1 for ms, *_r in v if ms > 200.0) for k, v in calls.items()},
            token_calls={k: len(v) for k, v in calls.items()}, statuses=statuses,
            cluster_tx_bytes=wire["tx"].value - w0["tx"], cluster_rx_bytes=wire["rx"].value - w0["rx"],
            batch_frames_tx=frames_tx, window_events=len(events), window_worst_fill=worst,
            kernel_launches_run=launches,
        )
        check(outcomes.get("pass", 0) > 0 and outcomes.get("FlowException", 0) + bulk_mix[ERR.BLOCK_FLOW] > 0,
              ("cluster: the traffic met no cluster flow deny", outcomes, bulk_mix.tolist()))
        if device == "cuda":
            for kname in ("scatter_many", "gather_many", "seg_incl_min"):
                check(launches[kname] > 0, ("cluster: a kernel of the path was not launched", kname, launches))
            out["decision_client"] = decision_client_profile(FU, SC, torch, svc, dec, flow, param)
        out["degrade"], srv = degrade_and_recover(SRV, ERR, app, svc, srv, tok, flow)
        return out
    finally:
        mgr.stop()
        srv.stop()
        svc.close()
        app.stop()
        dec.stop()


def decision_client_profile(FU, SC, torch, svc, dec, flow, param) -> dict:
    """With the serving client idle: the decision path's device work for a
    flow token batch (the column, or the decision client's ticks) and for a
    param token (the decision client's ticks), each 4 times under the
    profiler; the ticks the decision client ran, its device launches a
    tick and which of B1-B4 it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in (("flow_batch", lambda: svc.request_token_batch(flow[0].cluster_flow_id, 16)),
                      ("param", lambda: svc.request_param_token(param[0].cluster_flow_id, 1, ["v-profile"]))):
        fn()
        torch.cuda.synchronize()
        evs = []
        for _session in range(3):
            FU.reset_launches()
            SC.reset_launches()
            ticks0 = dec._build_ticks
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if evs:
                break
        ticks = dec._build_ticks - ticks0
        # a flow token batch is one column call when the column decides it
        cols = 4 if svc.col is not None and label == "flow_batch" else 0
        kernels = dict(FU.LAUNCHES, **SC.LAUNCHES)
        out[label] = dict(decision_ticks=ticks, column_calls=cols, device_events=len(evs),
                          device_launches_a_tick=(len(evs) / ticks) if ticks else None,
                          device_launches_a_column_call=(len(evs) / cols) if cols and not ticks else None,
                          b1_b4=kernels, b1_b4_launched=sorted(k for k, n in kernels.items() if n))
    return out


def degrade_and_recover(SRV, ERR, app, svc, srv, tok, flow) -> tuple:
    """Stop the token server: the serving client degrades and its fallback
    rules block locally (the flow with the smallest threshold, hammered);
    restart it on the same port: the first answered probe brings the
    client back.  Returns (report, the restarted server)."""
    port = srv.port
    app.cluster_retry_interval_s = 0.0  # every entry probes again
    tok.reconnect_interval_s = 0.05
    srv.stop()
    target = min(flow, key=lambda r: r.count)
    seen = {}
    for _ in range(int(target.count) + 6):
        try:
            app.entry(target.resource).exit()
            k = "pass"
        except ERR.BlockException as e:
            k = type(e).__name__
        seen[k] = seen.get(k, 0) + 1
    check(app._cluster_degraded_active, "cluster: stopping the server did not degrade the serving client")
    check(seen.get("FlowException", 0) > 0, ("cluster: the local fallback rules blocked nothing", seen))
    srv2 = SRV.ClusterTokenServer(svc, host="127.0.0.1", port=port)
    srv2.start()
    t = time.perf_counter()
    probes = 0
    while app._cluster_degraded_active and time.perf_counter() - t < 60:
        probes += 1
        try:
            app.entry(flow[-1].resource).exit()
        except ERR.BlockException:
            pass
        time.sleep(0.02)
    check(not app._cluster_degraded_active, "cluster: the serving client did not come back after the restart")
    return dict(degraded_entries=seen, target=target.resource, target_count=target.count, probes_to_recover=probes,
                recover_s=time.perf_counter() - t), srv2


def cluster_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 8: the token column (card against CPU), then a token server
    and its clients over loopback TCP on the card, on both decision paths."""
    from sentinel_tpu_torch.cluster import token_service as TTS
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    rep = {"card": smi}
    col = column_phase(np, torch, S, TTS, VirtualTimeSource)
    rep["column"] = col
    log(f"[cluster] {smi}: token column, {col['chunks']} chunks of {col['entries_a_chunk']} entries over "
        f"{COLUMN_SLOTS} flow slots (one re-projection at chunk {COLUMN_PUSH_AT}: 128 flows dropped, 256 added, "
        f"{col['slots_final']} slots), Zipf(1.1), partial / strict / forced: the card's granted, observed and every "
        f"state leaf equal the CPU's after every chunk ({col['granted']} granted, {col['denied']} denied); "
        f"{col['chunk_ms_median']:.4f} ms a chunk (median; host presort + one upload + decide + one readback); "
        f"decide_batch alone {col['decide_device_ms']:.4f} ms device, {col['decide_host_ms']:.4f} ms host enqueue; "
        f"{col['device_launches_a_chunk']:g} device launches and {col['copies_a_chunk']:g} copies a chunk "
        f"({col['device_us_a_chunk']:.1f} us device)")
    for use_col in (True, False):
        r = cluster_serving_run(np, st, FU, SC, torch, platform_config(), use_col)
        rep[f"serving_{'column' if use_col else 'engine'}"] = r
        dp = r.get("decision_client", {})
        log(f"[cluster] {smi}: use_token_column={use_col}: HELLO at v{r['peer_version']}; {r['entries']} entry() "
            f"calls from {N_THREADS} threads in {r['entries_s']:.2f} s ({r['tokens_per_s_entries']:.0f} tokens/s), "
            f"outcomes {json.dumps(r['entry_outcomes'], sort_keys=True)}; decision (serving client -> token server "
            f"-> back) p50 {r['decision_p50_ms']:.3f} ms, p99 {r['decision_p99_ms']:.3f} ms (param tokens p50 "
            f"{r['param_p50_ms']:.3f}, p99 {r['param_p99_ms']:.3f}; timeout {r['request_timeout_ms']} ms, calls past 200 ms "
            f"{json.dumps(r['calls_past_200ms'], sort_keys=True)}); bulk "
            f"{r['bulk_calls']} x check_batch(B={r['bulk_b']}) in {r['bulk_s']:.2f} s ({r['tokens_per_s_bulk']:.0f} "
            f"tokens/s), verdict mix {r['bulk_mix']}, batch call p50 {r['bulk_call_p50_ms']:.3f} / p99 "
            f"{r['bulk_call_p99_ms']:.3f} ms; token statuses {json.dumps(r['statuses'], sort_keys=True)}; cluster "
            f"tx {r['cluster_tx_bytes']:.0f} B, rx {r['cluster_rx_bytes']:.0f} B, {r['batch_frames_tx']:.0f} BATCH "
            f"frames tx; thresholds held in every window ({r['window_events']} grants, fullest window "
            f"{r['window_worst_fill']:.3f} of its threshold); kernel launches in the run (both clients) "
            f"{json.dumps(r['kernel_launches_run'])}")
        for label, d in dp.items():
            log(f"[cluster] {smi}: use_token_column={use_col}: decision path, {label}, 4 calls alone: "
                f"{d['decision_ticks']} decision-client ticks, {d['column_calls']} column calls, "
                f"{d['device_events']} device events ({d['device_launches_a_tick']} a tick, "
                f"{d['device_launches_a_column_call']} a column call); B1-B4 launched {d['b1_b4_launched']} "
                f"{json.dumps(d['b1_b4'])}")
        g = r["degrade"]
        log(f"[cluster] {smi}: use_token_column={use_col}: server stopped -> degraded, local fallback on "
            f"{g['target']} (threshold {g['target_count']}): {json.dumps(g['degraded_entries'], sort_keys=True)}; "
            f"server restarted -> back to the token server after {g['probes_to_recover']} probes "
            f"({g['recover_s']:.2f} s)")
    return rep


# -- phase 9: the control plane ---------------------------------------------------------

#: request threads' arguments and origins in phase 9: entries carry one
#: argument; 1 in 20 on the 50 hottest names comes from origin "bad"
CONTROL_ORIGIN_NAMES = 50
#: HTTP round trips a command: the two whole-map reads, the rest
CONTROL_HEAVY_REPS = 3
CONTROL_LIGHT_REPS = 15
#: wall seconds the metric timer writes for
CONTROL_METRIC_S = 5


class StateReader:
    """What ``ClientStats`` and ``SentinelClient.rt_quantiles`` read off a
    client — its config, registry and state, a clock frozen at one
    ``now_ms`` and a lock of its own — so that the card's state and a copy
    of it on the CPU go through the same reader code at the same time."""

    def __init__(self, client, state, now_ms: int, device):
        import torch

        self.cfg, self.registry = client.cfg, client.registry
        self._state, self.device = state, torch.device(device)
        self._engine_lock = threading.Lock()
        self.time = self
        self._now = int(now_ms)

    def now_ms(self) -> int:
        return self._now

    def reads(self, qs=(0.5, 0.9, 0.99, 0.999)) -> dict:
        from sentinel_tpu_torch.runtime.client import ClientStats, SentinelClient

        stats = ClientStats(self)
        origins = {f"{k[1]}": stats._row_stats(row) for k, row in self.registry.extra_rows().items()
                   if k[0] == "origin"}
        return dict(snapshot=stats.snapshot(), origin=origins, entry=stats.entry_node(),
                    rtq=SentinelClient.rt_quantiles(self, qs))


def state_to(x, device):
    """A (nested) state NamedTuple's tensors copied to ``device``."""
    if hasattr(x, "to") and not isinstance(x, tuple):
        return x.to(device, copy=True)
    return type(x)(*[state_to(v, device) for v in x])


def reads_equal(got, want, path="") -> list:
    """Where two reader results differ: ints and strings must be equal,
    floats within rtol 1e-6 (atol 1e-4)."""
    bad = []
    if isinstance(want, dict):
        if list(got.keys()) != list(want.keys()):
            return [f"{path}: keys differ"]
        for k in want:
            bad += reads_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float):
        if not abs(got - want) <= 1e-4 + 1e-6 * abs(want):
            bad.append(f"{path}: {got} != {want}")
    elif got != want or type(got) is not type(want):
        bad.append(f"{path}: {got!r} != {want!r}")
    return bad


def card_against_cpu(client, torch) -> tuple:
    """The readers on the card's state against the same readers on a CPU
    copy of it, at one frozen time (the client idle): (differences, the
    number of values compared)."""
    with client._engine_lock:
        now = client.time.now_ms()
        cpu_state = state_to(client._state, "cpu")
    card = StateReader(client, client._state, now, client.device).reads()
    cpu = StateReader(client, cpu_state, now, "cpu").reads()
    n = sum(len(v) for v in card["snapshot"].values()) + sum(len(v) for v in card["origin"].values())
    return reads_equal(card, cpu), n, card


def http_call(url, data=None, token=None):
    """(ms, status, body bytes) of one HTTP round trip."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET")
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as rsp:
            body, status = rsp.read(), rsp.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    return (time.perf_counter() - t) * 1e3, status, body


def control_traffic(np, st, client, names, stop, outcomes, lock, seed):
    """One closed-loop request thread: Zipf(1.1) names, one argument from
    10,000 values, 1 in 20 of the hottest names from origin "bad", real
    exits (1 in 20 after 2 ms); every outcome counted (a lost entry is any
    other exception)."""
    probs, vprobs = zipf_probs(np, N_NAMES), zipf_probs(np, N_VALUES)
    rng = np.random.default_rng(seed)
    local = {}
    while not stop.is_set():
        picks = rng.choice(N_NAMES, size=64, p=probs)
        values = rng.choice(N_VALUES, size=64, p=vprobs)
        for k, v in zip(picks, values):
            origin = "bad" if k < CONTROL_ORIGIN_NAMES and rng.random() < 0.05 else None
            try:
                e = client.entry(names[k], args=[arg_value(v)], origin=origin, inbound=bool(rng.random() < 0.5))
                if rng.random() < 0.03:
                    e.trace(RuntimeError("business error"))
                if rng.random() < 0.05:
                    time.sleep(0.002)  # a call that takes a while: the RT histogram's input
                e.exit()
                kind = "pass"
            except st.BlockException as exc:
                kind = type(exc).__name__
            except Exception as exc:  # counted: the phase fails on any
                kind = f"lost:{type(exc).__name__}"
            local[kind] = local.get(kind, 0) + 1
            if stop.is_set():
                break
    with lock:
        for k, v in local.items():
            outcomes[k] = outcomes.get(k, 0) + v


def control_flow_ok(client, snap, limits) -> tuple:
    """Every DEFAULT flow rule's windowed pass count (from a snapshot)
    against its threshold: (violations, the fullest window's share)."""
    interval_s = client.cfg.second_sample_count * client.cfg.second_window_ms / 1000.0
    bad, worst = [], 0.0
    for name, limit in limits.items():
        s = snap.get(name)
        if s is None:
            continue
        passed = s["passQps"] * interval_s
        worst = max(worst, passed / limit)
        if passed > limit * interval_s:
            bad.append((name, passed, limit))
    return bad, worst


def control_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 9: the control plane of a threaded serving client on the card
    at the default widths — rules through a file datasource, the HTTP
    command center under traffic, the metric log, live reshape, the
    heartbeat, the readers against a CPU copy — then snapshot on bench.py's
    sketch configuration."""
    import tempfile
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from sentinel_tpu_torch import transport as TT
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.core.rules import rules_to_json_list
    from sentinel_tpu_torch.datasource import DynamicSentinelProperty, FileRefreshableDataSource, json_rule_converter
    from sentinel_tpu_torch.metrics import MetricSearcher, MetricTimerListener, MetricWriter
    from sentinel_tpu_torch.runtime.client import SentinelClient

    rep = {"card": smi}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="control-", dir=os.path.join(ROOT, "build"))
    os.environ["CSP_SENTINEL_LOG_DIR"] = os.path.join(work, "logs")
    t_phase = time.perf_counter()
    client = SentinelClient(cfg=platform_config(), device="cuda", mode="threaded", entry_timeout_s=30.0,
                            app_name="control")
    flow, degrade, authority, system, param = build_rules(st)
    rules_path = os.path.join(work, "flow-rules.json")
    with open(rules_path, "w") as f:
        json.dump(rules_to_json_list(flow), f)
    ds = FileRefreshableDataSource(rules_path, json_rule_converter("flow"), refresh_ms=3_600_000)
    client.flow_rules.register_property(ds.get_property())
    check(len(client.flow_rules.get()) == len(flow), "the file datasource did not load the flow rules")
    client.degrade_rules.load(degrade)
    client.authority_rules.load(authority)
    client.system_rules.load(system)
    client.param_flow_rules.load(param)
    names = [f"res-{i}" for i in range(N_NAMES)]
    for n in names:
        client.registry.resource_id(n)
    client.start()
    limits = {r.resource: r.count for r in flow if r.control_behavior == st.CONTROL_DEFAULT}
    app_dir = os.path.join(work, "metrics")
    searcher = MetricSearcher(app_dir, client.app_name)
    center = TT.start_command_center(client, metric_searcher=searcher, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{center.port}"
    rep["setup_s"] = time.perf_counter() - t_phase

    stop, lock, outcomes = threading.Event(), threading.Lock(), {}

    def start_traffic(seed):
        stop.clear()
        # daemons: a failed check must not leave the script waiting on them
        ts = [threading.Thread(target=control_traffic, args=(np, st, client, names, stop, outcomes, lock, seed + i),
                               daemon=True) for i in range(N_THREADS)]
        for t in ts:
            t.start()
        return ts

    def stop_traffic(ts):
        stop.set()
        for t in ts:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in ts), "control: request threads still running after 120 s")
        deadline = time.perf_counter() + 30
        while client._has_work() and time.perf_counter() < deadline:
            time.sleep(0.01)
        client.tick_once()
        torch.cuda.synchronize()

    FU.reset_launches()
    SC.reset_launches()
    threads = start_traffic(SEED + 900)
    time.sleep(2.0)
    # -- the command center under traffic: each command's round trips
    http = {}
    commands = [("clusterNode", CONTROL_HEAVY_REPS), ("jsonTree", CONTROL_HEAVY_REPS),
                ("origin?id=res-0", CONTROL_LIGHT_REPS), ("topParams?id=res-0&n=16", CONTROL_LIGHT_REPS),
                ("rtQuantiles", CONTROL_LIGHT_REPS), ("systemStatus", CONTROL_LIGHT_REPS),
                ("getRules?type=flow", CONTROL_HEAVY_REPS)]
    bodies = {}
    for cmd, reps in commands:
        ms = []
        for _ in range(reps):
            t, status, body = http_call(f"{base}/{cmd}")
            check(status == 200, f"control: {cmd} answered HTTP {status}: {body[:200]!r}")
            ms.append(t)
        bodies[cmd] = json.loads(body)
        http[cmd.split("?")[0]] = dict(p50_ms=_pct(ms, 0.5), p99_ms=_pct(ms, 0.99), reps=reps, bytes=len(body))
    n_res = len(client.registry.resources())
    check(len(bodies["clusterNode"]) == n_res >= N_NAMES, f"clusterNode listed {len(bodies['clusterNode'])} of "
          f"{n_res} resources")
    check(len(bodies["getRules?type=flow"]) == len(flow), "getRules did not list the flow rules")
    check(any(n["passQps"] > 0 for n in bodies["clusterNode"]), "clusterNode: no resource passed")
    check(bodies["origin?id=res-0"] and bodies["topParams?id=res-0&n=16"], "origin / topParams answered nothing")
    check(bodies["rtQuantiles"]["p50"] > 0, "rtQuantiles: no inbound RT")
    check(bodies["jsonTree"]["resource"] == "machine-root" and len(bodies["jsonTree"]["children"]) == n_res,
          "jsonTree: not the whole map")
    snap_split = dict(client.stats.last_read)
    # -- the metric log: the timer's run_once once a wall second for 5 s
    timer = MetricTimerListener(client, MetricWriter(app_dir, client.app_name))
    run_ms, lines_written = [], 0
    for _ in range(CONTROL_METRIC_S):
        time.sleep(1.0 - (time.time() % 1.0) + 0.01)
        t = time.perf_counter()
        lines_written += timer.run_once()
        run_ms.append((time.perf_counter() - t) * 1e3)
    timer.writer.close()
    t, status, body = http_call(f"{base}/metric?startTime=0&maxLines=100000000")
    check(status == 200, f"control: metric answered HTTP {status}")
    served = body.decode().splitlines()
    written = []
    for f in sorted(os.listdir(app_dir)):
        if ".idx" not in f:
            with open(os.path.join(app_dir, f)) as fh:
                written += fh.read().splitlines()
    check(served == written and len(written) == lines_written and lines_written > 0,
          f"control: the searcher served {len(served)} lines, the timer wrote {lines_written} ({len(written)} on disk)")
    http["metric"] = dict(p50_ms=t, p99_ms=t, reps=1, bytes=len(body))
    rep["metric"] = dict(run_once_ms=run_ms, lines=lines_written, seconds=CONTROL_METRIC_S)
    # -- live reshape under traffic: 2 x 500 ms -> 4 x 250 ms, then a property push back
    swaps = []
    snaps = []
    prop = DynamicSentinelProperty()
    client.register_window_property(prop)
    for label, do in (("update_window_shape(sample_count=4, window_ms=250)",
                       lambda: client.update_window_shape(sample_count=4, window_ms=250)),
                      ('property push {"sampleCount": 2, "intervalMs": 1000}',
                       lambda: prop.update_value({"sampleCount": 2, "intervalMs": 1000}))):
        snaps.append(client.stats.snapshot())
        t = time.perf_counter()
        do()
        swap_ms = (time.perf_counter() - t) * 1e3
        swaps.append(dict(what=label, swap_ms=swap_ms, lock_ms=client.swap_lock_ms,
                          lock_wait_ms=client.swap_lock_wait_ms,
                          shape=[client.cfg.second_sample_count, client.cfg.second_window_ms]))
        for _ in range(5):
            snaps.append(client.stats.snapshot())
            time.sleep(0.25)
    check([s["shape"] for s in swaps] == [[4, 250], [2, 500]], f"control: reshape shapes {swaps}")
    fill = 0.0
    for sn in snaps:
        bad, worst = control_flow_ok(client, sn, limits)
        check(not bad, f"control: a flow resource passed past its threshold across the swap: {bad[:5]}")
        fill = max(fill, worst)
    rep["reshape"] = dict(swaps=swaps, snapshots_checked=len(snaps), fullest_window=fill)
    # -- setRules: a new rule blocks on the next tick
    new_rule = st.FlowRule(resource="ctl-new", count=0)
    e = client.try_entry("ctl-new")
    check(e is not None, "control: ctl-new blocked before its rule")
    e.exit()
    data = "data=" + urllib.parse.quote(json.dumps(rules_to_json_list(flow + [new_rule])))
    t, status, body = http_call(f"{base}/setRules?type=flow", data=data.encode())
    check(status == 200 and body == b"success", f"control: setRules answered {status} {body[:200]!r}")
    http["setRules"] = dict(p50_ms=t, p99_ms=t, reps=1, bytes=len(data))
    try:
        client.entry("ctl-new").exit()
        blocked_after = False
    except st.FlowException:
        blocked_after = True
    check(blocked_after, "control: the pushed rule did not block on the next tick")
    stop_traffic(threads)
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    check(all(launches[k] > 0 for k in ("scatter_many", "gather_many", "seg_incl_min")),
          f"control: the serving ticks did not launch B1, B2 and B4: {launches}")
    lost = {k: v for k, v in outcomes.items() if k.startswith("lost")}
    check(not lost, f"control: entries lost under the control plane: {lost}")
    check(int(client._state.concurrency.sum().item()) == 0, "control: concurrency left after every exit")
    rep["traffic"] = dict(outcomes=dict(outcomes), launches=launches)
    # -- setSwitch=false: entries pass and no tick runs
    ticks0, launch0 = client._build_ticks, sum(FU.LAUNCHES.values())
    t_off, status, body = http_call(f"{base}/setSwitch?value=false")
    check(status == 200, "control: setSwitch=false failed")
    passed_off = 0
    for i in range(200):
        with client.entry("ctl-new"):
            passed_off += 1
    time.sleep(0.05)
    ticks_off = client._build_ticks - ticks0
    launches_off = sum(FU.LAUNCHES.values()) - launch0
    t_on, status, _ = http_call(f"{base}/setSwitch?value=true")
    check(status == 200, "control: setSwitch=true failed")
    check(passed_off == 200 and ticks_off == 0 and launches_off == 0,
          f"control: switch off passed {passed_off}, ran {ticks_off} ticks, {launches_off} launches")
    try:
        client.entry("ctl-new").exit()
        check(False, "control: switch back on, ctl-new passed its 0 QPS rule")
    except st.FlowException:
        pass
    http["setSwitch"] = dict(p50_ms=(t_off + t_on) / 2, p99_ms=max(t_off, t_on), reps=2, bytes=0)
    rep["switch"] = dict(passed_off=passed_off, ticks_off=ticks_off, launches_off=launches_off,
                         ticks_after_on=client._build_ticks - ticks0)
    rep["http"] = http
    # -- the heartbeat to a local receiver
    got = []

    class Recv(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            got.append((self.path, self.rfile.read(n).decode()))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    recv = ThreadingHTTPServer(("127.0.0.1", 0), Recv)
    threading.Thread(target=recv.serve_forever, daemon=True).start()
    try:
        hb = TT.HeartbeatSender(client.app_name, dashboard_addresses=[f"127.0.0.1:{recv.server_address[1]}"],
                                center=center)
        t = time.perf_counter()
        ok = hb.send_once()
        hb_ms = (time.perf_counter() - t) * 1e3
    finally:
        recv.shutdown()
        recv.server_close()
    check(ok and got and got[0][0] == "/registry/machine" and f"port={center.port}" in got[0][1],
          f"control: the heartbeat did not arrive: {got}")
    rep["heartbeat"] = dict(ms=hb_ms, body=got[0][1])
    # -- the readers: the card against a CPU copy; snapshot's parts at 100,000 resources
    for i in range(40):  # inbound calls that take 1-3 ms: the RT histogram holds them
        try:
            with client.entry(f"res-{1000 + i}", inbound=True, origin="bad" if i % 4 == 0 else None):
                time.sleep(0.001 + 0.0005 * (i % 5))
        except st.BlockException:
            pass
    client.tick_once()
    diffs, n_vals, card = card_against_cpu(client, torch)
    check(not diffs, f"control: the card's readers differ from the CPU copy's: {diffs[:5]}")
    check(card["rtq"][0.5] > 0, "control: the RT histogram read nothing")
    rows_np = np.fromiter(client.registry.resources().values(), np.int64)
    rows_dev = torch.as_tensor(rows_np, device=client.device)
    now = client.time.now_ms()
    dev_ms, host_ms = time_ms(lambda: client.stats._gather_exact(client._state, rows_dev, now), reps=10)
    t = time.perf_counter()
    client.stats.snapshot()
    rep["snapshot_exact"] = dict(resources=len(rows_np), device_ms=dev_ms, enqueue_ms=host_ms,
                                 wall_ms=(time.perf_counter() - t) * 1e3, under_traffic=snap_split,
                                 idle=dict(client.stats.last_read))
    rep["readers_equal"] = dict(values=n_vals, origins=len(card["origin"]), rtq=card["rtq"])
    center.stop()
    ds.close()
    client.stop()
    del client
    torch.cuda.empty_cache()
    rep["sketch"] = control_sketch(np, st, torch)
    rep["phase_s"] = time.perf_counter() - t_phase
    control_log(rep)
    return rep


def control_sketch(np, st, torch) -> dict:
    """snapshot on bench.py's sketch configuration: its names interned
    (res-1 .. res-10000 exact, the organic rest burnt, tail-0 .. tail-2047,
    then every other of the 2^20 names as a sketch id), its rules, six of
    client_bench's B = 2,048 blocks with their exits; the readers on the
    card against a CPU copy; snapshot's device, readback and dict ms."""
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.sketch import impl_for
    from sentinel_tpu_torch.ops import engine as E

    cfg = sketch_cfg(platform_config)
    c = SentinelClient(cfg=cfg, device="cuda", mode="sync", app_name="control-sketch")
    intern_bench_names(c.registry)
    for raw in range(N_RULED + N_TAIL_RULED + 1, N_TOTAL):
        c.registry.resource_id(f"n-{raw}")
    flow, degrade, authority, system, param = sketch_rules(st)
    c.flow_rules.load(flow)
    c.degrade_rules.load(degrade)
    c.param_flow_rules.load(param)
    c.authority_rules.load(authority)
    c.system_rules.load(system)
    c.start()
    tail_ids = np.asarray([c.registry.peek_resource_id(f"tail-{r}") for r in range(N_TAIL_RULED)], np.int32)
    traffic, _ = bench_traffic(np, PS, c, 2048, tail_ids)
    for ids, onode, oid, ph, inb, rt in traffic:
        v, _w = c.check_batch_ids(ids, origin_node=onode, origin_id=oid, param_hash=ph, inbound=inb)
        ok = v == 0
        c.submit_completion_block(ids[ok], rt[ok], inbound=inb[ok], origin_node=onode[ok], param_hash=ph[ok])
        c.tick_once()
    res = c.registry.resources()
    n_sketch = sum(1 for r in res.values() if c.registry.is_sketch_id(r))
    diffs, n_vals, card = card_against_cpu(c, torch)
    check(not diffs, f"control sketch: the card's readers differ from the CPU copy's: {diffs[:5]}")
    check(any(s["passQps"] > 0 for n, s in card["snapshot"].items() if c.registry.is_sketch_id(res[n])),
          "control sketch: no sketch-id resource shows traffic")
    rids = torch.as_tensor(np.fromiter((r for r in res.values() if c.registry.is_sketch_id(r)), np.int64),
                           device=c.device).to(torch.int32)
    now = c.time.now_ms()
    scfg = E.sketch_config(c.cfg)
    est_ms, est_host = time_ms(lambda: impl_for(c.cfg).estimate(c._state.gs, now, rids, scfg), reps=10)
    exact_rows = torch.as_tensor(np.fromiter((r for r in res.values() if not c.registry.is_sketch_id(r)), np.int64),
                                 device=c.device)
    ex_ms, ex_host = time_ms(lambda: c.stats._gather_exact(c._state, exact_rows, now), reps=10)
    t = time.perf_counter()
    snap = c.stats.snapshot()
    wall = (time.perf_counter() - t) * 1e3
    check(len(snap) == len(res), "control sketch: snapshot missed resources")
    out = dict(resources=len(res), sketch_ids=n_sketch, exact=len(res) - n_sketch, values=n_vals,
               sketch_device_ms=est_ms, sketch_enqueue_ms=est_host, exact_device_ms=ex_ms, exact_enqueue_ms=ex_host,
               snapshot_wall_ms=wall, split=dict(c.stats.last_read))
    c.stop()
    return out


def control_log(rep) -> None:
    smi = rep["card"]
    for cmd, h in rep["http"].items():
        log(f"[control] {smi}: HTTP {cmd}: p50 {h['p50_ms']:.3f} ms, p99 {h['p99_ms']:.3f} ms over {h['reps']} "
            f"round trips ({h['bytes']} B)")
    s = rep["snapshot_exact"]
    log(f"[control] {smi}: snapshot of {s['resources']} exact resources: device {s['device_ms']:.4f} ms (gathers, "
        f"host enqueue {s['enqueue_ms']:.3f} ms); idle split {json.dumps(s['idle'], sort_keys=True)}; under traffic "
        f"{json.dumps(s['under_traffic'], sort_keys=True)}; wall {s['wall_ms']:.3f} ms")
    m = rep["metric"]
    log(f"[control] {smi}: metric log: run_once ms {[round(x, 3) for x in m['run_once_ms']]} over "
        f"{m['seconds']} wall seconds, {m['lines']} lines written, served back line for line")
    for w in rep["reshape"]["swaps"]:
        log(f"[control] {smi}: reshape {w['what']}: swap {w['swap_ms']:.3f} ms, engine lock waited for "
            f"{w['lock_wait_ms']:.3f} ms, held {w['lock_ms']:.3f} ms -> {w['shape']}")
    log(f"[control] {smi}: reshape under traffic: {rep['reshape']['snapshots_checked']} snapshots, every DEFAULT "
        f"flow resource within its threshold (fullest window {rep['reshape']['fullest_window']:.3f}); "
        f"traffic {json.dumps(rep['traffic']['outcomes'], sort_keys=True)}, none lost; launches "
        f"{json.dumps(rep['traffic']['launches'])}")
    sw = rep["switch"]
    log(f"[control] {smi}: setSwitch=false: {sw['passed_off']} entries passed, {sw['ticks_off']} ticks, "
        f"{sw['launches_off']} launches; setRules enforced on the next tick; heartbeat "
        f"{rep['heartbeat']['ms']:.3f} ms ({rep['heartbeat']['body']})")
    log(f"[control] {smi}: readers on the card == on a CPU copy ({rep['readers_equal']['values']} values, "
        f"{rep['readers_equal']['origins']} origin rows, rtq {json.dumps(rep['readers_equal']['rtq'])})")
    k = rep["sketch"]
    log(f"[control] {smi}: sketch configuration: snapshot of {k['resources']} resources ({k['sketch_ids']} sketch "
        f"ids, {k['exact']} exact): sketch estimate device {k['sketch_device_ms']:.4f} ms (enqueue "
        f"{k['sketch_enqueue_ms']:.3f}), exact gather device {k['exact_device_ms']:.4f} ms (enqueue "
        f"{k['exact_enqueue_ms']:.3f}); split {json.dumps(k['split'], sort_keys=True)}; wall "
        f"{k['snapshot_wall_ms']:.3f} ms; card == CPU copy ({k['values']} values)")
    log(f"[control] {smi}: phase 9 took {rep['phase_s']:.1f} s (set-up {rep['setup_s']:.1f} s)")


# -- phase 10: overload protection and the plain effects path ---------------------------

#: ticks of phase 10a's stream, a plain configuration each
PLAIN_TICKS = 8
#: phase 10c: request threads before and after the burst, and during it (2x)
OVERLOAD_THREADS = (8, 16)
#: phase 10c: seconds healthy, in the burst, after it
OVERLOAD_SECONDS = (2.5, 4.0, 2.5)


def plain_batches(np, E, torch, cfg, cols, device, clamp=None):
    """Batches of ``cols`` in ``cfg``'s wire dtypes on ``device`` (counts
    clamped to ``clamp``, as the client clamps them on the fused path)."""

    def put(batch, cols_, k):
        x = cols_[k] if clamp is None or k not in ("count", "success", "error") else np.minimum(cols_[k], clamp)
        return torch.as_tensor(x).to(dtype=getattr(batch, k).dtype, device=device)

    out = []
    for a, c in cols:
        B = a["res"].shape[0]
        acq, comp = E.empty_acquire(cfg, device, B), E.empty_complete(cfg, device, B)
        out.append((acq._replace(**{k: put(acq, a, k) for k in a}), comp._replace(**{k: put(comp, c, k) for k in c})))
    return out


def wires_match(np, WIRE, cfg, B, got: bytes, want: bytes):
    """None when two readbacks of one tick agree — verdicts, waits, the
    drop count and the hot block exactly, the telemetry and timeline rows
    within rtol 1e-6 / atol 1e-4, the explain records' words exactly but
    their observed / threshold values within the same tolerance (at their
    1/256 resolution) — else what differs.  The plain path lands float32
    sums whose order differs between the card (atomics, parallel scans)
    and the CPU, and its counts run to 65,535, so such sums pass 2^24."""
    from sentinel_tpu_torch.obs import explain as EX

    lo = WIRE.layout_for(cfg, B)
    a, b = WIRE.unpack(got, lo), WIRE.unpack(want, lo)
    for f in ("verdict", "wait", "hot"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            return f"{f} differs"
    if (a.n_wait, a.seg_dropped) != (b.n_wait, b.seg_dropped):
        return "header differs"
    for f in ("stats", "res_stats"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not np.allclose(x, y, rtol=1e-6, atol=1e-4)):
            return f"{f} differs beyond rtol 1e-6 / atol 1e-4"
    if a.expl is not None:
        (na, ra), (nb, rb) = EX.decode_section(a.expl), EX.decode_section(b.expl)
        if na != nb or ra.shape != rb.shape or not np.array_equal(ra[:, :2], rb[:, :2]):
            return "explain records differ"
        fa, fb = ra[:, 2:].astype(np.float64), rb[:, 2:].astype(np.float64)
        unknown = (ra[:, 2:] == EX.FX_UNKNOWN) | (rb[:, 2:] == EX.FX_UNKNOWN)
        if not np.array_equal(ra[:, 2:][unknown], rb[:, 2:][unknown]) or not np.all(
                np.abs(fa - fb)[~unknown] <= 1e-6 * np.maximum(fa, fb)[~unknown] + 1e-4 * EX.FX + 1):
            return "explain observed / threshold differ beyond the tolerance"
    return None


def plain_path_run(np, st, E, S, FU, SC, torch) -> dict:
    """Phase 10a: the plain effects path at the default widths, B = 2,048 —
    ``platform_config(fused_effects=False, seg_effects=False)`` and
    ``platform_config(use_mxu_tables=False)`` (fused_effects on, no one-hot
    tables: the reference's _use_fused is False) — on a stream with counts
    of 1-65,535, every tick (under the sync-debug mode "error") held to the
    same tick on the CPU: the readback's verdicts, waits and integers equal
    and its float planes within rtol 1e-6 / atol 1e-4 (``wires_match``),
    every integer state leaf equal and every float leaf within the same
    tolerance.  The
    path launches none of B1-B4.  Then ms a tick (median, card) and, from a
    profile of 4 ticks, device busy and device launches, beside the fused
    path's on the same stream with its counts clamped to 255."""
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.core.rule_tensors import hash_param
    from sentinel_tpu_torch.ops import wire as WIRE
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.runtime.registry import Registry

    cfgs = {
        "plain": platform_config(fused_effects=False, seg_effects=False, packed_wire=True),
        "plain-nomxu": platform_config(use_mxu_tables=False, packed_wire=True),
        "fused": platform_config(seg_effects=False, packed_wire=True),
    }
    check(not E._use_fused(cfgs["plain"]) and not E._use_fused(cfgs["plain-nomxu"]) and E._use_fused(cfgs["fused"]),
          "phase 10a: the path selection")
    reg = Registry(cfgs["plain"])
    names_to_rows = np.array([reg.resource_id(f"res-{i}") for i in range(N_NAMES)], dtype=np.int32)
    value_hashes = np.array([hash_param(arg_value(k)) for k in range(N_VALUES)], dtype=np.int32)
    B = cfgs["plain"].batch_size
    cols = batch_columns(np, PS, PLAIN_TICKS, names_to_rows, B, SEED + 10, value_hashes)
    rng = np.random.default_rng(SEED + 11)
    for a, c in cols:
        a["count"] = np.where(rng.random(B) < 0.5, 1, rng.integers(1, 65536, B)).astype(np.int32)
        c["success"] = rng.integers(0, 65536, B).astype(np.int32)
        c["error"] = np.where(rng.random(B) < 0.2, rng.integers(1, 65536, B), 0).astype(np.int32)
        c["rt"] = (rng.random(B) * 120.0).astype(np.float32)
    flow, degrade, authority, system, param = build_rules(st)
    rules = {}
    for name, cfg in cfgs.items():
        for d in ("cuda", "cpu") if name != "fused" else ("cuda",):
            rules[name, d] = E.compile_ruleset(cfg, reg, flow_rules=flow, degrade_rules=degrade, param_rules=param,
                                               authority_rules=authority, system_rules=system, device=d)
    rep = {"ticks": PLAIN_TICKS, "batch": B}
    t0_ms = 1_000
    states, streams = {}, {}
    for name in ("plain", "plain-nomxu"):
        cfg = cfgs[name]
        card, cpu = plain_batches(np, E, torch, cfg, cols, "cuda"), plain_batches(np, E, torch, cfg, cols, "cpu")
        streams[name] = card
        st_card, st_cpu = E.init_state(cfg, "cuda"), E.init_state(cfg, "cpu")
        FU.reset_launches()
        SC.reset_launches()
        tick_ms, float_diff, n_leaves, exact = [], 0.0, 0, 0
        for i in range(PLAIN_TICKS):
            now = t0_ms + 137 * i
            st_card, w_card, wt_card, t_s = run_stream(E, torch, st_card, rules[name, "cuda"], cfg,
                                                       [card[i]], now, forbid_sync=True)
            tick_ms.append(1e3 * t_s[0])
            st_cpu, out = E.tick(st_cpu, rules[name, "cpu"], *cpu[i], now, 0.3, 0.2, cfg, E.ALL_FEATURES)
            diff = wires_match(np, WIRE, cfg, B, w_card[0], out.wire.numpy().tobytes())
            check(diff is None, f"phase 10a {name}: tick {i}'s readback: {diff}")
            exact += w_card[0] == out.wire.numpy().tobytes()
            check(np.array_equal(wt_card[0], out.wait_ms.numpy()), f"phase 10a {name}: tick {i}'s waits differ")
            # the CPU's state goes up and the leaves compare on the card
            got, want = S.leaves(st_card), S.leaves(st_cpu)
            for k in want:
                g, w = got[k], want[k].to("cuda")
                if w.dtype.is_floating_point:
                    check(bool(torch.allclose(g, w, rtol=1e-6, atol=1e-4)), f"phase 10a {name}: tick {i}: {k} differs")
                    if g.numel():
                        float_diff = max(float_diff, float((g.double() - w.double()).abs().max()))
                else:
                    check(bool(torch.equal(g, w)), f"phase 10a {name}: tick {i}: {k} differs")
            n_leaves = len(want)
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        check(not any(launches.values()), f"phase 10a {name}: the plain path launched a kernel: {launches}")
        big = int(max(int(st_card.win_sec.run.max()), 0))
        check(big > 65_535, f"phase 10a {name}: the windows hold {big}, not the unclamped sums")
        states[name] = st_card
        rep[name] = dict(tick_ms=tick_ms, ms_median=float(np.median(tick_ms[1:])), state_leaves=n_leaves,
                         float_state_max_diff=float_diff, kernel_launches=launches, window_max=big,
                         wires_bit_equal=int(exact))
        del st_cpu
    streams["fused"] = plain_batches(np, E, torch, cfgs["fused"], cols, "cuda", clamp=cfgs["fused"].max_batch_count)
    st_f = E.init_state(cfgs["fused"], "cuda")
    st_f, _w, _wt, t_s = run_stream(E, torch, st_f, rules["fused", "cuda"], cfgs["fused"], streams["fused"], t0_ms,
                                    forbid_sync=True)
    rep["fused"] = dict(tick_ms=[1e3 * x for x in t_s], ms_median=float(np.median([1e3 * x for x in t_s[1:]])))
    variants = [(n, states[n] if n != "fused" else st_f, rules[n, "cuda"], cfgs[n])
                for n in ("plain", "plain-nomxu", "fused")]
    # the profile continues each run from its last state, at later times
    prof = {}
    for n, st_, r, c in variants:
        prof.update(profile_ticks(E, torch, [(n, st_, r, c)], streams[n], t0_ms + 137 * PLAIN_TICKS))
    for n, (dev_us, wall_us, cpu_us, n_launch, ours, _top) in prof.items():
        rep[n].update(device_busy_ms=dev_us / 4e3, wall_ms=wall_us / 4e3, host_cpu_ms=cpu_us / 4e3,
                      device_launches=n_launch / 4, idle_share=1.0 - dev_us / max(wall_us, 1e-9),
                      kernel_rows=ours)
    return rep


def simload_main(device: str, controller: str) -> int:
    """``python3 chip_smoke.py --simload DEVICE on|off`` (phase 10b): the
    full overload simulation, the controller on or off, on ``device``, in
    a process of its own so that the four runs overlap each other and the
    rest of phase 10; one JSON line (the ``SimResult`` and the wall
    seconds)."""
    import dataclasses

    import torch

    if device == "cpu":
        torch.set_num_threads(2)
    sys.path.insert(0, ROOT)
    from sentinel_tpu_torch.adaptive import simload as TS

    on = controller == "on"
    t = time.perf_counter()
    r = TS.run_overload_sim(adaptive=on, adaptive_cfg=TS.storm_controller_preset() if on else None, device=device)
    print(json.dumps(dict(dataclasses.asdict(r), wall_s=time.perf_counter() - t)), flush=True)
    return 0


def adaptive_serving_run(np, st, FU, SC, torch) -> dict:
    """Phase 10c: a threaded serving client on ``platform_config()`` with
    ``enable_adaptive()`` and the watchdog armed (250 ms), 8 closed-loop
    request threads, then a 2x burst — 16 threads and a bulk feeder that
    queues a 2,048-item block every 40 ms — then 8 again.  Every entry is
    inbound (the adaptive system columns gate it), one in ten prioritized,
    and holds a backend whose service time grows with its occupancy (2 ms a
    holder), so the burst's RT rises; one in four entries carries a 40 ms
    deadline.  The controller reads queue pressure above 1,024 queued
    items, RT above 1.3x its floor; its admission bound is 8,192 items.
    The steady ticks run under the sync-debug mode "error": a host sync in
    the controller's upload (or anywhere in the tick) fails the phase.
    Then one stall through the ``runtime.watchdog.stall`` failpoint
    (1.5 s) with the traffic paused: the time to fail closed,
    ``sentinel_watchdog_fired_total`` up by exactly one, and no future
    resolved twice."""
    from sentinel_tpu_torch.adaptive import degrade as DG
    from sentinel_tpu_torch.adaptive.controller import AdaptiveConfig
    from sentinel_tpu_torch.chaos import FaultPlan, FaultSpec, armed
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.obs.registry import REGISTRY
    from sentinel_tpu_torch.runtime.client import SentinelClient

    def counter(name, **labels):
        m = REGISTRY.get(name, labels or None)
        return 0 if m is None else m.value

    reasons = [("admit", "queue_full"), ("admit", "low_priority"), ("admit", "fail_closed"),
               ("admit", "deadline"), ("admit", "chaos"), ("tick", "deadline")]
    shed0 = {f"{a}/{b}": counter("sentinel_shed_total", stage=a, reason=b) for a, b in reasons}
    failed0 = counter("sentinel_resolve_failures_total")
    client = SentinelClient(cfg=platform_config(), device="cuda", mode="threaded", entry_timeout_s=30.0,
                            watchdog_timeout_s=0.25, app_name="overload")
    names = [f"api-{i}" for i in range(16)]
    client.flow_rules.load([st.FlowRule(resource=n, count=100_000) for n in names])
    ad = client.enable_adaptive(AdaptiveConfig(rt_tolerance=1.3, queue_high=1024, queue_max=8192, min_ceiling=4.0,
                                               climb_hold_ms=200, cool_hold_ms=500, cpu_high=2.0))
    client.start()
    stop = threading.Event()
    lock = threading.Lock()
    outcomes, errors = {}, []
    holders = [0]

    def worker(k, gate):
        rng = np.random.default_rng(SEED + 100 + k)
        while not stop.is_set():
            if not gate.is_set():
                time.sleep(0.002)
                continue
            name = names[int(rng.integers(0, len(names)))]
            dl = client.time.now_ms() + 40 if rng.random() < 0.25 else 0
            try:
                e = client.entry(name, inbound=True, deadline_ms=dl, prioritized=bool(rng.random() < 0.1))
                with lock:
                    holders[0] += 1
                    n_hold = holders[0]
                time.sleep(0.002 * n_hold)
                with lock:
                    holders[0] -= 1
                e.exit()
                key = "pass"
            except st.BlockException as exc:
                key = type(exc).__name__
                time.sleep(0.001)  # a rejected caller backs off a moment
            except Exception as exc:  # counted: the phase fails on any
                errors.append(repr(exc))
                key = "error"
            with lock:
                outcomes[key] = outcomes.get(key, 0) + 1

    rid = client.registry.resource_id(names[-1])
    blocks = []

    def feeder(gate):
        while not stop.is_set():
            if gate.is_set():
                f = client.submit_block(np.full(2048, rid, np.int32))
                if f is not None:
                    blocks.append(f)
            time.sleep(0.04)

    lo, hi = OVERLOAD_THREADS
    gates = [threading.Event() for _ in range(hi + 1)]  # the last one gates the feeder
    threads = [threading.Thread(target=worker, args=(k, gates[k]), daemon=True) for k in range(hi)]
    threads.append(threading.Thread(target=feeder, args=(gates[hi],), daemon=True))
    for t in threads:
        t.start()
    trajectory = []
    rep = {}
    FU.reset_launches()
    SC.reset_launches()
    uploads0 = client._sys_stage.uploads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for stage, (n_threads, secs) in enumerate(zip((lo, hi, lo), OVERLOAD_SECONDS)):
            for k in range(hi):
                (gates[k].set if k < n_threads else gates[k].clear)()
            (gates[hi].set if stage == 1 else gates[hi].clear)()
            end = time.perf_counter() + secs
            while time.perf_counter() < end:
                time.sleep(0.1)
                c = ad.ceiling
                trajectory.append((stage, round(time.perf_counter(), 3), -1.0 if c == float("inf") else round(c, 3),
                                   ad.ladder.level))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for g in gates:
            g.clear()
    for f in blocks:
        v_blk, _w = f.result(timeout=30.0)
        outcomes["block_items"] = outcomes.get("block_items", 0) + len(v_blk)
    time.sleep(0.2)
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    check(not errors, f"phase 10c: request errors {errors[:3]}")
    check(counter("sentinel_resolve_failures_total") == failed0, "phase 10c: a tick resolution failed (a sync?)")
    for k in ("scatter_many", "gather_many", "seg_incl_min"):
        check(launches.get(k, 0) > 0, f"phase 10c: the serving ticks launched no {k}: {launches}")
    armed_ = [c for _s, _t, c, _l in trajectory if c > 0]
    check(client._sys_stage.uploads > uploads0 and armed_, "phase 10c: the controller never published a ceiling")
    rep.update(outcomes=dict(outcomes), launches=launches, uploads=client._sys_stage.uploads - uploads0,
               adaptive_step_us=client.adaptive_step_us,
               ceiling_trajectory=[(s, c, l) for s, _t, c, l in trajectory],
               levels_seen=sorted({l for *_x, l in trajectory}),
               transitions=list(ad.ladder.transitions)[:32])
    # one measured control step's host time (the tick thread's own steps
    # are excluded meanwhile), beside the one of the last tick
    with client._tick_mutex:
        load, cpu = client._sys.sample()
        t = time.perf_counter()
        client._adaptive_step(ad, client.time.now_ms(), load, cpu)
        rep["adaptive_step_host_us"] = (time.perf_counter() - t) * 1e6
    rep["shed"] = {k: counter("sentinel_shed_total", stage=k.split("/")[0], reason=k.split("/")[1]) - v
                   for k, v in shed0.items()}

    # -- the stall: traffic paused, one probe through a stalled readback ----
    time.sleep(0.3)
    fired0 = counter("sentinel_watchdog_fired_total")
    failed1 = counter("sentinel_resolve_failures_total")
    plan = FaultPlan(name="overload-stall", seed=3,
                     faults=[FaultSpec("runtime.watchdog.stall", "delay", delay_ms=1500, max_fires=1)])
    calls = []
    # the ladder back at NORMAL first: at FAIL_CLOSED the probe would shed
    # before it reached a tick
    with client._tick_mutex:
        ad.ladder.reset()
    with armed(plan):
        t = time.perf_counter()
        f = client.submit_acquire(names[0], prioritized=True)
        f.add_done_callback(lambda fut: calls.append(fut.result()))
        v, _w = f.result(timeout=10.0)
        rep["stall_fail_closed_ms"] = (time.perf_counter() - t) * 1e3
        fired = counter("sentinel_watchdog_fired_total") - fired0
        time.sleep(1.7)  # the stalled resolver finishes: it must not fan out again
    check(v == ERR.BLOCK_SYSTEM, f"phase 10c: the stalled tick resolved {v}, not BLOCK_SYSTEM")
    check(rep["stall_fail_closed_ms"] < 1_400, f"phase 10c: failed closed after {rep['stall_fail_closed_ms']:.0f} ms")
    check(fired == 1 and counter("sentinel_watchdog_fired_total") - fired0 == 1,
          f"phase 10c: the watchdog fired {counter('sentinel_watchdog_fired_total') - fired0} times")
    check(len(calls) == 1 and counter("sentinel_resolve_failures_total") == failed1 and not client._inflight_ticks,
          f"phase 10c: the stalled tick fanned out again ({len(calls)} callbacks)")
    v2, _ = client.submit_acquire(names[0], prioritized=True).result(timeout=10.0)
    check(v2 in (ERR.PASS, ERR.PASS_WAIT, ERR.BLOCK_SYSTEM), "phase 10c: serving after the stall")
    rep["after_stall"] = int(v2)
    stop.set()
    for t_ in threads:
        t_.join(timeout=5)
    client.stop()
    rep["watchdog_fired"] = fired
    return rep


def overload_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 10: the plain effects path at the default widths (10a), the
    overload simulator on the card against the CPU (10b: four processes of
    their own — card and CPU, controller on and off — that run beside 10a
    and 10c), and a threaded serving client with adaptive protection,
    deadlines and the watchdog (10c).  10a's and 10c's numbers are taken
    with the simulations running beside them."""
    from sentinel_tpu_torch.ops import engine as E

    t_phase = time.perf_counter()
    sims = {}
    for where, d in (("cpu", "cpu"), ("card", "cuda")):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="") if d == "cpu" else dict(os.environ)
        for k in ("on", "off"):
            sims[where, k] = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--simload", d, k],
                                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True)
    results = {}
    try:
        rep = {"card": smi}
        t = time.perf_counter()
        rep["plain"] = plain_path_run(np, st, E, S, FU, SC, torch)
        rep["plain_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rep["serving"] = adaptive_serving_run(np, st, FU, SC, torch)
        rep["serving_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for key, proc in sims.items():
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"phase 10b: the simulation {key} failed: {err[-2000:]}")
            results[key] = json.loads(out.strip().splitlines()[-1])
        rep["simload_wait_s"] = time.perf_counter() - t
    finally:
        for proc in sims.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rep["simload"] = {w: {k: results[w, k] for k in ("on", "off")} for w in ("card", "cpu")}
    for k in ("on", "off"):
        card, cpu = (dict(rep["simload"][d][k]) for d in ("card", "cpu"))
        card.pop("wall_s"), cpu.pop("wall_s")
        check(card == cpu, f"phase 10b: the simulation with the controller {k} differs on the card: "
                           f"{ {f: (card[f], cpu[f]) for f in card if card[f] != cpu[f]} }")
    on = rep["simload"]["card"]["on"]
    check(on["max_level"] >= 1 and on["blocked"] > 0, "phase 10b: the storm did not climb the ladder")
    rep["phase_s"] = time.perf_counter() - t_phase
    overload_log(rep)
    return rep


def overload_log(rep) -> None:
    smi = rep["card"]
    p = rep["plain"]
    for n in ("plain", "plain-nomxu", "fused"):
        r = p[n]
        extra = (f"; every tick == the CPU's ({r['wires_bit_equal']} of {p['ticks']} readbacks bit-equal, "
                 f"{r['state_leaves']} state leaves, float max |diff| {r['float_state_max_diff']:.3g}); "
                 f"B1-B4 launches {json.dumps(r['kernel_launches'])}; "
                 f"windows hold up to {r['window_max']}") if n != "fused" else " (counts clamped to 255)"
        log(f"[overload] {smi}: 10a {n} at B={p['batch']}: median {r['ms_median']:.3f} ms a tick "
            f"({[round(x, 3) for x in r['tick_ms']]}); profile of 4 ticks: device busy {r['device_busy_ms']:.3f} ms "
            f"a tick of {r['wall_ms']:.3f} ms wall (idle share {r['idle_share']:.3f}), host CPU "
            f"{r['host_cpu_ms']:.3f} ms, {r['device_launches']:g} device launches a tick{extra}")
    s = rep["simload"]
    for k in ("on", "off"):
        c = s["card"][k]
        log(f"[overload] {smi}: 10b controller {k}: healthy p99 {c['p99_healthy_ms']} ms, storm p99 "
            f"{c['p99_storm_ms']} ms, goodput healthy / storm {c['goodput_healthy']:.3f} / "
            f"{c['goodput_storm']:.3f} a step (floor {c['goodput_floor']}), passed {c['passed']} blocked "
            f"{c['blocked']}, ladder transitions {len(c['ladder_transitions'])} (max level {c['max_level']}); "
            f"card == CPU field for field; {c['wall_s']:.2f} s on the card ({s['cpu'][k]['wall_s']:.2f} s on the "
            f"CPU)")
    v = rep["serving"]
    log(f"[overload] {smi}: 10c outcomes {json.dumps(v['outcomes'], sort_keys=True)}; shed by reason "
        f"{json.dumps(v['shed'], sort_keys=True)}; adaptive step host {v['adaptive_step_host_us']:.1f} us "
        f"(last in a tick {v['adaptive_step_us']:.1f} us); {v['uploads']} column uploads, no host sync in the "
        f"steady ticks; levels seen {v['levels_seen']}; launches {json.dumps(v['launches'], sort_keys=True)}")
    log(f"[overload] {smi}: 10c ceiling trajectory (stage, ceiling, level) a 100 ms: "
        f"{json.dumps(v['ceiling_trajectory'])}")
    log(f"[overload] {smi}: 10c stall: failed closed after {v['stall_fail_closed_ms']:.1f} ms (watchdog 250 ms, "
        f"stall 1,500 ms); sentinel_watchdog_fired_total +{v['watchdog_fired']}; one fan-out; next verdict "
        f"{v['after_stall']}")
    log(f"[overload] {smi}: phase 10 took {rep['phase_s']:.1f} s (10a {rep['plain_s']:.1f} s, 10c "
        f"{rep['serving_s']:.1f} s, then {rep['simload_wait_s']:.1f} s waiting for 10b's processes)")


# -- phase 5: the probes ----------------------------------------------------------------


def valued_hist_shapes(torch, PK, FL, HI):
    """The two valued-histogram probes at the shapes the probes run them:
    [(kernel, shape, kernel call, zero_ + index_add_ call, bytes it must
    move)] — P1, P2's ``sc5_call`` and the stat landing at each n_lo; the
    bytes: ids and value planes read once (int32 or float32, 4 B each), the
    padded float32 output written once."""
    ids, vals5 = FL.data()
    idx, valsf = HI.planes_data()
    sids, cnts, rt = HI.stat_data()
    valss = torch.cat([cnts, (rt & 0xFF)[:, None], ((rt >> 8) & 0xFF)[:, None]], dim=1)
    n_hi = -(-FL.PLANES_N // FL.PLANES_N_LO)
    shapes = [
        ("probe_hist_planes", f"{idx.numel()} x {HI.P1_P} float32 into [{HI.P1_N}, {HI.P1_P}]",
         lambda: PK.probe_hist_planes(idx, valsf, HI.P1_N), HI.index_add_call(idx, valsf, HI.P1_N)[0],
         4 * (idx.numel() + valsf.numel() + HI.P1_N * HI.P1_P)),
        ("probe_hist_planes", f"{ids.numel()} x 5 int32 into [5, {n_hi}, {FL.PLANES_N_LO}] (sc5_call)",
         lambda: PK.probe_hist_planes(ids, vals5, FL.PLANES_N, FL.PLANES_N_LO),
         HI.index_add_call(ids, vals5, FL.PLANES_N)[0], 4 * (ids.numel() + vals5.numel() + 5 * n_hi * FL.PLANES_N_LO)),
    ]
    lib = HI.index_add_call(sids, valss, HI.N_ROWS)[0]
    for n_lo in HI.N_LO:
        n_hi = -(-HI.N_ROWS // n_lo)
        shapes.append(("probe_hist_stat5", f"{sids.numel()} items into [5, {n_hi}, {n_lo}]",
                       lambda n_lo=n_lo: PK.probe_hist_stat5(sids, cnts, rt, HI.N_ROWS, n_lo), lib,
                       4 * (sids.numel() + cnts.numel() + rt.numel() + 5 * n_hi * n_lo)))
    return shapes


def probe_split(torch, PK, FL, HI) -> list:
    """One call of each valued-histogram probe at each of its shapes, split
    into its device launches (``launch_breakdown``: memsets and kernels, µs
    a call) beside the call's bracketed time and ``zero_ + index_add_``'s
    (``time_ms``), printed on ``[probe] split`` lines."""
    rows = []
    for kname, shape, run, lib, nbytes in valued_hist_shapes(torch, PK, FL, HI):
        per_launch = launch_breakdown(run)
        ms = time_ms(run)[0]
        lib_ms = time_ms(lib)[0]
        bnd, by = bound_ms(nbytes, 0)
        rows.append(dict(kernel=kname, shape=shape, launches=per_launch, ms=ms, library_ms=lib_ms, bound_ms=bnd,
                         bound_by=by, bytes=nbytes))
        log(f"[probe] split {kname} at {shape}: device launches a call "
            + ", ".join(f"{n.split('(')[0]} x{c:g} {ms_ * 1e3:.2f} us" for n, c, ms_ in per_launch)
            + f"; bracketed {ms * 1e3:.2f} us a call; zero_ + index_add_ {lib_ms * 1e3:.2f} us; bound "
            f"{bnd:.6f} ms ({by}, {nbytes} B)")
    return rows


def probe_calls(torch, PK, FL, HI) -> dict:
    """kernel -> dict(run, plain, lib, shape, bytes, ops): one call of each
    probe kernel at the shape its row of the kernel table reports, its plain
    version, the library call computing the same function, and the bytes it
    must move (inputs read once, output written once) and the adds it must
    do on these inputs."""
    ids, _vals5 = FL.data()
    idx, valsf = HI.planes_data()
    sids, cnts, rt = HI.stat_data()
    valss = torch.cat([cnts, (rt & 0xFF)[:, None], ((rt >> 8) & 0xFF)[:, None]], dim=1)
    n, n_lo = FL.PLANES_N, FL.PLANES_N_LO
    cells = -(-n // n_lo) * n_lo
    stat_cells = -(-HI.N_ROWS // HI.N_LO[0]) * HI.N_LO[0]
    ok = lambda x, n: int(((x >= 0) & (x < n)).sum().item())
    return {
        "probe_copy": dict(
            run=lambda: PK.probe_copy(ids), plain=lambda: PK.probe_copy_plain(ids), lib=lambda: torch.add(ids, 1),
            shape=f"int32 [{ids.numel()}], {PK.COPY_ITEMS} items a thread, 16-byte accesses", bytes=8 * ids.numel(), ops=ids.numel()),
        "probe_hist_count": dict(
            run=lambda: PK.probe_hist_count(ids, n, n_lo), plain=lambda: PK.probe_hist_count_plain(ids, n, n_lo),
            lib=HI.index_add_call(ids, torch.ones((ids.numel(), 1), device="cuda"), n)[0],
            shape=f"{ids.numel()} ids into [{cells // n_lo}, {n_lo}]", bytes=4 * ids.numel() + 4 * cells,
            ops=ok(ids, n)),
        "probe_hist_planes": dict(
            run=lambda: PK.probe_hist_planes(idx, valsf, HI.P1_N),
            plain=lambda: PK.probe_hist_planes_plain(idx, valsf, HI.P1_N), lib=HI.index_add_call(idx, valsf, HI.P1_N)[0],
            shape=f"{idx.numel()} x {HI.P1_P} float32 into [{HI.P1_N}, {HI.P1_P}]",
            bytes=4 * idx.numel() + 4 * valsf.numel() + 4 * HI.P1_N * HI.P1_P, ops=ok(idx, HI.P1_N) * HI.P1_P),
        "probe_hist_stat5": dict(
            run=lambda: PK.probe_hist_stat5(sids, cnts, rt, HI.N_ROWS, HI.N_LO[0]),
            plain=lambda: PK.probe_hist_stat5_plain(sids, cnts, rt, HI.N_ROWS, HI.N_LO[0]),
            lib=HI.index_add_call(sids, valss, HI.N_ROWS)[0],
            shape=f"{sids.numel()} items into [5, {stat_cells // HI.N_LO[0]}, {HI.N_LO[0]}] (the stat-landing shape)",
            bytes=4 * sids.numel() + 4 * cnts.numel() + 4 * rt.numel() + 4 * 5 * stat_cells,
            ops=ok(sids, HI.N_ROWS) * 5),
    }


def probe_phase(np, torch, tick_report, split):
    """Hold the four probe kernels against their plain versions (published
    shapes and edge cases, exact equality), check that each valued
    histogram's call in ``split`` (``probe_split``) is one device launch,
    time the kernels like the others, then run the probe tables with the
    launch counts reset just before and read just after.  Returns (kernel
    records, probe report)."""
    from sentinel_tpu_torch.probes import floor as FL
    from sentinel_tpu_torch.probes import hist as HI
    from sentinel_tpu_torch.probes import kernels as PK

    rng = np.random.default_rng(SEED + 5)

    def cuda(x):
        return torch.as_tensor(x).cuda()

    def edge_ids(n, N):
        ids = rng.integers(-2, n + 3, N).astype(np.int32)
        ids[: min(N, 3)] = [-1, n, 2**30][: min(N, 3)]
        return cuda(ids)

    err = dict.fromkeys(PROBE_KERNELS, 0.0)

    def hold(kname, got, want):
        err[kname] = max(err[kname], check_equal(kname, [got], [want]))

    # -- the shapes the probes run -----------------------------------------------
    ids, vals5 = FL.data()
    idx, valsf = HI.planes_data()
    sids, cnts, rt = HI.stat_data()
    x3 = ids.reshape(64, 1, 2048)
    for blocks in (0, 1, 4, 64):
        hold("probe_copy", PK.probe_copy(ids, blocks), PK.probe_copy_plain(ids))
        hold("probe_copy", PK.probe_copy(x3, blocks), PK.probe_copy_plain(x3))
    for n, n_lo in FL.COUNT_SHAPES:
        for ipb in (256, 4096, 8192):
            hold("probe_hist_count", PK.probe_hist_count(ids, n, n_lo, ipb), PK.probe_hist_count_plain(ids, n, n_lo))
    hold("probe_hist_planes", PK.probe_hist_planes(ids, vals5, FL.PLANES_N, FL.PLANES_N_LO),
         PK.probe_hist_planes_plain(ids, vals5, FL.PLANES_N, FL.PLANES_N_LO))
    for n_lo in HI.N_LO:
        for ipb in HI.ITEMS_PER_BLOCK:
            hold("probe_hist_stat5", PK.probe_hist_stat5(sids, cnts, rt, HI.N_ROWS, n_lo, ipb),
                 PK.probe_hist_stat5_plain(sids, cnts, rt, HI.N_ROWS, n_lo))
    for ipb in HI.ITEMS_PER_BLOCK:
        hold("probe_hist_planes", PK.probe_hist_planes(idx, valsf, HI.P1_N, None, ipb),
             PK.probe_hist_planes_plain(idx, valsf, HI.P1_N))

    # -- edge cases: ids -1 / n / 2**30, N = 1 and N off the block, one hot row,
    # n off n_lo (16392 / 128, 32777 / 128) -----------------------------------------
    for N in (1, 255, 2049, 131072 + 37):
        x = cuda(rng.integers(-(2**31), 2**31 - 1, N + 3).astype(np.int32))
        x[:4] = 2**31 - 1  # x + 1 wraps like int32 addition
        out = torch.empty(N + 3, dtype=torch.int32, device="cuda")
        for blocks in (0, 1, 4, 64, 512):  # 16-byte aligned, and views 4 / 12 bytes off it
            for lo, o in ((0, None), (1, None), (3, None), (1, out[2:]), (2, out[2:])):
                v = x[lo : lo + N]
                hold("probe_copy", PK.probe_copy(v, blocks, out=None if o is None else o[:N]), PK.probe_copy_plain(v))
        for n, n_lo in ((16392, 128), (32777, 128), (5, 8)):
            e = edge_ids(n, N)
            for ipb in (1, 100, 256) if N <= 2049 else (100, 256):
                hold("probe_hist_count", PK.probe_hist_count(e, n, n_lo, ipb), PK.probe_hist_count_plain(e, n, n_lo))
            vi = cuda(rng.integers(0, 200, (N, 5), dtype=np.int32))
            vf = cuda(rng.integers(0, 100, (N, 3)).astype(np.float32))
            hold("probe_hist_planes", PK.probe_hist_planes(e, vi, n, n_lo, 100), PK.probe_hist_planes_plain(e, vi, n, n_lo))
            hold("probe_hist_planes", PK.probe_hist_planes(e, vf, n), PK.probe_hist_planes_plain(e, vf, n))
            c = cuda(rng.integers(0, 2, (N, 3), dtype=np.int32))
            r = cuda(rng.integers(0, 40000, N, dtype=np.int32))
            hold("probe_hist_stat5", PK.probe_hist_stat5(e, c, r, n, n_lo, 100), PK.probe_hist_stat5_plain(e, c, r, n, n_lo))
    # every id equal — the hottest possible row; 60,000 items keep the byte
    # planes' sums (<= 255 an item) below 2^24
    N = 60_000
    hot = torch.full((N,), 7, dtype=torch.int32, device="cuda")
    c = torch.ones((N, 3), dtype=torch.int32, device="cuda")
    r = torch.full((N,), 0xFFFF, dtype=torch.int32, device="cuda")
    hold("probe_hist_count", PK.probe_hist_count(hot, 16392, 128), PK.probe_hist_count_plain(hot, 16392, 128))
    hold("probe_hist_planes", PK.probe_hist_planes(hot, vals5[:N].contiguous(), 16392, 128),
         PK.probe_hist_planes_plain(hot, vals5[:N].contiguous(), 16392, 128))
    got = PK.probe_hist_stat5(hot, c, r, 16640, 128)
    hold("probe_hist_stat5", got, PK.probe_hist_stat5_plain(hot, c, r, 16640, 128))
    check(got.reshape(5, -1)[:, 7].tolist() == [N, N, N, 255.0 * N, 255.0 * N], "hot row sums")
    # the valued histograms' plan: ids on every block's first and last row, n = 1,
    # a table past one cluster's shared memory (100,000 x 5), N = 0, and an out=
    # filled with NaN (every cell, padding included, is written)
    dev = torch.device("cuda")
    for n, n_lo in ((1, 1), (5, 8), (16392, 128), (32777, 128), (100_000, 128)):
        edges = [r for plan in (PK.card_plan(dev, n, 5, n_lo), PK.card_plan(dev, n, 3))
                 for c in range(plan.clusters) for b in range(plan.cluster)
                 for lo, hi in [plan.block_rows(c, b)] if hi > lo for r in (lo, hi - 1) if r < n]
        for extra in (0, 2049):
            e = cuda(np.concatenate([edges, rng.integers(-2, n + 3, extra)]).astype(np.int32))
            N = e.numel()
            vi = cuda(rng.integers(0, 200, (N, 5), dtype=np.int32))
            vf = cuda(rng.integers(0, 100, (N, 3)).astype(np.float32))
            c = cuda(rng.integers(0, 2, (N, 3), dtype=np.int32))
            r = cuda(rng.integers(0, 40000, N, dtype=np.int32))
            nan = lambda *shape: torch.full(shape, float("nan"), device="cuda")
            shape5 = (5,) + PK.padded_shape(n, n_lo)
            hold("probe_hist_planes", PK.probe_hist_planes(e, vi, n, n_lo, 256, out=nan(*shape5)),
                 PK.probe_hist_planes_plain(e, vi, n, n_lo))
            hold("probe_hist_planes", PK.probe_hist_planes(e, vf, n, None, 100, out=nan(n, 3)),
                 PK.probe_hist_planes_plain(e, vf, n))
            hold("probe_hist_stat5", PK.probe_hist_stat5(e, c, r, n, n_lo, 4096, out=nan(*shape5)),
                 PK.probe_hist_stat5_plain(e, c, r, n, n_lo))
    empty = cuda(np.zeros(0, np.int32))
    for n_lo in HI.N_LO:
        out = torch.full((5,) + PK.padded_shape(HI.N_ROWS, n_lo), float("nan"), device="cuda")
        got = PK.probe_hist_stat5(empty, empty.reshape(0, 1).expand(0, 3).contiguous(), empty, HI.N_ROWS, n_lo, out=out)
        hold("probe_hist_stat5", got, torch.zeros_like(got))
    out = torch.full((HI.P1_N, HI.P1_P), float("nan"), device="cuda")
    got = PK.probe_hist_planes(empty, torch.zeros((0, HI.P1_P), device="cuda"), HI.P1_N, out=out)
    hold("probe_hist_planes", got, torch.zeros_like(got))
    torch.cuda.synchronize()
    log(f"[probe] kernels equal to plain at the probes' shapes and on edge cases (max |err| {json.dumps(err)})")

    # -- each call of a valued histogram is ONE device launch (no memset) ---------
    for row in split:
        check(sum(c for _n, c, _ms in row["launches"]) == 1 and "memset" not in str(row["launches"]).lower(),
              f"{row['kernel']} at {row['shape']}: {row['launches']} device launches a call")

    # -- times, like the other kernels (L2 flushed before every launch) -----------
    records = {}
    for kname, c in probe_calls(torch, PK, FL, HI).items():
        ms, host_ms = time_ms(c["run"])
        plain_ms = time_ms(c["plain"], reps=10)[0]
        lib_ms = time_ms(c["lib"])[0]
        bnd, by = bound_ms(c["bytes"], c["ops"])
        records[kname] = dict(max_abs_err=err[kname], ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                              bound_by=by, bytes=c["bytes"], ops=c["ops"], wrapper_host_ms=host_ms, shape=c["shape"])
        log(f"[probe] {kname} at {c['shape']}: kernel {ms:.4f} ms ({EARLIER_MS[kname][0]}: {EARLIER_MS[kname][1]:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library ({'torch.add' if kname == 'probe_copy' else 'zero_ + index_add_'}) "
            f"{lib_ms:.4f} ms, bound {bnd:.6f} ms ({by}, {c['bytes']} B); wrapper host enqueue {host_ms:.4f} ms")
    records["probe_hist_planes"]["split"] = [r for r in split if r["kernel"] == "probe_hist_planes"]
    records["probe_hist_stat5"]["split"] = [r for r in split if r["kernel"] == "probe_hist_stat5"]

    # -- the probe run: counts reset just before, read just after ------------------
    PK.reset_launches()
    floor_rows = FL.run()
    hist_rows = HI.run()
    torch.cuda.synchronize()
    launches = dict(PK.LAUNCHES)
    for kname in PROBE_KERNELS:
        check(launches[kname] > 0, ("probe run", kname, launches))
        records[kname]["launches"] = launches[kname]
    log(f"[probe] floor (B = {FL.B}, K = {FL.K} steps a row, back to back, per step):")
    for line in FL.format_rows(floor_rows):
        log("[probe]", line)
    log(f"[probe] hist (K = {HI.K} launches a row, back to back, per launch; all sums equal):")
    for line in HI.format_rows(hist_rows):
        log("[probe]", line)
    log(f"[probe] kernel launches during the probe run: {json.dumps(launches)}")
    # what the launch floor says about the tick: host time of its launches
    by_name = {(r["name"], r["mode"]): r for r in floor_rows}
    eager_us = by_name[("torch x + 1", "eager")]["host_us"]
    graph_us = by_name[("torch x + 1", "graph")]["device_ms"] * 1e3
    for name, t in tick_report.items():
        n = t["device_launches"] / 4
        log(f"[probe] {name}: {n:.0f} device launches a tick x {eager_us:.2f} us host a PyTorch launch = "
            f"{n * eager_us / 1e3:.3f} ms of the {t['ms_median']:.3f} ms tick; the same launches inside one CUDA "
            f"graph at {graph_us:.2f} us each = {n * graph_us / 1e3:.3f} ms")
    return records, dict(floor=floor_rows, hist=hist_rows, launches=launches)


# -- set-up shared by the full run and --b2 ----------------------------------------------


def prepare(np, st, E):
    """(c0, cfgs, setups, cols, light_cols, segments): the three
    configurations (``c0`` is seg4's before its ``seg_u`` grows), each with
    its rules compiled on the card (``setups``: name -> (cfg, rules)); the
    seeded, presorted stream of 13 B = 2,048 ticks and one 256-row light
    tick; its largest live-segment count, from which seg4's and seg1's
    ``seg_u`` grow by the client's rule."""
    import dataclasses

    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.core.rule_tensors import hash_param
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.runtime.client import grown_seg_u
    from sentinel_tpu_torch.runtime.registry import Registry

    cfgs = {k: v for k, v in configs(platform_config).items() if k != "fused1"}
    c0 = cfgs["seg4"]
    log(f"[config] max_resources={c0.max_resources} max_nodes={c0.max_nodes} batch={c0.batch_size} "
        f"minute_window={c0.enable_minute_window}; fused: seg_effects=False, 4 lanes; seg4: seg_effects, "
        f"seg_fallback=False, 4 lanes; seg1: seg_effects, single lanes")
    reg = Registry(c0)
    names_to_rows = np.array([reg.resource_id(f"res-{i}") for i in range(N_NAMES)], dtype=np.int32)
    flow, degrade, authority, system, param = build_rules(st)
    value_hashes = np.array([hash_param(arg_value(k)) for k in range(N_VALUES)], dtype=np.int32)
    cols = batch_columns(np, PS, 13, names_to_rows, c0.batch_size, SEED, value_hashes)
    light_cols = batch_columns(np, PS, 1, names_to_rows, 256, SEED + 1, value_hashes)
    peak = stream_peak(np, PS, cols + light_cols, c0)
    seg_u = grown_seg_u(c0, peak)  # the client's growth rule
    log(f"[stream] peak {peak} live segments in a B={c0.batch_size} tick (compaction "
        f"{c0.batch_size / peak:.2f}x); seg_u={seg_u}")
    cfgs["seg4"] = dataclasses.replace(cfgs["seg4"], seg_u=seg_u)
    cfgs["seg1"] = dataclasses.replace(cfgs["seg1"], seg_u=seg_u, seg_static_ranks=True)
    setups = {}
    for name, cfg in cfgs.items():
        rules = E.compile_ruleset(cfg, reg, flow_rules=flow, degrade_rules=degrade, param_rules=param,
                                  authority_rules=authority, system_rules=system, device="cuda")
        n_param = int(rules.param.enabled.sum().item())
        check(n_param == (16 if name == "seg1" else 32), (name, "param rules", n_param))
        setups[name] = (cfg, rules)
    segments = dict(peak=peak, seg_u=seg_u, batch=c0.batch_size, compaction=c0.batch_size / peak)
    return c0, cfgs, setups, cols, light_cols, segments


# -- B2: the tick's flow read against the sequence it replaced ---------------------------


def flow_read_calls(E, W, FU, torch, state, ids, now_ms, cfg):
    """name -> call of the tick's per-item flow read (windowed pass,
    concurrency and borrow pool at ``ids``, the tick's node rows) on
    ``state``.  ``dense + table``: the six launches that build the dense
    [node_rows, 3] table (compare, where, round, cast, a stack that reads
    run[:, EV_PASS], clamp) and one gather_many of the table form, as the
    tick read it up to commit 3441415; ``table alone``: that gather_many on
    the table built beforehand; ``columns``: one gather_many that reads the
    columns where they lie (``E.flow_read_job``), where the package has
    it."""
    cap = (1 << 24) - 1
    cur_wid = W.wid_of(now_ms, cfg.second_window_ms)

    def table():
        pool = torch.where(state.occ_epoch == cur_wid + 1, state.occ_tokens, 0.0)
        tab = torch.stack([W.window_event_run(state.win_sec, W.EV_PASS), state.concurrency,
                           torch.round(pool).to(torch.int32)], dim=1)
        return torch.clamp_max(tab, cap)

    def gather(tab):
        return FU.gather_many([FU.GatherJob("wsum", ids, tab, (3, 3, 3))])

    built = table()
    calls = {"dense + table": lambda: gather(table()), "table alone": lambda: gather(built)}
    if hasattr(E, "flow_read_job"):
        calls["columns"] = lambda: FU.gather_many([E.flow_read_job(state, ids, cur_wid)])
    return calls


def flow_read_report(E, W, FU, torch, state, ids, now_ms, cfg, name) -> dict:
    """Each of ``flow_read_calls``: equal to the others, then its device ms
    a call (L2 flushed, ``time_ms``), its device launches a call
    (``launch_breakdown``) and its host enqueue ms, on ``[b2]`` lines."""
    calls = flow_read_calls(E, W, FU, torch, state, ids, now_ms, cfg)
    outs = {k: c() for k, c in calls.items()}
    for k, out in outs.items():
        check_equal(f"{name} flow read, {k} against dense + table", out, outs["dense + table"])
    rows = {}
    for k, c in calls.items():
        ms, host_ms = time_ms(c)
        per_launch = launch_breakdown(c)
        n = sum(c_ for _n, c_, _ms in per_launch)
        rows[k] = dict(ms=ms, host_ms=host_ms, device_launches=n, launches=per_launch)
        log(f"[b2] {name} flow read at {ids.numel()} items, {k}: device {ms:.4f} ms a call, {n:g} device "
            f"launches (" + ", ".join(f"{n_.split('(')[0][:40]} x{c_:g} {ms_ * 1e3:.2f} us"
                                      for n_, c_, ms_ in per_launch)
            + f"), host enqueue {host_ms:.4f} ms")
    return rows


def tick_flow_ids(E, FU, torch, setup, state, acq, comp, now_ms):
    """Run one tick; (state, a copy of the ids its gather_many call got,
    or None where the tick makes none)."""
    cfg, rules = setup
    seen = []
    real = FU.gather_many

    def rec(jobs):
        seen.append(jobs[0].ids.clone())
        return real(jobs)

    FU.gather_many = rec
    try:
        state, _ = E.tick(state, rules, acq, comp, now_ms, 0.3, 0.2, cfg, E.ALL_FEATURES)
    finally:
        FU.gather_many = real
    return state, (seen[0] if seen else None)


def copy_report(torch, PK, FL, TM) -> dict:
    """probe_copy at the probes' int32 [131,072] against ``torch.add``
    (device ms a call, L2 flushed, in turns: copy, add, add, copy), and its
    P3 block series back to back as the floor probe runs it (1 / 4 / 64 /
    512 blocks and the default grid), on ``[copy]`` lines."""
    ids, _ = FL.data()
    check_equal("probe_copy", [PK.probe_copy(ids)], [PK.probe_copy_plain(ids)])
    turns = [("probe_copy", lambda: PK.probe_copy(ids)), ("torch.add", lambda: torch.add(ids, 1))]
    got = {}
    for k, fn in turns + turns[::-1]:
        got.setdefault(k, []).append(time_ms(fn)[0])
    series = {}
    for blocks in (1, 4, 64, 512, 0):
        step = FL._chain(lambda src, dst, b=blocks: PK.probe_copy(src, b, out=dst), ids)
        series[blocks] = TM.eager(step, FL.K)["device_ms"]
    log(f"[copy] int32 [{ids.numel()}], L2 flushed, ms a call: probe_copy "
        + " / ".join(f"{t:.4f}" for t in got["probe_copy"]) + ", torch.add "
        + " / ".join(f"{t:.4f}" for t in got["torch.add"]))
    log("[copy] back to back, ms a launch, by blocks (0: the default grid): "
        + ", ".join(f"{b}: {t:.5f}" for b, t in series.items()))
    return dict(probe_copy_ms=got["probe_copy"], torch_add_ms=got["torch.add"], series_ms=series)


def b2_main() -> int:
    """``python3 chip_smoke.py --b2``: the numbers of B2 and probe_copy
    against what they replaced, with whatever package lies beside this
    file (so a copy of it in an older checkout measures that checkout).
    For fused, seg4 and seg1 at B = 2,048: one captured tick, the flow
    read's calls (``flow_read_report``) on its state and ids, then 4
    ticks under the profiler (device launches a tick); then
    ``copy_report``; last, each flow read's host time a call function by
    function (``host_breakdown``; after every ``torch.profiler`` session,
    which in one run on the H100 recorded no device activity after a
    cProfile session in the same process).  No main path, no JSON
    record."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.ops import _build
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import window as W
    from sentinel_tpu_torch.probes import floor as FL
    from sentinel_tpu_torch.probes import kernels as PK
    from sentinel_tpu_torch.probes import timing as TM

    log(f"[b2] package {os.path.dirname(os.path.abspath(st.__file__))}; {TM.card_line()}")
    _build.load_library()
    c0, cfgs, setups, cols, _light, _seg = prepare(np, st, E)
    stream = to_batches(E, torch, c0, cols)
    reads = {}
    for name in ("fused", "seg4", "seg1"):
        cfg, rules = setups[name]
        state, ids = tick_flow_ids(E, FU, torch, setups[name], E.init_state(cfg, "cuda"), *stream[0], 1_000)
        torch.cuda.synchronize()
        if ids is not None:
            flow_read_report(E, W, FU, torch, state, ids, 1_000, cfg, name)
            reads[name] = flow_read_calls(E, W, FU, torch, state, ids, 1_000, cfg)
        prof = profile_ticks(E, torch, [(name, state, rules, cfg)], stream[1:], 1_250)
        dev_us, wall_us, cpu_us, n_launch, ours, _top = prof[name]
        log(f"[b2] {name}: profile of 4 ticks: {n_launch} device launches ({n_launch / 4:g} a tick), device busy "
            f"{dev_us / 1e3:.3f} ms, wall {wall_us / 1e3:.3f} ms, host CPU {cpu_us / 1e3:.3f} ms; the port's kernels "
            f"and memsets: {json.dumps(ours, sort_keys=True)}")
    copy_report(torch, PK, FL, TM)
    for name, calls in reads.items():
        for k, c in calls.items():
            wall, host = host_breakdown(c)
            log(f"[b2] {name} flow read, {k}: host {wall:.4f} ms a call, own time "
                + ", ".join(f"{f} {t:.4f}" for f, t in host[:6]) + " ms")
    print(TM.card_line(), flush=True)
    return 0


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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
    from sentinel_tpu_torch.ops import segment as SG
    from sentinel_tpu_torch.ops import segscan as SC
    from sentinel_tpu_torch.ops import window as W
    from sentinel_tpu_torch.ops import wire as WIRE

    report = {"torch": torch.__version__, "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)}
    smi = nvidia_smi()
    report["nvidia_smi"] = smi

    # -- 1. build -----------------------------------------------------------
    t = time.perf_counter()
    _build.load_library()
    log(f"[build] kernels ready in {time.perf_counter() - t:.2f} s (nvcc, every source at once, then one link: "
        f"{_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("[build]", line.strip())

    # -- 2. kernels against their plain versions ------------------------------
    c0, cfgs, setups, cols, light_cols, report["stream_segments"] = prepare(np, st, E)
    report["state_bytes"] = sum(v.numel() * v.element_size() for v in S.leaves(E.init_state(c0, "meta")).values())
    sk = prepare_sketch(np, st, E, torch)
    cfgs["sketch"] = sk["cfg"]
    setups["sketch"] = (sk["cfg"], sk["rules"])
    report["sketch_segments"] = sk["segments"]
    report["sketch_state_bytes"] = sum(v.numel() * v.element_size()
                                       for v in S.leaves(E.init_state(sk["cfg"], "meta")).values())

    # the kernels' wrapper functions (seg_excl_cumsum_many is B3's combined
    # narrow + wide launch, the segment check's ranks)
    real = {"scatter_many": FU.scatter_many, "gather_many": FU.gather_many,
            "seg_excl_cumsum": SC.seg_excl_cumsum, "seg_excl_cumsum_many": SC.seg_excl_cumsum_many,
            "seg_incl_min": SC.seg_incl_min}
    mods = {"scatter_many": FU, "gather_many": FU, "seg_excl_cumsum": SC, "seg_excl_cumsum_many": SC,
            "seg_incl_min": SC}
    kernel_of = dict({k: k for k in real}, seg_excl_cumsum_many="seg_excl_cumsum")

    def install(fns):
        for k, fn in fns.items():
            setattr(mods[k], k, fn)

    def capture_tick(name, state, acq, comp, now_ms):
        """Run one tick; the kernels' arguments (cloned) at each call."""
        cfg, rules = setups[name]
        calls = {k: [] for k in PATH_KERNELS["seg1"] + PATH_KERNELS["seg4"]}

        def recorder(k):
            def rec(*args):
                if k == "scatter_many":
                    a = ([j._replace(**{f: getattr(j, f).clone() for f in j._fields
                                        if isinstance(getattr(j, f), torch.Tensor)}) for j in args[0]],)
                elif k == "gather_many":
                    a = ([gather_job_copy(FU, torch, j) for j in args[0]],)
                else:
                    a = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in args)
                calls[kernel_of[k]].append((k, a))
                return real[k](*args)
            return rec

        install({k: recorder(k) for k in real})
        try:
            state, _ = E.tick(state, rules, acq, comp, now_ms, 0.3, 0.2, cfg, E.ALL_FEATURES)
        finally:
            install(real)
        got = {k for k, v in calls.items() if v}
        check(got == set(PATH_KERNELS[name]), f"{name}: the tick called {sorted(got)}, expected {PATH_KERNELS[name]}")
        return state, calls

    ops = kernel_ops(FU, SC, torch)

    def measure(kname, calls):
        """Hold each call against the plain version; device ms per tick of
        kernel, plain and PyTorch call, the bound, the wrapper's host ms."""
        err = ms = plain_ms = lib_ms = floor_ms = host_ms = 0.0
        nbytes_all = ops_all = 0
        lib = floor = None
        for fname, args in calls:
            run, plain, work, lib, floor = ops[fname]
            err = max(err, check_equal(kname, run(args), plain(args)))
            d, h = time_ms(lambda: run(args))
            ms += d
            host_ms += h
            plain_ms += time_ms(lambda: plain(args), reps=10)[0]
            if lib is not None:
                lib_ms += time_ms(lib(args))[0]
            if floor is not None:
                floor_ms += time_ms(floor(args))[0]
            nb, op = work(args)
            nbytes_all += nb
            ops_all += op
        bnd, by = bound_ms(nbytes_all, ops_all)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms if lib is not None else None,
                    cumsum_floor_ms=floor_ms if floor is not None else None, bound_ms=bnd, bound_by=by,
                    calls_per_tick=len(calls), bytes=nbytes_all, ops=ops_all, wrapper_host_ms=host_ms)

    kern = {}
    plane_reports = {}
    b1_detail, b3_detail = [], []
    flow_reads = {}
    state0 = {}
    stream = to_batches(E, torch, c0, cols)
    light = to_batches(E, torch, c0, light_cols)[0]
    streams = {name: (stream, light) for name in cfgs}
    streams["sketch"] = (sk["stream"], sk["light"])
    torch.cuda.synchronize()  # set-up done: a fault below is the tick's
    for name in cfgs:
        s0 = E.init_state(cfgs[name], "cuda")
        log(f"[capture] {name}")
        stream_n, light_n = streams[name]
        s0, cap_full = capture_tick(name, s0, *stream_n[0], 1_000)
        torch.cuda.synchronize()
        s0, cap_light = capture_tick(name, s0, *light_n, 1_100)
        torch.cuda.synchronize()
        state0[name] = s0
        plane_reports[name] = plane_report(E, torch, s0, setups[name][1], cfgs[name], *stream_n[1], 1_150)
        torch.cuda.synchronize()
        log(f"[planes] {name}: the tick's plane functions alone, a call at B={c0.batch_size}: " + "; ".join(
            f"{k} {v['launches']:g} device launches, device {v['ms']:.4f} ms, host enqueue {v['host_ms']:.4f} ms"
            for k, v in plane_reports[name].items()))
        for shape, cap in ((f"B={c0.batch_size}", cap_full), ("B=256", cap_light)):
            for kname in PATH_KERNELS[name]:
                k = measure(kname, cap[kname])
                kern.setdefault(kname, {})[f"{name} {shape}"] = k
                extra = (f", library {k['library_ms']:.4f} ms" if k["library_ms"] is not None
                         else f", torch.cumsum floor (unsegmented) {k['cumsum_floor_ms']:.4f} ms")
                was = (f" ({EARLIER_MS[kname][0]}: {EARLIER_MS[kname][1]:.4f} ms)"
                       if kname in EARLIER_MS and name == RECORD_CFG[kname] and shape == f"B={c0.batch_size}" else "")
                log(f"[kernel] {kname} on {name} at {shape}: equal to plain (max |err| {k['max_abs_err']}); "
                    f"per tick ({k['calls_per_tick']} call(s)), device time: kernel {k['ms']:.4f} ms{was}, plain "
                    f"{k['plain_ms']:.4f} ms{extra}, bound {k['bound_ms']:.6f} ms ({k['bound_by']}, "
                    f"{k['bytes']} B); wrapper host enqueue {k['wrapper_host_ms']:.4f} ms")
            # B2 against the dense build it replaced, at the full batch
            if shape == f"B={c0.batch_size}" and cap["gather_many"]:
                ids = cap["gather_many"][0][1][0][0].ids
                flow_reads[name] = flow_read_report(E, W, FU, torch, s0, ids, 1_100, cfgs[name], name)
            # B1's time, launch by launch and on the host, call by call
            for i, (_f, args) in enumerate(cap["scatter_many"]):
                jobs = args[0]
                FU.reset_launches()
                FU.scatter_many(jobs)
                check(FU.LAUNCHES["scatter_many"] <= 2, f"{name} {shape} B1 call {i}: {FU.LAUNCHES} launches")
                per_launch = launch_breakdown(lambda: FU.scatter_many(jobs))
                wall, host = host_breakdown(lambda: FU.scatter_many(jobs))
                units = sum(j.rows.shape[0] for j in jobs)
                cells = sum(j.n * j.values.shape[-2] for j in jobs)
                b1_detail.append(dict(config=name, shape=shape, call=i, jobs=len(jobs), units=units, cells=cells,
                                      launches=per_launch, host_ms=wall, host_split=host))
                log(f"[b1] {name} {shape} call {i} ({len(jobs)} jobs, {units} row-vectors, {cells} cells): "
                    "device ms a call by kernel " + ", ".join(f"{n.split('(')[0]} x{c:g} {ms:.4f}" for n, c, ms in per_launch)
                    + f" ms; host {wall:.4f} ms a call, own time "
                    + ", ".join(f"{n} {ms:.4f}" for n, ms in host) + " ms")
            # B3's calls, launch by launch (a cast of a non-int32 row is the
            # wrapper's, inside the call)
            for i, (f, args) in enumerate(cap.get("seg_excl_cumsum", [])):
                per_launch = launch_breakdown(lambda: ops[f][0](args))
                b3_detail.append(dict(config=name, shape=shape, call=i, wrapper=f, launches=per_launch))
                log(f"[b3] {name} {shape} call {i} ({f}, rows {[tuple(a.shape) for a in args[1:] if a is not None]}): "
                    "device ms a call by kernel " + ", ".join(f"{n.split('(')[0]} x{c:g} {ms:.4f}" for n, c, ms in per_launch)
                    + " ms")
    report["b2_flow_read"] = flow_reads
    report["b1_breakdown"] = b1_detail
    report["b3_breakdown"] = b3_detail
    # the valued-histogram probes' calls, launch by launch, checked in phase 5
    # (taken here: after phase 4's profiles of ticks, torch.profiler recorded
    # no device activity in this process on the H100)
    from sentinel_tpu_torch.probes import floor as FL
    from sentinel_tpu_torch.probes import hist as HI
    from sentinel_tpu_torch.probes import kernels as PK

    probe_splits = probe_split(torch, PK, FL, HI)
    edge = edge_cases(FU, np, torch)
    edge.update(scan_edge_cases(SC, SG, np, torch))
    log(f"[kernel] edge cases equal to plain (max |err| {json.dumps(edge)})")
    for kname, per_shape in kern.items():
        for k in per_shape.values():
            k["max_abs_err"] = max(k["max_abs_err"], edge[kname])

    # -- 3. the main paths ---------------------------------------------------------
    main_runs = {}
    for name in ("fused", "seg4", "seg1"):
        base = configs(platform_config)[name]  # the client sizes seg_u itself
        counts, n_done, elapsed, launches, info = drive_main_path(st, np, FU, SC, torch, base, MAIN_ENTRIES)
        log(f"[main] {name}: {n_done} entries from {N_THREADS} threads in {elapsed:.2f} s "
            f"({n_done / elapsed:.0f} entries/s); verdict mix {json.dumps(counts, sort_keys=True)}")
        log(f"[main] {name}: kernel launches during the run: {json.dumps(launches)}; client {json.dumps(info)}")
        check(n_done >= MAIN_ENTRIES, (name, n_done))
        for kname in PATH_KERNELS[name]:
            check(launches[kname] > 0, (name, kname, launches))
        check(counts.get("FlowException", 0) > 0, (name, counts))
        check(counts.get("ParamFlowException", 0) > 0, (name, "no entry was blocked by a param rule", counts))
        check("param" in info["features"] and info["param_rules"] == (16 if name == "seg1" else 32), (name, info))
        check(info["pconc_after_exits"] == 0 and info["pcms_total"] > 0,
              f"{name}: THREAD-grade param concurrency did not return to 0 after the exits: {info}")
        if name == "seg1":
            check(info["seg_static_ranks"], "seg1: the client did not turn seg_static_ranks on")
        if name != "fused":
            check(info["seg_dropped_total"] == 0, (name, info))
        # the planes on the main path: the telemetry row's folded verdict
        # mix is what the futures returned, every blocked entry is explained
        # or counted past explain_k, and the timeline recorded rows
        check(info["wire_decode_failures"] == 0, (name, info))
        check(all(info["folded_verdicts"][k] == counts.get(k, 0) for k in FOLDED),
              f"{name}: folded device verdicts {info['folded_verdicts']} != the futures' {counts}")
        n_blocked = sum(v for k, v in counts.items() if k not in ("pass", "pass_wait"))
        check(info["explain_coverage"]["blocked"] == n_blocked and info["explain_coverage"]["explained"] > 0,
              (name, "explain coverage", info["explain_coverage"], n_blocked))
        check(info["timeline_rows"] > 0, (name, "the timeline recorded no rows"))
        main_runs[name] = dict(entries=n_done, seconds=elapsed, verdicts=counts, launches=launches, client=info)
    # the extension points on the seg4 client: a no-op hook, slot and metric
    # extension change no verdict, and each fires once an entry
    plain, loaded, calls = drive_extension_points(st, np, torch, configs(platform_config)["seg4"])
    n_pass = sum(1 for k, _w in loaded if k == "pass")
    log(f"[main] extension points (seg4, {EXT_ENTRIES} entries, one thread, a stepped clock): verdicts with a "
        f"no-op hook, slot and extension loaded equal the plain run's: {plain == loaded}; callbacks "
        f"{json.dumps(calls, sort_keys=True)}; {n_pass} passed")
    check(plain == loaded, "a no-op hook, slot and extension changed the verdicts")
    check(calls.get("hook") == calls.get("slot_entry") == calls.get("slot_exit") == EXT_ENTRIES
          and calls.get("on_pass", 0) + calls.get("on_block", 0) == EXT_ENTRIES
          and calls.get("on_complete") == n_pass and 0 < n_pass < EXT_ENTRIES,
          ("extension callback counts", calls, n_pass))
    report["extension_points"] = dict(entries=EXT_ENTRIES, calls=calls, passed=n_pass, equal=plain == loaded)
    # the sketch configuration through the client: bench.py's names through
    # the registry (the exact space fills, the tail interns as sketch ids)
    sk_client = sketch_cfg(platform_config)  # the client sizes seg_u and seg_static_ranks itself
    counts, n_done, elapsed, launches, info = drive_sketch_main(st, np, FU, SC, torch, sk_client, MAIN_ENTRIES)
    log(f"[main] sketch: {n_done} entries from {N_THREADS} threads (+{HAMMER} on {info['hammered']}) in "
        f"{elapsed:.2f} s ({n_done / elapsed:.0f} entries/s); verdict mix {json.dumps(counts, sort_keys=True)}")
    log(f"[main] sketch: kernel launches during the run: {json.dumps(launches)}; client {json.dumps(info)}")
    log(f"[main] sketch: the hot-set loop in phase 3: {info['promotions']} promotions (rule loads and manager), "
        f"{info['promotion_failures']} failed, {info['demotions']} demotions; {info['manager_promoted']} promoted by "
        f"the manager; {info['hot_candidates']} hot candidates folded, all sketch ids: "
        f"{info['hot_candidate_ids_sketch']}; {info['tail_names_left_on_sketch_ids']} tail-ruled names on sketch ids")
    check(n_done >= MAIN_ENTRIES, ("sketch", n_done))
    for kname in PATH_KERNELS["sketch"]:
        check(launches[kname] > 0, ("sketch", kname, launches))
    check(counts.get("hammer FlowException", 0) > 0, ("sketch: the tail rule blocked none of the hammer", counts))
    check(info["hot_candidates"] > 0 and info["hot_candidate_ids_sketch"], ("sketch: hot rows", info))
    check("tail_flow" in info["features"] and info["seg_static_ranks"] and info["seg_dropped_total"] == 0, info)
    check(info["wire_decode_failures"] == 0 and info["promotions"] > 0, info)
    plain_counts = {k: v for k, v in counts.items() if not k.startswith("hammer ")}
    check(all(info["folded_verdicts"][k] == plain_counts.get(k, 0) for k in FOLDED),
          f"sketch: folded device verdicts {info['folded_verdicts']} != the futures' {plain_counts}")
    main_runs["sketch"] = dict(entries=n_done, seconds=elapsed, verdicts=counts, launches=launches, client=info)
    report["main_path"] = main_runs

    # open-loop bursts: full 2,048-acquire ticks through the client
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.ops import engine_seg as ES

    bursts = {}
    burst_ref = {"seg4": "fused", "seg1": "fused1"}
    for name in ("fused", "fused1", "seg4", "seg1"):
        base = configs(platform_config)[name]
        verdicts, launches, info = drive_burst(st, np, FU, SC, base, build_rules(st))
        mix = np.bincount([v for v, _w in verdicts], minlength=7).tolist()
        log(f"[burst] {name}: 2 bursts of {base.batch_size} acquires, one tick each, and {info['exits']} exits "
            f"between; verdict mix {mix}; launches {json.dumps(launches)}; client {json.dumps(info)}")
        for kname in PATH_KERNELS[name]:
            check(launches[kname] > 0, (name, "burst", kname, launches))
        check(mix[ERR.BLOCK_FLOW] > 0 and mix[ERR.PASS_WAIT] > 0 and mix[ERR.BLOCK_DEGRADE] > 0, (name, mix))
        check(mix[ERR.BLOCK_PARAM] > 0, (name, "no burst item was blocked by a param rule", mix))
        check(info["param_rules"] == (16 if name.endswith("1") else 32), (name, info))
        if name in burst_ref:
            auto = ES.seg_capacity(base, base.batch_size)
            check(info["peak_segments"] > auto and info["seg_u"] > auto,
                  f"{name}: the burst did not grow seg_u past the automatic capacity {auto}: {info}")
            check(info["seg_dropped_total"] == 0, (name, "burst", info))
            check(verdicts == bursts[burst_ref[name]]["verdicts"],
                  f"{name}: burst verdicts or waits differ from the {burst_ref[name]} client's")
        bursts[name] = dict(verdicts=verdicts, mix=mix, launches=launches, client=info)
    # the sketch configuration's bursts: the segment client against the
    # per-item fused client on the same configuration, item for item
    for name, kw in (("sketch fused", dict(seg_effects=False)), ("sketch", {})):
        verdicts, launches, info = drive_sketch_burst(st, np, FU, SC, sketch_cfg(platform_config, **kw))
        mix = np.bincount([v for v, _w in verdicts], minlength=7).tolist()
        log(f"[burst] {name}: 2 bursts of 2048 acquires ({HAMMER} on {info['hammered']} each), one tick each, and "
            f"{info['exits']} exits between; verdict mix {mix}; launches {json.dumps(launches)}; client "
            f"{json.dumps(info)}")
        for kname in PATH_KERNELS["sketch" if name == "sketch" else "fused"]:
            check(launches[kname] > 0, (name, "burst", kname, launches))
        check(info["hammer_blocked"] > 0 and info["seg_dropped_total"] == 0, (name, info))
        if name == "sketch":
            check(info["seg_static_ranks"], ("sketch burst", info))
            check(verdicts == bursts["sketch fused"]["verdicts"],
                  "sketch: burst verdicts or waits differ from the fused sketch client's")
        bursts[name] = dict(verdicts=verdicts, mix=mix, launches=launches, client=info)
    report["burst"] = {k: {f: v for f, v in b.items() if f != "verdicts"} for k, b in bursts.items()}

    # -- 4. the tick against itself --------------------------------------------------
    from sentinel_tpu_torch.obs import explain as TX

    ticks = stream[1:]
    plain = {"scatter_many": FU.scatter_many_plain, "gather_many": FU.gather_many_plain,
             "seg_excl_cumsum": SC.seg_excl_cumsum_plain, "seg_excl_cumsum_many": SC.seg_excl_cumsum_many_plain,
             "seg_incl_min": SC.seg_incl_min_plain}
    report["tick"] = {}
    for name, (cfg, rules) in setups.items():
        if name == "sketch":
            continue  # its own phase below
        lo = WIRE.layout_for(cfg, cfg.batch_size)
        st_a = E.clone_state(state0[name])
        st_b = E.clone_state(state0[name])
        FU.reset_launches()
        SC.reset_launches()
        scores = []
        st_a, wires_a, waits_a, tick_s = run_stream(E, torch, st_a, rules, cfg, ticks, 1_250, forbid_sync=True,
                                                    scores=scores)
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        for kname in PATH_KERNELS[name]:
            check(launches[kname] > 0, (name, "tick", kname, launches))
        install(plain)
        try:
            st_b, wires_b, waits_b, _ = run_stream(E, torch, st_b, rules, cfg, ticks, 1_250)
        finally:
            install(real)
        mix = np.zeros(7, np.int64)
        for i, (wa, wb) in enumerate(zip(wires_a, wires_b)):
            check(wa == wb, f"{name} tick {i}: wire bytes differ between kernels and plain versions")
            check(np.array_equal(waits_a[i], waits_b[i]), f"{name} tick {i}: wait_ms differ")
            fr = WIRE.unpack(wa, lo)
            check(fr.seg_dropped == 0, f"{name} tick {i}: {fr.seg_dropped} items dropped for segment capacity")
            mix += np.bincount(fr.verdict, minlength=7)
        check(mix[ERR.BLOCK_PARAM] > 0, (name, "no tick item was blocked by a param rule", mix.tolist()))
        check(int(st_a.pcms.sum().item()) > 0, f"{name}: the param store stayed empty")
        float_diff = 0.0
        la, lb = S.leaves(st_a), S.leaves(st_b)
        for k in la:
            if la[k].dtype.is_floating_point:
                float_diff = max(float_diff, (la[k] - lb[k]).abs().max().item())
            else:
                check(torch.equal(la[k], lb[k]), f"{name}: integer state leaf {k} differs")
        del st_b, la, lb
        planes = check_planes(np, E, WIRE, TX, cfg, wires_a, scores)
        # the same stream with the planes off: the same verdicts, waits and state
        cfg_off = planes_off(cfg)
        lo_off = WIRE.layout_for(cfg_off, cfg.batch_size)
        st_c, wires_c, waits_c, _ = run_stream(E, torch, E.clone_state(state0[name]), rules, cfg_off, ticks,
                                               1_250, forbid_sync=True)
        for i, (wa, wc) in enumerate(zip(wires_a, wires_c)):
            fa, fc = WIRE.unpack(wa, lo), WIRE.unpack(wc, lo_off)
            check(np.array_equal(fa.verdict, fc.verdict) and np.array_equal(waits_a[i], waits_c[i]),
                  f"{name} tick {i}: the planes changed a verdict or a wait")
        la, lc = S.leaves(st_a), S.leaves(st_c)
        check(all(torch.equal(la[k], lc[k]) for k in la), f"{name}: the planes changed the state")
        del st_c, la, lc
        # tick time with the planes off and on, in turns (off, on, on, off)
        # from the same state, so that host drift weighs on both alike
        turns = {"off": [], "on": []}
        for label in ("off", "on", "on", "off"):
            c_turn = cfg if label == "on" else cfg_off
            _s, _w, _wt, ts_turn = run_stream(E, torch, E.clone_state(state0[name]), rules, c_turn, ticks, 1_250,
                                              forbid_sync=True)
            turns[label] += ts_turn[2:]
            del _s
        ms_tick = 1e3 * sorted(turns["on"])[len(turns["on"]) // 2]
        ms_off = 1e3 * sorted(turns["off"])[len(turns["off"]) // 2]
        prof = profile_ticks(E, torch, [("off", st_a, rules, cfg_off), ("on", st_a, rules, cfg)], ticks, 9_000)
        dev_us, wall_us, cpu_us, n_launch, ours, top = prof["on"]
        dev_off, wall_off, cpu_off, n_off, _ours_off, _top_off = prof["off"]
        idle = 1 - dev_us / wall_us
        log(f"[tick] {name}: {len(ticks)} ticks at B={cfg.batch_size}, no host sync inside; kernels == plain "
            f"versions (wire bytes, wait_ms, integer state; float state max |diff| {float_diff}); "
            f"seg_dropped 0; verdict mix {mix.tolist()}; launches {json.dumps(launches)}")
        log(f"[tick] {name}: planes checked on the card ({json.dumps(planes)}): stats row == bitmap, n_blocked, "
            f"explain sec_sum, timeline rows == host sort of the run readback; planes off: same verdicts, waits, "
            f"state; wire {lo.total} words at B={cfg.batch_size} and {WIRE.layout_for(cfg, 256).total} at 256 "
            f"(planes off {lo_off.total} and {WIRE.layout_for(cfg_off, 256).total})")
        log(f"[tick] {name}: median {ms_tick:.3f} ms per tick -> {cfg.batch_size / ms_tick * 1e3:.0f} decisions/s "
            f"(planes off {ms_off:.3f} ms -> {cfg.batch_size / ms_off * 1e3:.0f}; two runs of each in turns, "
            f"off / on / on / off, {len(turns['on'])} steady ticks each); "
            f"profile of 4 ticks: device busy {dev_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
            f"(idle share {idle:.3f}), host CPU {cpu_us / 1e3:.3f} ms, {n_launch} device launches "
            f"({n_launch / 4:g} a tick; 71b3c5a: {EARLIER_LAUNCHES[name]:g}); "
            f"scatter_many launches a tick {launches['scatter_many'] / len(ticks):g}; the profile's launches of "
            f"the port's kernels and memsets, 4 ticks: {json.dumps(ours, sort_keys=True)}")
        log(f"[tick] {name}: the planes add, a tick: {(n_launch - n_off) / 4:g} device launches "
            f"({n_off / 4:g} -> {n_launch / 4:g}), {(dev_us - dev_off) / 4e3:.4f} ms device busy "
            f"({dev_off / 4e3:.4f} -> {dev_us / 4e3:.4f}), {(cpu_us - cpu_off) / 4e3:.4f} ms host CPU under the "
            f"profiler ({cpu_off / 4e3:.4f} -> {cpu_us / 4e3:.4f}), {(wall_us - wall_off) / 4e3:.4f} ms wall "
            f"({wall_off / 4e3:.4f} -> {wall_us / 4e3:.4f}); median tick {ms_tick - ms_off:.3f} ms")
        for row_name, (n, us) in top:
            log(f"[profile] {name}: {row_name[:60]:60s} x{n:5d} {us / 1e3:9.3f} ms (4 ticks)")
        report["tick"][name] = dict(ms_median=ms_tick, decisions_per_s=cfg.batch_size / ms_tick * 1e3,
                                    tick_ms=[1e3 * s for s in turns["on"]], ticks=len(ticks),
                                    float_state_max_diff=float_diff,
                                    verdict_mix=mix.tolist(), launches=launches, device_us=dev_us, wall_us=wall_us,
                                    host_cpu_us=cpu_us, idle_share=idle, device_launches=n_launch, seg_u=cfg.seg_u,
                                    profile_kernel_launches=ours,
                                    scatter_many_launches_a_tick=launches["scatter_many"] / len(ticks),
                                    planes_checked=planes, wire_words={"on": [lo.total, WIRE.layout_for(cfg, 256).total],
                                                                       "off": [lo_off.total, WIRE.layout_for(cfg_off, 256).total]},
                                    planes_off=dict(ms_median=ms_off, tick_ms=[1e3 * s for s in turns["off"]],
                                                    device_us=dev_off, wall_us=wall_off, host_cpu_us=cpu_off,
                                                    device_launches=n_off),
                                    plane_fns=plane_reports[name])
        del st_a

    from sentinel_tpu_torch.sketch import salsa as SA

    sk["state0"] = state0["sketch"]
    report["tick"]["sketch"] = sketch_tick_phase(np, E, WIRE, TX, S, FU, SC, SA, torch, install, real, plain, sk)
    del sk["state0"]

    # -- 5. the probes ---------------------------------------------------------------
    flat = {k: (v["b2048"]["on"] if k == "sketch" else v) for k, v in report["tick"].items()}
    probe_records, report["probes"] = probe_phase(np, torch, flat, probe_splits)

    # -- 6. seg_fallback=True: the tick's two routes ------------------------------------
    report["fallback"] = fallback_phase(np, st, E, WIRE, S, FU, SC, torch, install, real, plain, setups, sk)
    del sk
    torch.cuda.empty_cache()

    # -- 7. bench.py's client_bench through the port's client ---------------------------
    report["client_bench"] = {str(B): client_bench_phase(np, st, FU, SC, torch, B, smi) for B in (BIG_B, 2048)}

    # -- 8. cluster flow control: the token column, server and clients --------------------
    report["cluster"] = cluster_phase(np, st, S, FU, SC, torch, smi)

    # -- 9. the control plane: readers, command center, metric log, reshape ---------------
    report["control"] = control_phase(np, st, S, FU, SC, torch, smi)

    # -- 10. overload protection and the plain effects path --------------------------------
    report["overload"] = overload_phase(np, st, S, FU, SC, torch, smi)

    kernels = []
    for kname in ("scatter_many", "gather_many", "seg_excl_cumsum", "seg_incl_min"):
        name = RECORD_CFG[kname]
        k = kern[kname][f"{name} B={c0.batch_size}"]
        src, replaces = KERNEL_SRC[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=main_runs[name]["launches"][kname], max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=k["library_ms"],
        ))
    for kname in PROBE_KERNELS:
        k = probe_records[kname]
        src, replaces = KERNEL_SRC[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces, launches=k["launches"],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
        ))
    kern.update({kname: {k["shape"]: k} for kname, k in probe_records.items()})
    report["kernel_detail"] = kern
    log("[report]", json.dumps(report, sort_keys=True))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


#: aten operations that make no device launch of their own (views, shape
#: and dtype queries, allocation): left out of the operation count
VIEW_OPS = frozenset(
    "aten::" + n for n in (
        "view alias as_strided reshape _reshape_alias _unsafe_view view_as select slice narrow expand "
        "unsqueeze squeeze t transpose permute numpy_T split unbind chunk detach lift_fresh contiguous "
        "empty empty_strided resolve_conj resolve_neg result_type item _local_scalar_dense is_nonzero"
    ).split()
)


def ops_main() -> int:
    """``python3 chip_smoke.py --ops``: on the CPU, the PyTorch operations
    one B = 2,048 tick of the ``sketch`` configuration runs, with the
    sketch tier on and off (top-level, non-view aten operations of a
    ``torch.profiler`` CPU trace of the second tick): the count a
    prediction of the tier's device launches starts from.  Needs no card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.ops import engine as E

    sk = prepare_sketch(np, st, E, torch, device="cpu")
    cfg, rules = sk["cfg"], sk["rules"]
    cfg_off, _ = sketch_off(E, torch, cfg, E.init_state(cfg, "cpu"))
    for label, c in (("off", cfg_off), ("on", cfg)):
        state = E.init_state(c, "cpu")
        state, _ = E.tick(state, rules, *sk["stream"][0], 1_000, 0.3, 0.2, c, E.ALL_FEATURES)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            E.tick(state, rules, *sk["stream"][1], 1_137, 0.3, 0.2, c, E.ALL_FEATURES)
        n = sum(1 for e in prof.events() if e.name.startswith("aten::") and e.name not in VIEW_OPS
                and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
        log(f"[ops] sketch tier {label}: {n} top-level non-view aten operations in one B={cfg.batch_size} tick")
    return 0


def control_main() -> int:
    """``python3 chip_smoke.py --control``: the kernels' build and phase 9
    alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.ops import _build
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import segscan as SC

    _build.load_library()
    rep = control_phase(np, st, S, FU, SC, torch, nvidia_smi())
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


def cluster_main() -> int:
    """``python3 chip_smoke.py --cluster``: the kernels' build and phase 8
    alone, on the card (about two minutes)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.ops import _build
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import segscan as SC

    _build.load_library()
    rep = cluster_phase(np, st, S, FU, SC, torch, nvidia_smi())
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


def overload_main() -> int:
    """``python3 chip_smoke.py --overload``: the kernels' build and phase 10
    alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.ops import _build
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import segscan as SC

    _build.load_library()
    rep = overload_phase(np, st, S, FU, SC, torch, nvidia_smi())
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    mode = sys.argv[1:]
    sys.exit(b2_main() if mode == ["--b2"] else ops_main() if mode == ["--ops"]
             else cluster_main() if mode == ["--cluster"] else control_main() if mode == ["--control"]
             else overload_main() if mode == ["--overload"]
             else simload_main(*mode[1:]) if mode[:1] == ["--simload"] and len(mode) == 3
             else main())
