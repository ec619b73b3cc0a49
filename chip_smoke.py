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
   request threads, Zipf(1.1) over 100,000 names, real exits, 2,000
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
   until it is spent), 2,000 entries of its traffic by name from 8
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

11. The operations plane (``workload_phase``).  (a) ``workload.
   run_closed_loop`` on a sync client on virtual time under
   ``platform_config()`` at the default widths (flow rules on the 16
   keys): flash_crowd_2x(seed=7) as bench.py:1859, op0 the config's point
   (batch 2,048), candidates batch 512 and 256 each also with
   pipeline_depth=2; static, then tuned twice (the replay must be
   identical), and the same static and tuned runs on the CPU in a process
   of its own (journal, latencies and counts equal to the card's);
   B1 / B2 / B4 launched, no surprise retrace, and one captured tick of the
   tuned run replayed with the kernels (profiled by name) and with their
   plain versions, equal.  (b) A threaded ``platform_config()`` client at
   pipeline_depth=4 under 8 request threads: ``apply_operating_point``
   moves the batch 2,048 -> 512 -> 2,048 and the depth 4 -> 0 -> 4 live;
   no timeout, every future resolved, each swap's engine-lock hold and
   decisions/s before, during and after.  (c) The memory ledger against
   the card's allocator on that client and on bench.py's build: pools,
   ``reconcile()``, the sketch pool within 10 % of ``salsa.hbm_bytes``,
   ``stop()`` dropping the client's entries, and a capacity one byte over
   the total making the tuner reject a grown sketch point.  (d) The
   sketch audit (k 8, period 16) on bench.py's build over phase 4's
   sketch stream at B = 2,048: checks > 0, no underestimate, no eps
   violation, no failure; every tick but the audit's under the sync-debug
   mode "error"; B1 / B3 / B4 launched; an audit tick's host and device
   time beside another's; a captured tick against its plain-version tick.
   (e) Through the HTTP command center of (b)'s client: api/memory,
   api/profile?ms=250 (ok, then rate_limited), metrics?fleet=1 with the
   center itself as a fleet target (well formed, the self-scrape dropped);
   then ``default_slos()`` judged over the phase (``[workload]`` lines).

12. The front doors and the adapters (``doors_phase``).  (a) The native
   front door at the default widths: a ``platform_config()`` decision
   client, a ``DefaultTokenService`` deciding on its engine with phase 8's
   rules, two ``NativeFrontDoor``s on one port (``reuseport=True``)
   attached and following it, then a cluster param rule whose resource
   gateway rules left no hash lane (``sentinel_front_door_unenforceable_
   rules`` must not move for the lane-0 rules and must count that one).
   A sync client on virtual time: 8 sockets in turn each pipeline 512
   frames (flow, param with int and string values, concurrent acquire and
   release), the rings fill, one ``tick_once`` drains them (under
   ``set_sync_debug_mode("error")`` with the kernels); once with the
   kernels, once with their plain versions and once on the CPU in a
   process of its own — every response's status, wait and token id equal;
   one captured door tick against its plain-version tick, B1 / B2 / B4 by
   name.  Then a threaded client: 8 load threads pipelining bursts of 64
   frames for 8 s beside 2 ``entry()`` threads — every frame answered, no
   tick failed closed; tokens/s, round trip p50 / p99, ms a tick, the
   doors' share of a batch, and a half-second profile (busy and idle share
   a tick, B1 / B2 / B4 by name).  (b) The Envoy RLS rule model
   (``rls/rules.py``; no grpcio, no protobuf): 10,000 descriptors over a
   matched domain, unmatched values and an unknown domain resolved to flow
   ids and decided through (a)'s token service, ``hits_addend`` 1 then 3;
   OK / OVER_LIMIT equal the CPU's, code for code (the gRPC wire is held
   on the CPU by the tests).  (c) A threaded ``platform_config()`` client
   with flow rules, gateway route rules and gateway param rules (header,
   URL param, client IP): bare ``entry()``, WSGI and ASGI apps called in
   process, ``@sentinel_resource`` with a fallback, ``guard_stream`` —
   requests/s and µs added over bare ``entry()``; ``drive_gateway``,
   ``drive_asgi`` and ``drive_streaming`` over flash_crowd_2x(seed=7) cut
   to 16 steps: submitted == passed + blocked, blocks where a rule binds,
   B1 / B2 / B4 launched; and ``drive_gateway``'s sync replay (12 steps)
   equal to the CPU's request for request (``[doors]`` lines).

13. The operator's plane (``operator_phase``).  (a) A threaded
   ``platform_config()`` client at the default widths (phase 9's rules:
   4,000 flow, 1,000 degrade, 32 param, an authority and a system rule;
   Zipf(1.1) over 100,000 names from 8 request threads) with its metric
   log, its command center and a heartbeat into the port's
   ``DashboardServer``, whose ``MetricFetcher`` sweeps every second (round
   p50 / p99 ms and rows saved).  Through the dashboard's REST routes: the
   whole flow rule set fetched and pushed back with ``res-1``'s count
   raised, its burst of 24 flipping from at most 6 passed to all passed
   (push -> rules loaded -> first enforcing tick, in ms and ticks; ms a
   tick in the second around the push against steady traffic); the
   degrade, param and system rules round-tripped unchanged; no reload
   builds a tick (``sentinel_engine_tick_builds_total``).  Then
   ``/cluster/assign`` over two more clients on the card, each with its
   token service and command center: a cluster-mode rule allowing 5 on
   the server and 1,000 on the client machine's fallback lets 5 of 12
   through.  (b) The ten datasources (HTTP poll with ETags, callback,
   Redis, ZooKeeper, Nacos, Consul, Apollo, Eureka, etcd, Spring Cloud
   Config), each against a stub of its store on 127.0.0.1 speaking its
   wire, push the same change (``ds-res`` count 1,000 -> 2) to (a)'s
   serving client: push -> first enforcing tick, and a one-tick burst of
   12 flipping from 12 passed to at most 2; every datasource's threads
   end on ``close()``.  Then the same pushes to a sync client on virtual
   time, on the card and on the CPU (a process of its own): (passed,
   blocked) equal.  (c) The unpacked client (``packed_wire=False``)
   against the packed one, each a sync client on virtual time over 16
   ticks of B = 2,048 Zipf(1.1) requests with exits, on
   ``platform_config()`` (B1, B2, B4) and phase 4's seg1 configuration
   (B1, B3, B4): verdicts and waits bit-identical on the card and equal to
   the CPU's unpacked run; ms a tick, tx / rx bytes a tick, reads a tick,
   B1-B4 launches a tick (``[operator]`` lines).
14. The sharded cluster and the shard router (``shards_phase``).  (a) A
   4-shard ``ShardFleet``: each shard a ``DefaultTokenService`` (the token
   column) on its own sync ``platform_config()`` client on the card
   behind a ``ClusterTokenServer`` on 127.0.0.1, holding phase 8's 1,000
   cluster flow rules (all GLOBAL here) and 32 cluster param rules,
   partitioned over the ring (the shards' clients are sync, on the real
   clock, as ``cluster_sharded_bench``'s).  A threaded ``platform_config()`` serving
   client with 4,000 flow rules (those 1,000 cluster-mode) and the param
   rules joins through ``ClusterStateManager.set_to_sharded_client``; 8
   threads send 60 Zipf(1.1) entries each over the 4,000 names (one in 8
   with an argument), then one ``check_batch`` of 2,048.  Every decision
   an owner's token column makes is for a flow the ring gives it; the owners'
   grants stay within each threshold in every window, and the client's
   admits (remote grants plus lease-local admits) within the threshold
   plus one lease; lease-first local admits happen; no token call fails.
   The hottest flow's owner is killed: that flow's decisions pass only
   against the lease carried at the kill and then block (never
   STATUS_FAIL, the client's own cluster degrade never engages), the
   other shards still answer remotely, and ``api/shards`` from the serving
   client's command center lists four shards, one degraded; on ``rejoin``
   the exit transition comes and remote answers resume.  The serving
   client's tick launches B1, B2 and B4, and one captured tick is held
   against its plain versions.  ``cluster_sharded_bench``'s row
   (bench.py:615-700) at 1 and 4 shards.  A sync replay of a seeded token
   sequence (a kill and a rejoin in it) on virtual time with
   ``lease_refresh_async=False`` on a 2-shard card fleet equals the CPU's
   (a process of its own).  (b) A ``ShardRouter`` over two ``RemoteShard``
   s, each on an in-process token server whose host client (sync,
   virtual time, ``platform_config()``) runs on the card, takes four mixed
   batches of 2,048: verdicts in input order equal to a router over two
   in-process card clients and to the CPU's; one host's server stops
   before the third batch (its spans give BLOCK_SYSTEM through the
   router's ``block`` mode, no chunk answered twice) and restarts on its
   port: served again after ``retry_interval_s``.  A second pass over two
   threaded card host clients behind servers at their default worker count
   (a connection's chunks decide on 8 workers, answers in any order) takes
   eight batches of 2,048 whose names' verdicts are fixed by their rules:
   every item gets its own verdict, no chunk degrades, each host decides
   each of its items once; its decisions/s and chunk ms are the router's
   numbers.  The hosts' ticks launch B1, B2 and B4 (``[shards]`` lines).
15. The chaos plane, the lock witness and the trace CLI (``chaos_phase``).
   (a) Every chaos scenario of ``sentinel_tpu_torch/chaos/runner.py`` (all
   eleven, the two outside the ``fast`` set too) on the card at seed 7:
   each green, its injected counts equal to the CPU's run of the same
   seed (a process of its own, ``--chaos-cpu``); ``seg_overflow_storm``
   (the fused segment path: B1, B3, B4) again with the kernels and with
   their plain versions: both storms' verdicts and waits and the seg drops
   equal; the fast set a second time, every injected count as in the
   first (the determinism check); each scenario's seconds and launches.
   (b) The lock witness over a full-width serving client: a threaded
   ``platform_config()`` client at the default widths with phase 9's
   4,000 flow and 1,000 degrade rules (plus eight cluster-mode rules
   served by a two-shard fleet through ``set_to_sharded_client``), beside
   a token server and client pair, under 8 Zipf(1.1) request threads over
   100,000 names (every 16th request also asks the token client), with
   ``runtime.lock.contend`` armed as a delay — once unwitnessed, once with
   the witness installed before anything is built: ``verdict-accounting``,
   ``no-stranded-futures``, ``pipeline-drained`` and ``no-order-violations``
   green, no dynamic edge the port's ``lock_order.json`` lacks, B1, B2 and
   B4 launched; ms a tick and decisions/s of both runs and
   ``sentinel_lock_wait_ms``.  (c) The trace CLI on the card: a
   self-capture ``--summary`` with all six ``tick.*`` stages (B1 and B2
   launched), ``explain``, ``--profile 250``, ``--merge`` of a token
   client's and a token server's dumps (every RPC span linked) and
   ``--postmortem`` of the bundle a deliberately red invariant triggered
   (``[chaos]`` lines).

16. The sharded engine (``spmd_phase``; ``parallel/spmd.py``), phase 4's
   traffic: ``platform_config()`` at the default widths, build_rules'
   4,000 flow and 1,000 degrade rules, SPMD_TICKS ticks of B = 2,048
   Zipf(1.1) over 100,000 names.  (a) World size 1 over NCCL: the
   sharded ticks under ``set_sync_debug_mode("error")`` equal
   ``make_tick``'s tick for tick (the wire) and in state; B1-B4 launches,
   the collectives' count, bytes and ms a tick.  (b) 2 and 4 ranks on the
   one card over gloo (NCCL refuses two ranks on one device; gloo stages
   CUDA tensors through the host, so these runs are exempt from the sync
   check): every tick's wire equal to (a)'s single-device tick and the
   gathered state equal, once with the kernels and once with their plain
   versions installed on every rank, and at 4 ranks phase 4's sketch
   build (SALSA, width-sharded) against its single-device run; ms a tick,
   collectives and their bytes and ms, state bytes a rank against the
   whole, each rank's memory_allocated and B1 / B2 launches.  (c) The
   tier-4 analyzer's 8 ranks on the card (``--device cuda``, gloo): their
   recorded ledger equals the CPU ranks' (as ``analysis/spmd/collectives.json``
   pins it), ``run_spmd_analysis`` gives zero
   findings; the card's total_memory (``[spmd]`` lines).  Every rank
   group has a deadline and dies with the script (``parallel/launch.py``).

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
the build and phase 10 (``overload_main``), ``python3 chip_smoke.py
--workload`` the build and phase 11 (``workload_main``), ``python3
chip_smoke.py --doors`` the build and phase 12 (``doors_main``), ``python3
chip_smoke.py --operator`` the build and phase 13 (``operator_main``),
``python3 chip_smoke.py --shards`` the build and phase 14 (``shards_main``),
``python3 chip_smoke.py --chaos`` the build and phase 15 (``chaos_main``),
``python3 chip_smoke.py --spmd`` the build and phase 16 (``spmd_main``).
``python3 chip_smoke.py --profile-probe [N]`` counts the device records
that profiler sessions over one replayed tick lose, with and without the
wait each session here starts with (``profile_probe_main``).

The last lines: the run's fuller numbers, every kernel shape included
(``[report] {...}``), the kernels' JSON record, the card's name and power
limit (nvidia-smi), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import inspect
import json
import os
import socket
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
#: entries per threaded main-path run (host-bound at ~100 a second: the
#: four runs are most of phase 3's time)
MAIN_ENTRIES = 2_000
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


#: the environment variable that names a child's parent (child_env): a
#: child dies with the process that started it (die_with_parent)
PARENT_PID_ENV = "CHIP_SMOKE_PARENT_PID"


def child_env(cpu: bool = True) -> dict:
    """The environment of a process this script starts: the CPU alone
    unless ``cpu`` is false, and this process's pid, so that the child ends
    when this process does, however it ends (``die_with_parent``)."""
    env = dict(os.environ, **{PARENT_PID_ENV: str(os.getpid())})
    if cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def die_with_parent() -> None:
    """In a process ``child_env`` started: have the kernel send it SIGKILL
    when its parent ends, however the parent ends, and end it now if the
    parent is already gone (``parallel/launch.die_with_parent``)."""
    parent = os.environ.get(PARENT_PID_ENV)
    if not parent:
        return
    sys.path.insert(0, ROOT)
    from sentinel_tpu_torch.parallel.launch import die_with_parent as die_with

    die_with(int(parent))


def live_children() -> list:
    """This process's child processes that still run (zombies left out),
    read from /proc: [(pid, command)]."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue  # ended while listed
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == me and state != "Z":
            out.append((int(d), stat[stat.index("(") + 1:stat.rindex(")")]))
    return out


def check(ok, what) -> None:
    """A phase's pass/fail condition (raises; not an ``assert``, which
    ``python -O`` would strip)."""
    if not ok:
        raise AssertionError(what)


# -- the collector ------------------------------------------------------------

#: every full (generation 2) collection while the script runs:
#: [perf_counter at its start, ms it held every thread]
GC_FULL = []
_gc_started = [0.0]


def _gc_watch(phase, info) -> None:
    if info["generation"] != 2:
        return
    if phase == "start":
        _gc_started[0] = time.perf_counter()
    else:
        GC_FULL.append([_gc_started[0], (time.perf_counter() - _gc_started[0]) * 1e3])


def gc_pauses_since(t0: float, least_ms: float = 0.0) -> list:
    """The full collections that started at or after ``t0``: [(s after
    ``t0``, ms)], those of at least ``least_ms``."""
    return [(round(t - t0, 3), round(ms, 3)) for t, ms in GC_FULL if t >= t0 and ms >= least_ms]


def settle_heap() -> dict:
    """What a process of its own would start the next run with: collect
    what the runs before left, over the whole heap (the ms is what a full
    collection in the next run would hold every thread for), then freeze
    what survives, so that the next run's collections traverse only the
    objects it makes.  One script drives every phase in one process, and a
    full collection over all of their objects stops the serving threads
    for as long as it walks them."""
    import gc

    gc.unfreeze()
    t = time.perf_counter()
    gc.collect()
    ms = (time.perf_counter() - t) * 1e3
    gc.freeze()
    return {"collect_ms": ms, "frozen_objects": gc.get_freeze_count()}


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
            settle_profiler(torch)
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
            settle_profiler(torch)
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
            settle_profiler(torch)
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


def cluster_rules(np, st, C, threshold_type=None):
    """1,000 cluster flow rules (``cres-<i>``, flow id i + 1, half GLOBAL,
    half AVG_LOCAL — or all of ``threshold_type`` — counts 5..59 from the
    seed) and 32 cluster param rules on the 32 hottest (flow id 10,001 + i,
    2..5 a value a second)."""
    rng = np.random.default_rng(SEED + 81)
    flow = [st.FlowRule(resource=f"cres-{i}", count=int(rng.integers(5, 60)), cluster_mode=True,
                        cluster_flow_id=i + 1,
                        cluster_threshold_type=threshold_type if threshold_type is not None
                        else C.FLOW_THRESHOLD_GLOBAL if i % 2 else C.FLOW_THRESHOLD_AVG_LOCAL)
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
    (it comes back).  The heap is settled (settle_heap) between the set-up
    and the traffic, and the run's full collections are reported.
    ``request_timeout_ms``: the token client's timeout (None: the default,
    200 ms; see CLUSTER_REQUEST_TIMEOUT_MS)."""
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

            def cap_tick(acq, comp, now_ms, blocks=(), fronts=()):
                p = real_tick(acq, comp, now_ms, blocks=blocks, fronts=fronts)
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

        out["heap"] = settle_heap()  # the three clients' set-up, as a server freezes its start-up heap
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
        out["full_collections"] = gc_pauses_since(t_start[0])
        check(not failed, ("cluster: token calls failed (call, s into the run, ms)", failed[:20], statuses,
                           "slowest calls (ms, call, s into the run)", slow,
                           "full collections (s into the run, ms)", out["full_collections"]))
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
            # the card's activity alone: the decision client's tick thread
            # launches while the session runs (see device_profile)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                settle_profiler(torch)
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
            f"{json.dumps(r['kernel_launches_run'])}; the set-up's heap {r['heap']['frozen_objects']} objects "
            f"({r['heap']['collect_ms']:.1f} ms a full collection), full collections in the run (s into it, ms) "
            f"{json.dumps(r['full_collections'])}")
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
#: passes the request threads make before phase 9 reads under traffic
CONTROL_WARM_PASSES = 500


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
    pass0 = folded_verdicts()["pass"]
    threads = start_traffic(SEED + 900)
    time.sleep(2.0)
    # the reads below want the traffic in their windows, and an entry on
    # res-0 from origin "bad" (1 in 20 of the hottest names' entries): on a
    # slow host the request threads take longer than 2 s to get there
    t_warm = time.perf_counter()
    while (folded_verdicts()["pass"] - pass0 < CONTROL_WARM_PASSES
           or client.registry.origin_row_if_exists("res-0", "bad") is None) and time.perf_counter() < t_warm + 60:
        time.sleep(0.05)
    rep["traffic_warm_s"] = 2.0 + time.perf_counter() - t_warm
    warm_passes = folded_verdicts()["pass"] - pass0
    # -- the command center under traffic: each command's round trips
    http = {}
    commands = [("clusterNode", CONTROL_HEAVY_REPS), ("jsonTree", CONTROL_HEAVY_REPS),
                ("origin?id=res-0", CONTROL_LIGHT_REPS), ("topParams?id=res-0&n=16", CONTROL_LIGHT_REPS),
                ("rtQuantiles", CONTROL_LIGHT_REPS), ("systemStatus", CONTROL_LIGHT_REPS),
                ("getRules?type=flow", CONTROL_HEAVY_REPS)]
    bodies, node_passes = {}, []
    for cmd, reps in commands:
        ms = []
        for _ in range(reps):
            t, status, body = http_call(f"{base}/{cmd}")
            check(status == 200, f"control: {cmd} answered HTTP {status}: {body[:200]!r}")
            ms.append(t)
            if cmd == "clusterNode":
                # each read's windowed passes: a window of the traffic's, whichever read it is
                node_passes.append(sum(n["passQps"] for n in json.loads(body)))
        bodies[cmd] = json.loads(body)
        http[cmd.split("?")[0]] = dict(p50_ms=_pct(ms, 0.5), p99_ms=_pct(ms, 0.99), reps=reps, bytes=len(body))
    n_res = len(client.registry.resources())
    check(len(bodies["clusterNode"]) == n_res >= N_NAMES, f"clusterNode listed {len(bodies['clusterNode'])} of "
          f"{n_res} resources")
    check(len(bodies["getRules?type=flow"]) == len(flow), "getRules did not list the flow rules")
    check(any(p > 0 for p in node_passes), f"clusterNode: no resource passed in any of its reads ({node_passes} "
          f"passQps summed a read)")
    check(bodies["origin?id=res-0"] and bodies["topParams?id=res-0&n=16"], f"origin / topParams answered nothing "
          f"({warm_passes:g} passes in the first {rep['traffic_warm_s']:.1f} s of traffic)")
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
        env = child_env(cpu=d == "cpu")
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


# -- phase 11: the operations plane -----------------------------------------------------

#: steps of phase 11a's flash crowd (bench.py:1859's shape and seed), cut
#: from bench.py's 300: at 300 the CPU side took 136.9 s for its static and
#: tuned runs (NVIDIA H100 80GB HBM3 machine, 700 W); the tuner converges by
#: step ~95 (15 steps to measure op0, 20 a candidate)
WORKLOAD_STEPS = 120
WORKLOAD_STEPS_UNCUT = 300
#: request threads and seconds of each stage of phase 11b's live swap
SWAP_THREADS = 8
SWAP_STAGE_S = 1.5


def kernel_sets(FU, SC):
    """(real, plain, install): the kernels' wrappers, their plain versions,
    and a function that installs either set where the engine calls them."""
    real = {"scatter_many": FU.scatter_many, "gather_many": FU.gather_many,
            "seg_excl_cumsum": SC.seg_excl_cumsum, "seg_excl_cumsum_many": SC.seg_excl_cumsum_many,
            "seg_incl_min": SC.seg_incl_min}
    plain = {"scatter_many": FU.scatter_many_plain, "gather_many": FU.gather_many_plain,
             "seg_excl_cumsum": SC.seg_excl_cumsum_plain, "seg_excl_cumsum_many": SC.seg_excl_cumsum_many_plain,
             "seg_incl_min": SC.seg_incl_min_plain}
    mods = {"scatter_many": FU, "gather_many": FU, "seg_excl_cumsum": SC, "seg_excl_cumsum_many": SC,
            "seg_incl_min": SC}

    def install(fns):
        for k, fn in fns.items():
            setattr(mods[k], k, fn)

    return real, plain, install


def capture_client_tick(E, nth: int, only=None) -> tuple:
    """Keep a copy of the inputs (state, rules, batches, clock, route hint,
    config, features) of the ``nth`` engine tick from now on — whichever
    tick binding runs it (a resize or a swap rebinds the client's) — and
    return (the copy, a function that stops watching).  The watch goes
    as soon as it has its copy.  ``only``: a predicate a tick must meet to
    be counted (another client's ticks pass through uncounted)."""
    real_tick = E.tick
    box = {}
    n = [0]

    def rec(state, rules, acq, comp, now_ms, sys_load, sys_cpu, cfg, features, seg_fits=None):
        counted = only is None or only()
        if counted:
            n[0] += 1
        if counted and n[0] == nth and not box:
            box.update(state=E.clone_state(state), rules=rules, acq=E.clone_state(acq), comp=E.clone_state(comp),
                       now=now_ms, load=sys_load, cpu=sys_cpu, fits=seg_fits, cfg=cfg, feats=features)
            E.tick = real_tick
        return real_tick(state, rules, acq, comp, now_ms, sys_load, sys_cpu, cfg, features, seg_fits)

    E.tick = rec
    return box, lambda: setattr(E, "tick", real_tick)


#: seconds a profiler session waits, the card idle, before the work it
#: records: the device work of the first moments of a session can go
#: unrecorded (a replayed tick's first kernels, B4's among them; measured
#: by ``--profile-probe``), so every CUDA session here starts with this wait
PROFILE_SETTLE_S = 0.02


def settle_profiler(torch) -> None:
    """Inside a profiler session, before its work: the card idle for
    ``PROFILE_SETTLE_S`` (see there)."""
    torch.cuda.synchronize()
    time.sleep(PROFILE_SETTLE_S)


def device_profile(torch, fn, cpu=True) -> tuple:
    """(device busy us, kernel launches by name) of one call, from
    torch.profiler (``cpu=False``: the card's activity alone, which slows
    the host's threads less; a short call that another thread's ticks
    serve takes it: a session recording the host's operations while a
    client's tick thread ran them once died of a segmentation fault in no
    Python thread, and a 10 s session of ~45,500 device events that a tick
    thread launched did so too, so no long call of that kind is profiled);
    a session that records no device activity is taken again (twice at
    most)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            settle_profiler(torch)
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if dev:
            break
    check(dev, "the profiler recorded no device activity in 3 sessions")
    names = {}
    for e in dev:
        names[e.name] = names.get(e.name, 0) + 1
    return sum(e.time_range.elapsed_us() for e in dev), names


#: profiler kernel-name fragments of B1-B4 (csrc/fused.cu, csrc/segscan.cu)
PROFILE_NAMES = {"scatter_many": "scatter_many", "gather_many": "gather_many", "seg_excl_cumsum": "seg_sum",
                 "seg_incl_min": "seg_min"}


def replay_against_plain(np, E, S, FU, SC, torch, box, want, label) -> dict:
    """Phase 4's check on a tick the client ran: its captured inputs run
    again with the kernels (profiled: each kernel of ``want`` must show by
    name) and with their plain versions; wire bytes and integer state
    leaves equal, float leaves within 1e-6 / 1e-4."""
    check(box, f"phase {label}: no tick was captured")
    real, plain, install = kernel_sets(FU, SC)
    tick = E.make_tick(box["cfg"], box["feats"])

    def run():
        st, out = tick(E.clone_state(box["state"]), box["rules"], box["acq"], box["comp"], box["now"], box["load"],
                       box["cpu"], seg_fits=box["fits"])
        return st, out.wire.cpu().numpy().tobytes()

    got = {}
    # the profiler drops some sessions' device records (PERF.md §7; each
    # session waits in settle_profiler first, which spares the tick's first
    # kernels): a session that shows a wanted kernel by none of its records
    # is taken again, three sessions at most, each a run of the same tick
    for sessions in range(1, 4):
        busy, names = device_profile(torch, lambda: got.update(k=run()))
        seen = {k: sum(n for nm, n in names.items() if PROFILE_NAMES[k] in nm) for k in want}
        if all(seen.values()):
            break
    install(plain)
    try:
        st_p, wire_p = run()
    finally:
        install(real)
    st_k, wire_k = got["k"]
    check(wire_k == wire_p, f"phase {label}: the captured tick's wire differs from its plain-version tick")
    la, lb = S.leaves(st_k), S.leaves(st_p)
    fdiff = 0.0
    for k in la:
        if la[k].dtype.is_floating_point:
            d = (la[k] - lb[k]).abs()
            check(bool(torch.all(d <= 1e-4 + 1e-6 * lb[k].abs())), f"phase {label}: float leaf {k} differs")
            fdiff = max(fdiff, float(d.max()) if d.numel() else 0.0)
        else:
            check(torch.equal(la[k], lb[k]), f"phase {label}: integer state leaf {k} differs")
    for k in want:
        # the names first: the facts stay at the end of a cut error log
        check(seen[k] > 0, f"phase {label}: device records by name {names}; {sessions} profiles of the captured "
                           f"tick show no {k} kernel ({sum(names.values())} device records, {seen} of {want})")
    return dict(profile_kernels=seen, profile_sessions=sessions, device_busy_us=busy, float_state_max_diff=fdiff,
                batch=int(box["acq"].res.shape[0]), now_ms=int(box["now"]))


def loop_client(st, device, cfg, app):
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    c = SentinelClient(cfg=cfg, device=device, mode="sync", time_source=VirtualTimeSource(start_ms=1_000),
                       app_name=app)
    c.flow_rules.load([st.FlowRule(resource=f"wl/key{k}", count=150.0) for k in range(16)])
    c.start()
    return c


def closed_loop_runs(np, st, device, steps: int, labels, on_client=None) -> dict:
    """Phase 11a's runs on ``device``: ``run_closed_loop`` on a sync client
    on virtual time under ``platform_config()`` at the default widths,
    flash_crowd_2x(seed=7), op0 = the config's point (batch 2,048), the
    candidates batch 512 and 256 (both batch fields), each also with
    pipeline_depth=2; one run a label in ``labels`` ("static", or a tuned
    one), each on a fresh client.  ``on_client(label, client)`` runs
    before each loop."""
    from sentinel_tpu_torch import workload as WL
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.obs import profile as PROF

    spec = WL.flash_crowd_2x(seed=7, steps=steps)
    out = {}
    for label in labels:
        c = loop_client(st, device, platform_config(), f"workload-{label}")
        op0 = WL.OperatingPoint.from_engine_config(c.cfg)
        cands = []
        for b in (512, 256):
            p = op0.replace(batch_size=b, complete_batch_size=b)
            cands += [p, p.replace(pipeline_depth=2)]
        if on_client is not None:
            on_client(label, c)
        surprise0 = PROF.RETRACE.surprise_count()
        t = time.perf_counter()
        tune = label != "static"
        r = WL.run_closed_loop(c, spec, op0, candidates=cands if tune else (), tune=tune)
        wall = time.perf_counter() - t
        out[label] = dict(counts=[r.submitted, r.passed, r.blocked], latencies=r.latencies_ms, decisions=r.decisions,
                          converged=r.converged_op.describe(), bad_frac=r.bad_frac(), p99_ms=r.p99_ms(),
                          surprises=PROF.RETRACE.surprise_count() - surprise0, wall_s=wall,
                          ticks=c._build_ticks, swap_lock_ms=c.swap_lock_ms, swap_lock_wait_ms=c.swap_lock_wait_ms)
        c.stop()
    return out


def workload_loop_main(device: str, steps: str, label: str) -> int:
    """``python3 chip_smoke.py --workload-loop DEVICE STEPS LABEL`` (phase
    11a): one closed-loop run (``static`` or ``tuned0``) on ``device`` in a
    process of its own (the CPU side the card's journal is held against);
    one JSON line."""
    import numpy as np
    import torch

    if device == "cpu":
        torch.set_num_threads(3)
    sys.path.insert(0, ROOT)
    import sentinel_tpu_torch as st

    t = time.perf_counter()
    out = closed_loop_runs(np, st, device, int(steps), [label])
    print(json.dumps(dict(runs=out, wall_s=time.perf_counter() - t)), flush=True)
    return 0


def loop_view(run) -> dict:
    """What two runs of the closed loop must agree on."""
    return {k: run[k] for k in ("counts", "latencies", "decisions", "converged")}


def swap_under_traffic(np, st, torch, FU, SC) -> tuple:
    """Phase 11b: a threaded ``platform_config()`` client with
    pipeline_depth=4 and 8 request threads; ``apply_operating_point``
    moves the batch 2,048 -> 512 -> 2,048, then pipeline_depth 4 -> 0 -> 4,
    with the traffic running.  Returns (report, the live client, and
    ``finish()``, which stops the traffic — it keeps running for 11c and
    11e — and checks that no request failed and every future resolved)."""
    from sentinel_tpu_torch import workload as WL
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.obs import profile as PROF
    from sentinel_tpu_torch.runtime.client import SentinelClient

    c = SentinelClient(cfg=platform_config(), device="cuda", mode="threaded", pipeline_depth=4,
                       entry_timeout_s=20.0, app_name="workload-swap")
    names = [f"api-{i}" for i in range(64)]
    c.flow_rules.load([st.FlowRule(resource=n, count=2_000.0) for n in names])
    c.start()
    stop = threading.Event()
    lock = threading.Lock()
    done = [0]
    errors, outcomes = [], {}

    def worker(k):
        rng = np.random.default_rng(SEED + 300 + k)
        while not stop.is_set():
            try:
                e = c.entry(names[int(rng.integers(0, len(names)))], inbound=True)
                e.exit()
                key = "pass"
            except st.BlockException as exc:
                key = type(exc).__name__
            except Exception as exc:  # a timeout among them: the phase fails on any
                errors.append(repr(exc))
                key = "error"
            with lock:
                done[0] += 1
                outcomes[key] = outcomes.get(key, 0) + 1

    threads = [threading.Thread(target=worker, args=(k,), daemon=True) for k in range(SWAP_THREADS)]
    surprise0 = PROF.RETRACE.surprise_count()
    for t_ in threads:
        t_.start()
    time.sleep(0.5)  # the threads reach steady state
    op = WL.OperatingPoint.from_engine_config(c.cfg, pipeline_depth=4)
    moves = [("batch 512", op.replace(batch_size=512, complete_batch_size=512)), ("batch 2048", op),
             ("depth 0", op.replace(pipeline_depth=0)), ("depth 4", op)]
    rates, swaps = [], []

    def window(label, secs):
        n0, t0 = done[0], time.perf_counter()
        time.sleep(secs)
        rates.append((label, (done[0] - n0) / (time.perf_counter() - t0)))

    window("before", SWAP_STAGE_S)
    for label, p in moves:
        n0, t0 = done[0], time.perf_counter()
        applied = c.apply_operating_point(p, cause="chip-smoke-swap")
        dt = time.perf_counter() - t0
        swaps.append(dict(move=label, applied=applied, swap_ms=dt * 1e3, lock_ms=c.swap_lock_ms if applied["engine"]
                          else 0.0, lock_wait_ms=c.swap_lock_wait_ms if applied["engine"] else 0.0,
                          batch=c.cfg.batch_size, depth=c._pipeline_depth))
        rates.append((f"during {label}", (done[0] - n0) / max(dt, 1e-9)))
        window(f"after {label}", SWAP_STAGE_S / 2)
    check(c.cfg.batch_size == op.batch_size and c._pipeline_depth == 4, "phase 11b: the client did not come back")
    check(PROF.RETRACE.surprise_count() == surprise0, "phase 11b: a swap made a surprise retrace")
    rep = dict(outcomes=outcomes, rates=rates, swaps=swaps)

    def finish():
        stop.set()
        for t_ in threads:
            t_.join(timeout=30)
        check(not any(t_.is_alive() for t_ in threads), "phase 11b: a request thread never returned")
        check(not errors, f"phase 11b: request errors (timeouts among them): {errors[:3]}")
        f = c.submit_acquire(names[0])
        check(f is not None and f.result(timeout=10)[0] in (0, 1), "phase 11b: serving after the swaps")
        rep["entries"] = done[0]

    return rep, c, finish


def memory_report(PROF, client, label) -> dict:
    rec = PROF.LEDGER.reconcile(client.device)
    mine = {k: v for k, v in rec["entries"].items() if f"/{client._ledger_name}:" in k}
    pools = {}
    for k, v in mine.items():
        p = k.split("/", 1)[0]
        pools[p] = pools.get(p, 0) + v
    return dict(client_pools=pools, pools=rec["pools"], total_bytes=rec["total_bytes"],
                live_array_bytes=rec["live_array_bytes"], unaccounted_bytes=rec["unaccounted_bytes"],
                device_memory_stats={k: v for k, v in (rec["device_memory_stats"] or {}).items()
                                     if k.startswith(("allocated_bytes.all.current", "reserved_bytes.all.current",
                                                      "allocated_bytes.all.peak", "reserved_bytes.all.peak"))},
                label=label)


def command_plane(np, torch, client, slo_eng, clock) -> dict:
    """Phase 11e, with 11b's traffic running: api/memory, api/profile?ms=250
    (ok, then rate_limited), metrics?fleet=1 with the center's own URL as a
    fleet target (the duplicate dropped), through the HTTP command center;
    then ``slo_eng`` (default_slos(), anchored at the phase's start on
    ``clock``) judges the registry's deltas over the phase."""
    from sentinel_tpu_torch import transport as TT
    from sentinel_tpu_torch.obs import fleet as FLT
    from sentinel_tpu_torch.obs import profile as PROF

    center = TT.start_command_center(client, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{center.port}"
    FLT.add_fleet_target(f"127.0.0.1:{center.port}")
    out = {}
    try:
        ms = []
        for _ in range(5):
            t, status, body = http_call(base + "/api/memory")
            check(status == 200, f"phase 11e: api/memory answered {status}: {body[:200]}")
            ms.append(t)
        mem = json.loads(body)
        check(mem["live_array_bytes"] and mem["pools"], "phase 11e: api/memory read no allocator on the card")
        out["api/memory"] = dict(p50_ms=float(np.median(ms)), live_array_bytes=mem["live_array_bytes"])
        PROF._LAST_CAPTURE[0] = 0.0
        t1, s1, b1 = http_call(base + "/api/profile?ms=250")
        t2, s2, b2 = http_call(base + "/api/profile?ms=250")
        p1, p2 = json.loads(b1), json.loads(b2)
        check(s1 == 200 and "chrome_trace" in p1, f"phase 11e: api/profile did not capture: {b1[:200]}")
        check(s2 == 200 and p2.get("error") == "rate_limited", f"phase 11e: the second capture was not "
                                                               f"rate-limited: {b2[:200]}")
        out["api/profile"] = dict(p50_ms=float(np.median([t1, t2])), ok_ms=t1, rate_limited_ms=t2,
                                  spans=p1["span_count"])
        ms = []
        for _ in range(5):
            t, status, body = http_call(base + "/metrics?fleet=1")
            check(status == 200, f"phase 11e: metrics?fleet=1 answered {status}")
            ms.append(t)
        text = body.decode()
        lines = text.strip().split("\n")
        pat = __import__("re").compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9][0-9a-zA-Z+.e-]*$")
        bad = [ln for ln in lines if not (ln.startswith(("# HELP ", "# TYPE ", "# EXEMPLAR ")) or pat.match(ln))]
        check(not bad, f"phase 11e: the fleet exposition is malformed: {bad[:3]}")
        check("sentinel_fleet_members 1" in lines and "sentinel_fleet_scrape_duplicates 1" in lines,
              "phase 11e: the self-scrape was not dropped as a duplicate")
        out["metrics?fleet=1"] = dict(p50_ms=float(np.median(ms)), lines=len(lines), bytes=len(body))
    finally:
        FLT.set_fleet_targets([])
        center.stop()
    out["slo"] = {s.name: s.to_dict() for s in slo_eng.step(clock.now_ms())}
    return out


def audit_run(np, st, torch, FU, SC, E, S, PS) -> tuple:
    """Phase 11d: bench.py's build (``sketch_cfg``) in a sync client with
    sketch_audit_k=8, sketch_audit_period=16, its exact rules loaded by
    name, 48 ticks of phase 4's sketch stream at B = 2,048 (13 ticks,
    repeated) with their completions, 137 virtual ms apart; every tick
    but the audit's under the sync-debug mode "error"; one audit iteration
    and the one after it profiled (device us).  Returns (report, the
    client)."""
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.obs.registry import REGISTRY
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    def counter(name):
        m = REGISTRY.get(name)
        return 0 if m is None else m.value

    names = ("sentinel_sketch_audit_checks_total", "sentinel_sketch_underestimates_total",
             "sentinel_sketch_eps_violations_total", "sentinel_sketch_audit_failures_total")
    c0 = {n: counter(n) for n in names}
    cfg = sketch_cfg(platform_config)
    c = SentinelClient(cfg=cfg, device="cuda", mode="sync", time_source=VirtualTimeSource(start_ms=1_000),
                       sketch_audit_k=8, sketch_audit_period=16, app_name="workload-audit")
    for i in range(N_RULED):
        c.registry.resource_id(f"res-{i + 1}")
    flow, degrade, authority, system, param = sketch_rules(st, with_tail_names=False)
    c.flow_rules.load(flow)
    c.degrade_rules.load(degrade)
    c.start()
    origin = (c.registry.origin_node_row("res-1", "peer-app"), c.registry.origin_id("peer-app"))
    cols, _peak = sketch_columns(np, PS, 13, 2048, SEED + 9, cfg.node_rows, cfg.trash_row, *origin)
    au = c._audit
    box, unwatch = capture_client_tick(E, 20)
    host = {"audit": [], "plain": []}
    dev = {}
    FU.reset_launches()
    SC.reset_launches()
    for i in range(48):
        a, cc = cols[i % len(cols)]
        # an iteration runs two ticks (the acquires', then the exits'); the
        # audit reads the card on the tick where its count hits the period
        auditing = any((au._ticks + j) % au.period == 0 for j in (1, 2))

        def one():
            if not auditing:
                torch.cuda.set_sync_debug_mode("error")
            try:
                c.check_batch_ids(a["res"], origin_node=a["origin_node"], origin_id=a["origin_id"],
                                  param_hash=a["param_hash"], inbound=a["inbound"])
                c.submit_completion_block(cc["res"], cc["rt"], inbound=cc["inbound"], param_hash=cc["param_hash"])
            finally:
                torch.cuda.set_sync_debug_mode("default")

        kind = "audit" if auditing else "plain"
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i >= 16 and kind not in dev and (kind == "audit" or "audit" in dev):
            dev[kind] = device_profile(torch, one)[0]  # the first audit iteration after the first, then the next
        else:
            one()
            host[kind].append((time.perf_counter() - t) * 1e3)
        c.time.advance(137)
    unwatch()
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    d = {n.split("_", 2)[2]: counter(n) - c0[n] for n in names}
    check(d["audit_checks_total"] > 0, "phase 11d: the audit made no check")
    check(d["underestimates_total"] == 0 and d["eps_violations_total"] == 0 and d["audit_failures_total"] == 0,
          f"phase 11d: the audit found {d}")
    for k in ("scatter_many", "seg_excl_cumsum", "seg_incl_min"):
        check(launches.get(k, 0) > 0, f"phase 11d: the audit run launched no {k}: {launches}")
    replay = replay_against_plain(np, E, S, FU, SC, torch, box, ("scatter_many", "seg_excl_cumsum", "seg_incl_min"),
                                  "11d")
    check(set(dev) == {"audit", "plain"}, f"phase 11d: no audit iteration and no other was profiled: {dev}")
    return dict(counters=d, launches=launches, tracked=sorted(au._tracked), last_audit=dict(au._last_audit),
                host_ms={k: float(np.median(v)) for k, v in host.items()}, audit_ticks=len(host["audit"]),
                device_us=dev, replay=replay), c


def workload_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 11: the operations plane on the card — (a) the autotuner's
    closed loop at full width, replayed, and held against the same loop on
    the CPU in a process of its own; (b) a live swap under traffic; (c) the
    memory ledger against the card's allocator; (d) the sketch audit on
    bench.py's build; (e) the command plane and the SLO judgement."""
    from sentinel_tpu_torch import workload as WL
    from sentinel_tpu_torch.obs import profile as PROF
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.sketch import salsa as SA

    from sentinel_tpu_torch.obs import slo as SLO
    from sentinel_tpu_torch.utils.time_source import TimeSource

    t_phase = time.perf_counter()
    clock = TimeSource()
    slo_eng = SLO.SloEngine()  # default_slos() over the process registry, anchored before any traffic
    slo_eng.step(clock.now_ms())
    env = child_env()
    cpu_procs = {label: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--workload-loop", "cpu",
                                          str(WORKLOAD_STEPS), label], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True) for label in ("static", "tuned0")}
    rep = {"card": smi, "steps": WORKLOAD_STEPS}
    log(f"[workload] {smi}: 11a steps cut from bench.py's {WORKLOAD_STEPS_UNCUT} to {WORKLOAD_STEPS} on both sides "
        f"(the CPU side's two runs took 136.9 s at {WORKLOAD_STEPS_UNCUT}); the CPU runs are two processes of their "
        f"own, beside the card's work")
    try:
        # -- (a) the closed loop on the card, counts from zero ----------------------
        boxes = {}

        def on_client(label, c):
            if label == "tuned0":
                boxes[label], unwatch[0] = capture_client_tick(E, 12)
            if label == "static":
                FU.reset_launches()
                SC.reset_launches()

        unwatch = [lambda: None]
        try:
            runs = closed_loop_runs(np, st, "cuda", WORKLOAD_STEPS, ["static", "tuned0", "tuned1"], on_client)
        finally:
            unwatch[0]()
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        loop_log(smi, WORKLOAD_STEPS, runs)
        for k in ("scatter_many", "gather_many", "seg_incl_min"):
            check(launches.get(k, 0) > 0, f"phase 11a: the closed loop launched no {k}: {launches}")
        static, tuned = runs["static"], runs["tuned0"]
        for label, r in runs.items():
            n, p, b = r["counts"]
            check(n == p + b > 0, f"phase 11a {label}: submitted {n} != passed {p} + blocked {b}")
            check(len(r["latencies"]) == p, f"phase 11a {label}: {len(r['latencies'])} latencies for {p} admits")
            check(r["surprises"] == 0, f"phase 11a {label}: {r['surprises']} surprise retraces")
        acts = [d["action"] for d in tuned["decisions"]]
        check("applied" in acts, f"phase 11a: the tuner applied no point: {acts}")
        check(acts[-1] in ("converged", "rollback"), f"phase 11a: the tuner ended on {acts[-1]}")
        check(loop_view(runs["tuned1"]) == loop_view(tuned), "phase 11a: the tuned loop did not replay on the card")
        rep["loop"] = {k: {f: v for f, v in r.items() if f != "latencies"} for k, r in runs.items()}
        rep["loop_launches"] = launches
        rep["loop_replay"] = replay_against_plain(np, E, S, FU, SC, torch, boxes.pop("tuned0"),
                                                  ("scatter_many", "gather_many", "seg_incl_min"), "11a")
        torch.cuda.empty_cache()  # the captured full-width state goes

        # -- (b) a live swap under traffic; (c) its ledger; (e) its command plane -----
        rep["swap"], client, finish = swap_under_traffic(np, st, torch, FU, SC)
        rep["memory_serving"] = memory_report(PROF, client, "serving")
        check(rep["memory_serving"]["live_array_bytes"] and rep["memory_serving"]["device_memory_stats"],
              "phase 11c: reconcile() read no allocator statistics on the card")
        check({"windows", "rules", "wire"} <= set(rep["memory_serving"]["client_pools"]),
              f"phase 11c: the serving client's pools {rep['memory_serving']['client_pools']}")
        rep["commands"] = command_plane(np, torch, client, slo_eng, clock)
        finish()
        owner = client._ledger_name
        client.stop()
        left = [k for k in PROF.LEDGER.snapshot()["entries"] if f"/{owner}:" in k]
        check(not left, f"phase 11c: stop() left ledger entries {left}")

        # -- (d) the audit on bench.py's build; (c) the sketch pool, the capacity guard --
        rep["audit"], sk = audit_run(np, st, torch, FU, SC, E, S, PS)
        mem = memory_report(PROF, sk, "sketch")
        want = SA.hbm_bytes(E.sketch_config(sk.cfg))
        got = mem["client_pools"].get("sketch", 0)
        check(abs(got - want) <= 0.1 * want, f"phase 11c: the sketch pool {got} B is not within 10 % of {want} B")
        mem["salsa_hbm_bytes"] = want
        rep["memory_sketch"] = mem
        cap0 = PROF.LEDGER.snapshot()["capacity_bytes"]
        PROF.LEDGER.set_capacity(PROF.LEDGER.total_bytes() + 1)
        from sentinel_tpu_torch.obs.registry import REGISTRY
        from sentinel_tpu_torch.obs.slo import SloEngine

        slo = SloEngine(specs=WL.workload_slos(), registry=REGISTRY)
        try:
            op0 = WL.OperatingPoint.from_engine_config(sk.cfg)
            grown = op0.replace(sketch_sample_count=max(8, op0.sketch_sample_count) * 8)
            tuner = WL.AutoTuner(sk, slo, op0, [grown], seed=3, tcfg=WL.TunerConfig(settle_steps=1, warmup_steps=0))
            tuner.step(sk.time.now_ms())
            acts = [d["action"] for d in tuner.decisions]
            check("rejected_hbm" in acts and sk.cfg.sketch_sample_count == op0.sketch_sample_count,
                  f"phase 11c: a capacity one byte over the total did not reject the grown sketch point: {acts}")
            rep["capacity_guard"] = acts
        finally:
            slo.close()
            PROF.LEDGER.set_capacity(cap0)
            sk.stop()

        t = time.perf_counter()
        cpu = {}
        for label, proc in cpu_procs.items():
            out, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"phase 11a: the CPU loop {label} failed: {err[-2000:]}")
            cpu[label] = json.loads(out.strip().splitlines()[-1])
            check(loop_view(cpu[label]["runs"][label]) == loop_view(runs[label]),
                  f"phase 11a {label}: the card's closed loop differs from the CPU's")
        rep["cpu"] = dict(wall_s=max(v["wall_s"] for v in cpu.values()), wait_s=time.perf_counter() - t,
                          loop_wall_s={k: v["runs"][k]["wall_s"] for k, v in cpu.items()})
    finally:
        slo_eng.close()
        for proc in cpu_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rep["phase_s"] = time.perf_counter() - t_phase
    workload_log(rep)
    return rep


def loop_log(smi, steps, runs) -> None:
    for label, r in runs.items():
        n, p, b = r["counts"]
        log(f"[workload] {smi}: 11a {label}: {steps} steps of flash_crowd_2x(seed=7) at the default widths, "
            f"submitted {n} passed {p} blocked {b}, bad_frac {r['bad_frac']:.4f}, p99 {r['p99_ms']:.2f} ms "
            f"(modeled), converged {r['converged']}, {r['ticks']} ticks in {r['wall_s']:.2f} s "
            f"({r['wall_s'] / max(r['ticks'], 1) * 1e3:.2f} ms a tick), surprise retraces {r['surprises']}")
    log(f"[workload] {smi}: 11a decisions {json.dumps([(d['action'], d['op']) for d in runs['tuned0']['decisions']])}")


def workload_log(rep) -> None:
    smi = rep["card"]
    lp = rep["loop"]
    log(f"[workload] {smi}: 11a the tuned loop replayed on the card, and static and tuned equal the CPU's "
        f"({json.dumps({k: round(v, 1) for k, v in rep['cpu']['loop_wall_s'].items()})} s a run on the CPU, "
        f"{rep['cpu']['wait_s']:.1f} s waited for them at the end) — journal, latencies, counts; the last swap held the engine lock "
        f"{lp['tuned0']['swap_lock_ms']:.2f} ms after waiting {lp['tuned0']['swap_lock_wait_ms']:.2f} ms; launches "
        f"{json.dumps(rep['loop_launches'], sort_keys=True)}; captured tick == its plain-version tick "
        f"({json.dumps(rep['loop_replay'], sort_keys=True)})")
    sw = rep["swap"]
    for s in sw["swaps"]:
        log(f"[workload] {smi}: 11b {s['move']}: {json.dumps(s['applied'])}, {s['swap_ms']:.1f} ms, engine lock held "
            f"{s['lock_ms']:.2f} ms after a wait of {s['lock_wait_ms']:.2f} ms (batch {s['batch']}, depth "
            f"{s['depth']})")
    log(f"[workload] {smi}: 11b decisions/s {json.dumps([(k, round(v, 1)) for k, v in sw['rates']])}; outcomes "
        f"{json.dumps(sw['outcomes'], sort_keys=True)} ({sw['entries']} entries); no timeout, every future resolved, "
        f"no surprise retrace")
    for key in ("memory_serving", "memory_sketch"):
        m = rep[key]
        log(f"[workload] {smi}: 11c {m['label']}: the client's pools {json.dumps(m['client_pools'], sort_keys=True)}; "
            f"all pools {json.dumps(m['pools'], sort_keys=True)}, total {m['total_bytes']} B; allocated "
            f"{m['live_array_bytes']} B (unaccounted {m['unaccounted_bytes']} B); allocator "
            f"{json.dumps(m['device_memory_stats'], sort_keys=True)}"
            + (f"; salsa.hbm_bytes {m['salsa_hbm_bytes']} B" if "salsa_hbm_bytes" in m else ""))
    log(f"[workload] {smi}: 11c stop() dropped the serving client's entries; a capacity one byte over the total: "
        f"{rep['capacity_guard']}")
    a = rep["audit"]
    log(f"[workload] {smi}: 11d audit on bench.py's build: {json.dumps(a['counters'], sort_keys=True)}; "
        f"{a['audit_ticks']} audit ticks, tracked {a['tracked']}, last {json.dumps(a['last_audit'], sort_keys=True)}; "
        f"host ms a tick (median) audit {a['host_ms']['audit']:.2f} / other {a['host_ms']['plain']:.2f}; device us "
        f"audit {a['device_us']['audit']:.1f} / other {a['device_us']['plain']:.1f}; launches "
        f"{json.dumps(a['launches'], sort_keys=True)}; no host sync outside the audit tick; captured tick == its "
        f"plain-version tick ({json.dumps(a['replay'], sort_keys=True)})")
    cm = rep["commands"]
    log(f"[workload] {smi}: 11e p50 ms api/memory {cm['api/memory']['p50_ms']:.2f}, api/profile?ms=250 "
        f"{cm['api/profile']['ok_ms']:.1f} (ok, {cm['api/profile']['spans']} spans) then "
        f"{cm['api/profile']['rate_limited_ms']:.2f} (rate_limited), metrics?fleet=1 "
        f"{cm['metrics?fleet=1']['p50_ms']:.2f} ({cm['metrics?fleet=1']['lines']} lines, the self-scrape dropped)")
    log(f"[workload] {smi}: 11e default_slos(): {json.dumps(cm['slo'], sort_keys=True)}")
    log(f"[workload] {smi}: phase 11 took {rep['phase_s']:.1f} s")


# -- phase 12: the front doors and the adapters ------------------------------------------

#: phase 12a: sockets and frames a socket (one step each: 4,096 frames in
#: all); the threaded half's load threads, burst and seconds, and its
#: entry() threads
DOOR_SOCKETS = 8
DOOR_FRAMES = 512
DOOR_LOAD_THREADS = 8
DOOR_BURST = 64
DOOR_LOAD_S = 8.0
DOOR_ENTRY_THREADS = 2
#: the cluster param rule given no hash lane on purpose (gateway rules take
#: both lanes of its resource first)
UNLANED_FID = 20_001
#: phase 12b: descriptors resolved and decided, in chunks of RLS_CHUNK a tick
RLS_REQUESTS = 10_000
RLS_CHUNK = 500
#: phase 12c: the flash crowd's steps (bench.py's flash_crowd_2x has 240),
#: cut to the phase's time — the threaded drivers', and the sync replay's
#: (held against the CPU, whose full-width ticks take ~0.2-0.5 s) — and the
#: requests each in-process adapter serves
ADAPTER_STEPS = 10
REPLAY_STEPS = 6
ADAPTER_REQUESTS = 32


def door_frames(np, P, C, rng, n, xid0, tokens) -> list:
    """One socket's step: ``n`` frames — flow frames (Zipf(1.1) over the
    1,000 cluster flows, 1 in 5 prioritized, 1-3 units), param frames (the
    32 param flows and the unlaned one, an int or a string value from 64),
    concurrent acquires on the first 16 flows, and releases of the tokens
    the previous step was granted (``tokens``), in a seeded order."""
    w = 1.0 / np.arange(1, CLUSTER_FLOWS + 1) ** 1.1
    w /= w.sum()
    values = [f"user-{i}" for i in range(32)] + list(range(1_000, 1_032))
    out, rel = [], list(tokens)
    for i in range(n):
        u, xid = rng.random(), xid0 + i
        if rel and u < 0.05:
            out.append(P.ClusterRequest(xid=xid, type=C.MSG_TYPE_CONCURRENT_RELEASE, token_id=rel.pop()))
        elif u < 0.10:
            out.append(P.ClusterRequest(xid=xid, type=C.MSG_TYPE_CONCURRENT_ACQUIRE,
                                        flow_id=int(rng.integers(1, 17)), count=1))
        elif u < 0.32:
            fid = UNLANED_FID if rng.random() < 0.05 else 10_001 + int(rng.integers(0, CLUSTER_PARAMS))
            out.append(P.ClusterRequest(xid=xid, type=C.MSG_TYPE_PARAM_FLOW, flow_id=fid, count=1,
                                        params=[values[int(rng.integers(0, len(values)))]]))
        else:
            out.append(P.ClusterRequest(xid=xid, type=C.MSG_TYPE_FLOW, flow_id=int(rng.choice(CLUSTER_FLOWS, p=w)) + 1,
                                        count=int(rng.integers(1, 4)), priority=bool(rng.random() < 0.2)))
    return out


def read_frames(P, sock, n, deadline_s=30.0) -> dict:
    """xid -> (status, wait_ms, token_id) of ``n`` response frames read from
    ``sock`` (every read with a timeout)."""
    import socket

    got, buf = {}, b""
    end = time.perf_counter() + deadline_s
    while len(got) < n and time.perf_counter() < end:
        try:
            chunk = sock.recv(1 << 16)
        except socket.timeout:
            continue
        if not chunk:
            break
        buf += chunk
        while len(buf) >= 2:
            ln = int.from_bytes(buf[:2], "big")
            if len(buf) - 2 < ln:
                break
            r = P.decode_response(buf[2 : 2 + ln])
            got[r.xid] = (r.status, r.wait_ms, r.token_id)
            buf = buf[2 + ln :]
    check(len(got) == n, f"phase 12: {len(got)} of {n} frames answered")
    return got


def door_setup(np, st, device, mode, time_source=None):
    """Phase 12a's setup: a ``platform_config()`` decision client at the
    default widths, a DefaultTokenService deciding on its engine with
    phase 8's rules (1,000 cluster flow rules, 32 cluster param rules),
    two NativeFrontDoors on one port (``reuseport=True``) attached and
    following the service; then one more cluster param rule whose resource
    gateway rules have no lane left for.  Returns (client, service, doors,
    the unenforceable counter's moves: lane-0 rules, the unlaned rule)."""
    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster.front_door import _C_UNENFORCEABLE, NativeFrontDoor
    from sentinel_tpu_torch.cluster.rules import param_resource
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.runtime.client import SentinelClient

    dec = SentinelClient(cfg=platform_config(), device=device, mode=mode, time_source=time_source,
                         tick_interval_ms=1.0, app_name=f"doors-{mode}")
    dec.start()
    svc = DefaultTokenService(dec, use_token_column=False)
    flow, param = cluster_rules(np, st, C)
    svc.flow_rules.load("default", flow)
    doors = [NativeFrontDoor(port=0, reuseport=True)]
    doors.append(NativeFrontDoor(port=doors[0].port, reuseport=True))
    for d in doors:
        d.follow(svc)
        dec.attach_front_door(d)
        d.start()
    u0 = _C_UNENFORCEABLE.value
    svc.param_rules.load("default", param)
    lane0 = _C_UNENFORCEABLE.value - u0
    name = param_resource(UNLANED_FID)
    dec.gateway_param_rules.load([st.ParamFlowRule(resource=name, count=5.0, param_idx=1),
                                  st.ParamFlowRule(resource=name, count=5.0, param_idx=2)])
    u1 = _C_UNENFORCEABLE.value
    svc.param_rules.load("default", param + [st.ParamFlowRule(resource="cres-unlaned", count=3.0, cluster_mode=True,
                                                              cluster_flow_id=UNLANED_FID)])
    return dec, svc, doors, (lane0, _C_UNENFORCEABLE.value - u1)


def door_close(dec, svc, doors, socks=()):
    for s in socks:
        s.close()
    for d in doors:
        d.stop()
    dec.stop()
    for d in doors:
        d.close()
    svc.close()


def door_replay(np, st, device, guard=None) -> dict:
    """Phase 12a's deterministic half on ``device``: a sync decision client
    on virtual time (``door_setup``); each of 8 sockets in turn sends its
    512 frames pipelined, the doors' rings fill, and ONE ``tick_once``
    drains them into a full-shape batch (``guard(True)`` / ``guard(False)``
    around it: the card's sync-debug mode); every response is read back,
    the virtual clock moves 137 ms.  Then phase 12b's RLS stream on the
    same client.  Returns the responses, the counter's moves, the doors'
    items a tick, and the stream's codes."""
    import socket

    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster import protocol as P
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    dec, svc, doors, unenf = door_setup(np, st, device, "sync", time_source=VirtualTimeSource(start_ms=1_000))
    socks = [socket.create_connection(("127.0.0.1", doors[0].port), timeout=10) for _ in range(DOOR_SOCKETS)]
    n_front = []  # door items a tick
    real_run = dec._run_tick

    def spy(*a, fronts=(), **kw):
        n_front.append(sum(len(cols[0]) for _d, cols in fronts))
        return real_run(*a, fronts=fronts, **kw)

    try:
        dec._warm_shapes()  # the staging slots exist before the guarded ticks
        dec._run_tick = spy
        rng = np.random.default_rng(SEED + 121)
        responses, tokens, xid = [], [], 1
        for k, s in enumerate(socks):
            frames = door_frames(np, P, C, rng, DOOR_FRAMES, xid, tokens)
            xid += len(frames)
            s.sendall(b"".join(P.encode_request(f) for f in frames))
            # the unlaned rule's frames are answered NO_RULE in C: the rest ring
            n_ring = sum(1 for f in frames if f.flow_id != UNLANED_FID)
            end = time.perf_counter() + 30
            while sum(d.pending() for d in doors) < n_ring:
                check(time.perf_counter() < end, "phase 12a: the doors' rings never filled")
                time.sleep(0.001)
            if guard is not None:
                guard(True)
            try:
                dec.tick_once(dec.time.now_ms())
            finally:
                if guard is not None:
                    guard(False)
            got = read_frames(P, s, len(frames))
            tokens = [got[f.xid][2] for f in frames
                      if f.type == C.MSG_TYPE_CONCURRENT_ACQUIRE and got[f.xid][0] == C.STATUS_OK]
            responses += [(k, f.xid, f.type) + got[f.xid] for f in frames]
            dec.time.advance(137)
        dec._run_tick = real_run
        rls = rls_stream(np, st, svc, dec)
        return dict(responses=responses, unenforceable=list(unenf), fronts=list(n_front), rls=rls,
                    resolve_failures=dec.wire_decode_failures)
    finally:
        dec._run_tick = real_run
        door_close(dec, svc, doors, socks)


def rls_stream(np, st, svc, dec) -> dict:
    """Phase 12b on a sync decision client: an ``EnvoyRlsRuleManager``
    (rls/rules.py; no protobuf) over the client's token service with 64
    descriptors in domain "mesh" (counts 20-200); 10,000 requests — a
    matched descriptor (Zipf(1.1) over the 64), an unmatched value in
    "mesh", or the unknown domain "edge" — resolved to flow ids on the
    host, and the resolved ones decided through the service's token path,
    ``hits_addend`` 1 for the first half and 3 for the second, in chunks of
    500 a tick, 50 virtual ms apart.  The codes follow the RLS service's
    rule (rls/server.py ``_decide``): no flow id, OK or NO_RULE is OK,
    anything else OVER_LIMIT."""
    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.rls.rules import EnvoyRlsRule, EnvoyRlsRuleManager, RlsKeyValue, RlsResourceDescriptor

    rng = np.random.default_rng(SEED + 122)
    mgr = EnvoyRlsRuleManager(svc)
    counts = rng.integers(20, 201, 64)
    mgr.load([EnvoyRlsRule(domain="mesh", descriptors=[
        RlsResourceDescriptor(key_values=[RlsKeyValue("dest", f"svc-{i}"), RlsKeyValue("route", f"r{i % 4}")],
                              count=float(counts[i])) for i in range(64)])])
    w = 1.0 / np.arange(1, 65) ** 1.1
    w /= w.sum()
    t = time.perf_counter()
    resolved = []
    for _ in range(RLS_REQUESTS):
        u = rng.random()
        if u < 0.8:
            i = int(rng.choice(64, p=w))
            resolved.append(mgr.lookup_flow_id("mesh", [("route", f"r{i % 4}"), ("dest", f"svc-{i}")]))
        elif u < 0.9:
            resolved.append(mgr.lookup_flow_id("mesh", [("dest", "svc-none")]))
        else:
            resolved.append(mgr.lookup_flow_id("edge", [("dest", "svc-0")]))
    resolve_ms = (time.perf_counter() - t) * 1e3
    codes, t = [], time.perf_counter()
    for lo in range(0, RLS_REQUESTS, RLS_CHUNK):
        hits = 1 if lo < RLS_REQUESTS // 2 else 3
        dec.mode = "threaded"  # queue the chunk without ticking
        futs = [None if fid is None else svc.request_token_async(fid, hits, False)
                for fid in resolved[lo : lo + RLS_CHUNK]]
        dec.mode = "sync"
        dec.tick_once(dec.time.now_ms())
        for f in futs:
            r = None if f is None else f.result(timeout=30)
            codes.append("ok" if r is None or r.status in (C.STATUS_OK, C.STATUS_NO_RULE) else "over_limit")
        dec.time.advance(50)
    decide_ms = (time.perf_counter() - t) * 1e3
    return dict(codes=codes, counts={k: codes.count(k) for k in ("ok", "over_limit")},
                unresolved=sum(1 for f in resolved if f is None), resolve_ms=resolve_ms, decide_ms=decide_ms)


def count_frames(sock, n, stamps, deadline_s=30.0) -> None:
    """Read ``n`` response frames from ``sock`` by their length prefixes
    (no decode: the load threads leave the interpreter to the tick loop),
    appending each frame's perf_counter arrival to ``stamps``."""
    import socket

    got, buf = 0, b""
    end = time.perf_counter() + deadline_s
    while got < n and time.perf_counter() < end:
        try:
            chunk = sock.recv(1 << 16)
        except socket.timeout:
            continue
        if not chunk:
            break
        buf += chunk
        now, off = time.perf_counter(), 0
        while len(buf) - off >= 2:
            ln = int.from_bytes(buf[off : off + 2], "big")
            if len(buf) - off - 2 < ln:
                break
            off += 2 + ln
            got += 1
            stamps.append(now)
        buf = buf[off:]
    check(got == n, f"phase 12a: {got} of {n} frames answered")


def door_load(np, st, torch, FU, SC) -> dict:
    """Phase 12a's threaded half: ``door_setup`` on a threaded client with
    the real clock; 8 load threads, each with its own socket, pipelining
    bursts of 64 frames (encoded before the clock starts, answers counted
    by their length prefixes) for 8 s, and 2 threads calling ``entry()`` on
    the flows' own resources beside them.  Over those 8 s: tokens/s, round
    trip p50 / p99 (a frame's answer against its burst's send), ms a tick
    (median and p90 from one dispatch to the next), the doors' share of each
    batch; then, under the same load, a
    CUDA-only profile of half a second: device busy a tick, the card's idle
    share, B1 / B2 / B4 by name."""
    import socket

    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster import protocol as P
    from sentinel_tpu_torch.cluster.rules import flow_resource
    from sentinel_tpu_torch.obs.registry import REGISTRY

    dec, svc, doors, unenf = door_setup(np, st, "cuda", "threaded")
    socks = [socket.create_connection(("127.0.0.1", doors[0].port), timeout=10) for _ in range(DOOR_LOAD_THREADS)]
    shares, real_run = [], dec._run_tick

    stamps_run = []  # each dispatch's perf_counter: dispatch to dispatch is a tick while the loop is busy

    def spy(acq, comp, now_ms, blocks=(), fronts=()):
        stamps_run.append(time.perf_counter())
        n_f = sum(len(cols[0]) for _d, cols in fronts)
        n_a = len(acq) + sum(t for _b, _o, t in blocks)
        if n_f + n_a:
            shares.append(n_f / (n_f + n_a))
        return real_run(acq, comp, now_ms, blocks=blocks, fronts=fronts)

    stop = threading.Event()
    rtts, answered, errors, entries = [], [0], [], [0]
    lock = threading.Lock()
    bursts = []
    for k in range(DOOR_LOAD_THREADS):
        rng = np.random.default_rng(SEED + 130 + k)
        bursts.append([b"".join(P.encode_request(f) for f in door_frames(np, P, C, rng, DOOR_BURST, 1 + j * DOOR_BURST,
                                                                          [])) for j in range(32)])

    def loader(k):
        j = 0
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                socks[k].sendall(bursts[k][j % len(bursts[k])])
                stamps = []
                count_frames(socks[k], DOOR_BURST, stamps)
                j += 1
                with lock:
                    rtts.extend((t - t0) * 1e3 for t in stamps)
                    answered[0] += DOOR_BURST
        except Exception as exc:  # reported by the check below
            errors.append(repr(exc))

    def caller(k):
        rng = np.random.default_rng(SEED + 140 + k)
        while not stop.is_set():
            try:
                dec.entry(flow_resource(int(rng.integers(1, CLUSTER_FLOWS + 1)))).exit()
            except st.BlockException:
                pass
            with lock:
                entries[0] += 1

    fail0 = REGISTRY.get("sentinel_resolve_failures_total").value
    try:
        dec._run_tick = spy
        FU.reset_launches()
        SC.reset_launches()
        threads = [threading.Thread(target=loader, args=(k,), daemon=True) for k in range(DOOR_LOAD_THREADS)]
        threads += [threading.Thread(target=caller, args=(k,), daemon=True) for k in range(DOOR_ENTRY_THREADS)]
        ticks0, t0 = dec._build_ticks, time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(DOOR_LOAD_S)
        # the measured window ends here; the profile after it (its CUPTI
        # callbacks slow every launch) sees the same load
        with lock:
            wall, ticks = time.perf_counter() - t0, dec._build_ticks - ticks0
            frames, rtts_w, gaps = answered[0], list(rtts), np.diff(stamps_run[1:]) * 1e3
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        tk, tw = dec._build_ticks, time.perf_counter()
        busy, names = device_profile(torch, lambda: time.sleep(0.5), cpu=False)
        prof_ticks, prof_wall = dec._build_ticks - tk, (time.perf_counter() - tw) * 1e3
        stop.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        stop.set()
        dec._run_tick = real_run
        door_close(dec, svc, doors, socks)
    check(not errors, f"phase 12a: a load thread failed: {errors[:3]}")
    check(REGISTRY.get("sentinel_resolve_failures_total").value == fail0 and dec.wire_decode_failures == 0,
          "phase 12a: a door tick failed closed under load")
    seen = {k: sum(n for nm, n in names.items() if PROFILE_NAMES[k] in nm)
            for k in ("scatter_many", "gather_many", "seg_incl_min")}
    for k, n in seen.items():
        check(n > 0 and launches.get(k, 0) > 0, f"phase 12a: the threaded doors launched no {k}: {names}")
    return dict(tokens_per_s=frames / wall, frames=frames, entries=entries[0], wall_s=wall,
                rtt_p50_ms=_pct(rtts_w, 0.5), rtt_p99_ms=_pct(rtts_w, 0.99), ticks=ticks,
                ms_a_tick=float(np.median(gaps)), ms_a_tick_p90=float(np.percentile(gaps, 90)),
                door_share_mean=float(np.mean(shares)), door_share_p50=_pct(shares, 0.5), unenforceable=list(unenf),
                profile=dict(ticks=prof_ticks, wall_ms=prof_wall, busy_ms=busy / 1e3,
                             busy_ms_a_tick=busy / 1e3 / max(prof_ticks, 1), idle_share=1 - busy / 1e3 / prof_wall,
                             kernels=seen),
                launches=launches)


class _RecordingGateway:
    """A GatewayAdapter as ``drive_gateway`` sees it, recording each
    request's verdict in order (1 passed, 0 blocked)."""

    def __init__(self, adapter, block_exc):
        self._a, self._exc = adapter, block_exc
        self.client = adapter.client
        self.verdicts = []

    def entries_for(self, route_id, req):
        try:
            entries = self._a.entries_for(route_id, req)
        except self._exc:
            self.verdicts.append(0)
            raise
        self.verdicts.append(1)
        return entries


def adapter_rules(st, c):
    """Phase 12c's rules on ``c``: a GatewayAdapter with route rules on
    ``wl-route`` keyed by the X-Wl-Param header and by the URL param ``p``
    (values starting "attacker": the flood's), an API group over every
    ``/wl`` path keyed by the client IP, and flow rules on the route and on
    the drivers' and the in-process apps' resources.  Returns the
    adapter."""
    from sentinel_tpu_torch.adapters import gateway as GW

    g = GW.GatewayAdapter(c)
    g.apis.load([GW.ApiDefinition("wl-api", [GW.ApiPredicateItem("/wl", GW.URL_MATCH_STRATEGY_PREFIX)])])
    g.rules.load_rules([
        GW.GatewayFlowRule(resource="wl-route", count=2, param_item=GW.GatewayParamFlowItem(
            GW.PARAM_PARSE_STRATEGY_HEADER, field_name="X-Wl-Param", pattern="attacker",
            match_strategy=GW.PARAM_MATCH_STRATEGY_PREFIX)),
        GW.GatewayFlowRule(resource="wl-route", count=1, param_item=GW.GatewayParamFlowItem(
            GW.PARAM_PARSE_STRATEGY_URL_PARAM, field_name="p", pattern="attacker",
            match_strategy=GW.PARAM_MATCH_STRATEGY_PREFIX)),
        GW.GatewayFlowRule(resource="wl-api", count=150, param_item=GW.GatewayParamFlowItem(
            GW.PARAM_PARSE_STRATEGY_CLIENT_IP)),
    ])
    c.flow_rules.load([st.FlowRule(resource="wl-route", count=120), st.FlowRule(resource="wl/key0", count=1),
                       st.FlowRule(resource="GET:/wl/key0", count=1), st.FlowRule(resource="GET:/app/wsgi", count=50),
                       st.FlowRule(resource="GET:/app/asgi", count=50), st.FlowRule(resource="deco", count=50),
                       st.FlowRule(resource="stream", count=50)])
    return g


def adapter_spec(WL, steps=ADAPTER_STEPS):
    """flash_crowd_2x(seed=7) cut to ``steps`` steps, with a hot parameter
    flood so the param-keyed rules see values."""
    base = WL.flash_crowd_2x(seed=7, steps=steps, start_step=steps // 3)
    return WL.WorkloadSpec(seed=base.seed, steps=base.steps, step_ms=base.step_ms, keys=base.keys,
                           shapes=base.shapes + (WL.HotParamFlood(rate=2.0, start_step=5, duration_steps=20),))


def gateway_replay(np, st, device) -> dict:
    """Phase 12c's replay: ``drive_gateway`` over ``adapter_spec`` at
    REPLAY_STEPS through a sync ``platform_config()`` client on virtual
    time at the default widths; its counts and every request's verdict."""
    from sentinel_tpu_torch import workload as WL
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    c = SentinelClient(cfg=platform_config(), device=device, mode="sync", time_source=VirtualTimeSource(start_ms=1_000),
                       app_name="gateway-replay")
    c.start()
    try:
        rec = _RecordingGateway(adapter_rules(st, c), st.BlockException)
        t = time.perf_counter()
        res = WL.drive_gateway(rec, WL.TrafficGenerator(adapter_spec(WL, REPLAY_STEPS)))
        return dict(counts=[res.submitted, res.passed, res.blocked], verdicts=rec.verdicts,
                    wall_s=time.perf_counter() - t)
    finally:
        c.stop()


def adapters_run(np, st, torch, FU, SC) -> dict:
    """Phase 12c on a threaded ``platform_config()`` client at the default
    widths with ``adapter_rules``: bare ``entry()``, a WSGI app and an ASGI
    app called in process, ``@sentinel_resource`` with a fallback and
    ``guard_stream`` over an async generator, ADAPTER_REQUESTS requests
    each; then ``drive_gateway``, ``drive_asgi`` and ``drive_streaming``
    over ``adapter_spec``.  Each adapter's requests/s and the µs it adds a
    request over bare ``entry()``; B1 / B2 / B4 launched over the run and
    by the WSGI requests."""
    import asyncio

    from sentinel_tpu_torch import adapters as AD
    from sentinel_tpu_torch import workload as WL
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.runtime.client import SentinelClient

    c = SentinelClient(cfg=platform_config(), device="cuda", mode="threaded", tick_interval_ms=1.0,
                       app_name="adapters")
    c.start()
    rep = {}
    try:
        g = adapter_rules(st, c)

        def timed(label, one, n=ADAPTER_REQUESTS):
            out = []
            t = time.perf_counter()
            for i in range(n):
                out.append(one(i))
            s = time.perf_counter() - t
            rep[label] = dict(requests=n, per_s=n / s, us_a_request=s / n * 1e6, outcomes={
                str(k): out.count(k) for k in sorted(set(map(str, out)))})
            return out

        def bare(i):
            try:
                c.entry("bare").exit()
                return "pass"
            except st.BlockException:
                return "block"

        def wsgi_app(environ, start_response):
            start_response("200 OK", [("Content-Type", "text/plain")])
            return [b"ok"]

        wsgi = AD.SentinelWSGIMiddleware(wsgi_app, client=c)

        def wsgi_one(i):
            status = {}
            body = wsgi({"REQUEST_METHOD": "GET", "PATH_INFO": "/app/wsgi"}, lambda s, h: status.update(s=s))
            b"".join(body)
            body.close() if hasattr(body, "close") else None
            return status["s"][:3]

        async def asgi_app(scope, receive, send):
            await send({"type": "http.response.start", "status": 200, "headers": []})
            await send({"type": "http.response.body", "body": b"ok"})

        asgi = AD.SentinelASGIMiddleware(asgi_app, client=c)

        async def asgi_many(n):
            out = []
            for _ in range(n):
                sent = []

                async def send(msg):
                    sent.append(msg)

                async def receive():
                    return {"type": "http.request"}

                await asgi({"type": "http", "method": "GET", "path": "/app/asgi", "headers": []}, receive, send)
                out.append(sent[0]["status"])
            return out

        @AD.sentinel_resource("deco", fallback=lambda i, exception=None: "fallback", client=c)
        def deco(i):
            if i % 10 == 9:
                raise ValueError("business error")
            return "pass"

        async def numbers():
            for i in range(2):
                yield i

        async def streams(n):
            out = []
            for _ in range(n):
                try:
                    out.append(len([x async for x in AD.guard_stream("stream", numbers(), client=c)]))
                except st.BlockException:
                    out.append("block")
            return out

        FU.reset_launches()
        SC.reset_launches()
        timed("bare_entry", bare)
        # the WSGI requests' ticks, by the wrappers' counts: no profiler
        # session here, where another thread (the client's tick thread)
        # launches all of its ~45,500 device events (the process died of a
        # segmentation fault in native code inside such a session twice)
        before = dict(FU.LAUNCHES, **SC.LAUNCHES)
        timed("wsgi", wsgi_one)
        rep["wsgi_launches"] = {k: n - before.get(k, 0) for k, n in dict(FU.LAUNCHES, **SC.LAUNCHES).items()}
        t = time.perf_counter()
        got = asyncio.run(asgi_many(ADAPTER_REQUESTS))
        s = time.perf_counter() - t
        rep["asgi"] = dict(requests=len(got), per_s=len(got) / s, us_a_request=s / len(got) * 1e6,
                           outcomes={str(k): got.count(k) for k in set(got)})
        timed("decorator", deco)
        t = time.perf_counter()
        got = asyncio.run(streams(ADAPTER_REQUESTS))
        s = time.perf_counter() - t
        rep["guard_stream"] = dict(requests=len(got), per_s=len(got) / s, us_a_request=s / len(got) * 1e6,
                                   outcomes={str(k): got.count(k) for k in set(got)})
        base_us = rep["bare_entry"]["us_a_request"]
        for k in ("wsgi", "asgi", "decorator", "guard_stream"):
            rep[k]["added_us"] = rep[k]["us_a_request"] - base_us
        # the adapters' own host cost, apart from the tick each request
        # waits for: the same calls with the client switched off (every
        # entry a pass-through, no tick), 500 each
        c.enabled = False
        try:
            host = {}
            for k, one in (("bare_entry", bare), ("wsgi", wsgi_one), ("decorator", deco)):
                t = time.perf_counter()
                for i in range(500):
                    one(i)
                host[k] = (time.perf_counter() - t) / 500 * 1e6
            for k, many in (("asgi", asgi_many), ("guard_stream", streams)):
                t = time.perf_counter()
                asyncio.run(many(500))
                host[k] = (time.perf_counter() - t) / 500 * 1e6
        finally:
            c.enabled = True
        for k in ("wsgi", "asgi", "decorator", "guard_stream"):
            rep[k]["passthrough_us"] = host[k]
            rep[k]["added_passthrough_us"] = host[k] - host["bare_entry"]
        rep["bare_entry"]["passthrough_us"] = host["bare_entry"]
        check(rep["decorator"]["outcomes"].get("fallback", 0) == ADAPTER_REQUESTS // 10,
              f"phase 12c: the decorator's fallbacks {rep['decorator']['outcomes']}")
        drivers = {}
        spec = adapter_spec(WL)
        n_events = len(WL.TrafficGenerator(spec).all_events())
        for label, run in (("drive_gateway", lambda: WL.drive_gateway(g, WL.TrafficGenerator(spec))),
                           ("drive_asgi", lambda: WL.drive_asgi(asgi, WL.TrafficGenerator(spec))),
                           ("drive_streaming", lambda: WL.drive_streaming(c, WL.TrafficGenerator(spec)))):
            t = time.perf_counter()
            res = run()
            s = time.perf_counter() - t
            drivers[label] = dict(counts=[res.submitted, res.passed, res.blocked], per_s=res.submitted / s, wall_s=s)
            check(res.submitted == n_events == res.passed + res.blocked,
                  f"phase 12c {label}: submitted {res.submitted} of {n_events}, passed {res.passed} + blocked "
                  f"{res.blocked}")
            check(res.blocked > 0 and res.passed > 0, f"phase 12c {label}: no rule bound ({res.passed} passed, "
                  f"{res.blocked} blocked)")
        rep["drivers"] = drivers
        rep["launches"] = dict(FU.LAUNCHES, **SC.LAUNCHES)
        for k in ("scatter_many", "gather_many", "seg_incl_min"):
            check(rep["launches"].get(k, 0) > 0 and rep["wsgi_launches"].get(k, 0) > 0,
                  f"phase 12c: the adapters' run launched no {k}: {rep['launches']}, the WSGI requests "
                  f"{rep['wsgi_launches']}")
        for name in ("wl-route", "wl-api", "GET:/app/wsgi", "deco", "stream"):
            s = c.stats.resource(name)
            check(s is not None and s["curThreadNum"] == 0, f"phase 12c: {name} holds {s} (an entry not exited)")
    finally:
        c.stop()
    return rep


def doors_cpu_main(part: str) -> int:
    """``python3 chip_smoke.py --doors-cpu replay|gateway`` (phase 12): the
    deterministic door run with its RLS stream, or the gateway driver's
    sync replay, on the CPU in a process of its own; one JSON line."""
    import numpy as np
    import torch

    torch.set_num_threads(3)
    sys.path.insert(0, ROOT)
    import sentinel_tpu_torch as st

    t = time.perf_counter()
    out = door_replay(np, st, "cpu") if part == "replay" else gateway_replay(np, st, "cpu")
    print(json.dumps(dict(out, wall_s=time.perf_counter() - t)), flush=True)
    return 0


def doors_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 12: the front doors and the adapters on the card — (a) the
    native front door at the default widths: a deterministic replay with
    the kernels, with their plain versions and on the CPU (a process of
    its own), one captured door tick against its plain-version tick, then
    a threaded load; (b) the RLS rule model resolving 10,000 descriptors
    decided through (a)'s token service, against the CPU; (c) the adapters
    and the workload drivers on a threaded client, and the gateway
    driver's sync replay against the CPU."""
    from sentinel_tpu_torch.ops import engine as E

    t_phase = time.perf_counter()
    env = child_env()
    cpu_procs = {part: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--doors-cpu", part], cwd=ROOT,
                                        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for part in ("replay", "gateway")}
    rep = {"card": smi}
    try:
        real, plain, install = kernel_sets(FU, SC)

        def guard(on):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if on else "default")

        # -- (a) + (b): the deterministic door replay, kernels then plain versions ----
        FU.reset_launches()
        SC.reset_launches()
        box, unwatch = capture_client_tick(E, 12)  # a door tick (after the warm-up's two and a rule load's)
        t = time.perf_counter()
        try:
            kern = door_replay(np, st, "cuda", guard=guard)
        finally:
            unwatch()
        rep["replay_s"] = time.perf_counter() - t
        rep["replay_launches"] = dict(FU.LAUNCHES, **SC.LAUNCHES)
        for k in ("scatter_many", "gather_many", "seg_incl_min"):
            check(rep["replay_launches"].get(k, 0) > 0, f"phase 12a: the door replay launched no {k}")
        rep["tick_replay"] = replay_against_plain(np, E, S, FU, SC, torch, box,
                                                  ("scatter_many", "gather_many", "seg_incl_min"), "12a")
        install(plain)
        try:
            pl = door_replay(np, st, "cuda")
        finally:
            install(real)
        check(kern["responses"] == pl["responses"], "phase 12a: the door's responses differ between the kernels and "
              "their plain versions")
        check(kern["rls"]["codes"] == pl["rls"]["codes"], "phase 12b: the RLS codes differ between the kernels and "
              "their plain versions")
        check(kern["unenforceable"][0] == 0 and kern["unenforceable"][1] > 0,
              f"phase 12a: sentinel_front_door_unenforceable_rules moved {kern['unenforceable']} (lane-0 rules, the "
              f"unlaned rule)")
        statuses = {}
        for r in kern["responses"]:
            statuses[r[3]] = statuses.get(r[3], 0) + 1
        rep["replay"] = dict(frames=len(kern["responses"]), statuses=statuses, fronts_a_tick=kern["fronts"],
                             unenforceable=kern["unenforceable"], rls=dict(kern["rls"], codes=None))
        torch.cuda.empty_cache()

        # -- (a): the threaded half -------------------------------------------------
        rep["load"] = door_load(np, st, torch, FU, SC)
        torch.cuda.empty_cache()

        # -- (c): the adapters, then the gateway driver's sync replay -----------------
        rep["adapters"] = adapters_run(np, st, torch, FU, SC)
        gw = gateway_replay(np, st, "cuda")
        torch.cuda.empty_cache()

        t = time.perf_counter()
        cpu = {}
        for part, proc in cpu_procs.items():
            out, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"phase 12: the CPU run {part} failed: {err[-2000:]}")
            cpu[part] = json.loads(out.strip().splitlines()[-1])
        rep["cpu"] = dict(wall_s=max(v["wall_s"] for v in cpu.values()), wait_s=time.perf_counter() - t)
        check(cpu["replay"]["responses"] == [list(r) for r in kern["responses"]],
              "phase 12a: the door's responses on the card differ from the CPU's")
        check(cpu["replay"]["rls"]["codes"] == kern["rls"]["codes"], "phase 12b: the RLS codes on the card differ "
              "from the CPU's")
        check(cpu["gateway"]["counts"] == gw["counts"] and cpu["gateway"]["verdicts"] == gw["verdicts"],
              f"phase 12c: the gateway driver's sync replay differs: card {gw['counts']}, CPU "
              f"{cpu['gateway']['counts']}")
        n, p, b = gw["counts"]
        check(n == p + b and b > 0 and p > 0, f"phase 12c: the sync replay's counts {gw['counts']}")
        rep["gateway_replay"] = dict(counts=gw["counts"], wall_s=gw["wall_s"], cpu_wall_s=cpu["gateway"]["wall_s"])
    finally:
        for proc in cpu_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rep["phase_s"] = time.perf_counter() - t_phase
    doors_log(rep)
    return rep


def doors_log(rep) -> None:
    smi = rep["card"]
    r = rep["replay"]
    log(f"[doors] {smi}: 12a replay: {r['frames']} frames over {DOOR_SOCKETS} sockets, two REUSEPORT doors, "
        f"statuses {json.dumps(r['statuses'], sort_keys=True)}; door items a tick {r['fronts_a_tick']}; responses "
        f"with the kernels == plain versions == the CPU; door ticks under set_sync_debug_mode('error'); "
        f"unenforceable rules +{r['unenforceable'][0]} for the lane-0 rules, +{r['unenforceable'][1]} for the "
        f"unlaned one; {rep['replay_s']:.1f} s; launches {json.dumps(rep['replay_launches'], sort_keys=True)}")
    log(f"[doors] {smi}: 12a captured door tick == its plain-version tick "
        f"({json.dumps(rep['tick_replay'], sort_keys=True)})")
    ld = rep["load"]
    pf = ld["profile"]
    log(f"[doors] {smi}: 12a load: {ld['tokens_per_s']:.0f} tokens/s ({ld['frames']} frames from "
        f"{DOOR_LOAD_THREADS} threads in bursts of {DOOR_BURST}, {ld['entries']} entry() calls beside them, "
        f"{ld['wall_s']:.1f} s); round trip p50 {ld['rtt_p50_ms']:.2f} ms p99 {ld['rtt_p99_ms']:.2f} ms; "
        f"{ld['ms_a_tick']:.2f} ms a tick, p90 {ld['ms_a_tick_p90']:.2f} (dispatch to dispatch; {ld['ticks']} ticks); "
        f"the doors' share of a batch mean {ld['door_share_mean']:.3f} p50 {ld['door_share_p50']:.3f}; CUDA "
        f"profile of {pf['wall_ms']:.0f} ms: {pf['ticks']} ticks, device busy {pf['busy_ms']:.3f} ms "
        f"({pf['busy_ms_a_tick']:.3f} ms a tick), idle share {pf['idle_share']:.3f}, kernels {json.dumps(pf['kernels'], sort_keys=True)}; every frame answered, no tick "
        f"failed closed; launches {json.dumps(ld['launches'], sort_keys=True)}")
    rl = r["rls"]
    log(f"[doors] {smi}: 12b RLS: {RLS_REQUESTS} descriptors resolved in {rl['resolve_ms']:.1f} ms "
        f"({rl['unresolved']} to no rule), decided in {rl['decide_ms']:.1f} ms through the token service: "
        f"{json.dumps(rl['counts'], sort_keys=True)} == the CPU's, code for code; the gRPC wire is held on the CPU "
        f"by tests/test_torch_rls.py")
    ad = rep["adapters"]
    for k in ("bare_entry", "wsgi", "asgi", "decorator", "guard_stream"):
        a = ad[k]
        log(f"[doors] {smi}: 12c {k}: {a['per_s']:.1f} requests/s, {a['us_a_request']:.0f} us a request"
            + (f" ({a['added_us']:+.0f} us over bare entry())" if "added_us" in a else "")
            + f"; switched off (no tick) {a['passthrough_us']:.1f} us a request"
            + (f" ({a['added_passthrough_us']:+.1f} us over bare entry())" if "added_passthrough_us" in a else "")
            + f", outcomes {json.dumps(a['outcomes'], sort_keys=True)}")
    for k, d in ad["drivers"].items():
        log(f"[doors] {smi}: 12c {k}: submitted / passed / blocked {d['counts']}, {d['per_s']:.1f} requests/s")
    gw = rep["gateway_replay"]
    log(f"[doors] {smi}: 12c drive_gateway sync replay {gw['counts']} == the CPU's, request for request "
        f"({gw['wall_s']:.1f} s on the card, {gw['cpu_wall_s']:.1f} s on the CPU); launches "
        f"{json.dumps(ad['launches'], sort_keys=True)}; the WSGI requests' launches "
        f"{json.dumps(ad['wsgi_launches'], sort_keys=True)}")
    log(f"[doors] {smi}: phase 12 took {rep['phase_s']:.1f} s (the CPU run {rep['cpu']['wall_s']:.1f} s, waited "
        f"{rep['cpu']['wait_s']:.1f} s for it at the end)")


def doors_main() -> int:
    """``python3 chip_smoke.py --doors``: the kernels' build and phase 12
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
    rep = doors_phase(np, st, S, FU, SC, torch, nvidia_smi())
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


# -- phase 13: the operator's plane -------------------------------------------------------

#: 13a: the resource whose flow count the dashboard's push changes (the
#: second-hottest name of the Zipf(1.1) stream; its rule allows 6 a second)
#: and the count the push gives it
OP_PUSH_RES = "res-1"
OP_PUSH_COUNT = 100_000
#: 13a: seconds of steady traffic before the push, and after it
OP_STEADY_S = 2.0
OP_AFTER_S = 1.5
#: 13b: the resource the datasources' rules are on, its count before and
#: after each push, and the entries a probe burst makes
OP_DS_RES = "ds-res"
OP_DS_BEFORE, OP_DS_AFTER = 1000, 2
OP_BURST = 12
#: 13b: how long a store stub holds a long poll or watch without a change,
#: and the polled sources' refresh interval on the serving client (ms)
OP_HOLD_S = 0.25
OP_POLL_MS = 100
#: 13c: ticks each replay runs, at the batch size
OP_TICKS = 16
#: the ten datasources, in the order 13b drives them
DATASOURCES = ("http", "callback", "redis", "zookeeper", "nacos", "consul", "apollo", "eureka", "etcd", "spring")
#: the B1-B4 wrappers' names in the launch counters
B_KERNELS = ("scatter_many", "gather_many", "seg_excl_cumsum", "seg_incl_min")


class StoreState:
    """One store's content: the rules text, and a version every change bumps
    (the stubs' ETag, Consul index, Apollo notification id and etcd
    revision)."""

    def __init__(self, value: str):
        self.value, self.version = value, 1
        self.seen = 0  # the version etcd's datasource last read (its range)
        self.cv = threading.Condition()

    def set(self, value: str) -> None:
        with self.cv:
            self.value, self.version = value, self.version + 1
            self.cv.notify_all()

    def hold(self, pred) -> bool:
        """Wait up to OP_HOLD_S for ``pred(self)``: a long poll's hold."""
        with self.cv:
            return self.cv.wait_for(lambda: pred(self), OP_HOLD_S)


def store_http_stub(kind: str, state: StoreState):
    """A started HTTP server on 127.0.0.1 speaking one store's protocol
    subset, as its datasource uses it: Nacos (config GET, the MD5 long
    poll), Consul (KV with blocking index queries), Apollo (config file,
    notifications long poll), Eureka (instance metadata), etcd (base64
    range, chunked watch stream), Spring Cloud Config (property sources),
    or a rules file with ETags (``http``)."""
    import base64
    import hashlib
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def b64(s):
        return base64.b64encode(s.encode()).decode()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def reply(self, code, body=b"", headers=()):
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urllib.parse.urlparse(self.path)
            q = {k: v[-1] for k, v in urllib.parse.parse_qs(u.query).items()}
            if kind == "http":
                tag = f'"v{state.version}"'
                if self.headers.get("If-None-Match") == tag:
                    return self.reply(304)
                return self.reply(200, state.value.encode(), [("ETag", tag)])
            if kind == "nacos":
                return self.reply(200, state.value.encode())
            if kind == "consul":
                if "index" in q:
                    idx = int(q["index"])
                    state.hold(lambda s: s.version > idx)
                return self.reply(200, json.dumps([{"Value": b64(state.value)}]).encode(),
                                  [("X-Consul-Index", str(state.version))])
            if kind == "apollo":
                if u.path.startswith("/configfiles/json/"):
                    return self.reply(200, json.dumps({"flowRules": state.value}).encode())
                nid = json.loads(q["notifications"])[0]["notificationId"]
                if not state.hold(lambda s: s.version > nid):
                    return self.reply(304)
                return self.reply(200, json.dumps([{"namespaceName": "application",
                                                    "notificationId": state.version}]).encode())
            if kind == "eureka":
                return self.reply(200, json.dumps({"instance": {"metadata": {"flowRules": state.value}}}).encode())
            if kind == "spring":
                return self.reply(200, json.dumps({"propertySources": [
                    {"source": {"other": "x"}}, {"source": {"sentinel.rules": state.value}}]}).encode())
            self.reply(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n).decode()
            if kind == "nacos":
                listening = urllib.parse.parse_qs(raw)["Listening-Configs"][0]
                data_id, group, md5 = listening.rstrip("\x01").split("\x02")[:3]
                changed = state.hold(lambda s: hashlib.md5(s.value.encode()).hexdigest() != md5)
                return self.reply(200, urllib.parse.quote(f"{data_id}\x02{group}\x01").encode() if changed else b"")
            if self.path == "/v3/kv/range":
                state.seen = state.version
                return self.reply(200, json.dumps({"kvs": [{"value": b64(state.value)}]}).encode())
            # /v3/watch: the created handshake, then one event once the key
            # is newer than the datasource's last read (a change between two
            # watches is not lost)
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj):
                b = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
                self.wfile.flush()

            chunk({"result": {"created": True}})
            if state.hold(lambda s: s.version > s.seen):
                chunk({"result": {"events": [{"type": "PUT"}]}})
            self.wfile.write(b"0\r\n\r\n")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, name=f"stub-{kind}", daemon=True).start()
    return srv


class RespStub:
    """A RESP2 server on 127.0.0.1 with the commands the Redis datasource
    and its operator use: GET, SET, SUBSCRIBE, PUBLISH."""

    def __init__(self, value: str):
        import socketserver

        self.data = {"sentinel:rules": value}
        self.subs, self.conns = [], []
        self.lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock, buf = self.request, b""
                outer.conns.append(sock)
                while True:
                    try:
                        chunk = sock.recv(65536)
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                    while True:
                        cmd, buf = outer.parse(buf)
                        if cmd is None:
                            break
                        outer.dispatch(sock, cmd)

        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, name="stub-redis", daemon=True).start()

    @staticmethod
    def parse(buf):
        """One array-of-bulk-strings request off ``buf``: (args, rest), or
        (None, buf) while it is incomplete."""
        if not buf.startswith(b"*") or b"\r\n" not in buf:
            return None, buf
        head, rest = buf.split(b"\r\n", 1)
        args = []
        for _ in range(int(head[1:])):
            if b"\r\n" not in rest:
                return None, buf
            lhead, rest = rest.split(b"\r\n", 1)
            n = int(lhead[1:])
            if len(rest) < n + 2:
                return None, buf
            args.append(rest[:n])
            rest = rest[n + 2:]
        return args, rest

    def dispatch(self, sock, cmd):
        name = cmd[0].upper()
        if name == b"GET":
            v = self.data.get(cmd[1].decode())
            sock.sendall(b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v.encode()), v.encode()))
        elif name == b"SET":
            self.data[cmd[1].decode()] = cmd[2].decode()
            sock.sendall(b"+OK\r\n")
        elif name == b"SUBSCRIBE":
            with self.lock:
                self.subs.append(sock)
            sock.sendall(b"*3\r\n$9\r\nsubscribe\r\n$%d\r\n%s\r\n:1\r\n" % (len(cmd[1]), cmd[1]))
        elif name == b"PUBLISH":
            with self.lock:
                subs = list(self.subs)
            for s in subs:
                s.sendall(b"*3\r\n$7\r\nmessage\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n" % (len(cmd[1]), cmd[1], len(cmd[2]), cmd[2]))
            sock.sendall(b":%d\r\n" % len(subs))
        else:
            sock.sendall(b"-ERR unknown command\r\n")

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        for c in self.conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class ZkStub:
    """The jute subset the ZooKeeper datasource speaks (connect, getData,
    exists, ping) on 127.0.0.1; ``set_data`` fires the one-shot watches as
    an ensemble does."""

    def __init__(self, path: str, value: bytes):
        import struct

        self.struct = struct
        self.nodes, self.watches, self.conns = {path: value}, {}, []
        self.lock = threading.Lock()
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        threading.Thread(target=self.accept_loop, name="stub-zk", daemon=True).start()

    def accept_loop(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self.serve, args=(conn,), daemon=True).start()

    def frame(self, conn):
        def n_bytes(n):
            out = b""
            while len(out) < n:
                c = conn.recv(n - len(out))
                if not c:
                    raise ConnectionError
                out += c
            return out

        (n,) = self.struct.unpack(">i", n_bytes(4))
        return n_bytes(n)

    def send(self, conn, payload):
        conn.sendall(self.struct.pack(">i", len(payload)) + payload)

    def serve(self, conn):
        P = self.struct.pack
        stat = P(">qqqqiiiqiiq", 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0)
        try:
            f = self.frame(conn)
            timeout = self.struct.unpack_from(">iqiq", f, 0)[2]
            self.send(conn, P(">iiq", 0, timeout, 0x1234) + P(">i", 16) + b"\x00" * 16)
            while True:
                f = self.frame(conn)
                xid, op = self.struct.unpack_from(">ii", f, 0)
                if xid == -2:
                    self.send(conn, P(">iqi", -2, 0, 0))
                    continue
                (plen,) = self.struct.unpack_from(">i", f, 8)
                path = f[12:12 + plen].decode()
                with self.lock:
                    data = self.nodes.get(path)
                    # as an ensemble: a getData of a missing node leaves no
                    # watch, and a connection's watch on a path fires once
                    if f[12 + plen] == 1 and (data is not None or op == 3) and conn not in self.watches.get(path, []):
                        self.watches.setdefault(path, []).append(conn)
                if data is None:
                    self.send(conn, P(">iqi", xid, 0, -101))
                elif op == 4:
                    self.send(conn, P(">iqi", xid, 0, 0) + P(">i", len(data)) + data + stat)
                else:
                    self.send(conn, P(">iqi", xid, 0, 0) + stat)
        except (ConnectionError, OSError):
            pass

    def set_data(self, path: str, value: bytes):
        with self.lock:
            self.nodes[path] = value
            conns = self.watches.pop(path, [])
        b = path.encode()
        for c in conns:
            self.send(c, self.struct.pack(">iqiiii", -1, 0, 0, 3, 3, len(b)) + b)

    def close(self):
        self.srv.close()
        for c in self.conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def ds_rules(count, base=()) -> str:
    """The datasources' rules text: ``base`` (JSON rule dicts) and a flow
    rule on ``ds-res`` allowing ``count`` a second."""
    return json.dumps(list(base) + [{"resource": OP_DS_RES, "count": count}])


def ds_count(rules):
    """The count of the loaded flow rule on ``ds-res`` (None: none)."""
    return next((r.count for r in rules if r.resource == OP_DS_RES), None)


class Store:
    """One of the ten datasources on its own stub, publishing flow rules:
    ``push(text)`` changes the store (a publish, a node write, a config
    change, a callback) and, for a polled source, ``refresh`` polls it
    once now (the serving client's run lets the datasource's own poll
    find it instead)."""

    def __init__(self, name: str, poll_ms: int, base=()):
        from sentinel_tpu_torch import datasource as DS
        from sentinel_tpu_torch.datasource import redis as R
        from sentinel_tpu_torch.datasource import stores as ST
        from sentinel_tpu_torch.datasource import zookeeper as Z

        self.name, self.R = name, R
        self.polled = name in ("http", "eureka", "spring")
        self.base = base
        first = ds_rules(OP_DS_BEFORE, base)
        parser = DS.json_rule_converter("flow")
        self.stub = self.state = None
        if name == "callback":
            self.ds = DS.CallbackDataSource(parser, initial=first)
        elif name == "redis":
            self.stub = RespStub(first)
            self.ds = R.RedisDataSource(parser, "127.0.0.1", self.stub.port, rule_key="sentinel:rules",
                                        channel="sentinel:chan").start()
        elif name == "zookeeper":
            self.stub = ZkStub("/sentinel/rules", first.encode())
            self.ds = Z.ZookeeperDataSource(f"127.0.0.1:{self.stub.port}", "/sentinel/rules", parser)
        else:
            self.state = StoreState(first)
            self.stub = store_http_stub(name, self.state)
            addr = f"127.0.0.1:{self.stub.server_address[1]}"
            hold_ms = int(OP_HOLD_S * 1000)
            self.ds = {
                "http": lambda: DS.HttpDataSource(f"http://{addr}/rules", parser, refresh_ms=poll_ms),
                "nacos": lambda: ST.NacosDataSource(addr, "SENTINEL_GROUP", "flow-rules", parser,
                                                    poll_timeout_ms=hold_ms),
                "consul": lambda: ST.ConsulDataSource("127.0.0.1", self.stub.server_address[1], "sentinel/flow",
                                                      parser, watch_timeout_s=1),
                "apollo": lambda: ST.ApolloDataSource(addr, "app", "default", "application", "flowRules", "[]",
                                                      parser),
                "eureka": lambda: ST.EurekaDataSource("APP", "inst-1", [f"http://{addr}/eureka"], "flowRules",
                                                      parser, refresh_ms=poll_ms),
                "etcd": lambda: ST.EtcdDataSource("127.0.0.1", self.stub.server_address[1], "sentinel.flow",
                                                  parser),
                "spring": lambda: ST.SpringCloudConfigDataSource(addr, "app", "prod", "sentinel.rules", parser,
                                                                 refresh_ms=poll_ms),
            }[name]()

    def push(self, text: str) -> None:
        if self.name == "callback":
            self.ds.update(text)
        elif self.name == "redis":
            op = self.R.RedisConnection("127.0.0.1", self.stub.port)
            try:
                op.execute("SET", "sentinel:rules", text)
                check(op.execute("PUBLISH", "sentinel:chan", text) == 1, "13b: the redis publish reached no one")
            finally:
                op.close()
        elif self.name == "zookeeper":
            self.stub.set_data("/sentinel/rules", text.encode())
        else:
            self.state.set(text)

    def refresh(self) -> None:
        if self.polled:
            self.ds.refresh()

    def close(self) -> None:
        """Close the datasource, check its threads ended, drop the stub (a
        callback source has neither thread nor close)."""
        if self.name != "callback":
            self.ds.close()
        threads = [getattr(self.ds, "_thread", None)]
        zk = getattr(self.ds, "_zk", None)
        if zk is not None:
            threads += [zk._reader, zk._pinger]
        for t in threads:
            if t is not None:
                t.join(timeout=5.0)
                check(not t.is_alive(), f"13b {self.name}: thread {t.name} outlived close()")
        if self.stub is not None:
            if hasattr(self.stub, "close"):
                self.stub.close()
            else:
                self.stub.shutdown()
                self.stub.server_close()


def wait_until(pred, timeout_s=15.0, what="") -> None:
    end = time.perf_counter() + timeout_s
    while not pred():
        check(time.perf_counter() < end, f"phase 13: timed out waiting for {what}")
        time.sleep(0.001)


def loaded_when(client, pred) -> threading.Event:
    """An event set by the first load of the client's flow rules that
    satisfies ``pred``: the rule managers call their listeners after the
    recompile, so the event means the engine enforces the load (polling
    ``flow_rules.get()`` would race a load on a datasource's thread, which
    sets the rules before it compiles them)."""
    evt = threading.Event()

    def on_load(rules):
        if pred(rules):
            evt.set()
            client.flow_rules._listeners.remove(on_load)

    client.flow_rules.add_listener(on_load)
    return evt


def rules_live(client, pred, do) -> dict:
    """Run ``do()`` (a push) and time it to its enforcement on a serving
    client: a listener on the client's flow rules marks the load that
    satisfies ``pred``; the first tick dispatched after that load is the
    first that enforces it.  ms and ticks counted from the push."""
    mark = {}

    def on_load(rules):
        if "t" not in mark and pred(rules):
            mark["t"], mark["n"] = time.perf_counter(), client._build_ticks

    client.flow_rules.add_listener(on_load)
    try:
        t0, n0 = time.perf_counter(), client._build_ticks
        out = do()
        wait_until(lambda: "t" in mark, what="the pushed rules to load")
        wait_until(lambda: client._build_ticks > mark["n"], what="a tick on the pushed rules")
        t1, n1 = time.perf_counter(), client._build_ticks
    finally:
        client.flow_rules._listeners.remove(on_load)
    return dict(ms=(t1 - t0) * 1e3, load_ms=(mark["t"] - t0) * 1e3, ticks=n1 - n0, out=out)


def burst(st, client, n=OP_BURST, res=OP_DS_RES) -> tuple:
    """(passed, blocked) of ``n`` requests on ``res`` (no argument), decided
    in one tick (``check_batch``): a burst that no window boundary splits."""
    from sentinel_tpu_torch.core import errors as ERR

    v = [verdict for verdict, _wait in client.check_batch([res] * n)]
    p = sum(1 for x in v if x in (ERR.PASS, ERR.PASS_WAIT))
    return p, n - p


def datasources_replay(np, st, device, cfg=None) -> dict:
    """13b's sync half: a sync client on virtual time; each of the ten
    datasources loads its rules (count 1,000), a burst of entries, the
    store pushes count 2, the clock moves past the window, another burst.
    Returns each source's (passed, blocked) before and after."""
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    c = SentinelClient(cfg=cfg or platform_config(), device=device, mode="sync", time_source=VirtualTimeSource(1_000),
                       app_name="operator-replay")
    c.start()
    out = {}
    try:
        for name in DATASOURCES:
            s = Store(name, poll_ms=3_600_000)
            try:
                c.flow_rules.register_property(s.ds.get_property())
                check(ds_count(c.flow_rules.get()) == OP_DS_BEFORE, f"13b {name}: the first rules did not load")
                before = burst(st, c)
                live = loaded_when(c, lambda rules: ds_count(rules) == OP_DS_AFTER)
                s.push(ds_rules(OP_DS_AFTER))
                s.refresh()
                check(live.wait(15.0), f"13b {name}: the push did not load")
                c.time.advance(1_100)
                out[name] = [list(before), list(burst(st, c))]
                check(out[name] == [[OP_BURST, 0], [OP_DS_AFTER, OP_BURST - OP_DS_AFTER]],
                      f"13b {name}: the sync replay's bursts {out[name]} (count {OP_DS_BEFORE}, then {OP_DS_AFTER})")
                c.time.advance(1_100)
            finally:
                s.close()
    finally:
        c.stop()
    return out


def unpacked_replay(np, st, device, cfg, n_names=N_NAMES, ticks=OP_TICKS) -> dict:
    """13c: a sync client on virtual time on ``cfg`` with build_rules' rule
    set; ``ticks`` ticks of B Zipf(1.1) requests over ``n_names`` names
    (argument hashes on the 16 param-ruled names, half inbound) with the
    previous tick's passes completing.  Returns the verdicts and waits, and
    each tick's ms, tx / rx bytes (the device path and the timeline's),
    device-to-host reads, and B1-B4 launches."""
    from sentinel_tpu_torch.obs import timeline as TLM
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import segscan as SC
    from sentinel_tpu_torch.runtime import client as CL
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    c = SentinelClient(cfg=cfg, device=device, mode="sync", time_source=VirtualTimeSource(1_000),
                       app_name="operator-wire")
    flow, degrade, authority, system, param = build_rules(st)
    c.flow_rules.load(flow)
    c.degrade_rules.load(degrade)
    c.authority_rules.load(authority)
    c.system_rules.load(system)
    c.param_flow_rules.load(param)
    c._sys.sample = lambda: (0.25, 0.5)  # the host's load / CPU: pinned, as the CPU run's
    ids_of = np.array([c.registry.resource_id(f"res-{i}") for i in range(n_names)], np.int32)
    c.start()
    B = c.cfg.batch_size
    rng = np.random.default_rng(SEED + 1300)
    probs = zipf_probs(np, n_names)
    # each device-to-host read adds its bytes once: on the device path, or
    # (the unpacked timeline rows) on the timeline's own
    reads = {"device": 0, "timeline": 0}
    counters = {"device": CL._C_WIRE["rx"], "timeline": TLM._C_WIRE["rx"]}
    real_inc = {k: m.inc for k, m in counters.items()}

    def counting(key):
        def inc(n=1):
            reads[key] += 1
            real_inc[key](n)
        return inc

    for k, m in counters.items():
        m.inc = counting(k)
    tx0, rx0, tl0 = CL._C_WIRE["tx"].value, CL._C_WIRE["rx"].value, TLM._C_WIRE["rx"].value
    skipped0 = CL._C_COLS_SKIPPED.value
    verdicts, waits, ms = [], [], []
    try:
        FU.reset_launches()
        SC.reset_launches()
        n0 = c._build_ticks
        prev = None
        for t in range(ticks):
            k = rng.choice(n_names, size=B, p=probs)
            ph = np.zeros((B, c.cfg.param_dims), np.int32)
            ph[:, 0] = np.where(k < 16, rng.integers(1, N_VALUES, B), 0)
            inb = (rng.random(B) < 0.5).astype(np.int32)
            rt = np.abs(rng.normal(3.0, 1.0, B)).astype(np.float32)
            if prev is not None:
                # queued, not ticked: the exits ride the acquire tick below
                c.mode = "threaded"
                c.submit_completion_block(*prev)
                c.mode = "sync"
            t0 = time.perf_counter()
            v, w = c.check_batch_ids(ids_of[k], param_hash=ph, inbound=inb)
            ms.append((time.perf_counter() - t0) * 1e3)
            ok = v == 0
            prev = (ids_of[k][ok], rt[ok])
            verdicts.append(v.tolist())
            waits.append(w.tolist())
            c.time.advance(37)
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        check(c._build_ticks - n0 == ticks, f"13c: {c._build_ticks - n0} ticks ran for {ticks} batches")
    finally:
        for k, m in counters.items():
            m.inc = real_inc[k]
        c.stop()
    # packed, the wire buffer's timeline share is accounted on the timeline's
    # path but rides the one read
    n_reads = reads["device"] + (0 if c.cfg.packed_wire else reads["timeline"])
    return dict(verdicts=verdicts, waits=waits, ms=ms, ticks=ticks, batch=B,
                tx=(CL._C_WIRE["tx"].value - tx0) / ticks, rx=(CL._C_WIRE["rx"].value - rx0) / ticks,
                rx_timeline=(TLM._C_WIRE["rx"].value - tl0) / ticks, reads=n_reads / ticks,
                skipped=CL._C_COLS_SKIPPED.value - skipped0,
                launches={k: launches.get(k, 0) / ticks for k in B_KERNELS},
                mix=np.bincount(np.concatenate([np.asarray(x) for x in verdicts]), minlength=7).tolist())


def unpacked_configs() -> dict:
    """13c's configurations: platform_config() at the default widths (B1,
    B2, B4) and phase 4's seg1 (B1, B3, B4)."""
    from sentinel_tpu_torch.core.config import platform_config

    return {"default": platform_config(), "seg1": configs(platform_config)["seg1"]}


def operator_cpu_main(part: str) -> int:
    """``python3 chip_smoke.py --operator-cpu datasources|unpacked`` (phase
    13): 13b's sync replay, or 13c's unpacked replays, on the CPU in a
    process of its own; one JSON line."""
    import dataclasses

    import numpy as np
    import torch

    torch.set_num_threads(3)
    sys.path.insert(0, ROOT)
    import sentinel_tpu_torch as st

    t = time.perf_counter()
    if part == "datasources":
        out = dict(counts=datasources_replay(np, st, "cpu"))
    else:
        out = {name: {k: v for k, v in unpacked_replay(np, st, "cpu", dataclasses.replace(cfg, packed_wire=False))
                      .items() if k in ("verdicts", "waits", "mix")}
               for name, cfg in unpacked_configs().items()}
    print(json.dumps(dict(out, wall_s=time.perf_counter() - t)), flush=True)
    return 0


def operator_serving(np, st, torch, FU, SC, work, device="cuda", cfg=None, n_names=N_NAMES) -> dict:
    """13a and 13b's serving half: a threaded client at ``cfg`` (default
    platform_config()) with build_rules' rules, its metric log, its command
    center, a heartbeat into the port's dashboard, and 8 request threads;
    the dashboard's fetcher every second; a push of the whole flow rule
    set with one count changed; the degrade, param and system rules
    round-tripped; then the ten datasources, each pushing a change to the
    same client; then /cluster/assign over two more clients."""
    import urllib.parse

    from sentinel_tpu_torch import dashboard as TD
    from sentinel_tpu_torch import transport as TT
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.core.rules import rules_to_json_list
    from sentinel_tpu_torch.metrics import MetricSearcher
    from sentinel_tpu_torch.obs.registry import REGISTRY
    from sentinel_tpu_torch.runtime.client import SentinelClient

    rep = {}
    cfg = cfg or platform_config()
    builds = REGISTRY.get("sentinel_engine_tick_builds_total")
    client = SentinelClient(cfg=cfg, device=device, mode="threaded", entry_timeout_s=30.0, app_name="operator",
                            metric_log=True, metric_log_dir=os.path.join(work, "metrics"))
    flow, degrade, authority, system, param = build_rules(st)
    client.flow_rules.load(flow)
    client.degrade_rules.load(degrade)
    client.authority_rules.load(authority)
    client.system_rules.load(system)
    client.param_flow_rules.load(param)
    names = [f"res-{i}" for i in range(n_names)]
    for n in names:
        client.registry.resource_id(n)
    client.start()
    center = TT.start_command_center(client, metric_searcher=MetricSearcher(os.path.join(work, "metrics"), "operator"),
                                     host="127.0.0.1", port=0)
    dash = TD.DashboardServer(host="127.0.0.1", port=0, fetch_metrics=False)
    dash.start()
    base = f"http://127.0.0.1:{dash.port}"
    machine = f"ip=127.0.0.1&port={center.port}"
    check(TT.HeartbeatSender("operator", dashboard_addresses=[f"127.0.0.1:{dash.port}"], center=center).send_once(),
          "13a: the heartbeat did not reach the dashboard")
    stamps, real_run = [], client._run_tick

    def spy(*a, **kw):
        stamps.append(time.perf_counter())
        return real_run(*a, **kw)

    client._run_tick = spy
    stop, lock, outcomes = threading.Event(), threading.Lock(), {}
    traffic = [threading.Thread(target=control_traffic, args=(np, st, client, names, stop, outcomes, lock,
                                                             SEED + 1310 + i), daemon=True) for i in range(N_THREADS)]
    fetches, fetch_stop = [], threading.Event()

    def fetch_loop():
        while not fetch_stop.wait(1.0):
            t = time.perf_counter()
            rows = dash.fetcher.fetch_once()
            fetches.append(((time.perf_counter() - t) * 1e3, rows))

    fetcher = threading.Thread(target=fetch_loop, name="operator-fetch", daemon=True)
    extra = []
    try:
        FU.reset_launches()
        SC.reset_launches()
        for t in traffic:
            t.start()
        fetcher.start()
        time.sleep(OP_STEADY_S)
        steady = (time.perf_counter() - OP_STEADY_S / 2, time.perf_counter())
        # -- 13a: the dashboard's push of the whole flow rule set, one count changed
        b0 = builds.value
        old = client.stats.resource(OP_PUSH_RES)["passQps"]
        before = burst(st, client, 2 * OP_BURST, OP_PUSH_RES)
        ms, status, body = http_call(f"{base}/rules?{machine}&type=flow")
        check(status == 200, f"13a: GET /rules answered {status}")
        listed, get_bytes = json.loads(body), len(body)
        check(len(listed) == len(flow), f"13a: the dashboard listed {len(listed)} of {len(flow)} flow rules")
        for r in listed:
            if r["resource"] == OP_PUSH_RES:
                limit = r["count"]
                r["count"] = OP_PUSH_COUNT
        t_push = time.perf_counter()
        live = rules_live(client, lambda rules: any(r.resource == OP_PUSH_RES and r.count == OP_PUSH_COUNT
                                                    for r in rules),
                          lambda: http_call(f"{base}/rules?{machine}&type=flow", data=json.dumps(listed).encode()))
        push_ms, status, body = live.pop("out")
        check(status == 200 and json.loads(body)["pushed"] == 1, f"13a: POST /rules answered {status}: {body[:200]!r}")
        after = burst(st, client, 2 * OP_BURST, OP_PUSH_RES)
        check(before[0] <= limit and after == (2 * OP_BURST, 0),
              f"13a: bursts on {OP_PUSH_RES}: {before} at count {limit}, {after} at {OP_PUSH_COUNT}")
        time.sleep(OP_AFTER_S)
        new = client.stats.resource(OP_PUSH_RES)["passQps"]
        rep["push"] = dict(rules=len(listed), post_ms=push_ms, get_ms=ms, get_bytes=get_bytes, **live,
                           bursts=[before, after], pass_qps=[old, new], limit=limit, builds=builds.value - b0)
        # -- 13a: the degrade, param and system rules round-tripped
        rt = {}
        b0 = builds.value
        for rtype in ("degrade", "paramFlow", "system"):
            ms_get, status, body = http_call(f"{base}/rules?{machine}&type={rtype}")
            got = json.loads(body)
            ms_post, status, rbody = http_call(f"{base}/rules?{machine}&type={rtype}", data=json.dumps(got).encode())
            check(status == 200, f"13a: POST /rules type={rtype} answered {status}: {rbody[:200]!r}")
            again = json.loads(http_call(f"{base}/rules?{machine}&type={rtype}")[2])
            check(again == got and len(got) > 0, f"13a: the {rtype} rules changed on a round trip")
            rt[rtype] = dict(rules=len(got), get_ms=ms_get, post_ms=ms_post)
        rep["round_trip"] = dict(rt, builds=builds.value - b0)
        check(rep["push"]["builds"] == 0 and rep["round_trip"]["builds"] == 0,
              f"13a: a reload that keeps the feature set built a tick ({rep['push']['builds']}, "
              f"{rep['round_trip']['builds']})")
        gaps_around = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:]) if t_push - 0.5 <= a <= t_push + 0.5]
        gaps_steady = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:]) if steady[0] <= a <= steady[1]]
        rep["ticks"] = dict(push_p50=_pct(gaps_around, 0.5), push_max=max(gaps_around), push_n=len(gaps_around),
                            steady_p50=_pct(gaps_steady, 0.5), steady_max=max(gaps_steady), steady_n=len(gaps_steady))
        # -- 13b: the ten datasources push the same change to the serving client.
        # Each carries the whole flow rule set and ds-res's rule: a load that
        # kept only ds-res would change the compiled feature set, whose warm-up
        # waits for the tick loop to go idle (_warm_after_recompile), and the
        # closed-loop request threads keep it busy
        flow_json = [{k: d[k] for k in ("resource", "count", "controlBehavior", "maxQueueingTimeMs",
                                        "warmUpPeriodSec")} for d in rules_to_json_list(flow)]
        ds, b0 = {}, builds.value
        for name in DATASOURCES:
            s = Store(name, poll_ms=OP_POLL_MS, base=flow_json)
            try:
                client.flow_rules.register_property(s.ds.get_property())
                wait_until(lambda: ds_count(client.flow_rules.get()) == OP_DS_BEFORE, what=f"{name}'s rules")
                before = burst(st, client)
                live = rules_live(client, lambda rules: ds_count(rules) == OP_DS_AFTER,
                                  lambda: s.push(ds_rules(OP_DS_AFTER, flow_json)))
                live.pop("out")
                after = burst(st, client)
                check(before == (OP_BURST, 0) and after[0] <= OP_DS_AFTER and after[1] >= OP_BURST - OP_DS_AFTER,
                      f"13b {name}: bursts {before} before the push, {after} after")
                ds[name] = dict(live, before=before, after=after)
            finally:
                s.close()
        rep["datasources"] = ds
        rep["datasource_builds"] = builds.value - b0
        check(rep["datasource_builds"] == 0, f"13b: the datasources' reloads built {rep['datasource_builds']} ticks")
        fetch_stop.set()
        fetcher.join(timeout=30)
        stop.set()
        for t in traffic:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in traffic), "13a: request threads still running after 120 s")
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        rep["launches"] = launches
        for k in ("scatter_many", "gather_many", "seg_incl_min"):
            check(launches.get(k, 0) > 0, f"13a: the serving client launched no {k}: {launches}")
        lost = {k: v for k, v in outcomes.items() if k.startswith("lost")}
        check(not lost and outcomes.get("pass", 0) > 0, f"13a: outcomes {outcomes}")
        rep["outcomes"] = outcomes
        rows = [r for _ms, r in fetches]
        check(len(fetches) >= 3 and sum(rows) > 0, f"13a: the fetcher's rounds saved {rows}")
        rep["fetch"] = dict(rounds=len(fetches), p50_ms=_pct([m for m, _r in fetches], 0.5),
                            p99_ms=_pct([m for m, _r in fetches], 0.99), rows=rows,
                            repo_resources=len(dash.repository.resources_of("operator")))
        apps = json.loads(http_call(f"{base}/apps")[2])
        check([m["port"] for m in apps.get("operator", [])] == [center.port], f"13a: /apps {apps}")
        # -- 13a: /cluster/assign over two more clients, then a cluster rule through the server
        rep["assign"] = operator_assign(st, TT, dash, base, device, cfg, extra)
    finally:
        fetch_stop.set()
        stop.set()
        for c, svc, cluster, cc in extra:
            cc.stop()
            cluster.stop()
            svc.close()
            c.stop()
        dash.stop()
        center.stop()
        client.stop()
    return rep


def operator_assign(st, TT, dash, base, device, cfg, extra) -> dict:
    """/cluster/assign over two serving clients, each with its token
    service, cluster state and command center, registered by heartbeat:
    one becomes the token server, the other its client.  A cluster-mode
    flow rule that allows 5 a second on the server and 1,000 on the client
    machine's local fallback is pushed to the client through the
    dashboard: 12 entries pass 5, so the server decided them."""
    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster import state as CS
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.runtime.client import SentinelClient

    for app in ("token-server", "token-client"):
        c = SentinelClient(cfg=cfg, device=device, mode="threaded", entry_timeout_s=30.0, app_name=app)
        c.start()
        svc = DefaultTokenService(c)
        cluster = CS.ClusterStateManager()
        cluster._embedded = svc
        # phase 8's token timeout: a decision waits for the server's eager
        # ticks while other clients' ticks share the host
        cluster.client_config.request_timeout_ms = CLUSTER_REQUEST_TIMEOUT_MS
        c.set_cluster(cluster)
        cc = TT.SimpleHttpCommandCenter(TT.build_default_handlers(c, cluster=cluster), host="127.0.0.1", port=0)
        cc.start()
        extra.append((c, svc, cluster, cc))
        check(TT.HeartbeatSender(app, dashboard_addresses=[f"127.0.0.1:{dash.port}"], center=cc).send_once(),
              f"13a: {app}'s heartbeat did not reach the dashboard")
    (sc, ssvc, scl, scc), (cc_, csvc, ccl, ccc) = extra
    rule = dict(resource="cluster-res", count=5, clusterMode=True,
                clusterConfig={"flowId": 77, "thresholdType": C.FLOW_THRESHOLD_GLOBAL, "fallbackToLocalWhenFail": True})
    # flow 78 only warms the token path (the connection, the server's first
    # decisions) before flow 77's burst
    ssvc.flow_rules.load("default", [
        st.FlowRule(resource="cluster-res", count=5, cluster_mode=True, cluster_flow_id=77,
                    cluster_threshold_type=C.FLOW_THRESHOLD_GLOBAL),
        st.FlowRule(resource="cluster-warm", count=1000, cluster_mode=True, cluster_flow_id=78,
                    cluster_threshold_type=C.FLOW_THRESHOLD_GLOBAL)])
    t = time.perf_counter()
    ms, status, body = http_call(f"{base}/cluster/assign", data=json.dumps({
        "server": {"ip": "127.0.0.1", "port": scc.port}, "clients": [{"ip": "127.0.0.1", "port": ccc.port}]}).encode())
    out = json.loads(body)
    check(status == 200 and out["server"]["tokenPort"] > 0 and out["clients"][0]["ok"] is True,
          f"13a: /cluster/assign answered {status}: {out}")
    check(scl.mode == CS.CLUSTER_SERVER and ccl.mode == CS.CLUSTER_CLIENT, "13a: the assign flipped no roles")
    wait_until(lambda: getattr(ccl.token_service(), "peer_version", 0) >= 3, what="the token client's handshake")
    assign_ms = (time.perf_counter() - t) * 1e3
    warm = [ccl.token_service().request_token(78).status for _ in range(3)]
    check(warm.count(C.STATUS_OK) == 3, f"13a: the assigned server's warm-up answered {warm}")
    machine = f"ip=127.0.0.1&port={ccc.port}"
    local = dict(rule, count=1000)  # the client machine's own copy: its local fallback allows 1,000
    ms_push, status, body = http_call(f"{base}/rules?{machine}&type=flow", data=json.dumps([local]).encode())
    check(status == 200, f"13a: the cluster rule's push answered {status}: {body[:200]!r}")
    check([(r.resource, r.cluster_mode, r.cluster_flow_id) for r in cc_.flow_rules.get()] == [("cluster-res", True, 77)],
          f"13a: the client machine's rules {cc_.flow_rules.get()}")
    # the entries at once, from threads of their own: one window holds them all
    got = []

    def one():
        try:
            cc_.entry("cluster-res").exit()
            got.append(True)
        except st.FlowException:
            got.append(False)

    t = time.perf_counter()
    threads = [threading.Thread(target=one, daemon=True) for _ in range(OP_BURST)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    burst_ms = (time.perf_counter() - t) * 1e3
    p, b = sum(got), len(got) - sum(got)
    check(p == 5 and b == OP_BURST - 5 and not cc_._cluster_degraded_active,
          f"13a: the assigned server let {p} of {OP_BURST} through (5 allowed) in {burst_ms:.0f} ms, degraded "
          f"{cc_._cluster_degraded_active}")
    return dict(assign_ms=ms, to_handshake_ms=assign_ms, token_port=out["server"]["tokenPort"], push_ms=ms_push,
                passed=p, blocked=b, burst_ms=burst_ms)


def operator_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 13: the operator's plane on the card — (a) the port's dashboard
    over a serving client at the default widths (fetch rounds, a push of
    the whole flow rule set, rule round trips, /cluster/assign); (b) the
    ten datasources pushing one change each to that client, then a sync
    replay against the CPU's (a process of its own); (c) the unpacked
    client (packed_wire=False) against the packed one on two
    configurations, equal on the card and to the CPU."""
    import dataclasses
    import tempfile

    t_phase = time.perf_counter()
    env = child_env()
    cpu_procs = {part: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--operator-cpu", part], cwd=ROOT,
                                        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for part in ("datasources", "unpacked")}
    rep = {"card": smi}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="operator-", dir=os.path.join(ROOT, "build"))
    os.environ["CSP_SENTINEL_LOG_DIR"] = os.path.join(work, "logs")
    try:
        # -- (a) + (b): the serving client ------------------------------------------------
        t = time.perf_counter()
        rep["serving"] = operator_serving(np, st, torch, FU, SC, work)
        rep["serving_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        # -- (b): the sync replay on the card -------------------------------------------------
        t = time.perf_counter()
        rep["replay"] = datasources_replay(np, st, "cuda")
        rep["replay_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        # -- (c): unpacked against packed ----------------------------------------------------
        rep["wire"] = {}
        for name, cfg in unpacked_configs().items():
            # in turns, so that host drift weighs on each alike; each run
            # from a fresh client.  "packed_noexpl" is the packed wire without
            # its explain records, which only the packed wire carries
            variants = {"packed": dict(packed_wire=True), "unpacked": dict(packed_wire=False),
                        "packed_noexpl": dict(packed_wire=True, explain_k=0)}
            turns = {k: [] for k in variants}
            for label in ("packed", "unpacked", "packed_noexpl", "packed_noexpl", "unpacked", "packed"):
                turns[label].append(unpacked_replay(np, st, "cuda", dataclasses.replace(cfg, **variants[label])))
                torch.cuda.empty_cache()
            want = ("scatter_many", "gather_many", "seg_incl_min") if name == "default" else (
                "scatter_many", "seg_excl_cumsum", "seg_incl_min")
            first = turns["packed"][0]
            runs = {}
            for label, (a, b) in turns.items():
                for r in (a, b):
                    check(r["verdicts"] == first["verdicts"] and r["waits"] == first["waits"],
                          f"13c {name}: a {label} run's verdicts or waits differ from the packed one's on the card")
                    for k in want:
                        check(r["launches"][k] > 0, f"13c {name} {label}: no {k} launched: {r['launches']}")
                check({k: v for k, v in a.items() if k != "ms"} == {k: v for k, v in b.items() if k != "ms"},
                      f"13c {name}: the two {label} runs differ")
                # the first two ticks of a fresh client build its plans and pinned buffers
                runs[label] = dict(a, ms=a["ms"][2:] + b["ms"][2:], runs=2)
            check(runs["unpacked"]["skipped"] == 0,
                  f"13c {name}: the unpacked client skipped {runs['unpacked']['skipped']} columns")
            rep["wire"][name] = runs
        t = time.perf_counter()
        cpu = {}
        for part, proc in cpu_procs.items():
            out, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"phase 13: the CPU run {part} failed: {err[-2000:]}")
            cpu[part] = json.loads(out.strip().splitlines()[-1])
        rep["cpu"] = dict(wall_s={k: v["wall_s"] for k, v in cpu.items()}, wait_s=time.perf_counter() - t)
        check(cpu["datasources"]["counts"] == rep["replay"],
              f"13b: the sync replay's counts differ: card {rep['replay']}, CPU {cpu['datasources']['counts']}")
        for name, runs in rep["wire"].items():
            c = cpu["unpacked"][name]
            check(c["verdicts"] == runs["unpacked"]["verdicts"] and c["waits"] == runs["unpacked"]["waits"],
                  f"13c {name}: the unpacked client's verdicts or waits on the card differ from the CPU's")
            for r in runs.values():
                del r["verdicts"], r["waits"]
    finally:
        for proc in cpu_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rep["phase_s"] = time.perf_counter() - t_phase
    operator_log(rep)
    return rep


def operator_log(rep) -> None:
    smi, sv = rep["card"], rep["serving"]
    f, p, tk = sv["fetch"], sv["push"], sv["ticks"]
    log(f"[operator] {smi}: 13a fetch rounds (MetricFetcher.fetch_once every second, {f['rounds']} rounds): p50 "
        f"{f['p50_ms']:.2f} ms p99 {f['p99_ms']:.2f} ms, rows {f['rows']}, {f['repo_resources']} resources in the "
        f"repository; request outcomes {json.dumps(sv['outcomes'], sort_keys=True)}")
    log(f"[operator] {smi}: 13a push of {p['rules']} flow rules ({OP_PUSH_RES} {p['limit']:g} -> {OP_PUSH_COUNT}): "
        f"GET {p['get_ms']:.1f} ms, POST {p['post_ms']:.1f} ms; push -> rules loaded {p['load_ms']:.1f} ms, -> first "
        f"enforcing tick {p['ms']:.1f} ms ({p['ticks']} ticks); bursts of {2 * OP_BURST} on {OP_PUSH_RES} "
        f"(passed, blocked) {p['bursts'][0]} -> {p['bursts'][1]}; its passQps under traffic {p['pass_qps'][0]:g} -> "
        f"{p['pass_qps'][1]:g}; tick builds +{p['builds']}")
    log(f"[operator] {smi}: 13a ms a tick (dispatch to dispatch) in the second around the push p50 "
        f"{tk['push_p50']:.2f} max {tk['push_max']:.2f} ({tk['push_n']} ticks), steady p50 {tk['steady_p50']:.2f} max "
        f"{tk['steady_max']:.2f} ({tk['steady_n']} ticks)")
    rt = sv["round_trip"]
    log(f"[operator] {smi}: 13a round trips " + ", ".join(
        f"{k} {v['rules']} rules GET {v['get_ms']:.1f} POST {v['post_ms']:.1f} ms" for k, v in rt.items()
        if k != "builds") + f"; tick builds +{rt['builds']}")
    a = sv["assign"]
    log(f"[operator] {smi}: 13a /cluster/assign {a['assign_ms']:.1f} ms (to the token client's handshake "
        f"{a['to_handshake_ms']:.1f} ms, token port {a['token_port']}); the cluster rule's push {a['push_ms']:.1f} ms; "
        f"{a['passed']} of {a['passed'] + a['blocked']} entries passed through the assigned server (5 allowed)")
    log(f"[operator] {smi}: 13a+b launches {json.dumps(sv['launches'], sort_keys=True)}")
    for name, d in sv["datasources"].items():
        log(f"[operator] {smi}: 13b {name:9s} push -> rules loaded {d['load_ms']:7.1f} ms, -> first enforcing tick "
            f"{d['ms']:7.1f} ms ({d['ticks']} ticks); bursts {d['before']} -> {d['after']}")
    log(f"[operator] {smi}: 13b sync replay on virtual time == the CPU's (passed, blocked) before -> after: "
        f"{json.dumps(rep['replay'], sort_keys=True)} ({rep['replay_s']:.1f} s)")
    for name, runs in rep["wire"].items():
        for label, r in runs.items():
            log(f"[operator] {smi}: 13c {name} {label}: {_pct(r['ms'], 0.5):.2f} ms a tick p50 (max {max(r['ms']):.2f}; "
                f"{r['runs']} runs in turns of {r['ticks']} ticks at B={r['batch']}, the first 2 of each left out); tx {r['tx']:.0f} B, rx {r['rx']:.0f} B + timeline "
                f"{r['rx_timeline']:.0f} B a tick; {r['reads']:g} reads a tick; skipped columns {r['skipped']}; "
                f"launches a tick {json.dumps(r['launches'], sort_keys=True)}; verdict mix {r['mix']}")
        log(f"[operator] {smi}: 13c {name}: unpacked == packed on the card, verdicts and waits, and == the CPU's")
    log(f"[operator] {smi}: phase 13 took {rep['phase_s']:.1f} s (serving {rep['serving_s']:.1f} s; the CPU runs "
        f"{json.dumps(rep['cpu']['wall_s'])} s, waited {rep['cpu']['wait_s']:.1f} s for them at the end)")


def operator_main() -> int:
    """``python3 chip_smoke.py --operator``: the kernels' build and phase
    13 alone, on the card."""
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
    rep = operator_phase(np, st, S, FU, SC, torch, nvidia_smi())
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


# -- phase 14: the sharded cluster and the shard router ----------------------------------

#: 14a: token shards; the serving client's local flow rules beside the 1,000
#: cluster flow rules; entry() calls a request thread makes, one in
#: SHARD_ARG_EVERY with an argument (a param token, never leased)
SHARDS = 4
SHARD_LOCAL_FLOWS = 3_000
SHARD_ENTRIES = 60
SHARD_ARG_EVERY = 8
#: the bulk check after the entries (one request_token_batch a distinct cluster name)
SHARD_BULK = 2_048
#: the fleet's and the router's failover cooldown (retry_interval_s)
SHARD_RETRY_S = 1.0
#: cluster_sharded_bench's row (bench.py:615-700): flows, requests, workers
SHARD_BENCH = (16, 2_000, 8)
#: the sync replay: flows, operations, the kill and the rejoin
REPLAY_FLOWS = 8
REPLAY_OPS = 96
REPLAY_KILL_AT, REPLAY_HEAL_AT = 40, 70
#: 14b: router names, mixed batches of ROUTER_B, and the batch before which
#: host 1's server stops (it restarts after that batch)
ROUTER_NAMES = 512
ROUTER_BATCHES = 4
ROUTER_B = 2_048
ROUTER_DOWN_AT = 2
#: 14b's second pass (hosts at the server's default worker count): mixed
#: batches of ROUTER_B after one untimed; one name in ROUTER_BLOCK_EVERY
#: has a count of 0 (BLOCK_FLOW), the rest 1e9 (PASS)
ROUTER_THREADED_BATCHES = 8
ROUTER_BLOCK_EVERY = 3
#: the kernels a platform_config() tick launches
SHARD_KERNELS = ("scatter_many", "gather_many", "seg_incl_min")


class ShardDown:
    """A RemoteShard fallback that refuses: a host that stops answering
    fails its spans CLOSED through the router's ``block`` mode instead of
    RemoteShard's fail-open pass-through."""

    def check_batch(self, resources, **kw):
        raise OSError("shard host down")


#: the sharded client's series that 14a reads as deltas, by shard
SHARD_SERIES = ("sentinel_shard_requests_total", "sentinel_lease_local_admits_total",
                "sentinel_shard_lease_tokens_total")


def shard_series() -> dict:
    """{(series, shard): value} of SHARD_SERIES from the port's registry."""
    from sentinel_tpu_torch.obs.registry import REGISTRY

    out = {}
    for key, v in REGISTRY.snapshot().items():
        name, _, labels = key.partition("{")
        if name in SHARD_SERIES and 'shard="' in labels:
            out[(name, labels.split('shard="')[1].split('"')[0])] = v
    return out


def shard_names():
    """The serving client's 4,000 names, a cluster name every fourth, so
    that Zipf ranks spread over both kinds: cres-0, res-0, res-1, res-2,
    cres-1, ..."""
    local = [f"res-{i}" for i in range(SHARD_LOCAL_FLOWS)]
    return [x for k in range(CLUSTER_FLOWS) for x in (f"cres-{k}", *local[3 * k:3 * k + 3])]


def wait_v3(clients, timeout_s=10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while any(c.peer_version < 3 for c in clients) and time.monotonic() < deadline:
        time.sleep(0.005)
    check(all(c.peer_version >= 3 for c in clients), ("a token client did not reach protocol v3",
                                                      [c.peer_version for c in clients]))


def sync_client(st, device, cfg):
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    c = st.SentinelClient(cfg=cfg, mode="sync", device=device, time_source=VirtualTimeSource(1_000))
    c.start()
    return c


def shards_serving_run(np, st, FU, SC, E, S, torch, device="cuda", cfg=None, entries=SHARD_ENTRIES) -> dict:
    """14a: the 4-shard fleet (sync decision clients) and a threaded serving
    client joined through set_to_sharded_client, on ``device`` at ``cfg``
    (platform_config())."""
    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster import shard as SH
    from sentinel_tpu_torch.cluster import state as STM
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.transport import start_command_center

    cfg = cfg or platform_config()
    made, out = [], {}

    def factory():
        # a sync decision client on the real clock, as bench.py's fleet's:
        # the token column answers on its own worker, a param token ticks
        # on the server's worker thread, and no tick loop of its own
        # competes with the serving client's for the interpreter
        c = st.SentinelClient(cfg=cfg, mode="sync", device=device)
        c.start()
        made.append(c)
        return c

    t = time.perf_counter()
    fleet = SH.ShardFleet(factory, n_shards=SHARDS, retry_interval_s=SHARD_RETRY_S,
                          timeout_ms=CLUSTER_REQUEST_TIMEOUT_MS, reconnect_interval_s=0.0)
    out["fleet_build_s"] = time.perf_counter() - t
    app = mgr = center = None
    try:
        flow, param = cluster_rules(np, st, C, threshold_type=C.FLOW_THRESHOLD_GLOBAL)
        fleet.load_flow_rules("default", flow)
        for name in fleet.names:
            fleet.services[name].param_rules.load(
                "default", [r for r in param if fleet.client.owner_of(r.cluster_flow_id) == name])
        app = st.SentinelClient(cfg=cfg, mode="threaded", device=device)
        app.start()
        mgr = STM.ClusterStateManager()
        mgr.client_config.request_timeout_ms = CLUSTER_REQUEST_TIMEOUT_MS
        mgr.set_to_sharded_client({n: ("127.0.0.1", p) for n, p in fleet._ports.items()},
                                  reconnect_interval_s=0.0, retry_interval_s=SHARD_RETRY_S)
        tok = mgr.token_service()
        tok.flow_rules.load("default", flow)  # the thresholds, for lease sizing
        wait_v3([s.client for s in tok._shards.values()])
        app.set_cluster(mgr)
        local = [st.FlowRule(resource=f"res-{i}", count=5 + i % 20) for i in range(SHARD_LOCAL_FLOWS)]
        app.flow_rules.load(local + flow)
        app.param_flow_rules.load(param)
        center = start_command_center(app, host="127.0.0.1", port=0)
        thr = {r.cluster_flow_id: float(r.count) for r in flow}
        owner_clock = {fid: fleet.services[tok.owner_of(fid)].client.time for fid in thr}

        # -- instruments.  The routed calls by shard, the lease-local admits
        # and the leased units come from the port's own series (deltas over
        # the run, ``shard_series``); wrappers stay where a check needs what
        # no series holds: the owners' grants and the lease-local admits a
        # window (windows_within), the units leased a flow and the lease
        # frames (the shard clients' two lease calls), and each public
        # token call's time and status
        lock = threading.Lock()
        grants, answered, admits, calls, batch_grants = [], [], [], [], []
        leased, lease_frames = {}, [0]

        def note_leases(fids, results):
            with lock:
                lease_frames[0] += 1
                for f, r in zip(fids, results):
                    if r.status == C.STATUS_OK and r.remaining > 0:
                        leased[int(f)] = leased.get(int(f), 0) + int(r.remaining)

        for sst in tok._shards.values():
            cli = sst.client

            def lease_call(fid, units, _real=cli.request_lease):
                r = _real(fid, units)
                note_leases([fid], [r])
                return r

            def batch_call(entries_, _real=cli.request_batch):
                rs = _real(entries_)
                lease = [(e[1], r) for e, r in zip(entries_, rs) if int(e[0]) == C.BATCH_KIND_LEASE]
                if lease:
                    note_leases(*zip(*lease))
                return rs

            cli.request_lease, cli.request_batch = lease_call, batch_call
        for name, svc in fleet.services.items():
            real_col = svc.col._run_column

            def cap_col(cols, now, _real=real_col, _svc=svc, _name=name):
                g, o = _real(cols, now)
                fid_of = {s_: f for f, s_ in _svc.col._slots.items()}
                live = cols[1] > 0
                with lock:
                    for s_, gr, part, fo in zip(cols[0][live], g[live], cols[3][live], cols[4][live]):
                        if int(s_) in fid_of:
                            answered.append((_name, fid_of[int(s_)]))
                            if not fo:
                                grants.append((int(now), fid_of[int(s_)], int(gr), bool(part)))
                return g, o

            svc.col._run_column = cap_col
        real_admit = tok._lease_admit

        def lease_admit(fid, count):
            r = real_admit(fid, count)
            if r is not None:
                clock = owner_clock.get(int(fid))
                with lock:
                    admits.append((clock.now_ms() if clock is not None else 0, int(fid), int(count)))
            return r

        tok._lease_admit = lease_admit
        for meth in ("request_token", "request_param_token", "request_token_batch"):
            real = getattr(tok, meth)

            def timed(*a, _real=real, _meth=meth, **kw):
                t0 = time.perf_counter()
                r = _real(*a, **kw)
                with lock:
                    calls.append((_meth, (time.perf_counter() - t0) * 1e3, r.status, int(a[1]) if len(a) > 1 else 1))
                    if _meth == "request_token_batch" and r.status == C.STATUS_OK and int(a[0]) in owner_clock:
                        # a partial grant: its units are admits (those from the
                        # lease are in ``admits`` already; these are the rest)
                        batch_grants.append((owner_clock[int(a[0])].now_ms(), int(a[0]), int(r.remaining)))
                return r

            setattr(tok, meth, timed)

        names = shard_names()
        zipf = zipf_probs(np, len(names))
        vals = zipf_probs(np, N_VALUES)
        rng = np.random.default_rng(SEED + 141)
        plan = [(rng.choice(len(names), size=entries, p=zipf), rng.choice(N_VALUES, size=entries, p=vals))
                for _ in range(N_THREADS)]
        outcomes = {}

        def worker(picks, values):
            mine = {}
            for k, (r, v) in enumerate(zip(picks, values)):
                args = [arg_value(int(v))] if k % SHARD_ARG_EVERY == 0 else None
                try:
                    app.entry(names[int(r)], args=args).exit()
                    key = "pass"
                except ERR.BlockException as e:
                    key = type(e).__name__
                mine[key] = mine.get(key, 0) + 1
            with lock:
                for key, n in mine.items():
                    outcomes[key] = outcomes.get(key, 0) + n

        out["heap"] = settle_heap()
        box = unwatch = None
        if device == "cuda":
            box, unwatch = capture_client_tick(E, 3, only=lambda: threading.current_thread() is app._thread)
        series0 = shard_series()
        FU.reset_launches()
        SC.reset_launches()
        threads = [threading.Thread(target=worker, args=p) for p in plan]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        t_entries = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "14a: a request thread did not finish")
        with lock:
            entry_calls, n_entry_admits = list(calls), len(admits)
        # one bulk check through the same client: one request_token_batch a
        # distinct cluster name (lease-first too)
        t1 = time.perf_counter()
        bulk = app.check_batch([names[int(r)] for r in rng.choice(len(names), size=SHARD_BULK, p=zipf)])
        t_bulk = time.perf_counter() - t1
        bulk_mix = np.bincount([v for v, _w in bulk], minlength=7)
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        if unwatch is not None:
            unwatch()
        check(tok.flush_lease_refresh(10.0), "14a: a lease top-up did not drain")
        with lock:
            run_admits, run_leased = list(admits), dict(leased)
        series = {k: v - series0.get(k, 0) for k, v in shard_series().items()}
        out["full_collections"] = gc_pauses_since(t0)
        # -- the checks of the run.  Every decision an owner's column made
        # was for a flow the ring gives it; a param token past its owner
        # would find no rule there (param rules load on the owners alone)
        misrouted = sorted({(n, f) for n, f in answered if tok.owner_of(f) != n})[:10]
        check(answered and not misrouted, ("14a: an owner decided a flow the ring gives another (shard, flow)",
                                           misrouted))
        failed = [(m, round(ms, 1)) for m, ms, stt, _u in calls if stt == C.STATUS_FAIL]
        check(not failed, ("14a: token calls failed", failed[:20]))
        odd = sorted({stt for m, _ms, stt, _u in calls if m == "request_param_token"}
                     - {C.STATUS_OK, C.STATUS_BLOCKED, C.STATUS_SHOULD_WAIT})
        check(not odd, ("14a: a param token met no rule at the shard it reached", odd))
        # the port's own series agree with what the wrappers saw
        by = {kind: sum(v for (n, _sh), v in series.items() if n == kind) for kind in SHARD_SERIES}
        check(by["sentinel_lease_local_admits_total"] == len(run_admits)
              and by["sentinel_shard_lease_tokens_total"] == sum(run_leased.values()),
              ("14a: the shard series disagree with the admits and leases seen", by, len(run_admits),
               sum(run_leased.values())))
        check(not app._cluster_degraded_active, "14a: the serving client's cluster degrade engaged")
        # the owners' grants (tokens and leases) within each threshold in
        # every window of their own clock
        bad, worst = windows_within([(now, fid, g) for now, fid, g, _part in grants if fid in thr], 100, 10, thr)
        check(not bad, ("14a: an owner granted a flow past its threshold in a window", bad[:5]))
        # the client's admits: remote all-or-nothing grants (at the owner's
        # decision), lease-local admits and the bulk's partial grants (on the
        # owner's clock when the client saw them) within threshold + one lease
        flow_grants = [(now, fid, g) for now, fid, g, part in grants if not part and fid in thr]
        lease_units = {fid: tok._lease_units(fid) for fid in thr}
        bound = {fid: thr[fid] + lease_units[fid] for fid in thr}
        bad_c, worst_c = windows_within(flow_grants + admits + batch_grants, 100, 10, bound)
        check(not bad_c, ("14a: the client admitted a flow past its threshold plus one lease", bad_c[:5]))
        # every lease-local admit spends a unit an owner granted as a lease
        spent = {}
        for _now, fid, u in run_admits:
            spent[fid] = spent.get(fid, 0) + u
        over = [(fid, u, run_leased.get(fid, 0)) for fid, u in spent.items() if u > run_leased.get(fid, 0)]
        check(not over, ("14a: lease-local admits past the leased units (flow, admitted, leased)", over[:5]))
        n_tokens = sum(1 for m, *_r in entry_calls if m == "request_token")
        check(run_admits, "14a: no lease-first local admit")
        check(outcomes.get("pass", 0) > 0 and outcomes.get("FlowException", 0) + bulk_mix[ERR.BLOCK_FLOW] > 0,
              ("14a: the traffic met no flow deny", outcomes, bulk_mix.tolist()))
        if device == "cuda":
            for k in SHARD_KERNELS:
                check(launches[k] > 0, ("14a: a kernel of the path was not launched", k, launches))
        lat = [ms for m, ms, *_r in entry_calls if m == "request_token"]
        param_lat = [ms for m, ms, *_r in entry_calls if m == "request_param_token"]
        units = sum(u for m, _ms, stt, u in entry_calls if stt == C.STATUS_OK and m == "request_token")
        out.update(
            entries=entries * N_THREADS, entry_outcomes=outcomes, entries_s=t_entries, bulk_b=SHARD_BULK,
            bulk_s=t_bulk, bulk_mix=bulk_mix.tolist(), leased_units=by["sentinel_shard_lease_tokens_total"],
            tokens_per_s=units / t_entries, decisions=len(calls), token_calls=n_tokens, param_calls=len(param_lat),
            decision_p50_ms=_pct(lat, 0.5), decision_p99_ms=_pct(lat, 0.99),
            param_p50_ms=_pct(param_lat, 0.5), param_p99_ms=_pct(param_lat, 0.99),
            local_admits=n_entry_admits, local_admit_share=n_entry_admits / max(n_tokens, 1),
            lease_frames=lease_frames[0], lease_frames_per_1000=1e3 * lease_frames[0] / max(len(calls), 1),
            owner_grants=len(grants), window_worst_fill=worst, client_window_worst_fill=worst_c,
            kernel_launches_run=launches,
            routed_by_shard={n: series.get(("sentinel_shard_requests_total", n), 0) for n in fleet.names},
        )
        # -- kill the hottest flow's owner
        fid = flow[0].cluster_flow_id
        victim = tok.owner_of(fid)
        vst = tok._shards[victim]
        carry = 0
        for _ in range(3):
            # a standing lease to carry into the kill: the flow's next token
            # (remote once the last lease lapsed) re-leases it; a spent
            # window waits for the next one
            tok.request_token(fid)
            check(tok.flush_lease_refresh(10.0), "14a: a lease top-up did not drain")
            with vst.lock:
                lease = vst.leases.get(fid)
                carry = (max(lease.granted - lease.used, 0) if lease is not None
                         and SH.wall_ms_now() < lease.expires_ms else 0)
            if carry:
                break
            time.sleep(1.1)
        check(carry > 0, "14a: the hottest flow holds no lease to carry into the kill")
        exits0 = vst.c_exit.value
        t_kill = time.perf_counter()
        fleet.kill(victim)
        statuses, blip_kill, first_ms = [], None, None
        for _ in range(carry + 64):
            statuses.append(tok.request_token(fid).status)
            if first_ms is None:
                first_ms = (time.perf_counter() - t_kill) * 1e3
            if blip_kill is None and tok.shard_degraded(victim):
                blip_kill = (time.perf_counter() - t_kill) * 1e3
            if statuses[-1] == C.STATUS_BLOCKED and blip_kill is not None:
                break
        statuses += [tok.request_token(fid).status for _ in range(3)]
        first_block = statuses.index(C.STATUS_BLOCKED) if C.STATUS_BLOCKED in statuses else len(statuses)
        check(tok.shard_degraded(victim), "14a: the killed shard did not degrade")
        check(C.STATUS_FAIL not in statuses, ("14a: a killed shard's flow returned STATUS_FAIL", statuses))
        check(set(statuses[:first_block]) <= {C.STATUS_OK} and 1 <= first_block <= carry
              and set(statuses[first_block:]) == {C.STATUS_BLOCKED},
              ("14a: the killed shard's flow passed past its lease or did not block", carry, statuses))
        victim_res = flow[0].resource
        killed_entries = []
        for _ in range(4):
            try:
                app.entry(victim_res).exit()
                killed_entries.append("pass")
            except ERR.BlockException as e:
                killed_entries.append(type(e).__name__)
        check(set(killed_entries) == {"FlowException"} and not app._cluster_degraded_active,
              ("14a: entries on the killed shard's flow did not fail closed through the fleet", killed_entries))
        others = {}
        for name in fleet.names:
            if name == victim:
                continue
            ofid = next(r.cluster_flow_id for r in flow if tok.owner_of(r.cluster_flow_id) == name)
            req0 = tok._shards[name].c_requests.value
            r = tok.request_lease(ofid, 1)  # always routed: a remote answer
            others[name] = dict(status=r.status, routed=tok._shards[name].c_requests.value - req0)
            check(r.status in (C.STATUS_OK, C.STATUS_BLOCKED) and not tok.shard_degraded(name)
                  and others[name]["routed"] == 1, ("14a: a live shard did not answer remotely", name, others))
        ms, status, body = http_call(f"http://127.0.0.1:{center.port}/api/shards")
        listed = json.loads(body)
        ports = {f"127.0.0.1:{p}" for p in fleet._ports.values()}
        views = [[(s_["name"], s_["degraded"]) for s_ in d["shards"]] for d in listed
                 if {s_["addr"] for s_ in d["shards"]} == ports]
        check(status == 200 and [(victim, True)] in [[x for x in v if x[1]] for v in views]
              and all(len(v) == SHARDS for v in views),
              ("14a: api/shards did not list four shards with the killed one degraded", listed))
        out["api_shards"] = dict(ms=ms, fleets=len(listed), degraded=[x[0] for v in views for x in v if x[1]])
        # -- rejoin: the first probe after the cooldown exits, remote answers resume
        t_rejoin = time.perf_counter()
        fleet.rejoin(victim)
        while tok.shard_degraded(victim) and time.perf_counter() - t_rejoin < 30:
            tok.request_token(fid)
            time.sleep(0.01)
        blip_rejoin = (time.perf_counter() - t_rejoin) * 1e3
        check(not tok.shard_degraded(victim) and vst.c_exit.value - exits0 == 1,
              "14a: the rejoined shard did not exit degraded")
        req0 = vst.c_requests.value
        r = tok.request_lease(fid, 1)
        check(r.status in (C.STATUS_OK, C.STATUS_BLOCKED) and vst.c_requests.value - req0 == 1,
              ("14a: the rejoined shard gave no remote answer", r))
        out.update(victim=victim, victim_flow=fid, carry_at_kill=carry, killed_statuses=statuses,
                   killed_entries=killed_entries, other_shards=others, first_after_kill_ms=first_ms, blip_kill_ms=blip_kill,
                   blip_rejoin_ms=blip_rejoin, retry_interval_s=SHARD_RETRY_S)
        if box is not None:
            out["plain_check"] = replay_against_plain(np, E, S, FU, SC, torch, box, SHARD_KERNELS, "14a")
        out["bench"] = shard_bench_rows(st, made)
        return out
    finally:
        if center is not None:
            center.stop()
        if mgr is not None:
            mgr.stop()
        fleet.stop()
        for svc in fleet.services.values():
            svc.close()
        if app is not None:
            app.stop()
        for c in made:
            c.stop()


def shard_bench_rows(st, decision_clients) -> list:
    """bench.py's cluster_sharded_bench (bench.py:615-700) on the card: 16
    flows at count 1e9 (routing, not admission) behind 1 and 4 shards (new
    token services on the fleet's decision clients), 2,000 requests from 8
    workers through the fleet's own client: decisions/s, p50 / p99 ms."""
    from concurrent.futures import ThreadPoolExecutor

    from sentinel_tpu_torch.cluster import constants as C
    from sentinel_tpu_torch.cluster import shard as SH

    n_flows, n_requests, workers = SHARD_BENCH
    flows = list(range(1001, 1001 + n_flows))
    rows = []
    for n_shards in (1, 4):
        it = iter(decision_clients)
        fleet = SH.ShardFleet(lambda: next(it), n_shards=n_shards, lease_slack=0.25, retry_interval_s=300.0,
                              lease_ttl_ms=600_000, timeout_ms=5000, reconnect_interval_s=0.0, warm=False)
        try:
            fleet.load_flow_rules("default", [st.FlowRule(resource=f"res-{f}", count=1e9, cluster_mode=True,
                                                          cluster_flow_id=f, cluster_threshold_type=1)
                                              for f in flows])
            wait_v3([s.client for s in fleet.client._shards.values()])
            for f in flows:  # connections and leases off the clock
                fleet.client.request_token(f)
            lat = []

            def one(i):
                t0 = time.perf_counter()
                r = fleet.client.request_token(flows[i % n_flows])
                lat.append((time.perf_counter() - t0) * 1e3)
                return r.status

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=workers) as pool:
                statuses = list(pool.map(one, range(n_requests)))
            wall = time.perf_counter() - t0
            rows.append(dict(shards=n_shards, dps=n_requests / wall, decision_p50_ms=_pct(lat, 0.5),
                             decision_p99_ms=_pct(lat, 0.99),
                             non_ok=sum(1 for s_ in statuses if s_ != C.STATUS_OK)))
            check(rows[-1]["non_ok"] == 0, ("14a: cluster_sharded_bench met a non-OK decision", rows[-1]))
        finally:
            fleet.stop()
            for svc in fleet.services.values():
                svc.close()
    return rows


def shard_replay(np, st, clients) -> list:
    """A seeded token sequence through a 2-shard fleet on ``clients`` (sync,
    virtual time): single and batch tokens, many-flow asks (each flow once),
    param tokens, concurrent acquire / release and leases over 8 GLOBAL
    flows, shard-0 killed at one operation and rejoined at a later one;
    top-ups inline.  Returns every result as (status, remaining, wait_ms,
    deny provenance)."""
    from sentinel_tpu_torch.cluster import shard as SH

    rng = np.random.default_rng(SEED + 142)
    counts = [int(c) for c in rng.integers(3, 30, size=REPLAY_FLOWS)]
    plan = []
    for _ in range(REPLAY_OPS):
        k = int(rng.integers(7))
        many = rng.choice(REPLAY_FLOWS, size=int(rng.integers(1, 5)), replace=False)
        plan.append((k, int(rng.integers(REPLAY_FLOWS)), int(rng.integers(1, 4)), bool(rng.random() < 0.2),
                     [(int(a), int(rng.integers(1, 3))) for a in many], f"u{int(rng.integers(3))}"))
    it = iter(clients)
    fleet = SH.ShardFleet(lambda: next(it), n_shards=2, lease_slack=0.5, retry_interval_s=300.0,
                          lease_ttl_ms=600_000, timeout_ms=10_000, reconnect_interval_s=0.0,
                          lease_refresh_async=False)
    try:
        tok = fleet.client
        wait_v3([s.client for s in tok._shards.values()])
        fids = [next(f for f in range(101 + 50 * i, 2_000) if tok.owner_of(f) == f"shard-{i % 2}")
                for i in range(REPLAY_FLOWS)]
        fleet.load_flow_rules("default", [st.FlowRule(resource=f"res-{f}", count=float(c), cluster_mode=True,
                                                      cluster_flow_id=f, cluster_threshold_type=1)
                                          for f, c in zip(fids, counts)])
        for name in fleet.names:
            fleet.services[name].param_rules.load("default", [
                st.ParamFlowRule(resource=f"res-{f}", count=2, cluster_mode=True, cluster_flow_id=f)
                for f in fids if tok.owner_of(f) == name])

        def res(r):
            return [r.status, r.remaining, r.wait_ms, r.prov_kind, r.prov_rule, r.prov_observed, r.prov_limit]

        held, out = [], []
        for i, (k, j, n, prio, many, value) in enumerate(plan):
            if i == REPLAY_KILL_AT:
                fleet.kill("shard-0")
                time.sleep(0.2)
            if i == REPLAY_HEAL_AT:
                fleet.rejoin("shard-0")
                sst = tok._shards["shard-0"]
                check(sst.client._ensure_connected(), "14a replay: no reconnect to the rejoined shard")
                wait_v3([sst.client])
                with sst.lock:
                    sst.degraded_until = 0.0
            fid = fids[j]
            if k == 0:
                out.append(res(tok.request_token(fid, n, prio)))
            elif k == 1:
                out.append(res(tok.request_token_batch(fid, n)))
            elif k == 2:
                out.append([res(r) for r in tok.request_token_many([(fids[a], b) for a, b in many])])
            elif k == 3:
                out.append(res(tok.request_param_token(fid, 1, [value])))
            elif k == 4:
                r = tok.request_concurrent_token(fid)
                if r.ok:
                    held.append(r.token_id)
                out.append(res(r) + [r.token_id >> 48])
            elif k == 5 and held:
                out.append(res(tok.release_concurrent_token(held.pop(0))))
            else:
                out.append(res(tok.request_lease(fid, n)))
        return out
    finally:
        fleet.stop()
        for svc in fleet.services.values():
            svc.close()


def router_rules(st):
    """Flow rules on the router's names, each on its owning host of two:
    counts 5..44."""
    from sentinel_tpu_torch.parallel.router import shard_of

    per = [[], []]
    for i in range(ROUTER_NAMES):
        name = f"rres-{i}"
        per[shard_of(name, 2)].append(st.FlowRule(resource=name, count=5 + i % 40))
    return per


def router_batches(np) -> list:
    """ROUTER_BATCHES mixed batches of ROUTER_B names, Zipf(1.1) over the
    router's names (one unit an entry: a tick's rank and a chunk's agree)."""
    rng = np.random.default_rng(SEED + 143)
    p = zipf_probs(np, ROUTER_NAMES)
    return [[f"rres-{int(i)}" for i in rng.choice(ROUTER_NAMES, size=ROUTER_B, p=p)] for _ in range(ROUTER_BATCHES)]


def inprocess_router_run(np, st, clients) -> list:
    """The router's batches over in-process clients (sync, virtual time; 300
    ms between batches); before ROUTER_DOWN_AT's batch host 1 is down (its
    spans fail closed, BLOCK_SYSTEM)."""
    from sentinel_tpu_torch.parallel.router import ShardRouter

    for c, rules in zip(clients, router_rules(st)):
        c.flow_rules.load(rules)
    up, down = ShardRouter(clients), ShardRouter([clients[0], ShardDown()])
    out = []
    for b, names in enumerate(router_batches(np)):
        out.append([[int(v), int(w)] for v, w in (down if b == ROUTER_DOWN_AT else up).check_batch(names)])
        for c in clients:
            c.time.advance(300)
    return out


def shards_router_run(np, st, FU, SC, torch, device="cuda", cfg=None) -> dict:
    """14b: a ShardRouter over two RemoteShards on in-process token servers
    (one worker each: a host answers its chunks in order) whose host
    clients run ``cfg`` on ``device``; host 1's server stops before batch
    ROUTER_DOWN_AT and restarts after it."""
    from sentinel_tpu_torch import obs
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.obs.registry import REGISTRY
    from sentinel_tpu_torch.parallel.remote_shard import RemoteShard
    from sentinel_tpu_torch.parallel.router import ShardRouter

    cfg = cfg or platform_config()
    hosts = [sync_client(st, device, cfg) for _ in range(2)]
    for c, rules in zip(hosts, router_rules(st)):
        c.flow_rules.load(rules)
    svcs = [DefaultTokenService(c) for c in hosts]
    servers = [ClusterTokenServer(s, host="127.0.0.1", port=0, workers=1) for s in svcs]
    for s in servers:
        s.start()
    processed = [0, 0]
    for k, c in enumerate(hosts):
        real = c.check_batch

        def counted(names, *a, _real=real, _k=k, **kw):
            processed[_k] += len(names)
            return _real(names, *a, **kw)

        c.check_batch = counted
    shards = [RemoteShard("127.0.0.1", s.port, timeout_s=30.0, fallback=ShardDown(), retry_interval_s=SHARD_RETRY_S)
              for s in servers]
    router = ShardRouter(shards, on_shard_error="block")
    fail_key = 'sentinel_shard_route_failures_total{kind="io",shard="1"}'
    fails0 = REGISTRY.snapshot().get(fail_key, 0)
    out, verdicts, times = {}, [], []
    try:
        FU.reset_launches()
        SC.reset_launches()
        obs.TRACER.reset()
        obs.enable()
        try:
            for b, names in enumerate(router_batches(np)):
                if b == ROUTER_DOWN_AT:
                    port1 = servers[1].port
                    servers[1].stop()
                t0 = time.perf_counter()
                verdicts.append([[int(v), int(w)] for v, w in router.check_batch(names)])
                times.append(time.perf_counter() - t0)
                for c in hosts:
                    c.time.advance(300)
                if b == ROUTER_DOWN_AT:
                    servers[1] = ClusterTokenServer(svcs[1], host="127.0.0.1", port=port1, workers=1)
                    servers[1].start()
                    t_up = time.perf_counter()
                    time.sleep(SHARD_RETRY_S)
            spans = obs.summarize(obs.TRACER.snapshot(), prefix="shard.")
        finally:
            obs.disable()
            obs.TRACER.reset()
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        owner = [[router._owner(x) for x in names] for names in router_batches(np)]
        down = [v for v, o in zip(verdicts[ROUTER_DOWN_AT], owner[ROUTER_DOWN_AT]) if o == 1]
        check(set(v for v, _w in down) == {ERR.BLOCK_SYSTEM},
              ("14b: the stopped host's spans did not fail closed", sorted(set(v for v, _w in down))))
        after = [v for v, o in zip(verdicts[-1], owner[-1]) if o == 1]
        check(ERR.BLOCK_SYSTEM not in {v for v, _w in after} and not shards[1]._hy.active,
              "14b: the restarted host was not served again after retry_interval_s")
        remote_items = [sum(1 for b, names in enumerate(owner) for o in names if o == k and
                            not (k == 1 and b == ROUTER_DOWN_AT)) for k in range(2)]
        check(processed == remote_items, ("14b: a host answered an item twice or missed one", processed,
                                          remote_items))
        fails = REGISTRY.snapshot().get(fail_key, 0) - fails0
        check(fails == 1, ("14b: the stopped host's leg was not counted once as an io route failure", fails))
        if device == "cuda":
            for k in SHARD_KERNELS:
                check(launches[k] > 0, ("14b: a kernel of the hosts' ticks was not launched", k, launches))
        chunk = spans.get("shard.chunk", {})
        served = [t for b, t in enumerate(times) if b != ROUTER_DOWN_AT]
        out.update(verdicts=verdicts, batches=ROUTER_BATCHES, batch=ROUTER_B,
                   decisions_per_s=ROUTER_B * len(served) / sum(served), batch_s=times,
                   chunk_p50_ms=chunk.get("p50_ms"), chunk_p99_ms=chunk.get("p99_ms"), chunks=chunk.get("count"),
                   host_items=processed, route_failures=fails, kernel_launches=launches,
                   restart_to_batch_s=time.perf_counter() - t_up if ROUTER_DOWN_AT < ROUTER_BATCHES - 1 else None)
        return out
    finally:
        for s in shards:
            s.close()
        for s in servers:
            s.stop()
        for s in svcs:
            s.close()
        for c in hosts:
            c.stop()


def shards_router_threaded_run(np, st, FU, SC, torch, device="cuda", cfg=None) -> dict:
    """14b's second pass: the router over two RemoteShards on token servers
    at their default worker count, whose threaded host clients run ``cfg``
    on ``device``: a connection's pipelined chunks decide on the server's
    workers and their answers come back in any order.  A name's verdict is
    fixed by its rule (count 0 or 1e9), so every item must get its own;
    no chunk degrades, and each host decides each of its items once."""
    from sentinel_tpu_torch import obs
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.obs.registry import REGISTRY
    from sentinel_tpu_torch.parallel.remote_shard import RemoteShard
    from sentinel_tpu_torch.parallel.router import ShardRouter, shard_of

    cfg = cfg or platform_config()
    workers = inspect.signature(ClusterTokenServer).parameters["workers"].default
    want, per = {}, [[], []]
    for i in range(ROUTER_NAMES):
        name = f"rres-{i}"
        blocked = i % ROUTER_BLOCK_EVERY == 0
        want[name] = ERR.BLOCK_FLOW if blocked else ERR.PASS
        per[shard_of(name, 2)].append(st.FlowRule(resource=name, count=0 if blocked else 1e9))
    rng = np.random.default_rng(SEED + 144)
    p = zipf_probs(np, ROUTER_NAMES)
    batches = [[f"rres-{int(i)}" for i in rng.choice(ROUTER_NAMES, size=ROUTER_B, p=p)]
               for _ in range(ROUTER_THREADED_BATCHES + 1)]
    hosts, svcs, servers, shards = [], [], [], []
    try:
        for rules in per:
            c = st.SentinelClient(cfg=cfg, mode="threaded", device=device)
            c.start()
            hosts.append(c)
            c.flow_rules.load(rules)
        processed = [0, 0]
        for k, c in enumerate(hosts):
            real = c.check_batch

            def counted(names, *a, _real=real, _k=k, **kw):
                processed[_k] += len(names)
                return _real(names, *a, **kw)

            c.check_batch = counted
        svcs = [DefaultTokenService(c) for c in hosts]
        servers = [ClusterTokenServer(s, host="127.0.0.1", port=0) for s in svcs]
        for s in servers:
            s.start()
        shards = [RemoteShard("127.0.0.1", s.port, timeout_s=30.0, fallback=ShardDown(),
                              retry_interval_s=SHARD_RETRY_S) for s in servers]
        router = ShardRouter(shards, on_shard_error="block")
        router.check_batch(batches[0])  # connections and HELLO off the clock
        degraded_key = "sentinel_shard_chunks_degraded_total"
        degraded0 = REGISTRY.snapshot().get(degraded_key, 0)
        processed[:] = [0, 0]
        wrong, times = [], []
        FU.reset_launches()
        SC.reset_launches()
        obs.TRACER.reset()
        obs.enable()
        try:
            for names in batches[1:]:
                t0 = time.perf_counter()
                got = router.check_batch(names)
                times.append(time.perf_counter() - t0)
                wrong += [(b, v, w) for b, (v, w) in zip(names, got) if v != want[b] or w != 0][:5]
            spans = obs.summarize(obs.TRACER.snapshot(), prefix="shard.")
        finally:
            obs.disable()
            obs.TRACER.reset()
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        degraded = REGISTRY.snapshot().get(degraded_key, 0) - degraded0
        check(not wrong, ("14b: an item got another item's verdict through a threaded host (name, verdict, wait)",
                          wrong[:10]))
        check(degraded == 0, ("14b: chunks degraded through a threaded host", degraded))
        items = [sum(1 for names in batches[1:] for x in names if router._owner(x) == k) for k in range(2)]
        check(processed == items, ("14b: a threaded host decided an item twice or missed one", processed, items))
        if device == "cuda":
            for k in SHARD_KERNELS:
                check(launches[k] > 0, ("14b: a kernel of the threaded hosts' ticks was not launched", k, launches))
        chunk = spans.get("shard.chunk", {})
        return dict(batches=len(times), batch=ROUTER_B, workers=workers,
                    decisions_per_s=ROUTER_B * len(times) / sum(times), batch_s=times,
                    chunk_p50_ms=chunk.get("p50_ms"), chunk_p99_ms=chunk.get("p99_ms"), chunks=chunk.get("count"),
                    host_items=processed, kernel_launches=launches)
    finally:
        for s in shards:
            s.close()
        for s in servers:
            s.stop()
        for s in svcs:
            s.close()
        for c in hosts:
            c.stop()


def shards_cpu_main() -> int:
    """``python3 chip_smoke.py --shards-cpu``: 14's CPU side, in a process of
    its own: the router's batches over in-process CPU clients at the
    default widths, then the sync replay on a CPU fleet over the same two
    clients; one JSON line."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core.config import platform_config

    t = time.perf_counter()
    clients = [sync_client(st, "cpu", platform_config()) for _ in range(2)]
    try:
        verdicts = inprocess_router_run(np, st, clients)
        replay = shard_replay(np, st, clients)
    finally:
        for c in clients:
            c.stop()
    print(json.dumps(dict(router=verdicts, replay=replay, wall_s=time.perf_counter() - t)), flush=True)
    return 0


def shards_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 14: (a) the 4-shard token fleet under a serving client on the
    card, the kill and the rejoin, the bench row, the sync replay against
    the CPU; (b) the shard router over two remote hosts on the card against
    in-process card clients and the CPU."""
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.ops import engine as E

    t_phase = time.perf_counter()
    env = child_env()
    cpu = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--shards-cpu"], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rep = {"card": smi}
    try:
        t = time.perf_counter()
        rep["serving"] = shards_serving_run(np, st, FU, SC, E, S, torch)
        rep["serving_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rep["router"] = shards_router_run(np, st, FU, SC, torch)
        rep["router_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rep["router_threaded"] = shards_router_threaded_run(np, st, FU, SC, torch)
        rep["router_threaded_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        clients = [sync_client(st, "cuda", platform_config()) for _ in range(2)]
        try:
            local = inprocess_router_run(np, st, clients)
            replay = shard_replay(np, st, clients)
        finally:
            for c in clients:
                c.stop()
        rep["inprocess_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        check(rep["router"]["verdicts"] == local,
              "14b: the remote router's verdicts differ from the in-process card router's")
        t = time.perf_counter()
        out, err = cpu.communicate(timeout=900)
        check(cpu.returncode == 0, f"phase 14: the CPU run failed: {err[-2000:]}")
        got = json.loads(out.strip().splitlines()[-1])
        rep["cpu"] = dict(wall_s=got["wall_s"], wait_s=time.perf_counter() - t)
        check(got["router"] == local, "14b: the card router's verdicts differ from the CPU's")
        check(got["replay"] == replay, "14a: the card fleet's sync replay differs from the CPU fleet's")
        rep["replay"] = dict(ops=len(replay), statuses={
            str(s_): sum(1 for r in replay for x in (r if isinstance(r[0], list) else [r]) if x[0] == s_)
            for s_ in sorted({x[0] for r in replay for x in (r if isinstance(r[0], list) else [r])})})
        mix = np.bincount([v for batch in local for v, _w in batch], minlength=7)
        rep["router"]["verdict_mix"] = mix.tolist()
        del rep["router"]["verdicts"]
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    rep["phase_s"] = time.perf_counter() - t_phase
    shards_log(rep)
    return rep


def shards_log(rep) -> None:
    smi, sv, ro = rep["card"], rep["serving"], rep["router"]
    log(f"[shards] {smi}: 14a fleet of {SHARDS} shards built in {sv['fleet_build_s']:.1f} s; {sv['entries']} entry() "
        f"calls from {N_THREADS} threads in {sv['entries_s']:.2f} s ({sv['tokens_per_s']:.0f} tokens/s), outcomes "
        f"{json.dumps(sv['entry_outcomes'], sort_keys=True)}; one check_batch(B={sv['bulk_b']}) in {sv['bulk_s']:.2f} s, "
        f"mix {sv['bulk_mix']}; flow-token decisions p50 {sv['decision_p50_ms']:.3f} ms, p99 "
        f"{sv['decision_p99_ms']:.3f} ms over {sv['token_calls']} calls (param tokens p50 {sv['param_p50_ms']:.3f}, "
        f"p99 {sv['param_p99_ms']:.3f} over {sv['param_calls']}); "
        f"local admits {sv['local_admits']} of {sv['token_calls']} flow tokens (share {sv['local_admit_share']:.3f}; "
        f"{sv['leased_units']} units leased); "
        f"{sv['lease_frames']} lease frames ({sv['lease_frames_per_1000']:.1f} per 1,000 decisions); routed "
        f"(sentinel_shard_requests_total) {json.dumps(sv['routed_by_shard'], sort_keys=True)}, every owner's "
        f"decision on a flow of its own; owners' grants "
        f"{sv['owner_grants']}, fullest window {sv['window_worst_fill']:.3f} of its threshold; the client's "
        f"admits, fullest window {sv['client_window_worst_fill']:.3f} of threshold + one lease; launches in the run "
        f"(every client) {json.dumps(sv['kernel_launches_run'])}; full collections in it {json.dumps(sv['full_collections'])}")
    log(f"[shards] {smi}: 14a kill {sv['victim']} (flow {sv['victim_flow']}, lease carry {sv['carry_at_kill']}): "
        f"first decision {sv['first_after_kill_ms']:.2f} ms after the kill (lease-local), the first lease-fallback "
        f"decision (degraded) {sv['blip_kill_ms']:.1f} ms after it; statuses {sv['killed_statuses']}; "
        f"entries {sv['killed_entries']}; other shards {json.dumps(sv['other_shards'], sort_keys=True)}; api/shards "
        f"{sv['api_shards']['ms']:.1f} ms, degraded {sv['api_shards']['degraded']}; rejoin -> first remote answer "
        f"{sv['blip_rejoin_ms']:.1f} ms (cooldown {sv['retry_interval_s']} s)")
    if "plain_check" in sv:
        r = sv["plain_check"]
        log(f"[shards] {smi}: 14a a serving tick (B={r['batch']}) against its plain versions: wire and state equal; "
            f"profile kernels {json.dumps(r['profile_kernels'])}")
    for row in sv["bench"]:
        log(f"[shards] {smi}: cluster_sharded_bench {row['shards']} shard(s): {row['dps']:.0f} decisions/s, p50 "
            f"{row['decision_p50_ms']:.3f} ms, p99 {row['decision_p99_ms']:.3f} ms, non-OK {row['non_ok']}")
    log(f"[shards] {smi}: 14a sync replay on virtual time, {rep['replay']['ops']} operations with a kill and a "
        f"rejoin: the card fleet == the CPU fleet, statuses {json.dumps(rep['replay']['statuses'])}")
    rt = rep["router_threaded"]
    log(f"[shards] {smi}: 14b router over 2 remote hosts at the server's default {rt['workers']} workers "
        f"(threaded host clients, answers in any order), {rt['batches']} batches of {rt['batch']}: "
        f"{rt['decisions_per_s']:.0f} decisions/s (batch s {[round(x, 3) for x in rt['batch_s']]}), chunk p50 "
        f"{rt['chunk_p50_ms']} ms p99 {rt['chunk_p99_ms']} ms over {rt['chunks']} chunks; every item its own "
        f"verdict, no chunk degraded, host items {rt['host_items']} (each once); launches "
        f"{json.dumps(rt['kernel_launches'])}")
    log(f"[shards] {smi}: 14b router over 2 remote one-worker hosts (sync, virtual time: the CPU comparison), "
        f"{ro['batches']} batches of {ro['batch']}: "
        f"{ro['decisions_per_s']:.0f} decisions/s (batch s {[round(x, 3) for x in ro['batch_s']]}), chunk p50 "
        f"{ro['chunk_p50_ms']} ms p99 {ro['chunk_p99_ms']} ms over {ro['chunks']} chunks; verdicts == in-process card "
        f"router == CPU, mix {ro['verdict_mix']}; host 1 stopped for batch {ROUTER_DOWN_AT}: its spans BLOCK_SYSTEM, "
        f"route failures {ro['route_failures']}, host items {ro['host_items']} (each once); served again "
        f"{SHARD_RETRY_S} s after the restart; launches {json.dumps(ro['kernel_launches'])}")
    log(f"[shards] {smi}: phase 14 took {rep['phase_s']:.1f} s (serving {rep['serving_s']:.1f}, router "
        f"{rep['router_s']:.1f}, router at default workers {rep['router_threaded_s']:.1f}, in-process + replay {rep['inprocess_s']:.1f}; the CPU run {rep['cpu']['wall_s']:.1f} s, "
        f"waited {rep['cpu']['wait_s']:.1f} s for it)")


def shards_main() -> int:
    """``python3 chip_smoke.py --shards``: the kernels' build and phase 14
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
    rep = shards_phase(np, st, S, FU, SC, torch, nvidia_smi())
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


# -- phase 15: the chaos plane, the lock witness and the trace CLI --------------------------

#: the chaos plan seed phase 15 runs every scenario at (the CLI's default)
CHAOS_SEED = 7
#: 15b: seconds of 8-thread traffic in each of the unwitnessed and witnessed runs
WITNESS_S = 4.0
#: 15b: the contention the witnessed run injects: a delay at every 64th
#: witnessed acquisition (``runtime.lock.contend``, armed in both runs: it
#: fires only at witnessed locks)
CONTEND = dict(every_nth=64, delay_ms=0.2)
#: 15c: token requests whose client and server spans --merge links
MERGE_TOKENS = 16


def scenario_view(r) -> dict:
    """What 15a holds between the card and the CPU: the injected counts,
    the verdict and every invariant (name, ok, detail)."""
    return dict(ok=r.ok, injected=r.injected, invariants=[[v.name, v.ok, v.detail] for v in r.verdicts])


def chaos_cpu_main() -> int:
    """``python3 chip_smoke.py --chaos-cpu``: every chaos scenario at the
    phase's seed on the CPU (phase 15a's comparison), one JSON line."""
    import torch

    torch.set_num_threads(3)
    sys.path.insert(0, ROOT)
    from sentinel_tpu_torch.chaos import runner as CR

    t = time.perf_counter()
    out = {r.name: scenario_view(r) for r in CR.run_all(CHAOS_SEED, device="cpu")}
    print(json.dumps(dict(scenarios=out, wall_s=time.perf_counter() - t)), flush=True)
    return 0


def storm_run(FU, SC, install, fns) -> dict:
    """``seg_overflow_storm`` on the card with ``fns`` (the kernels or their
    plain versions) installed: its result, the verdicts and waits of both
    storms (the client's ``check_batch_ids`` answers), the seg drops it
    counted and the kernel launches."""
    from sentinel_tpu_torch.chaos import runner as CR
    from sentinel_tpu_torch.obs.registry import REGISTRY
    from sentinel_tpu_torch.runtime.client import SentinelClient

    real_check = SentinelClient.check_batch_ids
    answers = []

    def spy(self, *a, **kw):
        v, w = real_check(self, *a, **kw)
        answers.append([v.tolist(), w.tolist()])
        return v, w

    drops = REGISTRY.get("sentinel_seg_dropped_total")
    d0 = drops.value
    install(fns)
    SentinelClient.check_batch_ids = spy
    FU.reset_launches()
    SC.reset_launches()
    try:
        t = time.perf_counter()
        r = CR.run_scenario("seg_overflow_storm", CHAOS_SEED, "cuda")
        wall = time.perf_counter() - t
    finally:
        SentinelClient.check_batch_ids = real_check
    return dict(result=scenario_view(r), answers=answers, seg_drops=drops.value - d0, launches=dict(FU.LAUNCHES, **SC.LAUNCHES),
                s=wall)


def chaos_scenarios(np, st, FU, SC, torch) -> dict:
    """15a: every scenario (all eleven) on the card at the seed, each green
    and with the CPU's injected counts; ``seg_overflow_storm`` again with
    the kernels and with their plain versions (equal verdicts and drops);
    the fast set a second time (the determinism check)."""
    from sentinel_tpu_torch.chaos import runner as CR

    env = child_env()
    cpu = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--chaos-cpu"], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rep = {}
    try:
        first, rows = {}, {}
        for name, scn in CR.SCENARIOS.items():
            FU.reset_launches()
            SC.reset_launches()
            t = time.perf_counter()
            r = CR.run_scenario(name, CHAOS_SEED, "cuda")
            rows[name] = dict(s=time.perf_counter() - t, fast=scn.fast, injected=r.injected,
                              launches=dict(FU.LAUNCHES, **SC.LAUNCHES))
            first[name] = scenario_view(r)
            check(r.ok, f"15a: {name} is red on the card: {CR.report([r])}")
            torch.cuda.empty_cache()
        real, plain, install = kernel_sets(FU, SC)
        storms = {}
        try:
            for label, fns in (("kernels", real), ("plain", plain)):
                storms[label] = storm_run(FU, SC, install, fns)
        finally:
            install(real)
        k, p = storms["kernels"], storms["plain"]
        check(k["result"]["ok"] and p["result"]["ok"], ("15a: seg_overflow_storm red", k["result"], p["result"]))
        check(len(k["answers"]) == 2 and k["answers"] == p["answers"],
              "15a: seg_overflow_storm's verdicts with the kernels differ from those with the plain versions")
        check(k["seg_drops"] == p["seg_drops"] > 0, ("15a: seg drops differ", k["seg_drops"], p["seg_drops"]))
        check(all(k["launches"][x] > 0 for x in ("scatter_many", "seg_incl_min")),
              ("15a: the storm launched no B1 / B4", k["launches"]))
        check(not any(p["launches"].values()), ("15a: the plain-version storm launched a kernel", p["launches"]))
        t = time.perf_counter()
        again = {r.name: r for r in CR.run_all(CHAOS_SEED, fast_only=True, device="cuda")}
        rep["determinism_s"] = time.perf_counter() - t
        fast = [n for n, s in CR.SCENARIOS.items() if s.fast]
        check(sorted(again) == sorted(fast), ("15a: the fast set", sorted(again)))
        for name, r in again.items():
            check(r.ok, f"15a: {name} is red in the second pass: {CR.report([r])}")
            check(r.injected == first[name]["injected"],
                  ("15a: DETERMINISM VIOLATION", name, r.injected, first[name]["injected"]))
        t = time.perf_counter()
        out, err = cpu.communicate(timeout=600)
        check(cpu.returncode == 0, f"15a: the CPU run failed: {err[-2000:]}")
        got = json.loads(out.strip().splitlines()[-1])
        rep["cpu"] = dict(wall_s=got["wall_s"], wait_s=time.perf_counter() - t)
        for name in CR.SCENARIOS:
            mine, cpu_r = first[name], got["scenarios"][name]
            check(cpu_r["ok"], f"15a: {name} is red on the CPU")
            check(mine["injected"] == cpu_r["injected"], ("15a: injected differs from the CPU's", name,
                                                          mine["injected"], cpu_r["injected"]))
            rows[name]["details_unlike_cpu"] = [a[0] for a, b in zip(mine["invariants"], cpu_r["invariants"]) if a != b]
        rep["scenarios"] = rows
        rep["storm"] = {label: dict(seg_drops=v["seg_drops"], launches=v["launches"], s=v["s"],
                                    verdicts=[np.bincount(a[0], minlength=7).tolist() for a in v["answers"]])
                        for label, v in storms.items()}
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    return rep


def witness_traffic(np, st, client, names, stop, counts, lock, futures, tok, seed):
    """One 15b request thread: Zipf(1.1) entries over the names with one
    argument; every 32nd an asynchronous acquire whose future is kept; every
    16th a token request on the token client; every outcome counted."""
    probs, vprobs = zipf_probs(np, len(names)), zipf_probs(np, N_VALUES)
    rng = np.random.default_rng(seed)
    local, mine, i = {}, [], 0
    while not stop.is_set():
        picks = rng.choice(len(names), size=64, p=probs)
        values = rng.choice(N_VALUES, size=64, p=vprobs)
        for k, v in zip(picks, values):
            i += 1
            if i % 32 == 0:
                mine.append(client.submit_acquire(names[k]))
                kind = "submitted"
            else:
                try:
                    client.entry(names[k], args=[arg_value(v)]).exit()
                    kind = "pass"
                except st.BlockException:
                    kind = "blocked"
                except Exception as exc:  # counted: the accounting invariant fails on any
                    kind = f"lost:{type(exc).__name__}"
            if i % 16 == 0:
                local["token"] = local.get("token", 0) + 1
                tok.request_token(101)
            local[kind] = local.get(kind, 0) + 1
            if stop.is_set():
                break
    with lock:
        futures.extend(mine)
        for k, v in local.items():
            counts[k] = counts.get(k, 0) + v


def witness_run(np, st, FU, SC, torch, witnessed: bool, device="cuda", cfg=None, seconds=WITNESS_S) -> dict:
    """15b's run: a threaded serving client (``platform_config()`` at the
    default widths, phase 9's rules; a fleet of two shards joined by
    ``set_to_sharded_client`` for its cluster rules) beside a token server
    and client pair, under 8 request threads for ``seconds`` with
    ``runtime.lock.contend`` armed; with ``witnessed`` the lock witness is
    installed before anything is built.  The four invariants judge it."""
    from sentinel_tpu_torch.analysis.concurrency import witness as W
    from sentinel_tpu_torch.chaos import failpoints as FP
    from sentinel_tpu_torch.chaos.invariants import MetricsDelta, ScenarioContext, evaluate
    from sentinel_tpu_torch.chaos.plans import FaultPlan, FaultSpec
    from sentinel_tpu_torch.chaos.runner import _make_client, _make_token_server
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.shard import ShardFleet
    from sentinel_tpu_torch.cluster.state import ClusterStateManager
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.obs.registry import REGISTRY
    from sentinel_tpu_torch.runtime.client import SentinelClient

    rep = {}
    made, closers = [], []
    if witnessed:
        t = time.perf_counter()
        rep["witness_sites"] = W.install()
        W.reset()
        rep["install_s"] = time.perf_counter() - t
    try:
        decision, svc, server = _make_token_server(device, flow_count=1e9)
        closers += [server.stop, decision.stop]
        tok = ClusterTokenClient("127.0.0.1", server.port, timeout_ms=5000)
        tok.start()
        closers.insert(0, tok.close)

        def factory():
            c = _make_client(device)
            made.append(c)
            return c

        fleet = ShardFleet(factory, n_shards=2, retry_interval_s=300.0, reconnect_interval_s=0.0)
        closers.insert(0, lambda: [c.stop() for c in made])
        closers.insert(0, fleet.stop)
        cflow = [st.FlowRule(resource=f"cres-{k}", count=1e9, cluster_mode=True, cluster_flow_id=500 + k,
                             cluster_threshold_type=1) for k in range(8)]
        fleet.load_flow_rules("default", cflow)
        mgr = ClusterStateManager()
        mgr.set_to_sharded_client({n: ("127.0.0.1", p) for n, p in fleet._ports.items()})
        mgr.token_service().flow_rules.load("default", cflow)
        closers.insert(0, mgr.stop)
        client = SentinelClient(cfg=cfg or platform_config(), device=device, mode="threaded", entry_timeout_s=30.0,
                                app_name="witness" if witnessed else "unwitnessed")
        closers.insert(0, client.stop)
        flow, degrade, authority, system, _param = build_rules(st)
        client.flow_rules.load(flow + cflow)
        client.degrade_rules.load(degrade)
        client.authority_rules.load(authority)
        client.system_rules.load(system)
        client.set_cluster(mgr)
        names = [f"cres-{k}" for k in range(8)] + [f"res-{i}" for i in range(N_NAMES - 8)]
        for n in names:
            client.registry.resource_id(n)
        client.start()
        wait = REGISTRY.get("sentinel_lock_wait_ms")
        w_n0 = wait.count
        metrics = MetricsDelta()
        stop, lock, counts, futures = threading.Event(), threading.Lock(), {}, []
        plan = FaultPlan(name="witness-contend", seed=CHAOS_SEED, faults=[FaultSpec("runtime.lock.contend", "delay",
                                                                                   **CONTEND)])
        FU.reset_launches()
        SC.reset_launches()
        ticks0 = client._build_ticks
        with FP.armed(plan) as armed_state:
            ts = [threading.Thread(target=witness_traffic, daemon=True,
                                   args=(np, st, client, names, stop, counts, lock, futures, tok, SEED + 1500 + i))
                  for i in range(N_THREADS)]
            t = time.perf_counter()
            for th in ts:
                th.start()
            time.sleep(seconds)
            stop.set()
            for th in ts:
                th.join(timeout=120)
            check(not any(th.is_alive() for th in ts), "15b: request threads still running after 120 s")
            results = [f.result(timeout=60.0) for f in futures if f is not None]
            wall = time.perf_counter() - t
            injected = armed_state.injected()
        ticks = client._build_ticks - ticks0
        launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
        client.stop()
        # a name the registry cannot intern passes through (None, no future)
        ok = sum(1 for v, _w in results if v in (ERR.PASS, ERR.PASS_WAIT)) + sum(1 for f in futures if f is None)
        submitted = sum(v for k, v in counts.items() if k != "token")
        ctx = ScenarioContext(metrics=metrics, client=client, submitted=submitted, passed=counts.get("pass", 0) + ok,
                              blocked=counts.get("blocked", 0) + len(results) - (ok - futures.count(None)),
                              futures=futures)
        verdicts = evaluate(["verdict-accounting", "no-stranded-futures", "pipeline-drained"], ctx)
        rep.update(verdicts=[[v.name, v.ok, v.detail] for v in verdicts], counts=counts, wall_s=wall, ticks=ticks,
                   ms_a_tick=wall * 1e3 / max(ticks, 1), decisions_per_s=submitted / wall, launches=launches,
                   contend_fires=injected.get("runtime.lock.contend:delay", 0), lock_waits=wait.count - w_n0,
                   lock_wait_ms=dict(p50=wait.quantile(0.5), p99=wait.quantile(0.99)))
        if witnessed:
            rep.update(dynamic_edges=len(W.dynamic_edges()), violations=W.violations(),
                       unknown_edges=W.edges_unknown_to_static(),
                       runtime_edges=sorted(f"{a} -> {b}" for a, b in W.dynamic_edges()
                                            if a.startswith(("runtime.", "cluster.")) or b.startswith(("runtime.", "cluster."))))
    finally:
        for close in closers:
            close()
        if witnessed:
            W.uninstall()
            W.reset()
    return rep


def chaos_witness(np, st, FU, SC, torch) -> dict:
    """15b: the unwitnessed run, then the witnessed one; every invariant
    green, no violation and no edge the port's golden lacks, B1 / B2 / B4
    launched."""
    rep = {"unwitnessed": witness_run(np, st, FU, SC, torch, False)}
    torch.cuda.empty_cache()
    settle_heap()
    rep["witnessed"] = w = witness_run(np, st, FU, SC, torch, True)
    torch.cuda.empty_cache()
    for label in ("unwitnessed", "witnessed"):
        r = rep[label]
        check(all(ok for _n, ok, _d in r["verdicts"]), (f"15b: an invariant is red ({label})", r["verdicts"]))
        check(not any(k.startswith("lost") for k in r["counts"]), (f"15b: entries lost ({label})", r["counts"]))
        check(all(r["launches"][k] > 0 for k in ("scatter_many", "gather_many", "seg_incl_min")),
              (f"15b: B1 / B2 / B4 not all launched ({label})", r["launches"]))
    check(not w["violations"] and not w["unknown_edges"], ("15b: the witness", w["violations"], w["unknown_edges"]))
    check(w["dynamic_edges"] > 0 and w["contend_fires"] > 0 and w["lock_waits"] > 0,
          ("15b: the witness saw nothing", w["dynamic_edges"], w["contend_fires"], w["lock_waits"]))
    check(any(e.startswith("cluster.") for e in w["runtime_edges"]), ("15b: no cluster lock edge", w["runtime_edges"]))
    return rep


def chaos_trace_cli(np, st, FU, SC, torch) -> dict:
    """15c: the trace CLI on the card — a self-capture ``--summary`` with
    all six tick stages, ``explain``, ``--profile 250``, ``--merge`` of a
    token client's and server's dumps with the RPC spans linked, and
    ``--postmortem`` of the bundle a deliberately red invariant triggered.
    The span ring is left empty and the tracer off."""
    import contextlib
    import io

    from sentinel_tpu_torch import obs
    from sentinel_tpu_torch.chaos.invariants import MetricsDelta, ScenarioContext, evaluate
    from sentinel_tpu_torch.chaos.runner import _make_token_server
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.obs import __main__ as CLI
    from sentinel_tpu_torch.obs import profile as PROF
    from sentinel_tpu_torch.obs.flight import FLIGHT

    work = os.path.join(ROOT, "build", "chaos")
    os.makedirs(work, exist_ok=True)
    rep = {}

    def run(argv):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = CLI.main(argv)
        check(code == 0, (f"15c: {argv} exited {code}", buf.getvalue()[-2000:]))
        return buf.getvalue(), time.perf_counter() - t

    obs.TRACER.reset()
    try:
        FU.reset_launches()
        SC.reset_launches()
        out, s = run(["--summary"])
        stages = {ln.split()[0]: int(ln.split()[1]) for ln in out.splitlines() if ln.startswith("tick.")}
        check(sorted(stages) == sorted(CLI.TICK_STAGES) and all(stages.values()), ("15c: --summary stages", out))
        rep["summary"] = dict(stages=stages, s=s, launches=dict(FU.LAUNCHES, **SC.LAUNCHES), text=out)
        # the fast-path config's single lanes: the segment check phase (B1,
        # B3, B4), no per-item read (B2)
        check(all(rep["summary"]["launches"][k] > 0 for k in ("scatter_many", "seg_excl_cumsum", "seg_incl_min")),
              ("15c: the self-capture launched no B1 / B3 / B4", rep["summary"]["launches"]))
        obs.TRACER.reset()
        out, s = run(["explain"])
        check("explain coverage: blocked=" in out and "(100.0%)" in out and " flow " in out, ("15c: explain", out))
        rep["explain"] = dict(s=s, head=out.splitlines()[:3])
        PROF._LAST_CAPTURE[0] = 0.0
        out, s = run(["--profile", "250"])
        head = json.loads(out[: out.index("}") + 1])
        check(head["span_count"] > 0, ("15c: --profile", out))
        rep["profile"] = dict(s=s, span_count=head["span_count"], ms=head["ms"])
        obs.TRACER.reset()
        # --merge: a token client's and a token server's dumps of one run
        decision, svc, server = _make_token_server("cuda", flow_count=1e9)
        tok = ClusterTokenClient("127.0.0.1", server.port, timeout_ms=5000)
        tok.start()
        try:
            obs.enable()
            statuses = [tok.request_token(101).status for _ in range(MERGE_TOKENS)]
        finally:
            obs.disable()
            tok.close()
            server.stop()
            decision.stop()
        spans = obs.TRACER.snapshot()
        obs.TRACER.reset()
        client_spans = [x for x in spans if x["name"].startswith("cluster.rpc")]
        server_spans = [x for x in spans if not x["name"].startswith("cluster.rpc")]
        paths = [os.path.join(work, "client.json"), os.path.join(work, "server.json")]
        for path, part, pid in zip(paths, (client_spans, server_spans), (1, 2)):
            doc = obs.TRACER.chrome_trace(part)
            for e in doc["traceEvents"]:
                e["pid"] = pid
            with open(path, "w") as f:
                json.dump(doc, f)
        merged = os.path.join(work, "merged.json")
        out, s = run(["--merge", *paths, "-o", merged])
        with open(merged) as f:
            links = json.load(f)["otherData"]["flow_links"]
        check(links >= MERGE_TOKENS, ("15c: --merge linked too few RPC spans", links, statuses, out))
        rep["merge"] = dict(s=s, flow_links=links, client_spans=len(client_spans), server_spans=len(server_spans),
                            statuses=sorted(set(statuses)))
        # --postmortem of the bundle a red invariant triggers
        FLIGHT.reset_rate_limit()
        red = evaluate(["verdict-accounting"], ScenarioContext(metrics=MetricsDelta(), submitted=1))
        b = FLIGHT.last_bundle()
        check(not red[0].ok and b is not None and b["reason"] == "invariant-breach", "15c: no invariant-breach bundle")
        bundle = os.path.join(work, "bundle.json")
        with open(bundle, "w") as f:
            json.dump(b, f)
        out, s = run(["--postmortem", bundle])
        check("reason='invariant-breach'" in out and "invariant.breach" in out, ("15c: --postmortem", out[-2000:]))
        rep["postmortem"] = dict(s=s, lines=len(out.splitlines()))
    finally:
        obs.disable()
        obs.TRACER.reset()
    return rep


def chaos_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 15: (a) the chaos scenarios on the card, (b) the lock witness
    over a full-width serving client, (c) the trace CLI on the card."""
    t_phase = time.perf_counter()
    rep = {"card": smi}
    for part, fn, logger in (("scenarios", chaos_scenarios, log_scenarios), ("witness", chaos_witness, log_witness),
                             ("cli", chaos_trace_cli, log_trace_cli)):
        t = time.perf_counter()
        rep[part] = fn(np, st, FU, SC, torch)
        rep[f"{part}_s"] = time.perf_counter() - t
        logger(smi, rep[part])
        settle_heap()
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"[chaos] {smi}: phase 15 took {rep['phase_s']:.1f} s (15a {rep['scenarios_s']:.1f}, 15b "
        f"{rep['witness_s']:.1f}, 15c {rep['cli_s']:.1f})")
    return rep


def log_scenarios(smi, a) -> None:
    for name, r in a["scenarios"].items():
        log(f"[chaos] {smi}: 15a {name}{'' if r['fast'] else ' (not fast)'}: green on the card in {r['s']:.2f} s, "
            f"injected {json.dumps(r['injected'], sort_keys=True)} == the CPU's (invariants whose detail differs "
            f"from the CPU's: {r['details_unlike_cpu']}); launches {json.dumps(r['launches'])}")
    k, p = a["storm"]["kernels"], a["storm"]["plain"]
    log(f"[chaos] {smi}: 15a seg_overflow_storm with the kernels ({k['s']:.2f} s, launches {json.dumps(k['launches'])})"
        f" == with their plain versions ({p['s']:.2f} s): both storms' verdicts and waits equal (verdict counts "
        f"{k['verdicts']}), seg drops {k['seg_drops']:g} == {p['seg_drops']:g}")
    log(f"[chaos] {smi}: 15a determinism: the fast set again in {a['determinism_s']:.1f} s, every injected count "
        f"equal; the CPU ran all eleven in {a['cpu']['wall_s']:.1f} s (waited {a['cpu']['wait_s']:.1f} s)")


def log_witness(smi, w) -> None:
    for label in ("unwitnessed", "witnessed"):
        r = w[label]
        log(f"[chaos] {smi}: 15b {label}: {r['wall_s']:.2f} s of 8 threads, {sum(v for kk, v in r['counts'].items() if kk != 'token')} "
            f"decisions ({json.dumps(r['counts'], sort_keys=True)}) -> {r['decisions_per_s']:.0f} decisions/s, "
            f"{r['ticks']} ticks -> {r['ms_a_tick']:.3f} ms a tick; contend fires {r['contend_fires']}, "
            f"witnessed acquisitions {r['lock_waits']} (sentinel_lock_wait_ms p50 {r['lock_wait_ms']['p50']:g} / "
            f"p99 {r['lock_wait_ms']['p99']:g}); B1 / B2 / B3 / B4 launches {r['launches']['scatter_many']} / "
            f"{r['launches']['gather_many']} / {r['launches']['seg_excl_cumsum']} / {r['launches']['seg_incl_min']}; "
            f"invariants {json.dumps([[n, ok] for n, ok, _d in r['verdicts']])}")
    ww = w["witnessed"]
    log(f"[chaos] {smi}: 15b witness: {ww['witness_sites']} creation sites, installed in {ww['install_s']:.2f} s; "
        f"{ww['dynamic_edges']} dynamic edges, 0 violations, 0 edges unknown to the port's golden; runtime / cluster "
        f"edges seen: {json.dumps(ww['runtime_edges'])}")


def log_trace_cli(smi, c) -> None:
    s = c["summary"]
    log(f"[chaos] {smi}: 15c --summary self-capture on the card in {s['s']:.2f} s: stages {json.dumps(s['stages'])}; "
        f"launches {json.dumps(s['launches'])}")
    for ln in s["text"].splitlines():
        log(f"[chaos] 15c   {ln}")
    log(f"[chaos] {smi}: 15c explain {c['explain']['s']:.2f} s ({c['explain']['head'][0]}); --profile 250: "
        f"{c['profile']['span_count']} spans in {c['profile']['s']:.2f} s; --merge: {c['merge']['flow_links']} flow "
        f"links ({c['merge']['client_spans']} client / {c['merge']['server_spans']} server spans, statuses "
        f"{c['merge']['statuses']}) in {c['merge']['s']:.2f} s; --postmortem {c['postmortem']['lines']} lines in "
        f"{c['postmortem']['s']:.2f} s")


def chaos_main() -> int:
    """``python3 chip_smoke.py --chaos``: the kernels' build and phase 15
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
    rep = chaos_phase(np, st, S, FU, SC, torch, nvidia_smi())
    rep["cli"]["summary"].pop("text")
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


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


# -- phase 16: the sharded engine on the card -------------------------------------------------

#: ticks of the sharded runs (phase 4's traffic) and each rank group's deadline
SPMD_TICKS = 64
SPMD_DEADLINE_S = 240.0


def spmd_setup(np, st, E, torch, which: str, device="cuda"):
    """(cfg, rules, stream) of a phase-16 run, the same on every rank (all
    from SEED): ``platform`` is phase 4's traffic — platform_config() at
    the default widths with build_rules' 4,000 flow, 1,000 degrade, 32
    param, an authority and a system rule, SPMD_TICKS presorted ticks of
    B = 2,048 Zipf(1.1) over N_NAMES names; ``sketch`` is phase 4's
    sketch build (bench.py's), its 13 ticks of B = 2,048."""
    import dataclasses

    from sentinel_tpu_torch.core import rule_tensors as RT
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.core.rule_tensors import hash_param
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.runtime.client import grown_seg_u
    from sentinel_tpu_torch.runtime.registry import Registry

    if which == "platform":
        cfg = platform_config(packed_wire=True)
        reg = Registry(cfg)
        names_to_rows = np.array([reg.resource_id(f"res-{i}") for i in range(N_NAMES)], dtype=np.int32)
        flow, degrade, authority, system, param = build_rules(st)
        value_hashes = np.array([hash_param(arg_value(k)) for k in range(N_VALUES)], dtype=np.int32)
        cols = batch_columns(np, PS, SPMD_TICKS, names_to_rows, cfg.batch_size, SEED + 16, value_hashes)
        rules = E.compile_ruleset(cfg, reg, flow_rules=flow, degrade_rules=degrade, param_rules=param,
                                  authority_rules=authority, system_rules=system, device=device)
        stream = to_batches(E, torch, cfg, cols) if device == "cuda" else None
        return cfg, rules, stream
    base = sketch_cfg(platform_config)
    reg = Registry(base)
    for i in range(N_RULED):
        reg.resource_id(f"res-{i + 1}")
    origin = (reg.origin_node_row("res-1", "peer-app"), reg.origin_id("peer-app"))
    nr, trash = base.node_rows, base.trash_row
    cols, peak = sketch_columns(np, PS, 13, 2048, SEED + 9, nr, trash, *origin)
    cfg = dataclasses.replace(base, seg_u=grown_seg_u(base, peak), seg_static_ranks=True)
    flow, degrade, authority, system, param = sketch_rules(st, with_tail_names=False)
    rules = E.compile_ruleset(cfg, reg, flow_rules=flow, degrade_rules=degrade, param_rules=param,
                              authority_rules=authority, system_rules=system, device=device)
    tail = [(nr + r, 20.0) for r in range(N_RULED + 1, N_RULED + 1 + N_TAIL_RULED)]
    rules = rules._replace(tail=RT.to_device(RT.compile_tail_flow_rules(tail, cfg), device))
    return cfg, rules, sketch_batches(E, torch, cfg, cols, device)


def spmd_digests(S, state) -> dict:
    """sha256 of every leaf's bytes: the state compared across processes."""
    import hashlib

    return {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest() for k, v in S.leaves(state).items()}


def spmd_ticks(E, CL, torch, tick, state, rules, stream, forbid_sync=False) -> dict:
    """Run ``stream`` through ``tick`` (phase 4's timestamps): each tick's
    wire bytes and wait, its wall ms (synchronized on both sides), B1-B4
    launches and the collectives sent (count, bytes, host and device ms)."""
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import segscan as SC

    wires, ms = [], []
    FU.reset_launches()
    SC.reset_launches()
    with CL.stats() as cs:
        for i, (acq, comp) in enumerate(stream):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if forbid_sync:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, out = tick(state, rules, acq, comp, 1_000 + 137 * i, 0.3, 0.2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            wires.append(out.wire.cpu().numpy().tobytes())  # the one readback
            ms.append((time.perf_counter() - t) * 1e3)
        dev_ms = cs.device_ms()
    n = len(stream)
    launches = dict(FU.LAUNCHES, **SC.LAUNCHES)
    return dict(state=state, wires=wires, ms=sorted(ms)[n // 2], launches={k: v / n for k, v in launches.items()},
                coll_count=cs.count / n, coll_bytes=cs.bytes / n, coll_host_ms=cs.host_ms / n,
                coll_device_ms=dev_ms / n)


def spmd_rank(rank: int, n: int, mode: str) -> dict:
    """A phase-16 rank (``parallel/launch.start_ranks`` starts it): ``one``
    is 16a — the single-device ticks and the world-size-1 sharded ticks
    over NCCL; ``gloo`` is 16b — the sharded ticks on ``n`` ranks of the
    one card, with the kernels and with their plain versions, and at 4
    ranks the sketch build too.  The set-up (the mesh, the rules, the
    batches, NCCL's first collective) runs before ``launch.gate()``, while
    the other groups set up too; what is measured runs after it, one
    group at a time."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.ops import _build
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.ops import fused as FU
    from sentinel_tpu_torch.ops import segscan as SC
    from sentinel_tpu_torch.parallel import collectives as CL
    from sentinel_tpu_torch.parallel import launch, spmd

    _build.load_library()
    mesh = spmd.make_mesh(n, device="cuda")
    out = dict(rank=rank, backend=mesh.backend, world=mesh.world)

    def sharded_run(cfg, rules, stream, forbid_sync=False):
        whole = E.init_state(cfg, "cuda")
        state = spmd.shard_state(whole, cfg, mesh)
        out_bytes = dict(whole=sum(v.numel() * v.element_size() for v in S.leaves(whole).values()),
                         rank=sum(v.numel() * v.element_size() for v in S.leaves(state).values()))
        del whole
        torch.cuda.empty_cache()
        tick = spmd.make_sharded_tick(cfg, mesh)
        r = spmd_ticks(E, CL, torch, tick, state, rules, stream, forbid_sync)
        r["memory_allocated"] = torch.cuda.memory_allocated()
        gathered = spmd.gather_state(r.pop("state"), cfg, mesh)
        r["digests"] = spmd_digests(S, gathered) if rank == 0 else None
        del gathered
        torch.cuda.empty_cache()
        r["state_bytes"] = out_bytes
        if rank:
            r["wires"] = None
        return r

    cfg, rules, stream = spmd_setup(np, st, E, torch, "platform")
    if mode == "one" or n == 4:
        scfg, srules, sstream = spmd_setup(np, st, E, torch, "sketch")
    if mode == "one":
        # a first sharded tick outside the measured run: NCCL's communicator
        # starts at its first collective
        warm = spmd.make_sharded_tick(cfg, mesh)
        warm(spmd.shard_state(E.init_state(cfg, "cuda"), cfg, mesh), rules, *stream[0], 1_000, 0.3, 0.2)
        del warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    launch.gate()
    if mode == "one":
        single = spmd_ticks(E, CL, torch, E.make_tick(cfg), E.init_state(cfg, "cuda"), rules, stream)
        single["digests"] = spmd_digests(S, single.pop("state"))
        out["single"] = single
        out["sharded"] = sharded_run(cfg, rules, stream, forbid_sync=True)
        sk = spmd_ticks(E, CL, torch, E.make_tick(scfg), E.init_state(scfg, "cuda"), srules, sstream)
        sk["digests"] = spmd_digests(S, sk.pop("state"))
        out["sketch_single"] = sk
        props = torch.cuda.get_device_properties(0)
        out["total_memory"] = props.total_memory
        out["device_name"] = props.name
        return out
    out["kernels"] = sharded_run(cfg, rules, stream)
    real, plain, install = kernel_sets(FU, SC)
    install(plain)
    try:
        out["plain"] = sharded_run(cfg, rules, stream)
    finally:
        install(real)
    if n == 4:
        out["sketch"] = sharded_run(scfg, srules, sstream)
    return out


def stop_resource_tracker() -> None:
    """The ``spawn`` start method (phase 16's rank groups) starts
    multiprocessing's resource tracker, a child of this process that would
    live until this process ends.  Nothing of this script registers a
    resource with it (the ranks answer through pipes), so it is stopped
    once every rank group has ended; a later spawn would start it again."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()


def spmd_phase(np, st, S, FU, SC, torch, smi) -> dict:
    """Phase 16: (a) world size 1 over NCCL — SPMD_TICKS sharded ticks of
    phase 4's traffic under ``set_sync_debug_mode("error")`` equal
    make_tick's, tick for tick (the wire: verdicts, waits, the three
    planes) and in state; (b) 2 and 4 ranks on the one card over gloo
    (NCCL refuses two ranks on one device; gloo stages CUDA tensors
    through the host, so these runs are exempt from the sync check) —
    every tick's wire equal to (a)'s single-device tick and the gathered
    state equal, with the kernels and with their plain versions, and at 4
    ranks the sketch build (SALSA width-sharded) against its single-device
    run; (c) the tier-4 analyzer's ranks on the card (``--device cuda``)
    at 8 ranks: their recorded ledger equals the CPU ranks' inventory as
    ``analysis/spmd/collectives.json`` pins it, and ``run_spmd_analysis``
    gives zero findings.

    Every group starts at once, and (c)'s ranks run beside their set-up;
    once all are set up, (a) and then (b)'s groups run what they measure
    one at a time (``launch.gate``), with no other rank busy.  Every
    group has a deadline; a rank's failure fails the phase."""
    from sentinel_tpu_torch.analysis import spmd as AS
    from sentinel_tpu_torch.analysis.spmd import runner as AR
    from sentinel_tpu_torch.parallel import launch
    from sentinel_tpu_torch.parallel import meshspec as MS

    rep = {}
    t_phase = time.perf_counter()
    n_c = MS.mesh_spec().n_devices
    card_c = {}

    def run_c():
        try:
            card_c["report"] = AR.worker_report(n_c, refresh=True, device="cuda")
        except BaseException as e:  # noqa: BLE001 — the main thread raises it
            card_c["error"] = e

    c_thread = threading.Thread(target=run_c, name="spmd-16c", daemon=True)
    c_thread.start()
    groups = {}
    try:
        groups[1] = launch.start_ranks(spmd_rank, 1, ("one",), timeout_s=SPMD_DEADLINE_S, backend="nccl")
        for n in (2, 4):
            groups[n] = launch.start_ranks(spmd_rank, n, ("gloo",), timeout_s=SPMD_DEADLINE_S, backend="gloo")
        c_thread.join(timeout=AR.WORKER_TIMEOUT_S + 30.0)  # the runner kills its ranks at its own deadline
        check(not c_thread.is_alive(), "16c: the analyzer's ranks outlived the runner's deadline")
        if "error" in card_c:
            raise card_c["error"]
        t_c = time.perf_counter() - t_phase
        for g in groups.values():
            g.ready()
        rep["setup_seconds"] = time.perf_counter() - t_phase
        log(f"[spmd] {smi}: the 1-, 2- and 4-rank groups set up at once in {rep['setup_seconds']:.1f} s, the "
            f"tier-4 analyzer's {n_c} card ranks (16c) running beside them ({t_c:.1f} s); what follows runs one "
            f"group at a time")
        rep.update(spmd_measured(groups, smi))
    finally:
        for g in groups.values():
            g.kill()
    stop_resource_tracker()

    # -- 16c: the tier-4 analyzer's ranks on the card, against the CPU
    # ranks' inventory as the golden pins it (tests/test_torch_spmd_analysis.py
    # holds the golden equal to the CPU ranks' ledger at this world size)
    card = card_c["report"]
    golden = json.load(open(AS.COLLECTIVES_PATH))
    check(card["device"] == "cuda" and card["backend"] == "gloo", ("16c ranks", card["device"], card["backend"]))
    check(golden["mesh"]["n_devices"] == n_c, ("16c: the golden's world size", golden["mesh"]))
    inventory = {e["name"]: AS.group_collectives(AS.collectives_from_ledger(e["collectives"])) for e in card["entries"]}
    check(inventory == {k: v["collectives"] for k, v in golden["entries"].items()},
          ("16c: the card's ledger differs from the CPU ranks'", inventory))
    findings = AS.run_spmd_analysis(program=AS.build_program(device="cuda"))
    check(findings == [], ("16c findings", [f"{f.path}:{f.line} [{f.rule}] {f.message}" for f in findings]))
    one = rep.pop("one")
    rep["c"] = dict(ranks=n_c, entries={e["name"]: len(e["collectives"]) for e in card["entries"]},
                    total_memory=one["total_memory"], device_name=one["device_name"],
                    analyzer_capacity=AS.DEFAULT_CAPACITY_BYTES, seconds=t_c)
    log(f"[spmd] 16c {smi}: the tier-4 analyzer's {n_c} ranks on the card (gloo): ledger equal to the CPU ranks' "
        f"(the golden; {json.dumps(rep['c']['entries'])} collectives an entry), zero findings; total_memory "
        f"{one['total_memory']} B ({one['device_name']}; the analyzer's default capacity "
        f"{AS.DEFAULT_CAPACITY_BYTES} B); 16c took {t_c:.1f} s beside the set-up")
    rep["seconds"] = time.perf_counter() - t_phase
    return rep


def spmd_measured(groups, smi) -> dict:
    """Phase 16's (a) and (b) on groups that are set up (``spmd_phase``):
    each group in turn is let past its gate and waited for."""
    rep = {}
    t = time.perf_counter()
    groups[1].go()
    (one,) = groups[1].wait()
    rep["one"] = one
    single, sh = one["single"], one["sharded"]
    check(one["backend"] == "nccl", ("16a backend", one["backend"]))
    bad = [i for i, (a, b) in enumerate(zip(sh["wires"], single["wires"])) if a != b]
    check(not bad, ("16a: sharded ticks differ from make_tick's", bad[:8]))
    check(sh["digests"] == single["digests"],
          ("16a: sharded state differs", sorted(k for k in single["digests"] if sh["digests"][k] != single["digests"][k])))
    # route A on four rule lanes: B1, B2 and B4 (B3 ranks only single-lane
    # segment checks: the sketch build at 4 ranks launches it)
    check(sh["launches"] == single["launches"], ("16a launches", sh["launches"], single["launches"]))
    for k in PATH_KERNELS["seg4"]:
        check(sh["launches"][k] > 0, ("16a launched no", k, sh["launches"]))
    rep["a"] = dict(single_ms=single["ms"], sharded_ms=sh["ms"], launches=sh["launches"],
                    coll_count=sh["coll_count"], coll_bytes=sh["coll_bytes"], coll_device_ms=sh["coll_device_ms"],
                    coll_host_ms=sh["coll_host_ms"], state_bytes=sh["state_bytes"],
                    memory_allocated=sh["memory_allocated"], seconds=time.perf_counter() - t)
    log(f"[spmd] 16a {smi}: world 1 over {one['backend']}, {SPMD_TICKS} ticks B=2048 under "
        f"set_sync_debug_mode('error'): equal to make_tick tick for tick (wire) and in state; ms a tick "
        f"{sh['ms']:.3f} sharded vs {single['ms']:.3f} make_tick; B1-B4 launches a tick "
        f"{json.dumps(sh['launches'])}; collectives a tick {sh['coll_count']:.1f}, {sh['coll_bytes']:.0f} B, "
        f"{sh['coll_device_ms']:.4f} device ms ({sh['coll_host_ms']:.4f} host ms); 16a took {rep['a']['seconds']:.1f} s")

    for n in (2, 4):
        t = time.perf_counter()
        groups[n].go()
        ranks = groups[n].wait()
        r0 = ranks[0]
        check(r0["backend"] == "gloo", (f"16b n={n} backend", r0["backend"]))
        row = {}
        for label in ("kernels", "plain"):
            got = r0[label]
            bad = [i for i, (a, b) in enumerate(zip(got["wires"], single["wires"])) if a != b]
            check(not bad and len(got["wires"]) == SPMD_TICKS, (f"16b n={n} {label}: ticks differ", bad[:8]))
            check(got["digests"] == single["digests"], (f"16b n={n} {label}: gathered state differs",
                  sorted(k for k in single["digests"] if got["digests"][k] != single["digests"][k])))
            row[label] = dict(
                ms=got["ms"], coll_count=got["coll_count"], coll_bytes=got["coll_bytes"],
                coll_host_ms=got["coll_host_ms"], state_bytes=got["state_bytes"],
                memory_allocated=[r[label]["memory_allocated"] for r in ranks],
                b1_b2=[(r[label]["launches"]["scatter_many"], r[label]["launches"]["gather_many"]) for r in ranks],
            )
        for r in ranks:
            check(r["kernels"]["launches"]["scatter_many"] > 0 and r["kernels"]["launches"]["gather_many"] > 0,
                  (f"16b n={n} rank {r['rank']} launched no B1/B2", r["kernels"]["launches"]))
            check(r["plain"]["launches"]["scatter_many"] == 0, (f"16b n={n}: the plain run launched B1",))
        if n == 4:
            got, want = r0["sketch"], one["sketch_single"]
            bad = [i for i, (a, b) in enumerate(zip(got["wires"], want["wires"])) if a != b]
            check(not bad, ("16b sketch at 4 ranks: ticks differ", bad[:8]))
            check(got["digests"] == want["digests"], ("16b sketch at 4 ranks: gathered state differs",
                  sorted(k for k in want["digests"] if got["digests"][k] != want["digests"][k])))
            for k in PATH_KERNELS["sketch"]:
                check(got["launches"][k] > 0, ("16b sketch at 4 ranks launched no", k, got["launches"]))
            row["sketch"] = dict(ms=got["ms"], single_ms=want["ms"], coll_count=got["coll_count"], launches=got["launches"],
                                 coll_bytes=got["coll_bytes"], coll_host_ms=got["coll_host_ms"],
                                 state_bytes=got["state_bytes"])
        row["seconds"] = time.perf_counter() - t
        rep[f"b{n}"] = row
        k = row["kernels"]
        log(f"[spmd] 16b {smi}: {n} ranks on one card over gloo (host-staged: exempt from the sync check), "
            f"{SPMD_TICKS} ticks equal to 16a's make_tick and the gathered state equal, kernels and plain versions; "
            f"ms a tick {k['ms']:.3f} (plain {row['plain']['ms']:.3f}); collectives a tick {k['coll_count']:.1f}, "
            f"{k['coll_bytes']:.0f} B, {k['coll_host_ms']:.3f} host ms; state bytes a rank "
            f"{k['state_bytes']['rank']} of {k['state_bytes']['whole']}; memory_allocated a rank "
            f"{k['memory_allocated']}; B1/B2 launches a tick a rank {k['b1_b2']}"
            + (f"; sketch build: ms a tick {row['sketch']['ms']:.3f} (single device {row['sketch']['single_ms']:.3f}), "
               f"collectives {row['sketch']['coll_count']:.1f} a tick, {row['sketch']['coll_bytes']:.0f} B" if n == 4 else "")
            + f"; took {row['seconds']:.1f} s")
    return rep


def spmd_main() -> int:
    """``python3 chip_smoke.py --spmd``: the kernels' build and phase 16
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
    rep = spmd_phase(np, st, S, FU, SC, torch, nvidia_smi())
    left = live_children()
    check(not left, f"processes this script started still run at its end: {left}")
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


def profile_probe_main(n: int = 40) -> int:
    """``python3 chip_smoke.py --profile-probe [N]``: the kernels' build,
    then phase 11d's captured tick (``sketch_cfg``, a sync client, bench.py's
    rules and traffic; the 20th tick) replayed under ``N`` profiler
    sessions (CPU and CUDA activity, as ``replay_against_plain`` takes
    them) in each of four set-ups: with and without ``settle_profiler``
    first, each with the card otherwise idle and beside a thread that
    launches a short spin kernel every 0.5 ms.  Prints, per set-up, the fewest
    and most device records a session held, the sessions short of the
    most, and the sessions that showed no record of B1, B3 or B4."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core.config import platform_config
    from sentinel_tpu_torch.ops import _build
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.runtime import presort as PS
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    _build.load_library()
    smi = nvidia_smi()
    cfg = sketch_cfg(platform_config)
    c = SentinelClient(cfg=cfg, device="cuda", mode="sync", time_source=VirtualTimeSource(start_ms=1_000),
                       app_name="profile-probe")
    for i in range(N_RULED):
        c.registry.resource_id(f"res-{i + 1}")
    flow, degrade, _authority, _system, _param = sketch_rules(st, with_tail_names=False)
    c.flow_rules.load(flow)
    c.degrade_rules.load(degrade)
    c.start()
    origin = (c.registry.origin_node_row("res-1", "peer-app"), c.registry.origin_id("peer-app"))
    cols, _peak = sketch_columns(np, PS, 13, 2048, SEED + 9, cfg.node_rows, cfg.trash_row, *origin)
    box, unwatch = capture_client_tick(E, 20)
    for i in range(24):
        a, cc = cols[i % len(cols)]
        c.check_batch_ids(a["res"], origin_node=a["origin_node"], origin_id=a["origin_id"],
                          param_hash=a["param_hash"], inbound=a["inbound"])
        c.submit_completion_block(cc["res"], cc["rt"], inbound=cc["inbound"], param_hash=cc["param_hash"])
        c.time.advance(137)
    unwatch()
    c.stop()
    check(box, "profile probe: no tick was captured")
    tick = E.make_tick(box["cfg"], box["feats"])
    want = ("scatter_many", "seg_excl_cumsum", "seg_incl_min")

    def run():
        tick(E.clone_state(box["state"]), box["rules"], box["acq"], box["comp"], box["now"], box["load"],
             box["cpu"], seg_fits=box["fits"])[1].wire.cpu()

    run()
    stop = threading.Event()

    def background():
        while not stop.is_set():
            torch.cuda._sleep(1000)  # a "spin" kernel, left out of the counts below
            time.sleep(0.0005)

    rep = {"card": smi, "sessions_each": n}
    for settle in (False, True):
        for busy in (False, True):
            th = threading.Thread(target=background, daemon=True) if busy else None
            if th is not None:
                stop.clear()
                th.start()
            records, missed = [], 0
            try:
                for _ in range(n):
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        if settle:
                            settle_profiler(torch)
                        run()
                        torch.cuda.synchronize()
                    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                             and not getattr(e, "is_user_annotation", False) and "spin" not in e.name.lower()]
                    records.append(len(names))
                    missed += not all(any(PROFILE_NAMES[k] in nm for nm in names) for k in want)
            finally:
                if th is not None:
                    stop.set()
                    th.join()
            key = f"settle={settle},busy={busy}"
            rep[key] = dict(fewest=min(records), most=max(records), short=sum(r < max(records) for r in records),
                            missed_a_kernel=missed)
            log(f"[probe] {smi}: {key}: {n} sessions; device records fewest {min(records)}, most {max(records)}, "
                f"{rep[key]['short']} sessions short of the most; {missed} showed no record of one of {want}")
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


def main() -> int:
    t_script = time.perf_counter()
    #: (phase, perf_counter at its end): each phase's seconds in the [timing] line
    phase_clock = [("start", t_script)]
    #: phase -> the heap settled at its end (settle_heap) and its full collections
    report_gc = {}

    def end_phase(k):
        t_begin = phase_clock[-1][1]
        report_gc[k] = dict(settle_heap(), full_collections=gc_pauses_since(t_begin))
        phase_clock.append((k, time.perf_counter()))
        g = report_gc[k]
        log(f"[gc] phase {k}: full collections in it (s into it, ms) {json.dumps(g['full_collections'])}; at its "
            f"end a full collection over the whole heap took {g['collect_ms']:.1f} ms, "
            f"{g['frozen_objects']} objects frozen")

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

    end_phase("1")
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

    end_phase("2")
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

    end_phase("3")
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

    end_phase("4")
    # -- 5. the probes ---------------------------------------------------------------
    flat = {k: (v["b2048"]["on"] if k == "sketch" else v) for k, v in report["tick"].items()}
    probe_records, report["probes"] = probe_phase(np, torch, flat, probe_splits)

    end_phase("5")
    # -- 6. seg_fallback=True: the tick's two routes ------------------------------------
    report["fallback"] = fallback_phase(np, st, E, WIRE, S, FU, SC, torch, install, real, plain, setups, sk)
    del sk
    torch.cuda.empty_cache()

    end_phase("6")
    # -- 7. bench.py's client_bench through the port's client ---------------------------
    report["client_bench"] = {str(B): client_bench_phase(np, st, FU, SC, torch, B, smi) for B in (BIG_B, 2048)}

    end_phase("7")
    # -- 8. cluster flow control: the token column, server and clients --------------------
    report["cluster"] = cluster_phase(np, st, S, FU, SC, torch, smi)

    end_phase("8")
    # -- 9. the control plane: readers, command center, metric log, reshape ---------------
    report["control"] = control_phase(np, st, S, FU, SC, torch, smi)

    end_phase("9")
    # -- 10. overload protection and the plain effects path --------------------------------
    report["overload"] = overload_phase(np, st, S, FU, SC, torch, smi)

    end_phase("10")
    # -- 11. the operations plane: closed loop, live swap, ledger, audit, commands ---------
    report["workload"] = workload_phase(np, st, S, FU, SC, torch, smi)

    end_phase("11")
    # -- 12. the front doors and the adapters ------------------------------------------------
    report["doors"] = doors_phase(np, st, S, FU, SC, torch, smi)

    end_phase("12")
    # -- 13. the operator's plane: dashboard, datasources, the unpacked wire ------------------
    report["operator"] = operator_phase(np, st, S, FU, SC, torch, smi)
    end_phase("13")
    # -- 14. the sharded cluster and the shard router -------------------------------------------
    report["shards"] = shards_phase(np, st, S, FU, SC, torch, smi)
    end_phase("14")
    # -- 15. the chaos plane, the lock witness and the trace CLI --------------------------------
    report["chaos"] = chaos_phase(np, st, S, FU, SC, torch, smi)
    report["chaos"]["cli"]["summary"].pop("text")
    end_phase("15")
    # -- 16. the sharded engine: world 1 over NCCL, 2 and 4 ranks over gloo, the tier-4 ranks ------
    report["spmd"] = spmd_phase(np, st, S, FU, SC, torch, smi)
    end_phase("16")
    left = live_children()
    check(not left, f"processes this script started still run at its end: {left}")

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
    report["script_s"] = time.perf_counter() - t_script
    report["phase_s"] = {k: b - a for (_k, a), (k, b) in zip(phase_clock, phase_clock[1:])}
    report["gc"] = report_gc
    log(f"[timing] {smi}: the whole script took {report['script_s']:.1f} s; phase seconds (1 is the build) "
        f"{json.dumps({k: round(v, 1) for k, v in report['phase_s'].items()})}")
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


def workload_main() -> int:
    """``python3 chip_smoke.py --workload``: the kernels' build and phase 11
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
    rep = workload_phase(np, st, S, FU, SC, torch, nvidia_smi())
    log("[report]", json.dumps(rep, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    import faulthandler

    faulthandler.enable()  # a fatal signal in native code prints every thread's stack to stderr
    die_with_parent()
    import gc

    gc.callbacks.append(_gc_watch)
    mode = sys.argv[1:]
    sys.exit(b2_main() if mode == ["--b2"] else ops_main() if mode == ["--ops"]
             else cluster_main() if mode == ["--cluster"] else control_main() if mode == ["--control"]
             else overload_main() if mode == ["--overload"] else workload_main() if mode == ["--workload"]
             else doors_main() if mode == ["--doors"]
             else doors_cpu_main(mode[1]) if mode[:1] == ["--doors-cpu"] and len(mode) == 2
             else operator_main() if mode == ["--operator"]
             else shards_main() if mode == ["--shards"]
             else shards_cpu_main() if mode == ["--shards-cpu"]
             else chaos_main() if mode == ["--chaos"]
             else chaos_cpu_main() if mode == ["--chaos-cpu"]
             else spmd_main() if mode == ["--spmd"]
             else profile_probe_main(*map(int, mode[1:])) if mode[:1] == ["--profile-probe"] and len(mode) <= 2
             else operator_cpu_main(mode[1]) if mode[:1] == ["--operator-cpu"] and len(mode) == 2
             else workload_loop_main(*mode[1:]) if mode[:1] == ["--workload-loop"] and len(mode) == 4
             else simload_main(*mode[1:]) if mode[:1] == ["--simload"] and len(mode) == 3
             else main())
