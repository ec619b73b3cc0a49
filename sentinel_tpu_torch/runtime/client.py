"""Host runtime: SentinelClient — micro-batching + the tick loop.

The port's counterpart of ``sentinel_tpu/runtime/client.py``, reduced to
the admission path.  ``entry()`` queues an acquire; the tick loop (a
thread in ``mode="threaded"``, the caller's own thread in ``mode="sync"``)
builds the batch columns, uploads them, runs ONE engine tick, and reads
back ONE packed wire buffer (ops/wire.py), whose verdicts resolve the
waiting futures.  A wire buffer that fails validation fails the whole
tick CLOSED (every item gets BLOCK_SYSTEM).

Completions (``Entry.exit()``) go through a locked list and ride the
next tick.  Counts, successes and errors are clamped to
``cfg.max_batch_count`` at batch build — the envelope the fused kernels
carry exactly (core/config.py).

On the segment path (``seg_effects``, the default ``platform_config()``)
the client presorts each batch on the host by the engine's segment keys
(runtime/presort.py) and maps the verdicts and waits back through the
inverse permutation.  Knowing the exact live-segment count before it
dispatches, it grows ``seg_u`` at the first tick that would overflow it
(``_note_seg_count``), so no tick drops items for capacity; any item the
engine still fails closed for capacity is counted in
``seg_dropped_total``.  Every rule load sets ``seg_static_ranks`` when
the rules allow the scan-only ranks (single lanes, DIRECT rules with the
default limitApp).

The client runs on the card unless it is asked for the CPU:
``SentinelClient(device=None)`` picks ``"cuda"`` and raises where no CUDA
device exists.

Hot-parameter rules: every rule load rebuilds the per-resource lane map
(``rule_tensors.param_lanes``); ``entry(resource, args=...)`` hashes one
argument per assigned lane into the acquire's ``param_hash`` columns and
keeps the hashes on the entry handle, so ``exit()`` carries them as the
THREAD-grade release lanes.  The ``param`` stage is on only while param
rules are loaded.

The readback also carries the tick's observability planes, under the
reference's defaults: the device telemetry row, folded into the port's
metrics registry (``obs/registry.REGISTRY``: the verdict-mix and token
counters, the ENTRY-window and ceiling gauges); the top-K per-resource
timeline rows, folded into ``self.timeline`` (``obs/timeline.py``, built
in ``start()``: ``timeline.find(resource, start_ms, end_ms)``); and the
explain section, whose records fill ``self.explain_plane``
(``obs/explain.py``) before the verdicts fan out — ``explain(resource)``,
``explain_top_causes()`` and ``explain_coverage()`` read it.  A corrupt
main section fails the tick CLOSED; a corrupt explain section drops only
the tick's explanations.

The sketch tier (``sketch_stats``): names interned past the exact row
space get sketch ids (runtime/registry.py).  Every rule load first tries
to PROMOTE a sketch-id resource that carries a flow or degrade rule into
the exact rows (``sketch/hotset.guarded_promote``; rules the tail tables
cannot serve go first); what stays in the tail compiles into the tail
threshold tables and turns the ``tail_flow`` stage on.  With
``hotset_k > 0`` the readback's hot block feeds ``self.hotset``
(sketch/hotset.HotSetManager), whose promote / demote pass runs after a
tick iteration on its own cadence (``hotset_eval_s``).  ``stats.resource``
reads an exact row's windowed stats (what demotion grades).

Not ported yet (ROADMAP.md): cluster mode (a cluster-mode param rule
raises), the hot-parameter value counters (``top_params``), the native
completion ring, pipelined readback, adaptive protection, the flight
recorder and the block log, the sketch-accuracy audit and the sketch
ids' windowed stats (``stats.resource`` on a sketch id).
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.core.config import EngineConfig, app_name as cfg_app_name, platform_config
from sentinel_tpu_torch.core.rule_tensors import hash_param, param_lanes
from sentinel_tpu_torch.obs import timeline as TLM
from sentinel_tpu_torch.obs.explain import ExplainPlane
from sentinel_tpu_torch.obs.registry import REGISTRY as OBS
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import engine_seg as ES
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime import context as CTX
from sentinel_tpu_torch.runtime import presort as PS
from sentinel_tpu_torch.runtime.registry import Registry
from sentinel_tpu_torch.sketch.hotset import HotSetManager, guarded_promote
from sentinel_tpu_torch.utils.system_status import SystemStatusSampler
from sentinel_tpu_torch.utils.time_source import TimeSource, VirtualTimeSource, mono_s


# -- device-resident telemetry (cfg.device_telemetry): the engine emits a
# stats row per tick (ops/engine.STAT_*) and the readback folds it here,
# under the reference's metric names
_DEV_VERDICTS_HELP = (
    "per-tick verdict mix reported by the device telemetry row, by verdict"
)
_C_DEV_VERDICTS: Dict[str, object] = {
    v: OBS.counter(
        "sentinel_device_verdicts_total", _DEV_VERDICTS_HELP, labels={"verdict": v}
    )
    for v in (
        "pass",
        "pass_wait",
        "block_authority",
        "block_system",
        "block_param",
        "block_flow",
        "block_degrade",
    )
}
_C_DEV_TOKENS = {
    r: OBS.counter(
        "sentinel_device_tokens_total",
        "admitted/blocked token sums from the device telemetry row",
        labels={"result": r},
    )
    for r in ("pass", "block")
}
_C_DEV_FORCED = OBS.counter(
    "sentinel_device_forced_verdicts_total",
    "host-injected pre-verdicts (cluster token denials) the device recorded",
)
_G_DEV_WIN_PASS = OBS.gauge(
    "sentinel_device_entry_pass_window",
    "ENTRY-node sliding-window pass sum as computed on-device",
)
_G_DEV_MIN_RT = OBS.gauge(
    "sentinel_device_entry_min_rt_ms",
    "ENTRY-node windowed RT floor as computed on-device (0 = no completions)",
)
_G_DEV_CONC = OBS.gauge(
    "sentinel_device_entry_concurrency",
    "global inbound concurrency as computed on-device",
)
_G_DEV_CEIL_UTIL = OBS.gauge(
    "sentinel_device_ceiling_utilization",
    "windowed ENTRY pass over the active system qps ceiling (0 = no ceiling)",
)
_G_DEV_SEG_LIVE = OBS.gauge(
    "sentinel_device_seg_live",
    "live compacted segments in the last tick (seg path only)",
)
# the readback's bytes (the timeline rows are counted under their own path,
# obs/timeline.py); uploads are not counted yet
_C_WIRE_RX = OBS.counter(
    "sentinel_wire_bytes_total",
    "bytes moved, by path (device|cluster) and direction (tx|rx)",
    labels={"path": "device", "direction": "rx"},
)
_C_PACKED_DECODE = OBS.counter(
    "sentinel_packed_decode_failures_total",
    "fused wire readbacks rejected by the packed decoder (tick fails CLOSED)",
)
#: chaos site on the readback's main section (mangled bytes fail the tick
#: CLOSED); the explain section has its own site, obs.explain.decode
_FP_PACKED_DECODE = FP.register(
    "transport.packed.decode",
    "fused packed-wire readback bytes (mangled bytes fail the tick CLOSED)",
    FP.PIPE_ACTIONS,
)


def _mask_min_rt(v: float) -> float:
    """RT_MIN_INIT (5000) is the 'no completions in window' sentinel:
    report 0.0 instead of a phantom 5-second minimum."""
    return 0.0 if v >= W.RT_MIN_INIT else v


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sentinel_tpu_torch serves on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def grown_seg_u(cfg: EngineConfig, peak: int) -> int:
    """The segment capacity the client grows to for a live-segment peak:
    ``ceil((1.25 * peak + 128) / 128) * 128``, at most the batch size and
    never below the full shape's current capacity."""
    b_full = cfg.batch_size
    grown = min(b_full, -(-int(peak * 1.25 + 128) // 128) * 128)
    return max(grown, ES.seg_capacity(cfg, b_full))


@dataclass
class AcquireRequest:
    res: int
    count: int
    prio: int
    origin_id: int
    origin_node: int
    ctx_node: int
    ctx_name: int
    inbound: int
    pre_verdict: int = 0
    future: Optional[Future] = None
    param_hash: tuple = ()  # param_dims hashed hot-param lanes (0 = none)


@dataclass
class Completion:
    res: int
    origin_node: int
    ctx_node: int
    inbound: int
    rt: float
    success: int
    error: int
    param_hash: tuple = ()  # THREAD-grade release lanes


#: acquire columns: (field, fill, host dtype)
_ACQ_COLS = (
    ("res", None, np.int32),
    ("count", 0, np.int32),
    ("prio", 0, np.int32),
    ("origin_id", -1, np.int32),
    ("origin_node", None, np.int32),
    ("ctx_node", None, np.int32),
    ("ctx_name", -1, np.int32),
    ("inbound", 0, np.int32),
    ("pre_verdict", 0, np.int32),
)
_COMP_COLS = (
    ("res", None, np.int32),
    ("origin_node", None, np.int32),
    ("ctx_node", None, np.int32),
    ("inbound", 0, np.int32),
    ("rt", 0.0, np.float32),
    ("success", 0, np.int32),
    ("error", 0, np.int32),
)
#: the segment path's presort keys, most significant first: the segment
#: keys of engine_seg.prepare_acquire / prepare_completions, res-major (the
#: scan ranks also need res nondecreasing)
_ACQ_SEG_KEYS = ("res", "ctx_node", "origin_node", "origin_id", "ctx_name")
_COMP_SEG_KEYS = ("res", "ctx_node", "origin_node")


class Entry:
    """Live entry handle (the reference's Entry/CtEntry).  ``exit()``
    records RT + success; ``trace(exc)`` marks a business exception."""

    __slots__ = (
        "client", "resource", "res", "origin_node", "ctx_node", "inbound",
        "count", "create_ms", "wait_ms", "param_hash", "_errors", "_exited",
    )

    def __init__(self, client, resource, res, origin_node, ctx_node, inbound, count, create_ms, wait_ms=0,
                 param_hash=()):
        self.client = client
        self.resource = resource
        self.res = res
        self.origin_node = origin_node
        self.ctx_node = ctx_node
        self.inbound = inbound
        self.count = count
        self.create_ms = create_ms
        self.wait_ms = wait_ms
        self.param_hash = param_hash
        self._errors = 0
        self._exited = False

    def trace(self, exc: Optional[BaseException] = None, count: int = 1) -> None:
        if exc is not None and isinstance(exc, ERR.BlockException):
            return  # block exceptions are not business errors
        self._errors += count

    def exit(self, count: Optional[int] = None) -> None:
        if self._exited:
            return
        self._exited = True
        CTX.pop_entry(self)
        if self.res is None:
            return  # pass-through entry (capacity overflow)
        now = self.client.time.now_ms()
        self.client._submit_completion(
            Completion(
                res=self.res,
                origin_node=self.origin_node,
                ctx_node=self.ctx_node,
                inbound=self.inbound,
                rt=float(max(now - self.create_ms, 0)),
                success=count if count is not None else self.count,
                error=self._errors,
                param_hash=self.param_hash,
            )
        )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.trace(exc)
        self.exit()
        return False


class _PassThroughEntry(Entry):
    def __init__(self, client, resource):
        super().__init__(client, resource, None, 0, 0, 0, 1, 0)


class RuleManager:
    """Typed rule holder: ``load`` replaces the rule set and recompiles
    (FlowRuleManager.loadRules analog)."""

    def __init__(self, client: "SentinelClient", kind: str):
        self._client = client
        self.kind = kind
        self._rules: list = []

    def load(self, rules: Sequence) -> None:
        rules = list(rules) if rules else []
        if self.kind == "param-flow" and any(r.cluster_mode for r in rules):
            raise NotImplementedError(
                "not ported to sentinel_tpu_torch yet: cluster-mode param-flow rules "
                "(ROADMAP.md Queue A item 6: the cluster token column)"
            )
        self._rules = rules
        self._client._recompile_rules()

    def get(self) -> list:
        return list(self._rules)


class SentinelClient:
    def __init__(
        self,
        app_name: Optional[str] = None,
        cfg: Optional[EngineConfig] = None,
        time_source: Optional[TimeSource] = None,
        mode: str = "threaded",  # "threaded" | "sync"
        tick_interval_ms: float = 1.0,
        entry_timeout_s: float = 5.0,
        device=None,
        timeline_log=False,  # bool | obs.timeline.MetricLog
        timeline_dir: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.app_name = app_name or cfg_app_name()
        self.cfg = cfg or platform_config()
        if self.cfg.packed_wire is None:
            # the client path always reads the packed wire
            self.cfg = dataclasses.replace(self.cfg, packed_wire=True)
        if not self.cfg.packed_wire:
            raise NotImplementedError(
                "sentinel_tpu_torch's client reads the packed wire only "
                "(packed_wire=False is not ported)"
            )
        E.check_supported(self.cfg)
        self.time = time_source or TimeSource()
        self.mode = mode if not isinstance(self.time, VirtualTimeSource) else "sync"
        self.tick_interval_ms = tick_interval_ms
        self.entry_timeout_s = entry_timeout_s

        self.registry = Registry(self.cfg)
        self.flow_rules = RuleManager(self, "flow")
        self.degrade_rules = RuleManager(self, "degrade")
        self.system_rules = RuleManager(self, "system")
        self.authority_rules = RuleManager(self, "authority")
        self.param_flow_rules = RuleManager(self, "param-flow")
        self._sys = SystemStatusSampler()
        #: resource -> ordered param_idx list: which argument each hash lane carries
        self._param_lanes_by_res: Dict[str, list] = {}

        self._features = self._select_features()
        self._tick = E.make_tick(self.cfg, features=self._features)
        self._state = E.init_state(self.cfg, self.device)
        self._rules_dev = E.compile_ruleset(self.cfg, self.registry, device=self.device)

        self._lock = threading.Lock()  # guards the queues
        self._engine_lock = threading.Lock()  # guards state / rules / tick
        # serializes whole tick iterations (sync clients tick from request
        # threads); reentrant for future callbacks that tick again
        self._tick_mutex = threading.RLock()
        self._acquires: List[AcquireRequest] = []
        self._completions: List[Completion] = []
        self._wire_layouts: Dict[int, WIRE.WireLayout] = {}
        #: ticks whose wire failed validation (each failed CLOSED)
        self.wire_decode_failures = 0
        #: items the engine failed closed past the segment capacity
        self.seg_dropped_total = 0
        #: largest live-segment count seen in one batch
        self._seg_obs_peak = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._started = False
        self.stats = ClientStats(self)

        # hot-set manager (sketch/hotset.py): folds the readback's hot block
        # and promotes / demotes between the exact tier and the sketch tail
        # on its own cadence
        self.hotset: Optional[HotSetManager] = None
        if self.cfg.sketch_stats and E.hotset_k(self.cfg) > 0:
            self.hotset = HotSetManager(self)

        # per-resource timeline (obs/timeline.py): built in start() when the
        # engine emits timeline rows; an on-disk MetricLog is attached only
        # when asked for (timeline_log=True, a prebuilt MetricLog, or
        # timeline_dir) — the in-memory ring serves find() regardless
        self._timeline_log_opt = timeline_log
        self._timeline_dir = timeline_dir
        self.timeline: Optional[TLM.TimelineRecorder] = None
        # verdict provenance plane (obs/explain.py): the readback's explain
        # section decoded into per-resource "why blocked" rings
        self.explain_plane: Optional[ExplainPlane] = None
        if E.explain_k(self.cfg) > 0:
            self.explain_plane = ExplainPlane(name_source=self.registry.resource_name)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._stop_evt = threading.Event()
        if self.timeline is None and E.timeline_k(self.cfg) > 0:
            log = None
            if isinstance(self._timeline_log_opt, TLM.MetricLog):
                log = self._timeline_log_opt
            elif self._timeline_log_opt or self._timeline_dir:
                import os

                from sentinel_tpu_torch.utils.record_log import log_dir

                # pid-suffixed: two processes of one app sharing a log dir
                # never append to (or truncate) each other's live segments
                log = TLM.MetricLog(
                    os.path.join(
                        self._timeline_dir or log_dir(),
                        f"{self.app_name}-timeline.pid{os.getpid()}",
                    )
                )
            self.timeline = TLM.TimelineRecorder(
                self.registry.resource_name,
                self.cfg.second_window_ms,
                self.cfg.second_sample_count,
                log=log,
                name=self.app_name,
            )
        if self.mode == "threaded":
            # first ticks build the CUDA kernels (nvcc, seconds): run them
            # before serving so early entries don't time out
            self._warm_shapes()
            self._thread = threading.Thread(
                target=self._tick_loop, args=(self._stop_evt,),
                name="sentinel-tpu-torch-tick", daemon=True,
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        # decide whatever is still queued so no caller is left waiting
        self.tick_once()
        if self.timeline is not None:
            # flush the still-open second, release the log handles (start()
            # builds a new recorder)
            self.timeline.close()
            self.timeline = None
        self._started = False

    # -- rule compilation ---------------------------------------------------

    def _select_features(self) -> frozenset:
        """Engine stages the current rule set needs ('nodes' and 'occupy'
        stay on; 'warmup' joins when a warm-up shaper exists, 'param' while
        param rules are loaded, 'tail_flow' while a flow rule's resource
        has a sketch id)."""
        feats = {"nodes", "occupy", "flow"}
        if self.param_flow_rules.get():
            feats.add("param")
        if self.degrade_rules.get():
            feats.add("degrade")
        if self.authority_rules.get():
            feats.add("authority")
        if self.system_rules.get():
            feats.add("system")
        if any(
            r.control_behavior in (R.CONTROL_WARM_UP, R.CONTROL_WARM_UP_RATE_LIMITER)
            for r in self.flow_rules.get()
        ):
            feats.add("warmup")
        if self.cfg.sketch_stats and any(
            (rid := self.registry.peek_resource_id(r.resource)) is not None
            and self.registry.is_sketch_id(rid)
            for r in self.flow_rules.get()
            if not r.cluster_mode
        ):
            feats.add("tail_flow")
        return frozenset(feats)

    def _promote_ruled_tail(self, flow: list) -> None:
        """Rules binding to sketch-tail resources first try PROMOTION into
        the exact rows, so they get real windows; whatever stays in the tail
        enforces approximately.  When the reserve is short, rules the tail
        CANNOT serve go first (the tail tables take only QPS / DEFAULT /
        DIRECT default-limitApp flow rules, ``engine.compile_ruleset``): a
        rate limiter, a THREAD-grade, origin-scoped or RELATE rule, or a
        breaker, on a tail id is unenforceable unless it wins an exact row.
        A failed promotion leaves the rule on its sketch id, where the tail
        tables still enforce it conservatively."""

        def _tail_can_serve(r) -> bool:
            return (
                isinstance(r, R.FlowRule)
                and r.grade == R.GRADE_QPS
                and r.control_behavior == R.CONTROL_DEFAULT
                and r.strategy == R.STRATEGY_DIRECT
                and (r.limit_app or "default") == "default"
            )

        for r in sorted(flow + self.degrade_rules.get(), key=_tail_can_serve):
            rid = self.registry.peek_resource_id(r.resource)
            if rid is not None and self.registry.is_sketch_id(rid):
                guarded_promote(self.registry, r.resource)

    def _recompile_rules(self) -> None:
        flow = [r for r in self.flow_rules.get() if not r.cluster_mode]
        if self.cfg.sketch_stats:
            self._promote_ruled_tail(flow)
        param = self.param_flow_rules.get()
        # per-resource hash LANES: each entry hashes up to param_dims
        # distinct argument indices; every rule reads the lane its param_idx
        # was assigned (ParamFlowChecker.java:78 paramIdx dispatch)
        lane_map = param_lanes(param, self.cfg.param_dims)
        self._param_lanes_by_res = lane_map
        rules_dev = E.compile_ruleset(
            self.cfg,
            self.registry,
            flow_rules=flow,
            degrade_rules=self.degrade_rules.get(),
            param_rules=param,
            param_lanes=lane_map,
            authority_rules=self.authority_rules.get(),
            system_rules=self.system_rules.get(),
            device=self.device,
        )
        feats = self._select_features()
        cfg = self.cfg
        if cfg.seg_effects:
            # every batch is presorted (_run_tick), so single-lane DIRECT /
            # default-limitApp rules qualify for the scan-only ranks; the
            # engine still checks the contract and fails closed if it breaks
            want_static = (
                cfg.flow_rules_per_resource == 1
                and cfg.degrade_rules_per_resource == 1
                and cfg.param_rules_per_resource == 1
                and all(
                    r.strategy == R.STRATEGY_DIRECT
                    and (r.limit_app or "default") == "default"
                    for r in flow
                )
            )
            if want_static != cfg.seg_static_ranks:
                cfg = dataclasses.replace(cfg, seg_static_ranks=want_static)
        with self._engine_lock:
            self._rules_dev = rules_dev
            if feats != self._features or cfg != self.cfg:
                self.cfg = self.registry.cfg = cfg
                self._features = feats
                self._tick = E.make_tick(cfg, features=feats)

    # -- entry API ------------------------------------------------------------

    def entry(
        self,
        resource: str,
        count: int = 1,
        prioritized: bool = False,
        args: Optional[Sequence] = None,
        inbound: bool = False,
        origin: Optional[str] = None,
    ) -> Entry:
        """Acquire; raises BlockException on rejection (SphU.entry).
        ``args``: the call's arguments; the ones param-flow rules on this
        resource index are hashed into the hot-parameter lanes."""
        ctx_name, ctx_origin = CTX.current()
        origin = origin if origin is not None else ctx_origin
        rid = self.registry.resource_id(resource)
        if rid is None:
            e = _PassThroughEntry(self, resource)
            CTX.push_entry(e)
            return e  # capacity overflow → pass-through (CtSph.java:200)
        origin_id = self.registry.origin_id(origin) if origin else -1
        origin_node = (
            self.registry.origin_node_row(resource, origin) if origin else self.cfg.trash_row
        )
        if ctx_name != CTX.DEFAULT_CONTEXT_NAME:
            ctx_node = self.registry.ctx_node_row(resource, ctx_name)
            ctx_id = self.registry.context_id(ctx_name)
        else:
            ctx_node = self.cfg.trash_row
            ctx_id = -1
        param_hashes = self.param_hashes(resource, args)
        req = AcquireRequest(
            res=rid,
            count=count,
            prio=1 if prioritized else 0,
            origin_id=origin_id,
            origin_node=origin_node,
            ctx_node=ctx_node,
            ctx_name=ctx_id,
            inbound=1 if inbound else 0,
            future=Future(),
            param_hash=param_hashes,
        )
        with self._lock:
            self._acquires.append(req)
        if self.mode == "sync":
            self.tick_once()
        verdict, wait_ms = req.future.result(timeout=self.entry_timeout_s)
        if verdict not in (ERR.PASS, ERR.PASS_WAIT):
            raise ERR.exception_for_verdict(verdict, resource)
        if verdict == ERR.PASS_WAIT and wait_ms > 0:
            self.time.sleep_ms(wait_ms)
        e = Entry(
            self, resource, rid, origin_node, ctx_node, 1 if inbound else 0,
            count, self.time.now_ms(), wait_ms, param_hashes,
        )
        CTX.push_entry(e)
        return e

    def param_hashes(self, resource: str, args: Optional[Sequence]) -> tuple:
        """``param_dims`` hashed lanes for an entry on ``resource``: one
        argument per lane the rule compile assigned (lane 0 reads args[0]
        where no param rule names the resource); 0 = no argument."""
        M = self.cfg.param_dims
        hashes = [0] * M
        if args:
            lanes = self._param_lanes_by_res.get(resource) or [0]
            for li, idx in enumerate(lanes[:M]):
                if 0 <= idx < len(args):
                    hashes[li] = hash_param(args[idx])
        return tuple(hashes)

    def param_lane(self, resource: str, param_idx: int) -> Optional[int]:
        """Hash lane the compile assigned to ``param_idx`` on ``resource``,
        or None if that index holds no lane (the rule cannot be enforced)."""
        lanes = self._param_lanes_by_res.get(resource)
        if not lanes:
            return 0 if param_idx == 0 else None
        return lanes.index(param_idx) if param_idx in lanes else None

    def explain(self, resource, limit: int = 0) -> list:
        """Why was ``resource`` blocked?  Newest-first provenance records
        (obs/explain.ExplainRecord) from the readback's explain section.
        Empty when the plane is off (``explain_k == 0``) or nothing was
        blocked.  Accepts a resource name or a raw device id."""
        if self.explain_plane is None:
            return []
        if isinstance(resource, int):
            rid: Optional[int] = resource
        else:
            rid = self.registry.peek_resource_id(resource)
        if rid is None:
            return []
        return self.explain_plane.explain(rid, limit=limit)

    def explain_top_causes(self, n: int = 10) -> list:
        """Most frequent (resource, kind, rule, origin) block causes."""
        if self.explain_plane is None:
            return []
        return self.explain_plane.top_causes(n)

    def explain_coverage(self) -> dict:
        """Blocked-decision explainability: {blocked, explained, frac}."""
        if self.explain_plane is None:
            return {"blocked": 0, "explained": 0, "frac": 1.0}
        return self.explain_plane.coverage()

    def try_entry(self, resource: str, **kw) -> Optional[Entry]:
        """SphO-style boolean variant."""
        try:
            return self.entry(resource, **kw)
        except ERR.BlockException:
            return None

    def trace(self, exc: BaseException, count: int = 1) -> None:
        e = CTX.current_entry()
        if e is not None:
            e.trace(exc, count)

    def enter_context(self, name: str, origin: str = ""):
        return CTX.enter(name, origin)

    def exit_context(self, token) -> None:
        CTX.exit_ctx(token)

    def _submit_completion(self, c: Completion) -> None:
        with self._lock:
            self._completions.append(c)
        if self.mode == "sync":
            self.tick_once()

    # -- tick machinery -------------------------------------------------------

    def _tick_loop(self, stop_evt: threading.Event) -> None:
        interval = self.tick_interval_ms / 1000.0
        while not stop_evt.is_set():
            t0 = mono_s()
            try:
                self.tick_once()
            except Exception:  # pragma: no cover - keep the loop alive
                import traceback

                traceback.print_exc()
            dt = mono_s() - t0
            if dt < interval:
                stop_evt.wait(interval - dt)

    def tick_once(self, now_ms: Optional[int] = None) -> None:
        """Drain the queues and run engine ticks until both are empty; then
        one cadence check of the hot-set manager, outside the tick mutex (a
        promotion's rule recompile must not hold up the serving path)."""
        with self._tick_mutex:
            self._tick_once_locked(now_ms)
        hs = self.hotset
        if hs is not None:
            hs.maybe_evaluate()

    def _tick_once_locked(self, now_ms: Optional[int]) -> None:
        while True:
            with self._lock:
                acq = self._acquires[: self.cfg.batch_size]
                self._acquires = self._acquires[self.cfg.batch_size :]
                comp = self._completions[: self.cfg.complete_batch_size]
                self._completions = self._completions[self.cfg.complete_batch_size :]
            if not acq and not comp and now_ms is None:
                return
            try:
                dispatched = self._run_tick(acq, comp, now_ms)
            except Exception:
                # a tick that cannot run decides nothing: its callers
                # get a fail-closed verdict, not an entry timeout
                self._fail_closed(acq)
                raise
            self._resolve(acq, dispatched)
            now_ms = None
            with self._lock:
                if not self._acquires and not self._completions:
                    return

    def _warm_shapes(self) -> None:
        """Run both batch shapes once with no-op batches (builds the
        kernels before serving)."""
        self._resolve([], self._run_tick([], [], self.time.now_ms()))
        if self.cfg.batch_size > 256:
            filler = AcquireRequest(
                res=self.cfg.trash_row, count=0, prio=0, origin_id=-1,
                origin_node=self.cfg.trash_row, ctx_node=self.cfg.trash_row,
                ctx_name=-1, inbound=0,
            )
            self._resolve([], self._run_tick([filler] * 257, [], self.time.now_ms()))

    @staticmethod
    def _shape_for(n: int, cap: int) -> int:
        """Two batch shapes: a light tick runs at <= 256 rows, anything
        bigger at the full configured batch."""
        return min(256, cap) if n <= 256 else cap

    def _note_seg_count(self, segs: int, b: int) -> None:
        """Track the live-segment count of the batch about to be dispatched;
        when it exceeds the compacted capacity, grow ``seg_u`` to
        ``grown_seg_u(cfg, peak)`` before the tick runs.  Eager PyTorch has nothing to compile, so the
        new capacity serves this very tick.

        Unlike the JAX client, a light tick that overflows its own automatic
        capacity while the full shape's still covers the peak pins ``seg_u``
        at the full shape's capacity: with ``seg_fallback`` off, returning
        there would fail that tick's overflow items closed."""
        self._seg_obs_peak = max(self._seg_obs_peak, segs)
        if segs <= ES.seg_capacity(self.cfg, b):
            return
        new_u = grown_seg_u(self.cfg, self._seg_obs_peak)
        if new_u == self.cfg.seg_u:
            return  # already at the batch size: nothing larger to give
        cfg = dataclasses.replace(self.cfg, seg_u=int(new_u))
        with self._engine_lock:
            self.cfg = self.registry.cfg = cfg
            self._tick = E.make_tick(cfg, features=self._features)

    def _hash_col(self, items: Sequence, rows: int) -> np.ndarray:
        """int32 [rows, param_dims]: each request's hashed lanes (0 = none;
        padding rows and requests without arguments stay 0)."""
        M = self.cfg.param_dims
        col = np.zeros((rows, M), np.int32)
        for i, r in enumerate(items):
            if r.param_hash:
                col[i, : len(r.param_hash[:M])] = r.param_hash[:M]
        return col

    def _upload(self, x: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(x)
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device)

    def _run_tick(self, acq: List[AcquireRequest], comp: List[Completion], now_ms):
        """Build (and on the segment path presort) the batch columns, upload
        them (the uploads finish before the tick starts), run one tick;
        returns (TickOutput, wire layout, inverse permutation or None, the
        tick's engine ms)."""
        cfg = self.cfg
        trash = cfg.trash_row
        cap = cfg.max_batch_count
        B = self._shape_for(len(acq), cfg.batch_size)
        B2 = self._shape_for(len(comp), cfg.complete_batch_size)

        acols = {}
        for f, fill, dt in _ACQ_COLS:
            col = np.full(B, trash if fill is None else fill, dt)
            if acq:
                col[: len(acq)] = [getattr(r, f) for r in acq]
            if f == "count":
                np.minimum(col, cap, out=col)  # the fused kernels' envelope
            acols[f] = col
        acols["param_hash"] = self._hash_col(acq, B)
        ccols = {}
        for f, fill, dt in _COMP_COLS:
            col = np.full(B2, trash if fill is None else fill, dt)
            if comp:
                col[: len(comp)] = [getattr(c, f) for c in comp]
            if f in ("success", "error"):
                np.minimum(col, cap, out=col)
            ccols[f] = col
        ccols["param_hash"] = self._hash_col(comp, B2)
        inv = None
        if cfg.seg_effects:
            # trash-row padding has the largest res, so it sorts last and
            # stays inside the sort
            order, inv = PS.batch_sort5(*(acols[k] for k in _ACQ_SEG_KEYS))
            acols = {k: v[order] for k, v in acols.items()}
            # completions carry no futures: sort, no unsort (their effects
            # are order-independent sums and minima)
            order_c, _ = PS.batch_sort3(*(ccols[k] for k in _COMP_SEG_KEYS))
            ccols = {k: v[order_c] for k, v in ccols.items()}
            self._note_seg_count(PS.host_seg_count([acols[k] for k in _ACQ_SEG_KEYS]), B)
            self._note_seg_count(PS.host_seg_count([ccols[k] for k in _COMP_SEG_KEYS]), B2)
            cfg = self.cfg
        wd_a = WIRE.acquire_wire_dtypes(cfg)
        wd_c = WIRE.complete_wire_dtypes(cfg)
        a = E.AcquireBatch(**{f: self._upload(v, wd_a.get(f)) for f, v in acols.items()})
        c = E.CompleteBatch(**{f: self._upload(v, wd_c.get(f)) for f, v in ccols.items()})
        load, cpu = self._sys.sample()
        t = now_ms if now_ms is not None else self.time.now_ms()
        with self._engine_lock:
            self._state, out = self._tick(self._state, self._rules_dev, a, c, int(t), load, cpu)
        return out, self._wire_layout(B), inv, int(t)

    def _wire_layout(self, b: int) -> WIRE.WireLayout:
        lo = self._wire_layouts.get(b)
        if lo is None:
            lo = self._wire_layouts[b] = WIRE.layout_for(self.cfg, b)
        return lo

    def _resolve(self, acq: List[AcquireRequest], dispatched) -> None:
        """THE readback: one copy of the packed wire, validated; the
        telemetry row, timeline rows and explain records are folded, then
        the verdicts fan out to the futures.  A main section that fails
        validation fails every item of the tick CLOSED; the explain section
        fails OPEN on its own checksum (obs/explain.py)."""
        out, lo, inv, now_ms = dispatched
        try:
            raw = out.wire.cpu().numpy()
            tl_bytes = lo.tl_rows * lo.tl_cols * 4
            _C_WIRE_RX.inc(raw.nbytes - tl_bytes)
            if tl_bytes:
                TLM._C_WIRE["rx"].inc(tl_bytes)
            # the chaos pipe covers only the fail-CLOSED main section; the
            # explain section behind it has its own site
            buf = raw.tobytes()
            split = lo.off_expl * 4
            if lo.expl_k and len(buf) > split:
                data = FP.pipe(_FP_PACKED_DECODE, buf[:split]) + buf[split:]
            else:
                data = FP.pipe(_FP_PACKED_DECODE, buf)
            frame = WIRE.unpack(data, lo)
            verdict, wait = frame.verdict, frame.wait
            if wait is None:  # more PASS_WAIT rows than the sidecar holds
                wait = out.wait_ms.cpu().numpy()
        except WIRE.WireDecodeError:
            _C_PACKED_DECODE.inc()
            self.wire_decode_failures += 1
            self._fail_closed(acq)
            return
        except Exception:
            # a failed readback (device fault) fails the tick CLOSED too;
            # the tick loop reports the error
            self._fail_closed(acq)
            raise
        if frame.stats is not None:
            self._fold_device_stats(frame.stats)
        if frame.res_stats is not None and self.timeline is not None:
            self.timeline.note_tick(frame.res_stats, now_ms, self.time.wall_ms(now_ms) - now_ms)
        if frame.hot is not None and self.hotset is not None:
            self.hotset.fold(frame.hot)
        if frame.expl is not None and self.explain_plane is not None:
            # BEFORE the verdict fan-out, so an entry() that raises a
            # BlockException can already look itself up in explain()
            self.explain_plane.ingest_section(frame.expl, ts_ms=now_ms)
        if frame.seg_dropped:
            self.seg_dropped_total += frame.seg_dropped
        if inv is not None:
            # the wire's rows (bitmap and PASS_WAIT sidecar alike) are
            # positions in the sorted batch: back to submission order
            verdict, wait = verdict[inv], wait[inv]
        for i, r in enumerate(acq):
            if r.future is not None:
                r.future.set_result((int(verdict[i]), int(wait[i])))

    @staticmethod
    def _fold_device_stats(s) -> None:
        """Land one telemetry row (ops/engine.STAT_* float32 vector, host
        numpy) in the registry: verdict-mix counters plus the window and
        ceiling gauges."""
        n_pass = int(s[E.STAT_PASS])
        n_wait = int(s[E.STAT_PASS_WAIT])
        if n_pass:
            _C_DEV_VERDICTS["pass"].inc(n_pass)
        if n_wait:
            _C_DEV_VERDICTS["pass_wait"].inc(n_wait)
        for key, idx in (
            ("block_authority", E.STAT_BLOCK_AUTHORITY),
            ("block_system", E.STAT_BLOCK_SYSTEM),
            ("block_param", E.STAT_BLOCK_PARAM),
            ("block_flow", E.STAT_BLOCK_FLOW),
            ("block_degrade", E.STAT_BLOCK_DEGRADE),
        ):
            n = int(s[idx])
            if n:
                _C_DEV_VERDICTS[key].inc(n)
        n = int(s[E.STAT_FORCED])
        if n:
            _C_DEV_FORCED.inc(n)
        n = int(s[E.STAT_PASS_TOKENS])
        if n:
            _C_DEV_TOKENS["pass"].inc(n)
        n = int(s[E.STAT_BLOCK_TOKENS])
        if n:
            _C_DEV_TOKENS["block"].inc(n)
        _G_DEV_WIN_PASS.set(float(s[E.STAT_WIN_PASS]))
        _G_DEV_MIN_RT.set(_mask_min_rt(float(s[E.STAT_WIN_RT_MIN])))
        _G_DEV_CONC.set(float(s[E.STAT_ENTRY_CONC]))
        _G_DEV_CEIL_UTIL.set(float(s[E.STAT_CEIL_UTIL]))
        _G_DEV_SEG_LIVE.set(float(s[E.STAT_SEG_LIVE]))

    @staticmethod
    def _fail_closed(acq: List[AcquireRequest]) -> None:
        """Resolve every still-waiting request of a tick as BLOCK_SYSTEM."""
        for r in acq:
            if r.future is not None and not r.future.done():
                r.future.set_result((int(ERR.BLOCK_SYSTEM), 0))


class ClientStats:
    """Windowed statistics of a resource as the client's state holds them
    (the reference's ``ClientStats``, reduced to the exact rows' read the
    hot-set manager's demotion grades).  The sketch ids' estimates
    (``_sketch_stats``) are ROADMAP.md Queue A item 4."""

    def __init__(self, client: SentinelClient):
        self._c = client

    def _row_stats(self, row: int) -> Dict[str, float]:
        c = self._c
        sec_cfg = W.WindowConfig(c.cfg.second_sample_count, c.cfg.second_window_ms)
        now = c.time.now_ms()
        with c._engine_lock:
            win = c._state.win_sec
            mask = W.valid_mask(win, now, sec_cfg)
            counts = torch.sum(win.counts[row] * mask.to(torch.int32)[:, None], dim=0).tolist()
            rt_tot = float(torch.sum(win.rt_sum[row] * mask.to(torch.float32)))
            rt_min = float(torch.amin(torch.where(mask, win.rt_min[row], W.RT_MIN_INIT)))
            conc = int(c._state.concurrency[row])
        interval_s = sec_cfg.interval_ms / 1000.0
        succ = float(counts[W.EV_SUCCESS])
        return {
            "passQps": float(counts[W.EV_PASS]) / interval_s,
            "blockQps": float(counts[W.EV_BLOCK]) / interval_s,
            "successQps": succ / interval_s,
            "exceptionQps": float(counts[W.EV_EXCEPTION]) / interval_s,
            "occupiedPassQps": float(counts[W.EV_OCCUPIED]) / interval_s,
            "avgRt": rt_tot / succ if succ > 0 else 0.0,
            "minRt": _mask_min_rt(rt_min),
            "curThreadNum": conc,
        }

    def resource(self, name: str) -> Optional[Dict[str, float]]:
        """The resource's windowed stats (None when it was never seen)."""
        rid = self._c.registry.peek_resource_id(name)
        if rid is None:
            return None
        if self._c.registry.is_sketch_id(rid):
            raise NotImplementedError(
                "not ported to sentinel_tpu_torch yet: windowed stats of a sketch-id "
                "resource (ROADMAP.md Queue A item 4)"
            )
        return self._row_stats(rid)
