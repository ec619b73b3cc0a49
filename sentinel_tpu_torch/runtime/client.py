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
inverse permutation.  It counts each side's live segments exactly before
it dispatches.  Under ``seg_fallback=True`` (the default) it hands the
tick that count's verdict (``engine.tick``'s ``seg_fits``), so a side that
overflows ``seg_u`` runs the per-item branch alone — exact, only slower —
and grows ``seg_u`` once four ticks have overflowed (``_note_seg_count``,
the reference's rule); ``seg_fallback_ticks`` counts those ticks.  Under
``seg_fallback=False`` it grows ``seg_u`` at the first tick that would
overflow it, so no tick drops items for capacity; any item the engine
still fails closed for capacity is counted in ``seg_dropped_total``
(``_record_seg_dropped``).  Every rule load sets ``seg_static_ranks`` when
the rules allow the scan-only ranks (single lanes, DIRECT rules with the
default limitApp).

The bulk API takes column arrays of resource ids, no per-item Python:
``submit_block`` / ``check_batch_ids`` (acquires; ``ArrayBlock``),
``submit_completion_block`` (exits), ``submit_acquire`` and
``check_batch`` (named requests).  A tick fills its batch with object
requests first, then blocks; a block larger than the batch spans ticks
and resolves once, when all of its items have.  With ``pipeline_depth >
0`` the tick loop runs up to that many ticks ahead of their readback:
each tick's wire is copied into a pinned host buffer behind a CUDA event
as soon as it is dispatched, and one resolver thread waits on the event,
decodes and fans out, in tick order (the observability folds with it).  A
readback buffer goes back to its pool only once its tick is resolved.

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
completion ring, backpressure and deadlines (``deadline_ms`` raises),
front doors, adaptive protection, the flight recorder and the block log,
the obs span tracer, the sketch-accuracy audit and the sketch ids'
windowed stats (``stats.resource`` on a sketch id).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

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

_log = logging.getLogger(__name__)


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
_C_SEG_DROPPED = OBS.counter(
    "sentinel_seg_dropped_total",
    "items whose effects a seg_fallback=False engine dropped on capacity overflow",
)
_C_SEG_RESIZE = OBS.counter(
    "sentinel_seg_resizes_total", "seg_u capacity grow-and-hot-swap events"
)
_C_RESOLVE_FAILED = OBS.counter(
    "sentinel_resolve_failures_total",
    "tick resolutions that raised; their items failed CLOSED (system block)",
)
_G_OCCUPANCY = OBS.gauge(
    "sentinel_pipeline_occupancy", "dispatched-but-unresolved engine ticks"
)
_G_RESOLVER_Q = OBS.gauge(
    "sentinel_resolver_queue_depth", "in-flight resolver-pool readbacks"
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


def _no_deadlines(deadline_ms: int) -> None:
    """Deadline-aware backpressure is not ported (ROADMAP.md Queue A item
    6): a deadline would be silently ignored, so it raises."""
    if deadline_ms:
        raise NotImplementedError(
            "not ported to sentinel_tpu_torch yet: deadline_ms (deadline-aware "
            "backpressure, ROADMAP.md Queue A item 6)"
        )


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


@dataclass
class ArrayBlock:
    """A bulk acquire submission: column arrays, no per-item Python.

    Resource IDS (registry currency) and optional per-item columns; the
    tick loop slices blocks into engine batches.  ``future`` resolves to
    (verdicts int8 [n], waits int32 [n]) in submission order once every
    item has been decided."""

    res: np.ndarray  # int32 [n]
    count: Optional[np.ndarray] = None
    prio: Optional[np.ndarray] = None
    origin_id: Optional[np.ndarray] = None
    origin_node: Optional[np.ndarray] = None
    ctx_node: Optional[np.ndarray] = None
    ctx_name: Optional[np.ndarray] = None
    inbound: Optional[np.ndarray] = None
    param_hash: Optional[np.ndarray] = None  # int32 [n, param_dims]
    pre_verdict: Optional[np.ndarray] = None
    future: Optional[Future] = None
    # internal progress
    taken: int = 0  # items already placed into ticks
    unresolved: int = 0  # items whose verdicts are still pending
    verdicts: Optional[np.ndarray] = None  # int8 [n] result buffer
    waits: Optional[np.ndarray] = None  # int32 [n] result buffer


@dataclass
class _PendingTick:
    """A dispatched engine tick whose wire has not been decoded yet.

    Its readback is already under way: ``buf`` is a host buffer (pinned on
    the card) the wire is being copied into, ``event`` the CUDA event
    recorded behind that copy (None on the CPU, where the copy is done)."""

    acq: List[AcquireRequest]
    blocks: list  # [(ArrayBlock, src_off, take), ...] at batch offset n_obj
    inv_a: Optional[np.ndarray]
    out: Any  # TickOutput (device tensors)
    n_obj: int  # object-request count (blocks start here)
    n_blk: int  # block item count
    wire_lo: Any  # packed-wire layout of this tick's batch shape
    now_ms: int  # engine timestamp the tick ran at (timeline fold key)
    buf: Optional[torch.Tensor] = None
    event: Any = None
    # fan-out progress: a failed resolve fails CLOSED only the blocks the
    # normal path had not reached (no double decrement)
    blocks_done: int = 0


class _ReadbackPool:
    """Host buffers for the wire's device-to-host copies, pinned when the
    client runs on the card (so the copy is asynchronous).  A buffer is
    handed out again only after ``give`` returned it — after its tick was
    resolved — so an in-flight tick's bytes are never overwritten."""

    def __init__(self, pinned: bool):
        self._pinned = pinned
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._lock = threading.Lock()
        #: buffers allocated so far (steady state: pipeline_depth + 1 a shape)
        self.allocated = 0

    def take(self, n: int) -> torch.Tensor:
        with self._lock:
            free = self._free.get(n)
            if free:
                return free.pop()
            self.allocated += 1
        return torch.empty((n,), dtype=torch.int32, pin_memory=self._pinned)

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            self._free.setdefault(buf.shape[0], []).append(buf)


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
        pipeline_depth: int = 0,
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
        # bulk column-array submissions (ArrayBlock) and bulk completions
        # (dicts of _COMP_COLS columns plus param_hash)
        self._acq_blocks: List[ArrayBlock] = []
        self._comp_blocks: List[dict] = []
        # guards block progress accounting (resolver thread vs fail-closed)
        self._blk_lock = threading.Lock()
        self._wire_layouts: Dict[int, WIRE.WireLayout] = {}
        # dispatched-but-unresolved ticks: under sustained load the loop runs
        # up to pipeline_depth ticks ahead of their readback; ONE resolver
        # thread decodes them in tick order (it always drains to empty before
        # the loop goes idle, so latency at a low rate is unchanged)
        self._pipeline_depth = max(0, int(pipeline_depth))
        self._pending_ticks: List[_PendingTick] = []
        self._resolver_pool: Optional[ThreadPoolExecutor] = None
        self._resolve_futs: List[Future] = []
        self._readback = _ReadbackPool(pinned=self.device.type == "cuda")
        #: ticks whose wire failed validation (each failed CLOSED)
        self.wire_decode_failures = 0
        #: items the engine failed closed past the segment capacity
        self.seg_dropped_total = 0
        self._seg_drop_last_log_s = -1
        #: ticks in which a side overflowed seg_u and ran the per-item
        #: branch (seg_fallback=True)
        self.seg_fallback_ticks = 0
        #: largest live-segment count seen in one batch
        self._seg_obs_peak = 0
        #: overflowing ticks since the last seg_u resize (seg_fallback=True
        #: resizes after 4)
        self._seg_over_ticks = 0
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
        with self._tick_mutex:
            self._drain_resolves()
            if self._resolver_pool is not None:
                self._resolver_pool.shutdown(wait=True)
                self._resolver_pool = None
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
        _ctx: Optional[Tuple[str, str]] = None,
        _push_ctx: bool = True,
    ) -> Entry:
        """Acquire; raises BlockException on rejection (SphU.entry).
        ``args``: the call's arguments; the ones param-flow rules on this
        resource index are hashed into the hot-parameter lanes.
        ``_ctx`` / ``_push_ctx`` serve ``entry_async``: the caller's
        context captured on its own thread, and the entry left off this
        thread's stack."""
        ctx_name, ctx_origin = _ctx if _ctx is not None else CTX.current()
        origin = origin if origin is not None else ctx_origin
        rid = self.registry.resource_id(resource)
        if rid is None:
            e = _PassThroughEntry(self, resource)
            if _push_ctx:
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
        if _push_ctx:
            CTX.push_entry(e)
        return e

    async def entry_async(self, resource: str, **kw) -> Entry:
        """AsyncEntry analog: the entry handshake (a blocking wait on the
        engine tick) runs in an executor so the event loop never blocks;
        raises BlockException like entry().  Exit the returned Entry
        normally.  The caller's context is captured HERE and the Entry is
        pushed onto the awaiting task's context stack after the handshake:
        ``run_in_executor`` does not carry contextvars across."""
        import asyncio
        import functools

        ctx = CTX.current()
        loop = asyncio.get_running_loop()
        e = await loop.run_in_executor(
            None, functools.partial(self.entry, resource, _ctx=ctx, _push_ctx=False, **kw)
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

    # -- bulk API -------------------------------------------------------------

    def submit_acquire(
        self,
        resource: str,
        count: int = 1,
        prioritized: bool = False,
        inbound: bool = False,
        deadline_ms: int = 0,
    ) -> Optional[Future]:
        """Non-blocking single acquire: queue the request and return its
        Future of (verdict, wait_ms), or None for an unknown resource (a
        pass-through: the registry is full).  Thousands of in-flight
        requests coalesce into engine micro-batches without a thread each."""
        _no_deadlines(deadline_ms)
        rid = self.registry.resource_id(resource)
        if rid is None:
            return None
        req = AcquireRequest(
            res=rid,
            count=count,
            prio=1 if prioritized else 0,
            origin_id=-1,
            origin_node=self.cfg.trash_row,
            ctx_node=self.cfg.trash_row,
            ctx_name=-1,
            inbound=1 if inbound else 0,
            future=Future(),
            param_hash=(0,) * self.cfg.param_dims,
        )
        with self._lock:
            self._acquires.append(req)
        if self.mode == "sync":
            self.tick_once()
        return req.future

    def check_batch(
        self,
        resources: Sequence[str],
        counts: Optional[Sequence[int]] = None,
        origins: Optional[Sequence[str]] = None,
        params: Optional[Sequence[Any]] = None,
        prioritized: Optional[Sequence[bool]] = None,
        inbound: bool = False,
        deadline_ms: int = 0,
    ) -> List[Tuple[int, int]]:
        """Vector acquire: [(verdict, wait_ms)] per resource, N decisions in
        as few ticks as the batch size allows.  ``params[i]`` is hashed into
        lane 0; an unknown resource (full registry) passes through."""
        _no_deadlines(deadline_ms)
        futures = []
        with self._lock:
            for i, name in enumerate(resources):
                rid = self.registry.resource_id(name)
                if rid is None:
                    futures.append(None)
                    continue
                origin = origins[i] if origins else ""
                pv = params[i] if params else None
                req = AcquireRequest(
                    res=rid,
                    count=counts[i] if counts else 1,
                    prio=1 if (prioritized is not None and prioritized[i]) else 0,
                    origin_id=self.registry.origin_id(origin) if origin else -1,
                    origin_node=self.registry.origin_node_row(name, origin)
                    if origin
                    else self.cfg.trash_row,
                    ctx_node=self.cfg.trash_row,
                    ctx_name=-1,
                    inbound=1 if inbound else 0,
                    future=Future(),
                    param_hash=(hash_param(pv),) + (0,) * (self.cfg.param_dims - 1)
                    if pv is not None
                    else (0,) * self.cfg.param_dims,
                )
                self._acquires.append(req)
                futures.append(req.future)
        if self.mode == "sync":
            self.tick_once()
        return [
            (ERR.PASS, 0) if f is None else f.result(timeout=self.entry_timeout_s)
            for f in futures
        ]

    def submit_block(
        self,
        res: np.ndarray,
        counts: Optional[np.ndarray] = None,
        prio: Optional[np.ndarray] = None,
        origin_id: Optional[np.ndarray] = None,
        origin_node: Optional[np.ndarray] = None,
        ctx_node: Optional[np.ndarray] = None,
        ctx_name: Optional[np.ndarray] = None,
        inbound: Optional[np.ndarray] = None,
        param_hash: Optional[np.ndarray] = None,
        pre_verdict: Optional[np.ndarray] = None,
        deadline_ms: int = 0,
    ) -> Future:
        """Bulk acquire: COLUMN ARRAYS of engine resource ids (from
        ``registry.resource_id``), no per-item Python objects.  Returns a
        Future of (verdicts int8 [n], waits int32 [n]) in submission order;
        a block larger than the batch size spans ticks.  Negative ids are
        padding (the trash row).  Done-callbacks run on the resolving
        thread and must not block on another tick (they may submit more)."""
        _no_deadlines(deadline_ms)
        res = np.ascontiguousarray(res, dtype=np.int32)
        n = len(res)
        # negative ids would wrap in the scatters: they become padding
        if (res < 0).any():
            res = np.where(res < 0, np.int32(self.cfg.trash_row), res)

        def col(x):
            if x is None:
                return None
            x = np.ascontiguousarray(x, dtype=np.int32)
            if len(x) != n:
                raise ValueError(f"column of {len(x)} items for a block of {n}")
            return x

        blk = ArrayBlock(
            res=res,
            count=col(counts),
            prio=col(prio),
            origin_id=col(origin_id),
            origin_node=col(origin_node),
            ctx_node=col(ctx_node),
            ctx_name=col(ctx_name),
            inbound=col(inbound),
            param_hash=(
                np.ascontiguousarray(param_hash, dtype=np.int32).reshape(n, -1)
                if param_hash is not None
                else None
            ),
            pre_verdict=col(pre_verdict),
            future=Future(),
            unresolved=n,
            verdicts=np.zeros(n, np.int8),
            waits=np.zeros(n, np.int32),
        )
        if n == 0:
            blk.future.set_result((blk.verdicts, blk.waits))
            return blk.future
        with self._lock:
            self._acq_blocks.append(blk)
        if self.mode == "sync":
            self.tick_once()
        return blk.future

    def check_batch_ids(
        self,
        res: np.ndarray,
        counts: Optional[np.ndarray] = None,
        timeout_s: Optional[float] = None,
        **cols,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking form of submit_block: (verdicts, waits) arrays."""
        fut = self.submit_block(res, counts=counts, **cols)
        return fut.result(timeout=timeout_s or self.entry_timeout_s)

    def submit_completion_block(
        self,
        res: np.ndarray,
        rt: np.ndarray,
        success: Optional[np.ndarray] = None,
        error: Optional[np.ndarray] = None,
        inbound: Optional[np.ndarray] = None,
        origin_node: Optional[np.ndarray] = None,
        ctx_node: Optional[np.ndarray] = None,
        param_hash: Optional[np.ndarray] = None,
    ) -> None:
        """Bulk exits for block-acquired traffic: column arrays, queued for
        the next tick (completions are fire-and-forget).  ``success``
        defaults to 1, ``error`` and ``inbound`` to 0, the node rows to
        the trash row; ``param_hash`` carries the THREAD-grade release
        lanes."""
        res = np.ascontiguousarray(res, dtype=np.int32)
        n = len(res)
        trash = self.cfg.trash_row
        given = dict(res=res, origin_node=origin_node, ctx_node=ctx_node, inbound=inbound, rt=rt,
                     success=success, error=error)
        blk = {}
        for f, fill, dt in _COMP_COLS:
            x = given[f]
            if x is None:  # a block's exits default to one success each
                x = np.full(n, trash if fill is None else 1 if f == "success" else fill, dt)
            x = np.ascontiguousarray(x, dtype=dt)
            if len(x) != n:
                raise ValueError(f"column {f} of {len(x)} items for a block of {n}")
            blk[f] = x
        blk["inbound"] = (blk["inbound"] != 0).astype(np.int32)
        M = self.cfg.param_dims
        ph = np.zeros((n, M), np.int32)
        if param_hash is not None:
            src = np.ascontiguousarray(param_hash, dtype=np.int32).reshape(n, -1)[:, :M]
            ph[:, : src.shape[1]] = src
        blk["param_hash"] = ph
        if n == 0:
            return
        with self._lock:
            self._comp_blocks.append(blk)
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
        bs, cbs = self.cfg.batch_size, self.cfg.complete_batch_size
        while True:
            blocks = []
            comp_pieces = []
            with self._lock:
                acq = self._acquires[:bs]
                self._acquires = self._acquires[bs:]
                # bulk blocks fill the rest of the batch (object requests
                # first: a caller is blocked on each of them)
                room = bs - len(acq)
                while room > 0 and self._acq_blocks:
                    blk = self._acq_blocks[0]
                    take = min(room, len(blk.res) - blk.taken)
                    blocks.append((blk, blk.taken, take))
                    blk.taken += take
                    room -= take
                    if blk.taken >= len(blk.res):
                        self._acq_blocks.pop(0)
                comp = self._completions[:cbs]
                self._completions = self._completions[cbs:]
                # completion blocks join after the object completions
                room_c = cbs - len(comp)
                while room_c > 0 and self._comp_blocks:
                    cb = self._comp_blocks[0]
                    k = len(cb["res"])
                    if k <= room_c:
                        comp_pieces.append(cb)
                        self._comp_blocks.pop(0)
                        room_c -= k
                    else:
                        comp_pieces.append({f: v[:room_c] for f, v in cb.items()})
                        self._comp_blocks[0] = {f: v[room_c:] for f, v in cb.items()}
                        room_c = 0
            if not acq and not blocks and not comp and not comp_pieces and now_ms is None:
                # idle: flush any deferred readbacks before returning
                self._drain_resolves()
                return
            try:
                pending = self._run_tick(acq, comp, now_ms, blocks=blocks, comp_blocks=comp_pieces)
            except Exception:
                # a tick that cannot run decides nothing: its callers
                # get a fail-closed verdict, not an entry timeout
                self._fail_tick(_PendingTick(
                    acq=acq, blocks=blocks, inv_a=None, out=None, n_obj=len(acq), n_blk=0,
                    wire_lo=None, now_ms=0,
                ))
                raise
            self._pending_ticks.append(pending)
            _G_OCCUPANCY.set(len(self._pending_ticks))
            with self._lock:
                more = bool(self._acquires or self._acq_blocks or self._completions or self._comp_blocks)
            depth = self._pipeline_depth if more else 0
            while len(self._pending_ticks) > depth:
                p = self._pending_ticks.pop(0)
                if self._pipeline_depth > 0:
                    self._resolve_futs.append(self._pool().submit(self._resolve_tick, p))
                else:
                    self._resolve_tick(p)
            if self._resolve_futs:
                alive = []
                for f in self._resolve_futs:
                    if not f.done():
                        alive.append(f)
                    elif f.exception() is not None:
                        # a lost resolution must never vanish silently (its
                        # items were failed closed by _resolve_tick)
                        _log.error("tick resolution failed: %r", f.exception(), exc_info=f.exception())
                self._resolve_futs = alive
            _G_RESOLVER_Q.set(len(self._resolve_futs))
            if not more:
                # wait out in-flight resolutions; their callbacks may queue
                # new work (closed-loop callers) — check again
                self._drain_resolves()
                with self._lock:
                    more = bool(self._acquires or self._acq_blocks or self._completions or self._comp_blocks)
                if not more:
                    return
            now_ms = None

    def _pool(self) -> ThreadPoolExecutor:
        """The resolver: ONE thread, so ticks resolve — and the
        observability planes fold — in dispatch order; stop() shuts it."""
        if self._resolver_pool is None:
            self._resolver_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sentinel-resolve")
        return self._resolver_pool

    def _drain_resolves(self) -> None:
        """Flush deferred readbacks: pending ticks not yet handed to the
        resolver, then every in-flight resolution (bounded: a wedged
        readback is abandoned after 2 x entry_timeout_s, at least 5 s)."""
        while self._pending_ticks:
            p = self._pending_ticks.pop(0)
            if self._pipeline_depth > 0:
                self._resolve_futs.append(self._pool().submit(self._resolve_tick, p))
            else:
                self._resolve_tick(p)
        futs, self._resolve_futs = self._resolve_futs, []
        deadline = mono_s() + max(2.0 * self.entry_timeout_s, 5.0)
        for f in futs:
            try:
                f.result(timeout=max(0.0, deadline - mono_s()))
            except _FutTimeout:
                _log.warning("resolve drain abandoned a wedged tick")
            except Exception as exc:
                _log.error("tick resolution failed: %r", exc, exc_info=exc)
        _G_OCCUPANCY.set(0)
        _G_RESOLVER_Q.set(0)

    def _warm_shapes(self) -> None:
        """Run both batch shapes once with no-op batches (builds the
        kernels before serving)."""
        self._resolve_tick(self._run_tick([], [], self.time.now_ms()))
        if self.cfg.batch_size > 256:
            filler = AcquireRequest(
                res=self.cfg.trash_row, count=0, prio=0, origin_id=-1,
                origin_node=self.cfg.trash_row, ctx_node=self.cfg.trash_row,
                ctx_name=-1, inbound=0,
            )
            self._resolve_tick(self._run_tick([filler] * 257, [], self.time.now_ms()))

    @staticmethod
    def _shape_for(n: int, cap: int) -> int:
        """Two batch shapes: a light tick runs at <= 256 rows, anything
        bigger at the full configured batch."""
        return min(256, cap) if n <= 256 else cap

    def _note_seg_count(self, segs: int, b: int) -> None:
        """Track the live-segment count of the batch about to be dispatched
        against the compacted capacity.

        ``seg_fallback=True`` (the reference's rule): an overflowing tick is
        exact through the per-item branch, only slower, so ``seg_u`` grows
        — to ``ceil((1.25 * peak + 128) / 128) * 128``, at most the batch —
        once four ticks have overflowed, and only past the full shape's
        capacity.  ``seg_fallback=False``: overflow items would fail
        closed, so ``seg_u`` grows at the first overflow, before the tick
        runs (eager PyTorch has nothing to compile: the new capacity serves
        this very tick); unlike the JAX client, a light tick that overflows
        its own automatic capacity while the full shape's still covers the
        peak pins ``seg_u`` at the full shape's capacity."""
        self._seg_obs_peak = max(self._seg_obs_peak, segs)
        if segs <= ES.seg_capacity(self.cfg, b):
            return
        if self.cfg.seg_fallback:
            self._seg_over_ticks += 1
            if self._seg_over_ticks < 4:
                return
            b_full = self.cfg.batch_size
            new_u = min(b_full, -(-int(self._seg_obs_peak * 1.25 + 128) // 128) * 128)
            if new_u <= ES.seg_capacity(self.cfg, b_full):
                return  # the full shape's capacity already covers the peak
            self._resize_seg_u(new_u)
            return
        new_u = grown_seg_u(self.cfg, self._seg_obs_peak)
        if new_u == self.cfg.seg_u:
            return  # already at the batch size: nothing larger to give
        self._resize_seg_u(new_u)

    def _resize_seg_u(self, new_u: int) -> None:
        """Swap in a tick with the compacted capacity ``new_u`` (eager
        PyTorch: nothing to compile, the swap is immediate)."""
        _C_SEG_RESIZE.inc()
        cfg = dataclasses.replace(self.cfg, seg_u=int(new_u))
        with self._engine_lock:
            self.cfg = self.registry.cfg = cfg
            self._tick = E.make_tick(cfg, features=self._features)
            self._seg_over_ticks = 0

    def _record_seg_dropped(self, n: int) -> None:
        """Surface fail-closed segment-overflow drops (seg_fallback=False):
        the counter, the client's total and a warning at most once a
        second (the reference also writes the block log, not ported)."""
        _C_SEG_DROPPED.inc(n)
        with self._blk_lock:
            self.seg_dropped_total += n
        sec = int(self.time.wall_ms() // 1000)
        if sec != self._seg_drop_last_log_s:
            self._seg_drop_last_log_s = sec
            _log.warning(
                "segment capacity overflow: %d items FAILED CLOSED this tick (total %d) — "
                "seg_u=%d is undersized for the live traffic; raise seg_u or set seg_fallback=True",
                n, self.seg_dropped_total, ES.seg_capacity(self.cfg, self.cfg.batch_size),
            )

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

    def _acquire_columns(self, acq: List[AcquireRequest], blocks, B: int) -> dict:
        """The acquire batch's host columns: object requests at [0, n),
        block slices after them (array copies, no per-item Python), trash
        padding to B; counts clamped to the fused kernels' envelope."""
        cfg = self.cfg
        trash = cfg.trash_row
        n = len(acq)
        cols = {}
        for f, fill, dt in _ACQ_COLS:
            col = np.full(B, trash if fill is None else fill, dt)
            if acq:
                col[:n] = [getattr(r, f) for r in acq]
            o = n
            for blk, off, take in blocks:
                src = getattr(blk, f)
                if src is not None:
                    col[o : o + take] = src[off : off + take]
                elif f == "count":
                    col[o : o + take] = 1
                o += take
            if f == "count":
                np.minimum(col, cfg.max_batch_count, out=col)  # the fused kernels' envelope
            cols[f] = col
        ph = self._hash_col(acq, B)
        o = n
        M = cfg.param_dims
        for blk, off, take in blocks:
            if blk.param_hash is not None:
                src = blk.param_hash[off : off + take, :M]
                ph[o : o + take, : src.shape[1]] = src
            o += take
        cols["param_hash"] = ph
        return cols

    def _completion_columns(self, comp: List[Completion], comp_blocks: List[dict], B2: int) -> dict:
        """The completion batch's host columns: object completions first,
        then completion-block slices; successes and errors clamped."""
        cfg = self.cfg
        trash = cfg.trash_row
        cap = cfg.max_batch_count
        n = len(comp)
        cols = {}
        for f, fill, dt in _COMP_COLS:
            col = np.full(B2, trash if fill is None else fill, dt)
            if comp:
                col[:n] = [getattr(c, f) for c in comp]
            o = n
            for cb in comp_blocks:
                k = len(cb["res"])
                col[o : o + k] = cb[f]
                o += k
            if f in ("success", "error"):
                np.minimum(col, cap, out=col)
            cols[f] = col
        ph = self._hash_col(comp, B2)
        o = n
        for cb in comp_blocks:
            k = len(cb["res"])
            ph[o : o + k] = cb["param_hash"]
            o += k
        cols["param_hash"] = ph
        return cols

    def _run_tick(self, acq: List[AcquireRequest], comp: List[Completion], now_ms, blocks=(), comp_blocks=()):
        """Build (and on the segment path presort) the batch columns, upload
        them (the uploads finish before the tick starts), run one tick and
        start its wire's readback into a host buffer; returns the
        ``_PendingTick``."""
        cfg = self.cfg
        n_blk = sum(t for _b, _o, t in blocks)
        n_comp = len(comp) + sum(len(cb["res"]) for cb in comp_blocks)
        B = self._shape_for(len(acq) + n_blk, cfg.batch_size)
        B2 = self._shape_for(n_comp, cfg.complete_batch_size)
        acols = self._acquire_columns(acq, blocks, B)
        ccols = self._completion_columns(comp, list(comp_blocks), B2)
        inv = None
        seg_fits = None
        if cfg.seg_effects:
            # trash-row padding has the largest res, so it sorts last and
            # stays inside the sort
            order, inv = PS.batch_sort5(*(acols[k] for k in _ACQ_SEG_KEYS))
            acols = {k: v[order] for k, v in acols.items()}
            # completions carry no futures: sort, no unsort (their effects
            # are order-independent sums and minima)
            order_c, _ = PS.batch_sort3(*(ccols[k] for k in _COMP_SEG_KEYS))
            ccols = {k: v[order_c] for k, v in ccols.items()}
            segs_a = PS.host_seg_count([acols[k] for k in _ACQ_SEG_KEYS])
            segs_c = PS.host_seg_count([ccols[k] for k in _COMP_SEG_KEYS])
            self._note_seg_count(segs_a, B)
            self._note_seg_count(segs_c, B2)
            cfg = self.cfg
            if cfg.seg_fallback:
                # the exact count decides each side's branch on the host
                # (engine.tick's seg_fits): no device-side selection needed
                seg_fits = (segs_c <= ES.seg_capacity(cfg, B2), segs_a <= ES.seg_capacity(cfg, B))
                if not all(seg_fits):
                    self.seg_fallback_ticks += 1
        wd_a = WIRE.acquire_wire_dtypes(cfg)
        wd_c = WIRE.complete_wire_dtypes(cfg)
        a = E.AcquireBatch(**{f: self._upload(v, wd_a.get(f)) for f, v in acols.items()})
        c = E.CompleteBatch(**{f: self._upload(v, wd_c.get(f)) for f, v in ccols.items()})
        load, cpu = self._sys.sample()
        t = now_ms if now_ms is not None else self.time.now_ms()
        with self._engine_lock:
            self._state, out = self._tick(
                self._state, self._rules_dev, a, c, int(t), load, cpu, seg_fits=seg_fits
            )
        # start the readback NOW: the copy into a host buffer (pinned on the
        # card) is queued behind the tick, with an event the resolver waits on
        buf = self._readback.take(out.wire.shape[0])
        buf.copy_(out.wire, non_blocking=True)
        event = None
        if out.wire.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return _PendingTick(
            acq=acq, blocks=list(blocks), inv_a=inv, out=out, n_obj=len(acq), n_blk=n_blk,
            wire_lo=self._wire_layout(B), now_ms=int(t), buf=buf, event=event,
        )

    def _wire_layout(self, b: int) -> WIRE.WireLayout:
        lo = self._wire_layouts.get(b)
        if lo is None:
            lo = self._wire_layouts[b] = WIRE.layout_for(self.cfg, b)
        return lo

    def _resolve_tick(self, p: _PendingTick) -> None:
        """Decode one dispatched tick and fan its verdicts out — or, if
        anything on that path raises, fail the rest of the tick CLOSED
        (BLOCK_SYSTEM) instead of stranding its callers; then return its
        readback buffer to the pool."""
        try:
            self._resolve_tick_inner(p)
        except Exception:
            _C_RESOLVE_FAILED.inc()
            self._fail_tick(p)
            raise
        finally:
            if p.buf is not None:
                self._readback.give(p.buf)
                p.buf = None

    def _resolve_tick_inner(self, p: _PendingTick) -> None:
        """THE readback: wait for the tick's copy (its CUDA event), validate
        the packed wire; fold the telemetry row, timeline rows, hot block
        and explain records; then fan the verdicts out to the futures and
        the blocks.  A main section that fails validation fails every item
        of the tick CLOSED; the explain section fails OPEN on its own
        checksum (obs/explain.py)."""
        lo, out, now_ms = p.wire_lo, p.out, p.now_ms
        if p.event is not None:
            p.event.synchronize()
        raw = p.buf.numpy()
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
        try:
            frame = WIRE.unpack(data, lo)
        except WIRE.WireDecodeError:
            _C_PACKED_DECODE.inc()
            self.wire_decode_failures += 1
            self._fail_tick(p)
            return
        verdict, wait = frame.verdict, frame.wait
        if wait is None:  # more PASS_WAIT rows than the sidecar holds
            wait = out.wait_ms.cpu().numpy()
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
            self._record_seg_dropped(frame.seg_dropped)
        if p.inv_a is not None:
            # the wire's rows (bitmap and PASS_WAIT sidecar alike) are
            # positions in the sorted batch: back to submission order
            verdict, wait = verdict[p.inv_a], wait[p.inv_a]
        for i, r in enumerate(p.acq):
            if r.future is not None:
                r.future.set_result((int(verdict[i]), int(wait[i])))
        o = p.n_obj
        for blk, off, take in p.blocks:
            blk.verdicts[off : off + take] = verdict[o : o + take]
            blk.waits[off : off + take] = wait[o : o + take]
            self._block_done(blk, take)
            p.blocks_done += 1
            o += take

    def _block_done(self, blk: ArrayBlock, take: int) -> None:
        """``take`` more items of ``blk`` are decided; the block's future
        resolves once, when none is left."""
        with self._blk_lock:
            blk.unresolved -= take
            fire = blk.unresolved <= 0
        if fire and blk.future is not None and not blk.future.done():
            blk.future.set_result((blk.verdicts, blk.waits))

    def _fail_tick(self, p: _PendingTick) -> None:
        """Resolve every still-waiting consumer of a tick as BLOCK_SYSTEM:
        its object requests, and the block slices the normal fan-out had
        not reached (no double decrement)."""
        for r in p.acq:
            if r.future is not None and not r.future.done():
                r.future.set_result((int(ERR.BLOCK_SYSTEM), 0))
        for blk, off, take in p.blocks[p.blocks_done :]:
            blk.verdicts[off : off + take] = ERR.BLOCK_SYSTEM
            blk.waits[off : off + take] = 0
            self._block_done(blk, take)
            p.blocks_done += 1

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
