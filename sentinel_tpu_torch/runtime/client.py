"""Host runtime: SentinelClient — micro-batching + the tick loop.

The port's counterpart of ``sentinel_tpu/runtime/client.py``, reduced to
the admission path.  ``entry()`` queues an acquire; the tick loop (a
thread in ``mode="threaded"``, the caller's own thread in ``mode="sync"``)
builds the batch columns, uploads them, runs ONE engine tick, and reads
back ONE packed wire buffer (ops/wire.py), whose verdicts resolve the
waiting futures.  A wire buffer that fails validation fails the whole
tick CLOSED (every item gets BLOCK_SYSTEM).

Completions (``Entry.exit()``) are one push onto the native MPMC event
ring (native/ring.EventRing; an unbounded overflow list takes them when
the ring is full, so none is ever lost) and ride the next tick; bulk
completion blocks queue beside the ring in its column layout.  Counts,
successes and errors are clamped to ``cfg.max_batch_count`` at batch
build — the envelope the fused kernels carry exactly (core/config.py).

Batch assembly writes into two-slot host staging buffers (``_sbuf``,
pinned on the card), flipped every tick; a slot is written again only
after the CUDA event recorded behind its last uploads has completed, so
``pipeline_depth`` may run the card several ticks behind the host.  Each
column goes up through ``_dev_col``: a column equal to its fill
everywhere reuses one cached device constant, a column equal to the one
uploaded the tick before reuses that tensor (``cols_skipped``), and every
real upload is a copy, counted in ``sentinel_wire_bytes_total{direction=
"tx"}`` (the readback in ``direction="rx"``).  The engine never writes a
batch input in place, so cached columns are safe to share across ticks.

Extension points, at the reference's places: ``enabled`` (False: every
entry passes through and no tick runs), ``entry_hooks`` and the ordered
custom slots ``slots`` (runtime/slots.py; a BlockException raised there
rides the batch as the item's ``pre_verdict``, so the engine records the
block, and the original exception is re-raised), and the metric
extension SPI (metrics/extension.py: ``on_pass``, ``on_block``,
``on_complete``, ``on_exception``).

Stage spans (obs/trace.py, while tracing is on): each tick records
``tick.assemble`` (presort time taken out), ``tick.presort``,
``tick.dispatch`` (the eager tick call) on the dispatching thread, and
``tick.device`` (dispatch to the wire host-visible: the wait on the
tick's CUDA event), ``tick.readback`` and ``tick.resolve`` where it
resolves, all under one trace id; rule recompiles record
``client.recompile_rules`` and capacity resizes ``engine.seg_resize``.
``host_build_ms_avg`` is the mean host build time a tick (assembly,
presort, uploads), traced or not.

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

Cluster mode (FlowRuleChecker.passClusterCheck): a rule load splits
cluster-mode flow and param rules off the compiled ruleset; ``entry()``
and ``check_batch`` consult the token service of the attached
``ClusterStateManager`` (``set_cluster``) for them — after the host
mirror of the authority gate (``_authority_pre_blocks``), so a request
the authority slot will reject spends no token — and a remote deny rides
the batch as the item's ``pre_verdict`` (the engine records the block;
its provenance lands in the explain plane).  ``check_batch`` asks once per
(resource, argument) group and hands the granted units out greedily in
order.  With no service, or on a failed or overloaded one, the client
degrades (the ``cluster.degrade`` hysteresis, ``cluster_retry_interval_s``
of cooldown): the fallback-enabled cluster flow rules and every cluster
param rule are compiled in as local rules until a probe is answered.

Not ported yet (ROADMAP.md): the sharded cluster client (A7b), the
hot-parameter value counters (``top_params``), backpressure and deadlines
(``deadline_ms`` raises), front doors, adaptive protection, the flight
recorder and the block log, the sketch-accuracy audit and the sketch ids'
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

from sentinel_tpu_torch.adaptive.degrade import Hysteresis
from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.core.config import EngineConfig, app_name as cfg_app_name, platform_config
from sentinel_tpu_torch.core.rule_tensors import hash_param, param_lanes
from sentinel_tpu_torch.metrics import extension as MEXT
from sentinel_tpu_torch.native import EventRing
from sentinel_tpu_torch.native.ring import FLAG_COMPLETION, FLAG_INBOUND
from sentinel_tpu_torch.obs import timeline as TLM
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.explain import KIND_NAMES, ExplainPlane
from sentinel_tpu_torch.obs.registry import REGISTRY as OBS
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import engine_seg as ES
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime import context as CTX
from sentinel_tpu_torch.runtime import presort as PS
from sentinel_tpu_torch.runtime.registry import Registry
from sentinel_tpu_torch.runtime.slots import SlotChain, SlotContext, run_entry, run_exit
from sentinel_tpu_torch.sketch.hotset import HotSetManager, guarded_promote
from sentinel_tpu_torch.utils.system_status import SystemStatusSampler
from sentinel_tpu_torch.utils.time_source import TimeSource, VirtualTimeSource, mono_s

_log = logging.getLogger(__name__)

# -- per-stage tick histograms (obs/trace.py stage spans): they update only
# while tracing is enabled (OT.t0() truthiness is the hot path's single
# flag check)
_H_ASSEMBLE = OBS.histogram(
    "sentinel_tick_assemble_ms", "host batch assembly (columns + uploads) per tick"
)
_H_PRESORT = OBS.histogram(
    "sentinel_tick_presort_ms", "host segment-key presort (native sort + permute) per tick"
)
_H_DISPATCH = OBS.histogram(
    "sentinel_tick_dispatch_ms", "engine tick dispatch (the eager tick call) per tick"
)
_H_DEVICE = OBS.histogram(
    "sentinel_tick_device_ms",
    "dispatch to verdicts-host-visible per tick (device compute + transfer; "
    "includes pipeline queue wait)",
)
_H_READBACK = OBS.histogram(
    "sentinel_tick_readback_ms", "wire decode folds and residual device-to-host reads per tick"
)
_H_RESOLVE = OBS.histogram(
    "sentinel_tick_resolve_ms", "verdict fan-out (futures, blocks) per tick"
)

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
# -- wire byte accounting: the batch columns' uploads (tx) and the
# readback (rx; the timeline rows are counted under their own path,
# obs/timeline.py), as they cross between host and card
_C_WIRE = {
    d: OBS.counter(
        "sentinel_wire_bytes_total",
        "bytes moved, by path (device|cluster) and direction (tx|rx)",
        labels={"path": "device", "direction": d},
    )
    for d in ("tx", "rx")
}
_C_COLS_SKIPPED = OBS.counter(
    "sentinel_wire_cols_skipped_total",
    "batch-column uploads skipped because the column matched the previous tick",
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
_G_DEGRADED = OBS.gauge(
    "sentinel_cluster_degraded", "1 while cluster enforcement is degraded to local rules"
)
_C_DEGRADE_ENTER = OBS.counter(
    "sentinel_cluster_degrade_transitions_total",
    "cluster degrade state transitions",
    labels={"transition": "enter"},
)
_C_DEGRADE_EXIT = OBS.counter(
    "sentinel_cluster_degrade_transitions_total",
    "cluster degrade state transitions",
    labels={"transition": "exit"},
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


def _np_dtypes(wire_dtypes: dict) -> dict:
    """ops/wire.py's narrow torch dtypes as the numpy dtypes the host
    stages the columns in."""
    return {f: torch.empty(0, dtype=dt).numpy().dtype for f, dt in wire_dtypes.items()}


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
    # stage-span correlation: the tick's trace id and the monotonic ns its
    # dispatch returned (0 while tracing is off)
    tick_id: int = 0
    dispatched_ns: int = 0
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


class Entry:
    """Live entry handle (the reference's Entry/CtEntry).  ``exit()``
    records RT + success; ``trace(exc)`` marks a business exception."""

    __slots__ = (
        "client", "resource", "res", "origin_node", "ctx_node", "inbound",
        "count", "create_ms", "wait_ms", "param_hash", "_errors", "_exited",
        "slots", "slot_ctx",
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
        self.slots = ()  # entered custom slots (runtime/slots.py)
        self.slot_ctx = None

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
        rt = float(max(now - self.create_ms, 0))
        n = count if count is not None else self.count
        MEXT.safe_dispatch("on_complete", self.resource, rt, n, "")
        if self._errors:
            MEXT.safe_dispatch("on_exception", self.resource, self._errors, "")
        self.client._submit_completion(
            Completion(
                res=self.res,
                origin_node=self.origin_node,
                ctx_node=self.ctx_node,
                inbound=self.inbound,
                rt=rt,
                success=n,
                error=self._errors,
                param_hash=self.param_hash,
            )
        )
        if self.slots:
            self.slot_ctx.rt_ms = rt
            self.slot_ctx.success = n
            self.slot_ctx.errors = self._errors
            run_exit(self.slots, self.slot_ctx)

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

        # global protection switch (Constants.ON): when off, every entry is
        # a pass-through and nothing is counted
        self.enabled = True
        # custom entry hooks — the lightweight pre-check form: each hook
        # sees (resource, origin, args) before the engine check and may
        # raise a BlockException to reject
        self.entry_hooks: List[Any] = []
        # the ordered custom-slot SPI (runtime/slots.py): entry AND exit
        # hooks; register with client.slots.register(slot)
        self.slots = SlotChain()

        self.registry = Registry(self.cfg)
        self.flow_rules = RuleManager(self, "flow")
        self.degrade_rules = RuleManager(self, "degrade")
        self.system_rules = RuleManager(self, "system")
        self.authority_rules = RuleManager(self, "authority")
        self.param_flow_rules = RuleManager(self, "param-flow")
        self._sys = SystemStatusSampler()
        #: resource -> ordered param_idx list: which argument each hash lane carries
        self._param_lanes_by_res: Dict[str, list] = {}

        # cluster mode: cluster rules are checked against a TokenService; on
        # token-server loss the client degrades to local enforcement of the
        # rules that allow it (fallbackToLocalOrPass:166) and re-probes after
        # a cooldown
        self.cluster = None  # Optional[ClusterStateManager]
        self._cluster_flow_by_res: Dict[str, R.FlowRule] = {}
        self._cluster_param_by_res: Dict[str, R.ParamFlowRule] = {}
        #: host mirror of the authority gate: resource -> (origins, strategy)
        self._auth_host_rules: Dict[str, tuple] = {}
        # enter on a failed or missing service, exit on the first answered
        # probe; the transitions count on the reference's gauge and counters
        self._cluster_hy = Hysteresis(
            "cluster.degrade",
            cooldown_s=5.0,
            counter_enter=_C_DEGRADE_ENTER,
            counter_exit=_C_DEGRADE_EXIT,
            gauge=_G_DEGRADED,
        )
        # guards degrade transitions AND every ruleset recompile, so the
        # degraded flag each compile reads matches the ruleset it commits
        self._cluster_lock = threading.RLock()
        self.cluster_retry_interval_s = 5.0

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
        # completions are fire-and-forget (no futures), so they ride the
        # native MPMC event ring: Entry.exit() from any request thread is
        # one C call, and the tick drains straight into numpy columns
        self._comp_ring = EventRing(1 << 16)
        # completions must NEVER be lost (they release concurrency and feed
        # the breakers): when the ring is full they overflow into this
        # unbounded list
        self._comp_overflow: List[Completion] = []
        # bulk column-array submissions (ArrayBlock) and bulk completions
        # (tuples of columns in the ring's drain layout)
        self._acq_blocks: List[ArrayBlock] = []
        self._comp_blocks: List[tuple] = []
        # device-resident constant columns keyed by (field, fill, dtype,
        # shape): a batch column equal to its fill everywhere reuses one
        # cached device tensor instead of an upload every tick
        self._const_cols: Dict[tuple, torch.Tensor] = {}
        # dirty-column skip: field -> (PRIVATE host copy of the column as
        # last uploaded, its device tensor)
        self._col_last: Dict[str, tuple] = {}
        # two-slot staging for batch assembly: per-column host buffers
        # (pinned on the card) reused on alternating parity; a slot is
        # rewritten only once the CUDA event recorded behind its last
        # uploads has completed (_stage_events), whatever the pipeline depth
        self._stage: Dict[tuple, list] = {}
        self._stage_parity = 0
        self._stage_events: List[Any] = [None, None]
        self._pinned = self.device.type == "cuda"
        # empty batches of a side with nothing queued (never uploaded)
        self._empty_batches: Dict[tuple, Any] = {}
        # running sum of host batch-build time (host_build_ms_avg)
        self._build_ms_sum = 0.0
        self._build_ticks = 0
        #: which host presort ran the last segment-path tick: "native" (the
        #: C++ library, native/) or "numpy" (np.lexsort); None before one
        self.host_sort: Optional[str] = None
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

    def _select_features(self, local_flow=None, local_param=None) -> frozenset:
        """Engine stages the compiled (local) rule set needs ('nodes' and
        'occupy' stay on; 'warmup' joins when a warm-up shaper exists,
        'param' while local param rules are compiled, 'tail_flow' while a
        flow rule's resource has a sketch id)."""
        feats = {"nodes", "occupy", "flow"}
        flow = [r for r in self.flow_rules.get() if not r.cluster_mode] if local_flow is None else local_flow
        param = (
            [r for r in self.param_flow_rules.get() if not r.cluster_mode]
            if local_param is None
            else local_param
        )
        if param:
            feats.add("param")
        if self.degrade_rules.get():
            feats.add("degrade")
        if self.authority_rules.get():
            feats.add("authority")
        if self.system_rules.get():
            feats.add("system")
        if any(
            r.control_behavior in (R.CONTROL_WARM_UP, R.CONTROL_WARM_UP_RATE_LIMITER)
            for r in flow
        ):
            feats.add("warmup")
        if self.cfg.sketch_stats and any(
            (rid := self.registry.peek_resource_id(r.resource)) is not None
            and self.registry.is_sketch_id(rid)
            for r in flow
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
        # cluster-mode rules are enforced through the TokenService, not the
        # local engine — except while degraded, when the fallback-enabled
        # ones compile in as local rules (fallbackToLocalOrPass semantics)
        with self._cluster_lock:
            changed = self._recompile_rules_noted()
        self._warm_after_recompile(changed)

    def _recompile_rules_noted(self) -> bool:
        """The traced recompile; the caller holds ``_cluster_lock``.
        Returns whether the tick changed (the caller warms it)."""
        with OT.TRACER.span("client.recompile_rules"):
            return self._recompile_rules_traced()

    def _warm_after_recompile(self, changed: bool) -> None:
        """Run a changed tick once at both batch shapes, OUTSIDE
        ``_cluster_lock`` (``_tick_mutex`` is the outer lock), so the first
        entry after a rule load does not pay the new stages' first launches
        (the card loads each kernel's module at its first use, and the
        fused wrappers plan each new job signature) inside its wait — a
        cluster token request has 200 ms by default.  Threaded clients
        only, as in the reference."""
        if changed and self._started and self.mode == "threaded":
            with self._tick_mutex:
                self._warm_shapes()

    def _recompile_rules_traced(self) -> bool:
        all_flow = self.flow_rules.get()
        flow = [r for r in all_flow if not r.cluster_mode]
        cluster_flow = [r for r in all_flow if r.cluster_mode]
        self._cluster_flow_by_res = {r.resource: r for r in cluster_flow}
        if self.cfg.sketch_stats:
            self._promote_ruled_tail(flow)
        all_param = self.param_flow_rules.get()
        param = [r for r in all_param if not r.cluster_mode]
        cluster_param = [r for r in all_param if r.cluster_mode]
        self._cluster_param_by_res = {r.resource: r for r in cluster_param}
        self._auth_host_rules = self._authority_mirror()
        # per-resource hash LANES: each entry hashes up to param_dims
        # distinct argument indices; every rule reads the lane its param_idx
        # was assigned (ParamFlowChecker.java:78 paramIdx dispatch).  Lane 0
        # also feeds the cluster token request, so healthy (token service)
        # and degraded (local engine) modes throttle the same argument
        lane_map = param_lanes(all_param, self.cfg.param_dims)
        self._param_lanes_by_res = lane_map
        if self._cluster_degraded_active:
            flow = flow + [r for r in cluster_flow if r.cluster_fallback_to_local]
            param = param + cluster_param
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
        feats = self._select_features(flow, param)
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
            changed = feats != self._features or cfg != self.cfg
            if changed:
                self.cfg = self.registry.cfg = cfg
                self._features = feats
                self._tick = E.make_tick(cfg, features=feats)
        return changed

    def _authority_mirror(self) -> Dict[str, tuple]:
        """Host mirror of the authority gate, used ONLY to order cluster
        token consumption after the authority slot (the reference checks
        cluster INSIDE FlowSlot, after AuthoritySlot — FlowRuleChecker.java
        :64-72): a request the authority gate will reject must not consume
        a cluster token.  The device decision stays authoritative, and the
        mirror must only ever be host-LENIENT-or-equal — a host-stricter
        verdict would skip the token check on traffic the device then
        passes.  So it selects as ``compile_authority_rules`` does: invalid
        rules skipped, over-capacity resources skipped, origins capped at
        ``authority_origins_per_resource``, the LAST rule per resource wins;
        and a rule carrying an origin the registry could not intern (the
        device then matches it as -1, every un-interned request origin)
        drops out of the mirror entirely."""
        ka = self.cfg.authority_origins_per_resource
        auth_host: Dict[str, tuple] = {}
        for r in self.authority_rules.get():
            if not r.is_valid():
                continue
            rid = self.registry.resource_id(r.resource)
            if rid is None or rid > self.cfg.max_resources:
                continue
            origins = r.origins()[:ka]
            if any(self.registry.origin_id(o) == -1 for o in origins):
                # last-wins: this rule's outcome for the resource is "no mirror"
                auth_host.pop(r.resource, None)
                continue
            auth_host[r.resource] = (frozenset(origins), r.strategy)
        return auth_host

    # -- cluster consultation -------------------------------------------------

    def set_cluster(self, cluster_state_manager) -> None:
        """Attach a ClusterStateManager; cluster-mode rules consult its
        token service (client or embedded server role)."""
        self.cluster = cluster_state_manager

    @property
    def _cluster_degraded_active(self) -> bool:
        return self._cluster_hy.active

    @property
    def _cluster_degraded_until(self) -> float:
        return self._cluster_hy.until

    def _enter_cluster_degraded(self) -> None:
        """Token service unreachable: enforce the fallback-enabled cluster
        rules locally until a probe succeeds.  Idempotent — extends the
        cooldown without recompiling when already degraded.  The flag flip
        and the recompile are atomic under ``_cluster_lock``."""
        changed = False
        with self._cluster_lock:
            entered = self._cluster_hy.enter(cooldown_s=self.cluster_retry_interval_s)
            if entered:
                changed = self._recompile_rules_noted()
        self._warm_after_recompile(changed)

    def _exit_cluster_degraded(self) -> None:
        changed = False
        with self._cluster_lock:
            if self._cluster_hy.exit():
                changed = self._recompile_rules_noted()
        self._warm_after_recompile(changed)

    def _authority_pre_blocks(self, resource: str, origin: str) -> bool:
        """True when the device authority gate is going to reject this
        (resource, origin) — consulted BEFORE a cluster token is spent."""
        ent = self._auth_host_rules.get(resource)
        if ent is None:
            return False
        origins, strategy = ent
        listed = bool(origin) and origin in origins
        if strategy == R.AUTHORITY_WHITE:
            return not listed
        return strategy == R.AUTHORITY_BLACK and listed

    def _cluster_check(self, resource: str, count: int, prioritized: bool, param_value) -> Tuple[int, int]:
        """Consult the token service for the cluster-mode rules on
        ``resource``.  Returns (pre_verdict, wait_ms): pre_verdict > 0
        forces a recorded block; wait_ms > 0 is SHOULD_WAIT pacing before
        the entry proceeds.

        Degrade protocol: on a transport failure (or the namespace guard's
        overload, which the reference also routes to fallbackToLocalOrPass)
        the client enforces the fallback-enabled cluster rules locally.
        They STAY compiled through re-probes — only an answered probe drops
        them — so the token server being down never opens an unenforced
        window.  The SYSTEM gate still runs after the token is spent (as in
        the reference: its verdict needs the device's live windows)."""
        from sentinel_tpu_torch.cluster import constants as CC

        frule = self._cluster_flow_by_res.get(resource)
        prule = self._cluster_param_by_res.get(resource)
        if frule is None and prule is None:
            return 0, 0
        degraded = self._cluster_degraded_active
        if degraded and mono_s() < self._cluster_degraded_until:
            return 0, 0  # cooling down; the local fallback rules enforce
        svc = self.cluster.token_service() if self.cluster is not None else None
        if svc is None:
            self._enter_cluster_degraded()
            return 0, 0

        wait_total = 0
        responded = False
        if frule is not None:
            try:
                r = svc.request_token(frule.cluster_flow_id, count, prioritized)
            except Exception:  # degrade to LOCAL: the fallback rules recompile into the engine
                if frule.cluster_fallback_to_local:
                    self._enter_cluster_degraded()
                return 0, 0
            if r.status in (CC.STATUS_FAIL, CC.STATUS_TOO_MANY_REQUEST):
                # unreachable or overloaded server → local fallback
                if frule.cluster_fallback_to_local:
                    self._enter_cluster_degraded()
                return 0, 0
            # BAD_REQUEST is made client-side without the network: it proves
            # nothing about the server, so it is no successful probe
            if r.status != CC.STATUS_BAD_REQUEST:
                responded = True
            if r.status == CC.STATUS_BLOCKED:
                if degraded:
                    self._exit_cluster_degraded()
                self._fold_remote_deny(resource, r, ERR.BLOCK_FLOW)
                return ERR.BLOCK_FLOW, 0
            if r.status == CC.STATUS_SHOULD_WAIT:
                wait_total += r.wait_ms
            # OK / NO_RULE → proceed

        if prule is not None and param_value is not None:
            try:
                r = svc.request_param_token(prule.cluster_flow_id, count, [param_value])
            except Exception:  # degrade to LOCAL: the fallback rules recompile into the engine
                self._enter_cluster_degraded()
                return 0, wait_total
            if r.status in (CC.STATUS_FAIL, CC.STATUS_TOO_MANY_REQUEST):
                self._enter_cluster_degraded()
                return 0, wait_total
            if r.status != CC.STATUS_BAD_REQUEST:
                responded = True
            if r.status == CC.STATUS_BLOCKED:
                if degraded:
                    self._exit_cluster_degraded()
                self._fold_remote_deny(resource, r, ERR.BLOCK_PARAM)
                return ERR.BLOCK_PARAM, 0

        if degraded and responded:
            self._exit_cluster_degraded()  # probe answered: back to remote
        return 0, wait_total

    def _fold_remote_deny(self, resource: str, r, default_kind: int, n: int = 1) -> None:
        """Land a cluster deny's provenance in the explain plane.  A v3
        peer's TokenResult carries (kind, rule, observed, limit); an
        embedded service fills the same fields; a pre-v3 peer leaves them
        None and the deny is counted unexplained."""
        plane = self.explain_plane
        if plane is None:
            return
        rid = self.registry.peek_resource_id(resource)
        if rid is None or n <= 0:
            return
        if r.prov_kind is None:
            plane.count_unexplained(n)
            return
        kind = int(r.prov_kind) if int(r.prov_kind) in KIND_NAMES else default_kind
        for _ in range(n):
            plane.fold_remote(
                rid, kind, r.prov_rule, r.prov_observed, r.prov_limit, ts_ms=int(self.time.wall_ms())
            )

    def _cluster_check_bulk(self, resource: str, item_counts: List[int], param_value) -> Tuple[List[int], List[int]]:
        """The bulk path's cluster consultation with a partial grant: ONE
        ``request_token_batch`` round trip covers all items of a (resource,
        argument) group, and the granted units go to the items greedily in
        order.  The same degrade protocol as ``_cluster_check``."""
        from sentinel_tpu_torch.cluster import constants as CC

        n = len(item_counts)
        verdicts, waits = [0] * n, [0] * n
        frule = self._cluster_flow_by_res.get(resource)
        prule = self._cluster_param_by_res.get(resource)
        if frule is None and prule is None:
            return verdicts, waits
        degraded = self._cluster_degraded_active
        if degraded and mono_s() < self._cluster_degraded_until:
            return verdicts, waits
        svc = self.cluster.token_service() if self.cluster is not None else None
        if svc is None:
            self._enter_cluster_degraded()
            return verdicts, waits

        responded = False
        if frule is not None:
            total = sum(item_counts)
            try:
                r = svc.request_token_batch(frule.cluster_flow_id, total)
            except Exception:  # r=None takes the degrade-to-LOCAL branch below
                r = None
            if r is None or r.status in (CC.STATUS_FAIL, CC.STATUS_TOO_MANY_REQUEST):
                if frule.cluster_fallback_to_local:
                    self._enter_cluster_degraded()
                return verdicts, waits
            if r.status != CC.STATUS_BAD_REQUEST:
                responded = True
            if r.status in (CC.STATUS_OK, CC.STATUS_SHOULD_WAIT, CC.STATUS_BLOCKED):
                granted = r.remaining if r.status != CC.STATUS_BLOCKED else 0
                acc = 0
                blocked_items = 0
                for i, c in enumerate(item_counts):
                    if acc + c <= granted:
                        acc += c
                        waits[i] = r.wait_ms
                    else:
                        verdicts[i] = ERR.BLOCK_FLOW
                        blocked_items += 1
                if blocked_items:
                    self._fold_remote_deny(resource, r, ERR.BLOCK_FLOW, n=blocked_items)
            # NO_RULE → proceed

        if prule is not None and param_value is not None:
            live = [i for i in range(n) if verdicts[i] == 0]
            if live:
                total = sum(item_counts[i] for i in live)
                try:
                    r = svc.request_param_token(prule.cluster_flow_id, total, [param_value])
                except Exception:  # r=None takes the degrade-to-LOCAL branch below
                    r = None
                if r is None or r.status in (CC.STATUS_FAIL, CC.STATUS_TOO_MANY_REQUEST):
                    self._enter_cluster_degraded()
                    return verdicts, waits
                if r.status != CC.STATUS_BAD_REQUEST:
                    responded = True
                if r.status == CC.STATUS_BLOCKED:
                    for i in live:
                        verdicts[i] = ERR.BLOCK_PARAM
                    self._fold_remote_deny(resource, r, ERR.BLOCK_PARAM, n=len(live))

        if degraded and responded:
            self._exit_cluster_degraded()
        return verdicts, waits

    def pending_acquires(self) -> int:
        """Depth of the un-ticked acquire queue (the token service's
        load-shedding probe on the engine-backed decision path)."""
        with self._lock:
            return len(self._acquires)

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
        if not self.enabled:
            e = _PassThroughEntry(self, resource)
            if _push_ctx:
                CTX.push_entry(e)
            return e
        ctx_name, ctx_origin = _ctx if _ctx is not None else CTX.current()
        origin = origin if origin is not None else ctx_origin
        # custom entry hooks: a raised BlockException rides the batch as a
        # pre-verdict, so the ENGINE records the block (stats, telemetry,
        # explain), and the ORIGINAL exception is re-raised at the end
        hook_exc: Optional[ERR.BlockException] = None
        for hook in self.entry_hooks:
            try:
                hook(resource, origin, args)
            except ERR.BlockException as he:
                hook_exc = he
                break
        rid = self.registry.resource_id(resource)
        if rid is None:
            e = _PassThroughEntry(self, resource)
            if _push_ctx:
                CTX.push_entry(e)
            return e  # capacity overflow → pass-through (CtSph.java:200)
        # ordered custom slots: the entry side here; the exit side unwinds
        # on Entry.exit or on rejection below.  Pass-through entries above
        # run no slot (no chain runs at all)
        slot_ctx = None
        entered_slots: list = []
        slot_list = self.slots.snapshot()
        if slot_list and hook_exc is None:
            slot_ctx = SlotContext(
                resource=resource,
                origin=origin or "",
                args=args,
                count=count,
                prioritized=prioritized,
                inbound=inbound,
            )
            entered_slots, slot_exc = run_entry(slot_list, slot_ctx)
            if slot_exc is not None:
                hook_exc = slot_exc
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
        pre_verdict, cluster_wait = 0, 0
        if hook_exc is not None:
            code = getattr(hook_exc, "code", 0)
            pre_verdict = code if code > 0 else ERR.BLOCK_FLOW
        elif (self._cluster_flow_by_res or self._cluster_param_by_res) and not self._authority_pre_blocks(
            resource, origin or ""
        ):
            # authority-doomed requests skip the token service: the slot
            # order of the reference (the cluster check lives inside
            # FlowSlot, after AuthoritySlot — FlowRuleChecker.java:64-72)
            pre_verdict, cluster_wait = self._cluster_check(
                resource, count, prioritized, self._lane0_value(resource, args)
            )
        if cluster_wait > 0:
            # SHOULD_WAIT: pace before entering (TokenResultStatus.SHOULD_WAIT)
            self.time.sleep_ms(cluster_wait)
        req = AcquireRequest(
            res=rid,
            count=count,
            prio=1 if prioritized else 0,
            origin_id=origin_id,
            origin_node=origin_node,
            ctx_node=ctx_node,
            ctx_name=ctx_id,
            inbound=1 if inbound else 0,
            pre_verdict=pre_verdict,
            future=Future(),
            param_hash=param_hashes,
        )
        with self._lock:
            self._acquires.append(req)
        if self.mode == "sync":
            self.tick_once()
        verdict, wait_ms = req.future.result(timeout=self.entry_timeout_s)
        if verdict not in (ERR.PASS, ERR.PASS_WAIT):
            # the engine already counted the block; here only the
            # extension SPI and the slots' exit side fire
            exc = hook_exc if hook_exc is not None else ERR.exception_for_verdict(verdict, resource)
            MEXT.safe_dispatch("on_block", resource, count, origin or "", exc, args)
            if entered_slots:
                slot_ctx.block_exception = exc
                run_exit(entered_slots, slot_ctx)
            raise exc
        if verdict == ERR.PASS_WAIT and wait_ms > 0:
            self.time.sleep_ms(wait_ms)
        MEXT.safe_dispatch("on_pass", resource, count, origin or "", args)
        e = Entry(
            self, resource, rid, origin_node, ctx_node, 1 if inbound else 0,
            count, self.time.now_ms(), wait_ms, param_hashes,
        )
        e.slots = entered_slots
        e.slot_ctx = slot_ctx
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

    def _lane0_value(self, resource: str, args: Optional[Sequence]):
        """The argument hash lane 0 carries — the value a cluster param
        token is asked for — or None."""
        if not args:
            return None
        idx = (self._param_lanes_by_res.get(resource) or [0])[0]
        return args[idx] if 0 <= idx < len(args) else None

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
        """One push onto the completion ring (ring field names: origin_id
        carries the origin node row, param_hash the context node row, the
        aux lanes the THREAD-grade release hashes); the overflow list
        takes it when the ring is full."""
        ph = tuple(c.param_hash) + (0, 0, 0, 0)
        ok = self._comp_ring.push(
            res=c.res,
            count=c.success,
            origin_id=c.origin_node,
            param_hash=c.ctx_node,
            flags=FLAG_COMPLETION | (FLAG_INBOUND if c.inbound else 0),
            rt_ms=c.rt,
            error=c.error,
            aux0=ph[0],
            aux1=ph[1],
            aux2=ph[2],
            aux3=ph[3],
        )
        if not ok:
            with self._lock:
                self._comp_overflow.append(c)
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
        requests coalesce into engine micro-batches without a thread each.
        None too while the client is disabled (``enabled=False``)."""
        _no_deadlines(deadline_ms)
        if not self.enabled:
            return None
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
        lane 0; an unknown resource (full registry) passes through, and
        so does everything while the client is disabled."""
        _no_deadlines(deadline_ms)
        if not self.enabled:
            return [(ERR.PASS, 0)] * len(resources)
        # the cluster consultation runs OUTSIDE self._lock (a token-server
        # round trip must not stall the tick thread) and is AGGREGATED: one
        # request per distinct (resource, argument) group with the summed
        # count, not one round trip an item
        pre_verdicts = [0] * len(resources)
        pre_waits = [0] * len(resources)
        if self._cluster_flow_by_res or self._cluster_param_by_res:
            groups: Dict[Tuple[str, Any], List[int]] = {}
            for i, name in enumerate(resources):
                if name in self._cluster_flow_by_res or name in self._cluster_param_by_res:
                    if self._authority_pre_blocks(name, origins[i] if origins else ""):
                        continue  # the engine rejects it; it consumes no token
                    groups.setdefault((name, params[i] if params else None), []).append(i)
            for (name, pv), idxs in groups.items():
                vs, ws = self._cluster_check_bulk(name, [counts[i] if counts else 1 for i in idxs], pv)
                for j, i in enumerate(idxs):
                    pre_verdicts[i], pre_waits[i] = vs[j], ws[j]
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
                    pre_verdict=pre_verdicts[i],
                    future=Future(),
                    param_hash=(hash_param(pv),) + (0,) * (self.cfg.param_dims - 1)
                    if pv is not None
                    else (0,) * self.cfg.param_dims,
                )
                self._acquires.append(req)
                futures.append(req.future)
        if self.mode == "sync":
            self.tick_once()
        out = []
        for i, f in enumerate(futures):
            if f is None:
                out.append((ERR.PASS, 0))
                continue
            v, w = f.result(timeout=self.entry_timeout_s)
            if pre_waits[i] > 0 and v == ERR.PASS:
                # cluster SHOULD_WAIT pacing surfaces to bulk callers too
                v, w = ERR.PASS_WAIT, w + pre_waits[i]
            out.append((v, w))
        return out

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
    ) -> Optional[Future]:
        """Bulk acquire: COLUMN ARRAYS of engine resource ids (from
        ``registry.resource_id``), no per-item Python objects.  Returns a
        Future of (verdicts int8 [n], waits int32 [n]) in submission order;
        a block larger than the batch size spans ticks.  Negative ids are
        padding (the trash row).  Done-callbacks run on the resolving
        thread and must not block on another tick (they may submit more).
        None while the client is disabled: the block passes through."""
        _no_deadlines(deadline_ms)
        if not self.enabled:
            return None
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
        if fut is None:
            n = len(res)
            return np.full(n, ERR.PASS, np.int8), np.zeros(n, np.int32)
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
        the next tick (completions are fire-and-forget) beside the
        completion ring, in its drain layout.  ``success`` defaults to 1,
        ``error`` and ``inbound`` to 0, the node rows to the trash row;
        ``param_hash`` carries the THREAD-grade release lanes."""
        res = np.ascontiguousarray(res, dtype=np.int32)
        n = len(res)
        trash = self.cfg.trash_row

        def col(x, fill, dt=np.int32):
            if x is None:
                return np.full(n, fill, dt)
            x = np.ascontiguousarray(x, dtype=dt)
            if len(x) != n:
                raise ValueError(f"column of {len(x)} items for a block of {n}")
            return x

        flags = np.full(n, FLAG_COMPLETION, np.int32) | np.where(col(inbound, 0) != 0, FLAG_INBOUND, 0)
        if param_hash is not None:
            ph = np.ascontiguousarray(param_hash, dtype=np.int32).reshape(n, -1)
            aux = [ph[:, k] if k < ph.shape[1] else np.zeros(n, np.int32) for k in range(4)]
        else:
            aux = [np.zeros(n, np.int32)] * 4
        block = (
            res,
            col(success, 1),
            col(origin_node, trash),
            col(ctx_node, trash),
            flags.astype(np.int32),
            col(rt, 0.0, np.float32),
            col(error, 0),
            np.zeros(n, np.int32),
            *aux,
        )
        if n == 0:
            return
        with self._lock:
            self._comp_blocks.append(block)
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

    def _drain_completions(self, cbs: int):
        """Up to ``cbs`` completions as ring-layout columns (res, count,
        origin_node, ctx_node, flags, rt, error, tag, aux0..3), or None:
        the ring first, then the overflow list (only once the ring drains
        short, so spilled exits never jump ahead of older ring entries),
        then the completion blocks."""
        comp = self._comp_ring.drain(cbs)
        n_comp = len(comp[0])
        if n_comp < cbs and self._comp_overflow:
            with self._lock:
                spill = self._comp_overflow[: cbs - n_comp]
                self._comp_overflow = self._comp_overflow[len(spill):]
            if spill:
                rows = [
                    (c.res, c.success, c.origin_node, c.ctx_node,
                     FLAG_COMPLETION | (FLAG_INBOUND if c.inbound else 0), c.rt, c.error, 0)
                    + (tuple(c.param_hash) + (0, 0, 0, 0))[:4]
                    for c in spill
                ]
                comp = tuple(
                    np.concatenate([col, np.asarray(extra, col.dtype)])
                    for col, extra in zip(comp, zip(*rows))
                )
                n_comp += len(spill)
        if n_comp < cbs and self._comp_blocks:
            pieces = []
            with self._lock:
                room = cbs - n_comp
                while room > 0 and self._comp_blocks:
                    cb = self._comp_blocks[0]
                    k = len(cb[0])
                    if k <= room:
                        pieces.append(cb)
                        self._comp_blocks.pop(0)
                        room -= k
                    else:
                        pieces.append(tuple(col[:room] for col in cb))
                        self._comp_blocks[0] = tuple(col[room:] for col in cb)
                        room = 0
            if pieces:
                comp = tuple(np.concatenate([comp[j]] + [p[j] for p in pieces]) for j in range(len(comp)))
                n_comp = len(comp[0])
        return comp if n_comp else None

    def _has_work(self) -> bool:
        with self._lock:
            return bool(
                self._acquires or self._acq_blocks or self._comp_blocks or self._comp_overflow
                or len(self._comp_ring)
            )

    def _tick_once_locked(self, now_ms: Optional[int]) -> None:
        bs, cbs = self.cfg.batch_size, self.cfg.complete_batch_size
        while True:
            blocks = []
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
            comp = self._drain_completions(cbs)
            if not acq and not blocks and comp is None and now_ms is None:
                # idle: flush any deferred readbacks before returning
                self._drain_resolves()
                return
            try:
                pending = self._run_tick(acq, comp, now_ms, blocks=blocks)
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
            more = self._has_work()
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
                if not self._has_work():
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
        self._resolve_tick(self._run_tick([], None, self.time.now_ms()))
        if self.cfg.batch_size > 256:
            filler = AcquireRequest(
                res=self.cfg.trash_row, count=0, prio=0, origin_id=-1,
                origin_node=self.cfg.trash_row, ctx_node=self.cfg.trash_row,
                ctx_name=-1, inbound=0,
            )
            self._resolve_tick(self._run_tick([filler] * 257, None, self.time.now_ms()))

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
        h = OT.TRACER.begin("engine.seg_resize", seg_u=int(new_u))
        try:
            cfg = dataclasses.replace(self.cfg, seg_u=int(new_u))
            with self._engine_lock:
                self.cfg = self.registry.cfg = cfg
                self._tick = E.make_tick(cfg, features=self._features)
                self._seg_over_ticks = 0
        finally:
            OT.TRACER.end(h)

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

    @property
    def host_build_ms_avg(self) -> float:
        """Mean host batch-build time a tick (assembly, presort, uploads)
        since the client was built — the serial host share of serving."""
        return self._build_ms_sum / self._build_ticks if self._build_ticks else 0.0

    def _sbuf(self, name: str, shape, dt) -> np.ndarray:
        """The current-parity slot of the two-slot host staging buffer for
        one assembly column (pinned on the card); the caller fills it
        completely."""
        key = (name, shape, np.dtype(dt).str)
        s = self._stage.get(key)
        if s is None:
            s = self._stage[key] = [self._host_buffer(shape, dt) for _ in range(2)]
        return s[self._stage_parity]

    def _host_buffer(self, shape, dt) -> np.ndarray:
        if not self._pinned:
            return np.empty(shape, dt)
        tdt = torch.from_numpy(np.empty(0, dt)).dtype
        return torch.empty(shape, dtype=tdt, pin_memory=True).numpy()

    def _flip_stage(self) -> None:
        """Flip the staging parity, then wait until the uploads that last
        read this parity's slots have run on the card (the event recorded
        behind them; it has almost always completed)."""
        self._stage_parity ^= 1
        ev = self._stage_events[self._stage_parity]
        if ev is not None:
            ev.synchronize()
            self._stage_events[self._stage_parity] = None

    def _h2d(self, x: np.ndarray) -> torch.Tensor:
        """One column's upload — always a copy (on the CPU,
        ``torch.from_numpy`` alone would alias the staging slot), and
        asynchronous from a pinned slot on the card."""
        t = torch.from_numpy(x)
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)

    def _dev_col(self, field: str, x: np.ndarray, fill) -> torch.Tensor:
        """Upload a batch column — or reuse a cached device constant when
        the column equals ``fill`` everywhere, or the tensor of the
        previous upload of ``field`` when the column is bit-identical to
        it (``sentinel_wire_cols_skipped_total``).  Keyed by FIELD, so two
        batch leaves never share one tensor.  The dirty-skip's host ref is
        a PRIVATE COPY of the uploaded column, never the staging slot,
        which the next tick but one overwrites.  Every real upload counts
        its bytes under ``sentinel_wire_bytes_total{direction="tx"}``."""
        if (x == fill).all():
            key = (field, float(fill), x.dtype.str, x.shape)
            c = self._const_cols.get(key)
            if c is None:
                c = self._const_cols[key] = self._h2d(x)
                _C_WIRE["tx"].inc(x.nbytes)  # the constant's first (only) upload
            # the dirty ref would go stale while constant ticks bypass it
            self._col_last.pop(field, None)
            return c
        prev = self._col_last.get(field)
        if prev is not None and prev[0].shape == x.shape and prev[0].dtype == x.dtype and np.array_equal(prev[0], x):
            _C_COLS_SKIPPED.inc()
            return prev[1]
        dev = self._h2d(x)
        _C_WIRE["tx"].inc(x.nbytes)
        self._col_last[field] = (x.copy(), dev)
        return dev

    def _empty(self, kind: str, b: int):
        """The batch of a side with nothing queued (built once a shape,
        never uploaded again: the engine does not write its inputs)."""
        key = (kind, b)
        batch = self._empty_batches.get(key)
        if batch is None:
            make = E.empty_acquire if kind == "a" else E.empty_complete
            batch = self._empty_batches[key] = make(self.cfg, self.device, b)
        return batch

    def _run_tick(self, acq: List[AcquireRequest], comp, now_ms, blocks=()) -> _PendingTick:
        """Build the batch columns into the staging slots (presorted on the
        segment path), upload them through ``_dev_col``, run one tick and
        start its wire's readback into a host buffer; returns the
        ``_PendingTick``.  ``comp``: the drained ring-layout completion
        columns, or None."""
        cfg = self.cfg
        M = cfg.param_dims
        trash = cfg.trash_row
        n_blk = sum(t for _b, _o, t in blocks)
        # every _sbuf below hands out the slot the previous tick did not touch
        self._flip_stage()
        t_build0 = mono_s()
        # one trace id correlates this tick's spans across the dispatching
        # thread and the resolver; _t_asm truthiness is the single flag
        # check, and presort time is taken out of the assemble span
        tick_id = OT.TRACER.next_trace_id()
        _t_asm = OT.t0()
        _tp0 = 0
        _ns_presort = 0
        B = self._shape_for(len(acq) + n_blk, cfg.batch_size)
        B2 = self._shape_for(0 if comp is None else len(comp[0]), cfg.complete_batch_size)
        presort = cfg.seg_effects
        inv = None
        segs_a = segs_c = 0
        if acq or n_blk:
            n = len(acq)

            def arr(f, fill, dt=np.int32, blk_default=None):
                """Object requests at [0, n), block slices after them (array
                copies, no per-item Python), padding to B."""
                out = self._sbuf("a." + f, B, dt)
                out.fill(fill)
                if acq:
                    out[:n] = [getattr(r, f) for r in acq]
                o = n
                for blk, off, take in blocks:
                    src = getattr(blk, f)
                    if src is not None:
                        out[o : o + take] = src[off : off + take]
                    elif blk_default is not None:
                        out[o : o + take] = blk_default
                    o += take
                return out

            res_np = arr("res", trash)
            cnt_np = arr("count", 0, blk_default=1)
            np.minimum(cnt_np, cfg.max_batch_count, out=cnt_np)  # the fused kernels' envelope
            prio_np = arr("prio", 0)
            oid_np = arr("origin_id", -1)
            onode_np = arr("origin_node", trash)
            cnode_np = arr("ctx_node", trash)
            cname_np = arr("ctx_name", -1)
            inb_np = arr("inbound", 0)
            pre_np = arr("pre_verdict", 0)
            ph_np = self._sbuf("a.ph", (B, M), np.int32)
            ph_np.fill(0)
            for i, r in enumerate(acq):
                if r.param_hash:
                    h = tuple(r.param_hash)[:M]
                    ph_np[i, : len(h)] = h
            o = n
            for blk, off, take in blocks:
                if blk.param_hash is not None:
                    src = blk.param_hash[off : off + take, :M]
                    ph_np[o : o + take, : src.shape[1]] = src
                o += take
            if presort:
                _tp = OT.t0()
                # by the segment keys of engine_seg.prepare_acquire, res-major
                # (the scan ranks also need res nondecreasing); trash-row
                # padding has the largest res, so it sorts last
                order, inv = PS.batch_sort5(res_np, cnode_np, onode_np, oid_np, cname_np)
                self.host_sort = PS.sort_kind()
                cols = [res_np, cnt_np, prio_np, oid_np, onode_np, cnode_np, cname_np, inb_np, pre_np]
                for i, x in enumerate(cols):
                    dst = self._sbuf(f"s.{i}", B, x.dtype)
                    np.take(x, order, out=dst)
                    cols[i] = dst
                res_np, cnt_np, prio_np, oid_np, onode_np, cnode_np, cname_np, inb_np, pre_np = cols
                dst = self._sbuf("s.ph", (B, M), np.int32)
                np.take(ph_np, order, axis=0, out=dst)
                ph_np = dst
                if _tp:
                    _tp0 = _tp0 or _tp
                    _ns_presort += OT.now_ns() - _tp
                segs_a = PS.host_seg_count((res_np, cnode_np, onode_np, oid_np, cname_np))
                self._note_seg_count(segs_a, B)
            wd_a = _np_dtypes(WIRE.acquire_wire_dtypes(cfg))

            def nar(name, key, x, fill):
                # narrow upload (ops/wire.py): flags, verdict codes and
                # clamped counts fit the wire dtype, so the downcast is exact
                dt = wd_a.get(key)
                if dt is not None and x.dtype != dt:
                    nx = self._sbuf("w." + name, x.shape, dt)
                    np.copyto(nx, x, casting="unsafe")
                    x = nx
                return self._dev_col(name, x, fill)

            a = E.AcquireBatch(
                res=self._dev_col("a.res", res_np, trash),
                count=nar("a.count", "count", cnt_np, 1),
                prio=nar("a.prio", "prio", prio_np, 0),
                origin_id=self._dev_col("a.oid", oid_np, -1),
                origin_node=self._dev_col("a.onode", onode_np, trash),
                ctx_node=self._dev_col("a.cnode", cnode_np, trash),
                ctx_name=self._dev_col("a.cname", cname_np, -1),
                inbound=nar("a.inb", "inbound", inb_np, 0),
                param_hash=self._dev_col("a.ph", ph_np, 0),
                pre_verdict=nar("a.pre", "pre_verdict", pre_np, 0),
            )
        else:
            a = self._empty("a", B)
        if comp is not None:
            res_c, cnt_c, org_c, ctx_c, flags_c, rt_c, err_c, _tag, *aux_c = comp
            n = len(res_c)
            if presort and n > 1:
                _tp = OT.t0()
                # completions carry no futures: sorted, never unsorted (their
                # effects are order-independent sums and minima)
                order, _ = PS.batch_sort3(res_c, ctx_c, org_c, want_inv=False)
                res_c, cnt_c, org_c, ctx_c, flags_c, rt_c, err_c = (
                    x[order] for x in (res_c, cnt_c, org_c, ctx_c, flags_c, rt_c, err_c)
                )
                aux_c = [x[order] for x in aux_c]
                if _tp:
                    _tp0 = _tp0 or _tp
                    _ns_presort += OT.now_ns() - _tp
            wd_c = _np_dtypes(WIRE.complete_wire_dtypes(cfg))

            def pad(name, x, fill, dt=np.int32):
                out = self._sbuf(name, B2, dt)
                out.fill(fill)
                out[:n] = x
                return out

            c_res = pad("c.res", res_c, trash)
            c_onode = pad("c.onode", org_c, trash)
            c_cnode = pad("c.cnode", ctx_c, trash)
            if presort:
                segs_c = PS.host_seg_count((c_res, c_cnode, c_onode))
                self._note_seg_count(segs_c, B2)
            ph_c = self._sbuf("c.ph", (B2, M), np.int32)
            ph_c.fill(0)
            for k in range(min(M, len(aux_c))):
                ph_c[:n, k] = aux_c[k]
            cap = cfg.max_batch_count  # the acquire side's envelope
            c = E.CompleteBatch(
                res=self._dev_col("c.res", c_res, trash),
                origin_node=self._dev_col("c.onode", c_onode, trash),
                ctx_node=self._dev_col("c.cnode", c_cnode, trash),
                inbound=self._dev_col("c.inb", pad("c.inb", flags_c & FLAG_INBOUND, 0, wd_c.get("inbound", np.int32)), 0),
                rt=self._dev_col("c.rt", pad("c.rt", rt_c, 0.0, np.float32), 0.0),
                success=self._dev_col(
                    "c.succ", pad("c.succ", np.minimum(cnt_c, cap), 0, wd_c.get("success", np.int32)), 0
                ),
                error=self._dev_col("c.err", pad("c.err", np.minimum(err_c, cap), 0, wd_c.get("error", np.int32)), 0),
                param_hash=self._dev_col("c.ph", ph_c, 0),
            )
        else:
            c = self._empty("c", B2)
        if self._pinned:
            # the slots of this parity are free again once this has run
            ev = torch.cuda.Event()
            ev.record()
            self._stage_events[self._stage_parity] = ev
        seg_fits = None
        if presort:
            cfg = self.cfg  # a resize above swapped it
            if cfg.seg_fallback:
                # the exact count decides each side's branch on the host
                # (engine.tick's seg_fits): no device-side selection needed
                seg_fits = (segs_c <= ES.seg_capacity(cfg, B2), segs_a <= ES.seg_capacity(cfg, B))
                if not all(seg_fits):
                    self.seg_fallback_ticks += 1
        _t_disp = OT.t0()
        if _t_asm:
            OT.stage_ns(
                "tick.assemble", _t_asm, (_t_disp or OT.now_ns()) - _t_asm - _ns_presort, _H_ASSEMBLE,
                trace=tick_id, attrs={"b": B, "b2": B2},
            )
            if _ns_presort:
                OT.stage_ns("tick.presort", _tp0, _ns_presort, _H_PRESORT, trace=tick_id)
        load, cpu = self._sys.sample()
        t = now_ms if now_ms is not None else self.time.now_ms()
        self._build_ms_sum += (mono_s() - t_build0) * 1000.0
        self._build_ticks += 1
        with self._engine_lock:
            self._state, out = self._tick(
                self._state, self._rules_dev, a, c, int(t), load, cpu, seg_fits=seg_fits
            )
        _disp_done = 0
        if _t_disp:
            _disp_done = OT.now_ns()
            OT.stage_ns("tick.dispatch", _t_disp, _disp_done - _t_disp, _H_DISPATCH, trace=tick_id)
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
            tick_id=tick_id, dispatched_ns=_disp_done,
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
        _C_WIRE["rx"].inc(raw.nbytes - tl_bytes)
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
        if p.dispatched_ns and OT.TRACER.enabled:
            # dispatch -> verdicts host-visible: device compute and the
            # copy, plus the queue wait when pipelined (spans of successive
            # ticks may overlap: that overlap IS the pipelining)
            OT.stage_ns(
                "tick.device", p.dispatched_ns, OT.now_ns() - p.dispatched_ns, _H_DEVICE, trace=p.tick_id
            )
        # readback: the folds and any residual device read, after the wait
        _t_rb = OT.t0()
        verdict, wait = frame.verdict, frame.wait
        if wait is None:  # more PASS_WAIT rows than the sidecar holds
            wait = out.wait_ms.cpu().numpy()
            _C_WIRE["rx"].inc(wait.nbytes)
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
        if _t_rb:
            OT.stage("tick.readback", _t_rb, _H_READBACK, trace=p.tick_id)
        _t_res = OT.t0()
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
        if _t_res:
            OT.stage(
                "tick.resolve", _t_res, _H_RESOLVE, trace=p.tick_id,
                attrs={"n_obj": p.n_obj, "n_blk": p.n_blk},
            )

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
