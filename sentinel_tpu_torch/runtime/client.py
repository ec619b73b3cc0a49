"""Host runtime: SentinelClient — micro-batching + the tick loop.

The port's counterpart of ``sentinel_tpu/runtime/client.py``, reduced to
the admission path.  ``entry()`` queues an acquire; the tick loop (a
thread in ``mode="threaded"``, the caller's own thread in ``mode="sync"``)
builds the batch columns, uploads them, runs ONE engine tick, and reads
back ONE packed wire buffer (ops/wire.py), whose verdicts resolve the
waiting futures.  A wire buffer that fails validation fails the whole
tick CLOSED (every item gets BLOCK_SYSTEM).  Under ``packed_wire=False``
the tick returns the classic ``TickOutput`` tensors instead, read one by
one on the resolving thread (``_read_unpacked``), and every column is a
full int32 upload: the reference client the packed one is held to.

Completions (``Entry.exit()``) are one push onto the native MPMC event
ring (native/ring.EventRing; an unbounded overflow list takes them when
the ring is full, so none is ever lost) and ride the next tick; bulk
completion blocks queue beside the ring in its column layout.  On the
fused path (``engine._use_fused``: ``fused_effects`` and
``use_mxu_tables``) counts, successes and errors are clamped to
``cfg.max_batch_count`` at batch build — the envelope the fused kernels
carry exactly (core/config.py); on the plain path they go up as they
are, exact to 65,535.

Batch assembly writes into two-slot host staging buffers (``_sbuf``,
pinned on the card), flipped every tick; a slot is written again only
after the CUDA event recorded behind its last uploads has completed, so
``pipeline_depth`` may run the card several ticks behind the host.  Each
column goes up through ``_dev_col``: a column equal to its fill
everywhere reuses one cached device constant, a column equal to the one
uploaded the tick before reuses that tensor (``cols_skipped``; the packed
wire only), and every real upload is a copy, counted in
``sentinel_wire_bytes_total{direction="tx"}`` (the readback in
``direction="rx"``).  The engine never writes a
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

On the segment path (``seg_effects`` on the fused path, the default
``platform_config()``) the client presorts each batch on the host by the engine's segment keys
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
tick iteration on its own cadence (``hotset_eval_s``).

The control plane: ``stats`` (``ClientStats``) reads windowed statistics
for one resource, one (resource, origin) pair, the ENTRY node, or every
registered resource at once (``snapshot``: ONE device read for the exact
rows and one for the sketch ids, both at one timestamp);
``rt_quantiles`` reads the ENTRY node's RT histogram and ``top_params``
the host-side counts of argument values seen by ``entry()``.  The rule
managers take push listeners and a ``SentinelProperty`` (datasource/);
``update_window_shape`` and ``register_window_property`` reshape the
second / minute windows live (build and warm the new tick first, then
migrate the state under the engine lock: ``engine.migrate_state``).
``metric_log=True`` starts a ``MetricTimerListener`` (metrics/) that
writes every active resource's second to the metric log.  The HTTP
command center over all of it is ``transport/``.

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

Overload protection (adaptive/): ``enable_adaptive()`` arms a closed
loop that steps once a tick on the tick thread (``_adaptive_step``): the
signals row, the BBR-style controller, the degrade ladder's rung effects
(shed non-prioritized work, stop the host's hot-param counting, fall back
from the cluster token service, fail closed), and changed ceilings
published into the live system columns as a five-scalar upload
(``engine.replace_system_columns``: pinned staging behind a CUDA event,
no host sync, no rebuilt tick).  ``admission_queue_limit`` bounds the
un-ticked queue, block items included (``_admission_shed``; the
``sentinel_shed_total{stage,reason}`` counters).  ``deadline_ms`` on
``entry`` and the bulk API sheds work CLOSED once it is worthless: at
admission when it has already expired, and before dispatch
(``_sweep_expired``).  ``watchdog_timeout_s`` starts a watchdog thread
that fails a dispatched tick CLOSED when its wire is not host-visible in
time; a claim on the tick's state (``_claim_tick``) makes exactly one of
the watchdog and the resolver fan it out.  The flight recorder
(obs/flight.py) gets the client's ``client``, ``timeline`` and
``explain`` sections and its journal notes (``rules.recompile``,
``seg.resize``, ``watchdog.fired``, ``resolve.fail_closed``), and a
cluster-degrade entry triggers a bundle; ``block_log=True`` writes
``sentinel-block.log`` (metrics/block_log.py), each line keyed by the
explain plane's cause and rule slot.

The operations plane (obs/profile.py, workload/): every device buffer
the client builds is claimed in the memory ledger under the client's
owner tag (``stop()`` drops it); every new tick binding journals in the
retrace observatory, expected under its cause (``client-init``,
``rule-feature-change``, ``segment-resize``, a swap's cause) or a
surprise; ``sketch_audit_k`` arms the online sketch-accuracy audit
(``SketchAudit``: audit-then-fold before each dispatch, one estimate and
one readback on an audit tick only); ``apply_operating_point`` applies a
``workload.OperatingPoint`` live (host knobs as attribute writes, engine
knobs through ``_swap_engine``) — the autotuner's actuator.

Front doors: ``attach_front_door`` hands the tick loop a native front
door (cluster/front_door.py).  Each tick drains the doors' rings,
round-robin, into the room its batch has left after the object requests
and the blocks; concurrent acquire / release events are answered on the
host, and the engine items ride the batch after the blocks (their param
columns carry the lanes the door hashed in C).  The resolver answers
each door by its slice, under ``_respond_lock``; a tick that fails
answers every door it had not reached, CLOSED.  The adapters
(``adapters/``) and the Envoy RLS front door (``rls/``) call ``entry()``
and the token service as any caller does.  A sharded token fleet
(``cluster/shard.py``) joins through
``ClusterStateManager.set_to_sharded_client``: its client is the token
service the cluster check consults, and it fails a dead shard's flows
closed itself, so the client's own cluster degrade does not engage.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from contextlib import contextmanager
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.adaptive import degrade as DG
from sentinel_tpu_torch.adaptive.controller import AdaptiveConfig, AdaptiveController
from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.core.config import EngineConfig, app_name as cfg_app_name, platform_config
from sentinel_tpu_torch.core.rule_tensors import compile_system_rules, hash_param, param_lanes
from sentinel_tpu_torch.metrics import extension as MEXT
from sentinel_tpu_torch.native import EventRing
from sentinel_tpu_torch.native.ring import FLAG_COMPLETION, FLAG_INBOUND
from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs import profile as PROF
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
# -- adaptive protection / backpressure (adaptive/): shed accounting and
# the tick watchdog, registered at import so the exposition surface
# carries them from process start
_SHED_HELP = "admissions shed before device dispatch, by stage and reason"
_C_SHED: Dict[tuple, Any] = {
    (st, rs): OBS.counter("sentinel_shed_total", _SHED_HELP, labels={"stage": st, "reason": rs})
    for st, rs in (
        ("admit", "queue_full"),
        ("admit", "low_priority"),
        ("admit", "fail_closed"),
        ("admit", "deadline"),
        ("admit", "chaos"),
        ("tick", "deadline"),
    )
}
_C_WATCHDOG = OBS.counter(
    "sentinel_watchdog_fired_total",
    "stalled engine ticks the watchdog failed CLOSED",
)


def _shed_counter(stage: str, reason: str):
    c = _C_SHED.get((stage, reason))
    if c is None:
        c = _C_SHED[(stage, reason)] = OBS.counter(
            "sentinel_shed_total", _SHED_HELP, labels={"stage": stage, "reason": reason}
        )
    return c


# -- window rotation cadence: the windows' refresh is a pure function of
# the stamped tick timestamp, so the host derives the card's rotation and
# skip decisions from the timestamps it stamps — no readback.  "second" is
# the exact tier (every boundary rotates); "sketch" the minute-scale tier,
# whose slack batches the purge every slack_buckets buckets (a skip is a
# deferred boundary)
_C_WIN_ROT = {
    w: OBS.counter(
        "sentinel_window_rotations_total",
        "window bucket rotations whose batched expiry purge ran (host-derived"
        " from the tick timestamps; mirrors the device rotation condition)",
        labels={"window": w},
    )
    for w in ("second", "sketch")
}
_C_WIN_SLACK = {
    w: OBS.counter(
        "sentinel_window_slack_skips_total",
        "window bucket boundaries crossed with the expiry purge deferred by"
        " slack batching (bounded overestimate until the next rotation)",
        labels={"window": w},
    )
    for w in ("second", "sketch")
}

#: chaos sites on the tick loop's own failure surfaces (one flag check a
#: site while disarmed): the tick's timestamp, the readback, the fan-out
#: and the seg_u resize
_FP_TICK_CLOCK = FP.register(
    "runtime.tick.clock", "engine tick timestamp (skew shifts windows)", FP.SKEW_ACTIONS,
)
_FP_READBACK = FP.register(
    "runtime.resolve.readback", "verdict device-to-host readback", FP.HIT_ACTIONS
)
_FP_FANOUT = FP.register(
    "runtime.resolve.fanout", "verdict fan-out to futures/blocks/doors", FP.HIT_ACTIONS,
)
_FP_SEG_RESIZE = FP.register(
    "runtime.seg.resize", "background seg_u grow-and-swap compile", FP.HIT_ACTIONS
)
#: chaos site on the readback's main section (mangled bytes fail the tick
#: CLOSED); the explain section has its own site, obs.explain.decode
_FP_PACKED_DECODE = FP.register(
    "transport.packed.decode",
    "fused packed-wire readback bytes (mangled bytes fail the tick CLOSED)",
    FP.PIPE_ACTIONS,
)
#: the pre-engine admission shed check: a raise sheds the request CLOSED
_FP_ADMIT = FP.register(
    "runtime.client.admit",
    "pre-engine admission shed check (a raise sheds the request CLOSED)",
    FP.HIT_ACTIONS,
)
#: the readback's entry: a delay stalls the tick for the watchdog
_FP_WD_STALL = FP.register(
    "runtime.watchdog.stall",
    "verdict readback entry (a delay stalls the tick for the watchdog)",
    FP.HIT_ACTIONS,
)


def _mask_min_rt(v: float) -> float:
    """RT_MIN_INIT (5000) is the 'no completions in window' sentinel:
    report 0.0 instead of a phantom 5-second minimum."""
    return 0.0 if v >= W.RT_MIN_INIT else v


def _np_dtypes(wire_dtypes: dict) -> dict:
    """ops/wire.py's narrow torch dtypes as the numpy dtypes the host
    stages the columns in."""
    # stlint: disable-next-line=host-sync — an empty CPU tensor: only its dtype is read, nothing waits for the card
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
    #: absolute engine-time ms past which the answer is worthless to the
    #: caller (0 = none); expired entries shed CLOSED before dispatch
    deadline_ms: int = 0


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
    #: block-wide absolute engine-time deadline (0 = none); the untaken
    #: remainder of an expired block sheds CLOSED before it reaches a tick
    deadline_ms: int = 0
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
    wire_lo: Any  # packed-wire layout of this tick's batch shape (None: unpacked)
    now_ms: int  # engine timestamp the tick ran at (timeline fold key)
    buf: Optional[torch.Tensor] = None
    event: Any = None
    #: drained front-door items at batch offset n_obj + n_blk:
    #: [(door, (row, count, prio, corr, a0, a1)), ...]
    fronts: list = field(default_factory=list)
    # stage-span correlation: the tick's trace id and the monotonic ns its
    # dispatch returned (0 while tracing is off)
    tick_id: int = 0
    dispatched_ns: int = 0
    # fan-out progress: a failed resolve fails CLOSED only the blocks and
    # doors the normal path had not reached (no double decrement, no
    # double respond)
    blocks_done: int = 0
    fronts_done: int = 0
    # watchdog handshake: exactly ONE side fans this tick out.  The
    # resolver claims "done" once the wire is host-visible and decoded;
    # the watchdog (or the resolve-failure path) claims "failed" — whoever
    # wins the transition under state_lock owns the fan-out, the loser
    # discards
    state: str = "pending"  # pending | done | failed
    state_lock: threading.Lock = field(default_factory=threading.Lock)
    deadline_mono: float = 0.0  # mono_s() stall deadline (0 = unwatched)
    # unpacked wire: read seg_dropped (the segment path without its
    # capacity fallback; 0 everywhere else)
    check_dropped: bool = False


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
    """Typed rule holder with push-style listeners.

    The analog of FlowRuleManager/DegradeRuleManager/...: ``load`` replaces
    the full rule set and recompiles the engine's rule tables
    (FlowRuleManager.loadRules → property.updateValue → listener).
    """

    def __init__(self, client: "SentinelClient", kind: str):
        self._client = client
        self.kind = kind
        self._rules: list = []
        self._listeners: list = []
        self._property = None

    def load(self, rules: Sequence) -> None:
        self._rules = list(rules) if rules else []
        self._client._recompile_rules()
        for fn in list(self._listeners):
            fn(self._rules)

    def load_projection(self, rules: Sequence) -> None:
        """``load``, as a cluster token service projects its rules onto its
        decision client (``DefaultTokenService._reproject``, under the
        service's ``_lock``).  A name no other def shares: the tier-3
        analyzer resolves the call, so the lock-order graph holds the
        service lock -> client lock edges that the projection takes (the
        lock witness sees them at run time)."""
        self.load(rules)

    def get(self) -> list:
        return list(self._rules)

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def register_property(self, prop) -> None:
        """Subscribe this manager to a SentinelProperty so datasource pushes
        drive rule reloads (FlowRuleManager.register2Property analog)."""
        from sentinel_tpu_torch.datasource.property import SimplePropertyListener

        if self._property is not None:
            self._property.remove_listener(self._prop_listener)
        self._property = prop
        # None means "property not populated yet" — keep existing rules
        # (FlowPropertyListener.configLoad null-check); an empty list is a
        # real "clear all rules" push.
        self._prop_listener = SimplePropertyListener(
            lambda rules: None if rules is None else self.load(rules)
        )
        prop.add_listener(self._prop_listener)


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
        metric_log: bool = False,
        metric_log_dir: Optional[str] = None,
        block_log: bool = False,
        watchdog_timeout_s: float = 0.0,
        admission_queue_limit: int = 0,
        sketch_audit_k: int = 0,
        sketch_audit_period: int = 16,
    ):
        self.device = resolve_device(device)
        self.app_name = app_name or cfg_app_name()
        self.cfg = cfg or platform_config()
        if self.cfg.packed_wire is None:
            # tri-state: None resolves to the packed wire here; an explicit
            # False keeps the classic TickOutput tensors, read one by one
            # (the full-upload reference client the packed one is held to)
            self.cfg = dataclasses.replace(self.cfg, packed_wire=True)
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
        # gateway rules project onto param rules in a manager of their own,
        # so gateway pushes never clobber user param rules
        # (adapters/gateway.GatewayRuleManager)
        self.gateway_param_rules = RuleManager(self, "gateway-param")
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
        self._cluster_hy = DG.Hysteresis(
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

        # -- adaptive protection / deadline-aware backpressure -------------
        # disabled mode is one `is None` / one flag check per call site (the
        # obs tracing and chaos failpoint contract, guarded by tests);
        # enable_adaptive() arms the closed loop
        self._adaptive: Optional[AdaptiveController] = None
        #: host copy of the STATIC system-rule tensors — the base the
        #: controller folds its live ceilings into (tightest wins)
        self._system_static = compile_system_rules([], self.cfg)
        #: pinned staging of the controller's five-scalar uploads (no host
        #: sync on the card: ops/engine.ScalarStage)
        self._sys_stage = E.ScalarStage(self.device)
        #: hard bound on the un-ticked acquire queue, block items included
        #: (0 = unbounded); enable_adaptive() defaults it from
        #: AdaptiveConfig.queue_max
        self._admission_max = max(0, int(admission_queue_limit))
        #: the one flag the submit paths check — True only while
        #: backpressure has anything to do (a bound set or the ladder up)
        self._bp_armed = self._admission_max > 0
        #: set on the first deadline-carrying submission; the tick
        #: loop's expiry sweep runs only while True
        self._deadlines_live = False
        #: tick watchdog: fail a dispatched tick CLOSED when its wire is not
        #: host-visible within this budget (0 = off; threaded mode only)
        self.watchdog_timeout_s = max(0.0, float(watchdog_timeout_s))
        self._wd_thread: Optional[threading.Thread] = None
        #: dispatched ticks the watchdog may fail over (only while armed)
        self._inflight_ticks: Dict[int, _PendingTick] = {}
        self._inflight_lock = threading.Lock()

        self._features = self._select_features()
        # memory-ledger ownership (obs/profile.py): every device buffer built
        # FOR this client — engine state (the sketch tier claims itself inside
        # init_state), ruleset tensors, wire staging — is claimed under this
        # owner tag so stop() releases exactly them; the first tick binding
        # per config is a warmup retrace by contract
        self._ledger_name = f"client:{self.app_name}:{id(self):x}"
        with PROF.ledger_owner(self._ledger_name), PROF.expected_retrace("client-init"):
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
        # attached native front doors (attach_front_door): every tick drains
        # their rings into the batch, round-robin from _door_rr; their
        # response rings are single-producer on the C side, so every
        # respond holds _respond_lock
        self._front_doors: list = []
        self._door_rr = -1
        self._respond_lock = threading.Lock()
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
        #: host mirror of the windows' rotation cadence, a window each:
        #: [bucket ms, slack buckets, last bucket id, last rotated id]
        #: (_count_rotations, from each tick's stamped timestamp)
        self._rot_track = {"second": [self.cfg.second_window_ms, 1, None, None]}
        if self.cfg.sketch_stats:
            scfg = E.sketch_config(self.cfg)
            self._rot_track["sketch"] = [scfg.window_ms, scfg.slack_buckets, None, None]
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._started = False
        self.stats = ClientStats(self)

        # host-side hot-param value tracking: the device store holds hashes
        # only; the command plane's topParams view needs the VALUES, so the
        # entry path keeps a small capped counter per resource
        self._hot_params: Dict[str, Dict[Any, int]] = {}
        self._hot_params_lock = threading.Lock()
        # the metric log (MetricTimerListener, metrics/): built in start()
        self._metric_log_enabled = metric_log
        self._metric_log_dir = metric_log_dir
        self.metric_timer = None
        # the block log (metrics/block_log.py: sentinel-block.log, one line
        # per (resource, exception, origin, cause) a second)
        self.block_log = None
        if block_log:
            from sentinel_tpu_torch.metrics.block_log import default_block_logger

            self.block_log = default_block_logger()
        #: host ms the last live reshape waited for the engine lock (a tick's
        #: dispatch holds it), and then held it (the migration's enqueue)
        self.swap_lock_wait_ms = 0.0
        self.swap_lock_ms = 0.0

        # hot-set manager (sketch/hotset.py): folds the readback's hot block
        # and promotes / demotes between the exact tier and the sketch tail
        # on its own cadence
        self.hotset: Optional[HotSetManager] = None
        if self.cfg.sketch_stats and E.hotset_k(self.cfg) > 0:
            self.hotset = HotSetManager(self)

        # online sketch-accuracy audit (obs/profile.SketchAudit): a rotating
        # exact shadow of up to sketch_audit_k sketched resources, compared
        # against the device estimates every sketch_audit_period ticks.
        # Disarmed (k=0, the default) the tick pays ONE `is not None` check
        self._audit: Optional[PROF.SketchAudit] = None
        self._audit_scfg = None
        self._audit_provider = None
        if sketch_audit_k > 0 and self.cfg.sketch_stats:
            scfg = E.sketch_config(self.cfg)
            self._audit_scfg = scfg
            self._audit = PROF.SketchAudit(
                node_rows=self.cfg.node_rows,
                window_ms=scfg.window_ms,
                sample_count=scfg.sample_count,
                slack_buckets=scfg.slack_buckets,
                width=scfg.width,
                k=int(sketch_audit_k),
                period=int(sketch_audit_period),
                trash_row=self.cfg.trash_row,
            )

        # per-resource timeline (obs/timeline.py): built in start() when the
        # engine emits timeline rows; an on-disk MetricLog is attached only
        # when asked for (timeline_log=True, a prebuilt MetricLog, or
        # timeline_dir) — the in-memory ring serves find() regardless
        self._timeline_log_opt = timeline_log
        self._timeline_dir = timeline_dir
        self.timeline: Optional[TLM.TimelineRecorder] = None
        self._timeline_provider = None
        self._flight_provider = None
        self._explain_provider = None
        # verdict provenance plane (obs/explain.py): the readback's explain
        # section decoded into per-resource "why blocked" rings
        self.explain_plane: Optional[ExplainPlane] = None
        if E.explain_k(self.cfg) > 0:

            def _audit_eps() -> Optional[float]:
                au = self._audit
                return None if au is None else au._last_audit.get("eps_budget")

            self.explain_plane = ExplainPlane(eps_source=_audit_eps, name_source=self.registry.resource_name)

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
            # flight bundles carry the last ~30 s of top-K rows
            self._timeline_provider = self.timeline.flight_section
            FL.FLIGHT.register_provider("timeline", self._timeline_provider)
        if self.mode == "threaded":
            # first ticks build the CUDA kernels (nvcc, seconds): run them
            # before serving so early entries don't time out
            self._warm_shapes()
            self._thread = threading.Thread(
                target=self._tick_loop, args=(self._stop_evt,),
                name="sentinel-tpu-torch-tick", daemon=True,
            )
            self._thread.start()
            if self.watchdog_timeout_s > 0:
                self._wd_thread = threading.Thread(
                    target=self._watchdog_loop, args=(self._stop_evt,),
                    name="sentinel-tpu-torch-watchdog", daemon=True,
                )
                self._wd_thread.start()
        if self._metric_log_enabled and self.metric_timer is None:
            from sentinel_tpu_torch.metrics.timer import MetricTimerListener
            from sentinel_tpu_torch.metrics.writer import MetricWriter
            from sentinel_tpu_torch.utils.record_log import log_dir

            writer = MetricWriter(self._metric_log_dir or log_dir(), self.app_name)
            self.metric_timer = MetricTimerListener(self, writer)
            if self.mode == "threaded":
                self.metric_timer.start()
        # black-box providers: every flight bundle captured while this
        # client serves carries its rule fingerprints, pipeline state and a
        # config digest, and its explain plane's recent records (the last
        # started client wins the names)
        self._flight_provider = self._flight_state
        FL.FLIGHT.register_provider("client", self._flight_provider)
        if self._audit is not None:
            self._audit_provider = self._audit.flight_section
            FL.FLIGHT.register_provider("audit", self._audit_provider)
        if self.explain_plane is not None:
            self._explain_provider = self.explain_plane.flight_section
            FL.FLIGHT.register_provider("explain", self._explain_provider)

    def _flight_state(self) -> dict:
        """Flight-bundle section: what a post-mortem needs to know about
        this client at capture time (obs/flight.py provider contract)."""
        import hashlib
        import json

        fps = {}
        for name in ("flow_rules", "degrade_rules", "system_rules", "authority_rules", "param_flow_rules"):
            rules = getattr(self, name).get()
            js = json.dumps(R.rules_to_json_list(rules), sort_keys=True)
            fps[name] = {"count": len(rules), "sha1": hashlib.sha1(js.encode()).hexdigest()[:12]}
        cfg = {k: v for k, v in dataclasses.asdict(self.cfg).items() if isinstance(v, (int, float, str, bool))}
        ad = self._adaptive
        return {
            "app": self.app_name,
            "mode": self.mode,
            "device": str(self.device),
            "enabled": self.enabled,
            "degraded": self._cluster_degraded_active,
            "adaptive": {
                "level": DG.LEVEL_NAMES[ad.ladder.level],
                "ceiling": -1.0 if ad.ceiling == float("inf") else round(ad.ceiling, 3),
            }
            if ad is not None
            else None,
            "pending_ticks": len(self._pending_ticks),
            "registered_resources": self.registry.num_resources,
            "rule_fingerprints": fps,
            "config": cfg,
        }

    def stop(self) -> None:
        fp = getattr(self, "_flight_provider", None)
        if fp is not None:
            # only if still ours: a newer client may have taken the name
            FL.FLIGHT.unregister_provider("client", fp)
            self._flight_provider = None
        ap = getattr(self, "_audit_provider", None)
        if ap is not None:
            FL.FLIGHT.unregister_provider("audit", ap)
            self._audit_provider = None
        ep = getattr(self, "_explain_provider", None)
        if ep is not None:
            FL.FLIGHT.unregister_provider("explain", ep)
            self._explain_provider = None
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._wd_thread is not None:
            self._wd_thread.join(timeout=2.0)
            self._wd_thread = None
        # decide whatever is still queued so no caller is left waiting
        self.tick_once()
        with self._tick_mutex:
            self._drain_resolves()  # stlint: disable=blocking-under-lock — shutdown: a tick still pending at pipeline_depth 0 resolves inline here (its own readback), as the reference's stop() does under _tick_mutex; the drain of the resolver thread is bounded
            if self._resolver_pool is not None:
                self._resolver_pool.shutdown(wait=True)
                self._resolver_pool = None
        if self.metric_timer is not None:
            self.metric_timer.stop()
            self.metric_timer = None
        if self.timeline is not None:
            if self._timeline_provider is not None:
                FL.FLIGHT.unregister_provider("timeline", self._timeline_provider)
                self._timeline_provider = None
            # flush the still-open second, release the log handles (start()
            # builds a new recorder)
            self.timeline.close()
            self.timeline = None
        if self.block_log is not None:
            self.block_log.flush()
        # release this client's memory-ledger claims (engine state, rule
        # tensors, wire staging): the owner tag brackets exactly them
        PROF.LEDGER.drop_owner(self._ledger_name)
        self._started = False

    # -- adaptive protection / backpressure -----------------------------------

    def enable_adaptive(self, cfg: Optional[AdaptiveConfig] = None) -> AdaptiveController:
        """Arm closed-loop system-adaptive protection (adaptive/): a per-tick
        controller republishes the SystemSlot ceilings (maxPass x minRT) as
        live values of the ruleset's system columns — a five-scalar upload,
        never a rebuilt tick (``engine.replace_system_columns``) — and drives
        the degrade ladder whose rungs the admission path enforces.  The one
        recompile is here: it turns the system stage on (it stays on while
        the controller is armed).  Idempotent; returns the controller."""
        with self._cluster_lock:
            if self._adaptive is not None:
                return self._adaptive
            self._adaptive = AdaptiveController(cfg)
            if self._admission_max == 0:
                self._admission_max = int(self._adaptive.cfg.queue_max)
            self._bp_armed = True
        self._recompile_rules()
        return self._adaptive

    def disable_adaptive(self) -> None:
        """Disarm the closed loop and restore the static thresholds."""
        with self._cluster_lock:
            ad, self._adaptive = self._adaptive, None
            if ad is None:
                return
            ad.disarm()
            self._bp_armed = self._admission_max > 0
        self._recompile_rules()

    def _queue_depth(self) -> int:
        """Un-ticked acquire items, block items included (unlocked reads:
        approximate is fine — a submit_block flood must not slip past the
        bound because its items sit in _acq_blocks)."""
        return len(self._acquires) + sum(len(b.res) - b.taken for b in list(self._acq_blocks))

    def _admission_shed(self, prio: int) -> Optional[str]:
        """Pre-engine shed decision for one submission: the shed reason, or
        None to admit.  Disarmed, it is the single ``_bp_armed`` check."""
        if not self._bp_armed:
            return None
        try:
            FP.hit(_FP_ADMIT)  # chaos: a raise sheds this admission CLOSED
        except Exception:  # stlint: disable=fail-open — sheds CLOSED (BLOCK_SYSTEM): nothing is admitted
            return "chaos"
        ad = self._adaptive
        level = ad.ladder.level if ad is not None else DG.NORMAL
        if level >= DG.FAIL_CLOSED:
            return "fail_closed"
        qmax = self._admission_max
        if qmax:
            qd = self._queue_depth()
            if qd >= qmax:
                return "queue_full"
            if (
                level >= DG.SHED_LOW_PRIORITY
                and not prio
                and ad is not None
                and qd >= qmax * ad.cfg.shed_lowprio_frac
            ):
                return "low_priority"
        elif level >= DG.SHED_LOW_PRIORITY and not prio:
            # no queue bound configured: the rung itself sheds the
            # non-prioritized share
            return "low_priority"
        return None

    def _shed_blocked(self, stage: str, reason: str, n: int = 1) -> None:
        _shed_counter(stage, reason).inc(n)

    def _adaptive_step(self, ad: AdaptiveController, now_ms: int, load, cpu) -> None:
        """One closed-loop control step, on the tick thread: the signals row,
        the controller and ladder, the rung effects, and changed ceilings
        published into the live system columns (under the engine lock,
        replacing only the system leaves)."""
        t0 = mono_s()
        with self._lock:
            qd = self._queue_depth()
        sig = ad.signals.observe_tick(
            now_ms, qd, len(self._pending_ticks), len(self._resolve_futs), load, cpu
        )
        want = ad.on_tick(sig)
        level = ad.ladder.level
        self._bp_armed = level > DG.NORMAL or self._admission_max > 0
        if level >= DG.CLUSTER_FALLBACK and (self._cluster_flow_by_res or self._cluster_param_by_res):
            # rung effect: stop paying token-server round trips on the
            # admission path; fallback-enabled cluster rules enforce
            # locally.  Re-entering every step extends the cooldown, so
            # probes resume only after the ladder descends
            self._enter_cluster_degraded()
        if want is not None:
            qps, max_thread = want
            sys_np = ad.system_columns(self._system_static, qps, max_thread)
            with self._engine_lock:
                # re-read under the lock: a concurrent recompile may have
                # swapped the whole ruleset; only the system leaves change
                self._rules_dev = E.replace_system_columns(self._rules_dev, sys_np, self._sys_stage)
        #: host µs of the last control step (signals, controller, upload)
        self.adaptive_step_us = (mono_s() - t0) * 1e6

    adaptive_step_us = 0.0

    # -- tick watchdog ----------------------------------------------------------

    def _watchdog_loop(self, stop_evt: threading.Event) -> None:
        period = max(self.watchdog_timeout_s / 4.0, 0.01)
        while not stop_evt.wait(period):
            try:
                self._watchdog_scan()
            except Exception:  # stlint: disable=fail-open — a dead watchdog must not take serving down; the next scan retries
                _log.warning("watchdog scan failed", exc_info=True)

    def _watchdog_scan(self) -> None:
        """Fail CLOSED every dispatched tick whose wire is not host-visible
        past its stall deadline.  The state handshake with the resolver
        (``_claim_tick``) makes exactly one side fan the tick out."""
        now = mono_s()
        with self._inflight_lock:
            stalled = [p for p in self._inflight_ticks.values() if p.deadline_mono and now > p.deadline_mono]
        for p in stalled:
            if not self._claim_tick(p, "failed"):
                continue  # the resolver won the race: it fans the tick out
            _C_WATCHDOG.inc()
            OT.event("watchdog.fired")
            FL.note("watchdog.fired", n_obj=p.n_obj, n_blk=p.n_blk, budget_s=self.watchdog_timeout_s)
            ad = self._adaptive
            if ad is not None:
                ad.note_severe()  # a stalled device is overload evidence
            _log.error(
                "tick watchdog: device tick stalled past %.2fs — failing %d object / %d block item(s) CLOSED",
                self.watchdog_timeout_s, p.n_obj, p.n_blk,
            )
            self._fail_tick(p)
            self._untrack_tick(p)

    @staticmethod
    def _claim_tick(p: _PendingTick, state: str) -> bool:
        """Atomically move a tick pending -> done / failed; False when the
        other side already owns the fan-out."""
        with p.state_lock:
            if p.state != "pending":
                return False
            p.state = state
            return True

    def _track_tick(self, p: _PendingTick) -> None:
        if self.watchdog_timeout_s > 0:
            p.deadline_mono = mono_s() + self.watchdog_timeout_s
            with self._inflight_lock:
                self._inflight_ticks[id(p)] = p

    def _untrack_tick(self, p: _PendingTick) -> None:
        if p.deadline_mono:
            with self._inflight_lock:
                self._inflight_ticks.pop(id(p), None)

    # -- rule compilation ---------------------------------------------------

    def _select_features(self, local_flow=None, local_param=None) -> frozenset:
        """Engine stages the compiled (local) rule set needs ('nodes' and
        'occupy' stay on; 'warmup' joins when a warm-up shaper exists,
        'param' while local param rules are compiled, 'tail_flow' while a
        flow rule's resource has a sketch id)."""
        feats = {"nodes", "occupy", "flow"}
        flow = [r for r in self.flow_rules.get() if not r.cluster_mode] if local_flow is None else local_flow
        param = (
            [r for r in self.param_flow_rules.get() + self.gateway_param_rules.get() if not r.cluster_mode]
            if local_param is None
            else local_param
        )
        if param:
            feats.add("param")
        if self.degrade_rules.get():
            feats.add("degrade")
        if self.authority_rules.get():
            feats.add("authority")
        if self.system_rules.get() or self._adaptive is not None:
            # the adaptive controller publishes live ceilings through the
            # system columns: the stage must run even with no static rule
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
            changed = self._recompile_rules_traced()
        FL.note(
            "rules.recompile",
            degraded=self._cluster_degraded_active,
            flow=len(self.flow_rules.get()),
            param=len(self.param_flow_rules.get()),
        )
        return changed

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
                self._warm_shapes()  # stlint: disable=blocking-under-lock — deliberate: warm-up first-calls must exclude serving ticks; runs post-recompile on the control plane

    def _recompile_rules_traced(self) -> bool:
        all_flow = self.flow_rules.get()
        flow = [r for r in all_flow if not r.cluster_mode]
        cluster_flow = [r for r in all_flow if r.cluster_mode]
        self._cluster_flow_by_res = {r.resource: r for r in cluster_flow}
        if self.cfg.sketch_stats:
            self._promote_ruled_tail(flow)
        gateway_param = self.gateway_param_rules.get()
        all_param = self.param_flow_rules.get() + gateway_param
        param = [r for r in all_param if not r.cluster_mode]
        cluster_param = [r for r in all_param if r.cluster_mode]
        self._cluster_param_by_res = {r.resource: r for r in cluster_param}
        self._auth_host_rules = self._authority_mirror()
        # per-resource hash LANES: each entry hashes up to param_dims
        # distinct argument indices; every rule reads the lane its param_idx
        # was assigned (ParamFlowChecker.java:78 paramIdx dispatch).  Lane 0
        # also feeds the cluster token request, so healthy (token service)
        # and degraded (local engine) modes throttle the same argument.
        # Gateway rules claim lanes first on shared resources: gateway
        # traffic supplies the (short) parsed gateway vector as args, and a
        # user rule's larger param_idx would index past it
        lane_map = param_lanes(all_param, self.cfg.param_dims, priority=gateway_param)
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
            # host copy of the STATIC system thresholds: the adaptive
            # controller folds its live ceilings into these (tightest
            # wins), so a recompile resets the base, never the loop
            self._system_static = compile_system_rules(self.system_rules.get(), self.cfg)
            changed = feats != self._features or cfg != self.cfg
            if changed:
                self.cfg = self.registry.cfg = cfg
                self._features = feats
                with PROF.expected_retrace("rule-feature-change"):
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

    def attach_front_door(self, door) -> None:
        """Serve a NativeFrontDoor's traffic from this client's tick loop:
        its pending acquires join every engine batch as array lanes and
        their verdicts return through the door's response ring — the
        per-request work never touches Python (cluster/front_door.py).
        May be called once per SO_REUSEPORT shard: every attached door is
        drained into the same engine batches."""
        self._front_doors.append(door)

    def set_cluster(self, cluster_state_manager) -> None:
        """Attach a ClusterStateManager; cluster-mode rules consult its
        token service (client or embedded server role)."""
        self.cluster = cluster_state_manager

    # attribute-compatible views of the shared hysteresis state (tests
    # and the chaos harness read and poke these directly, as the
    # reference's do)
    @property
    def _cluster_degraded_active(self) -> bool:
        return self._cluster_hy.active

    @_cluster_degraded_active.setter
    def _cluster_degraded_active(self, v: bool) -> None:
        self._cluster_hy.active = bool(v)

    @property
    def _cluster_degraded_until(self) -> float:
        return self._cluster_hy.until

    @_cluster_degraded_until.setter
    def _cluster_degraded_until(self, v: float) -> None:
        self._cluster_hy.until = float(v)

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
        if entered:
            self._warm_after_recompile(changed)
            # black box: freeze the state that produced the degrade —
            # outside the lock (the bundle reads the rule managers) and
            # rate-limited inside trigger()
            FL.FLIGHT.trigger("cluster-degrade-enter")

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
            except Exception:  # stlint: disable=fail-open — degrade to LOCAL: the fallback rules recompile into the engine, enforcement continues
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
            except Exception:  # stlint: disable=fail-open — degrade to LOCAL: the fallback rules recompile into the engine, enforcement continues
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
            except Exception:  # stlint: disable=fail-open — r=None takes the degrade-to-LOCAL branch below
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
                except Exception:  # stlint: disable=fail-open — r=None takes the degrade-to-LOCAL branch below
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
        deadline_ms: int = 0,
        _ctx: Optional[Tuple[str, str]] = None,
        _push_ctx: bool = True,
    ) -> Entry:
        """Acquire; raises BlockException on rejection (SphU.entry).
        ``args``: the call's arguments; the ones param-flow rules on this
        resource index are hashed into the hot-parameter lanes.
        ``deadline_ms`` (absolute engine-time ms, 0 = none): past it the
        caller no longer wants the answer — an entry already expired raises
        SystemBlockException at once, and a still-queued expired one sheds
        CLOSED before device dispatch instead of burning a tick.
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
        if self._bp_armed:
            # backpressure rungs / the admission bound (adaptive/degrade.py):
            # shed CLOSED before any engine or cluster work — but AFTER the
            # pass-through branch (ungoverned traffic never queues, so
            # backpressure must not turn it into a block)
            reason = self._admission_shed(1 if prioritized else 0)
            if reason is not None:
                self._shed_blocked("admit", reason)
                if self.mode == "sync":
                    # a sync client ticks only on its submissions:
                    # the control loop must keep stepping even when every
                    # one sheds, or FAIL_CLOSED could never observe calm
                    self.tick_once()
                raise ERR.SystemBlockException(resource)
        if deadline_ms and deadline_ms < self.time.now_ms():
            self._shed_blocked("admit", "deadline")
            raise ERR.SystemBlockException(resource)
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
        # the hot-param value counters see every hashed argument — except at
        # PARAM_TAIL_OFF and above, where the ladder sheds this host-side
        # tail work (the enforcement hashes still flow)
        ad = self._adaptive
        tail_off = ad is not None and ad.ladder.level >= DG.PARAM_TAIL_OFF
        param_hashes = self.param_hashes(resource, args, note=not tail_off)
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
            deadline_ms=int(deadline_ms),
        )
        with self._lock:
            if deadline_ms:
                self._deadlines_live = True
            self._acquires.append(req)
        if self.mode == "sync":
            self.tick_once()
        verdict, wait_ms = req.future.result(timeout=self.entry_timeout_s)
        if verdict not in (ERR.PASS, ERR.PASS_WAIT):
            # the engine already counted the block; here only the block log,
            # the extension SPI and the slots' exit side fire
            exc = hook_exc if hook_exc is not None else ERR.exception_for_verdict(verdict, resource)
            if self.block_log is not None:
                kind_name = rule_slot = None
                if self.explain_plane is not None:
                    kind_name = KIND_NAMES.get(int(verdict))
                    # the resolver folded this tick's explain records BEFORE
                    # resolving our future: the newest matching record is
                    # this block's provenance
                    rule_slot = self.explain_plane.latest_rule(rid, int(verdict))
                self.block_log.log(
                    self.time.wall_ms(), resource, type(exc).__name__, origin or "", count,
                    kind=kind_name, rule=rule_slot,
                )
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

    def param_hashes(self, resource: str, args: Optional[Sequence], note: bool = False) -> tuple:
        """``param_dims`` hashed lanes for an entry on ``resource``: one
        argument per lane the rule compile assigned (lane 0 reads args[0]
        where no param rule names the resource); 0 = no argument.
        ``note``: count each hashed value in the hot-param counters
        (``top_params``), as ``entry()`` does."""
        M = self.cfg.param_dims
        hashes = [0] * M
        if args:
            lanes = self._param_lanes_by_res.get(resource) or [0]
            for li, idx in enumerate(lanes[:M]):
                if 0 <= idx < len(args):
                    hashes[li] = hash_param(args[idx])
                    if note:
                        self._note_hot_param(resource, args[idx])
        return tuple(hashes)

    _HOT_PARAM_CAP = 512

    def _note_hot_param(self, resource: str, value) -> None:
        """Count a parameter value sighting (ParameterMetric's value-keyed
        CacheMap analog, host side, capped with decimation on overflow)."""
        try:
            with self._hot_params_lock:
                counter = self._hot_params.setdefault(resource, {})
                counter[value] = counter.get(value, 0) + 1
                if len(counter) > self._HOT_PARAM_CAP:
                    top = sorted(counter.items(), key=lambda kv: -kv[1])
                    self._hot_params[resource] = dict(top[: self._HOT_PARAM_CAP // 2])
        except TypeError:
            pass  # unhashable param value — not trackable

    def rt_quantiles(self, qs=(0.5, 0.9, 0.99)) -> Dict[float, float]:
        """Service-level inbound RT quantiles over the trailing window
        (ops/rtq.py log-bucket histogram; ~11% bucket resolution): one
        device read of the 64 windowed bins."""
        from sentinel_tpu_torch.ops import rtq as RQ

        rcfg = E.rtq_config(self.cfg)
        now = self.time.now_ms()
        with self._engine_lock:
            counts = RQ.windowed_counts(self._state.rtq, now, rcfg)
        return RQ.quantiles(counts.cpu().numpy(), qs, rcfg)

    def top_params(self, resource: str, n: int = 16) -> list:
        """[(value, sightings)] — the hottest parameter values seen."""
        with self._hot_params_lock:
            counter = dict(self._hot_params.get(resource, {}))
        return sorted(counter.items(), key=lambda kv: -kv[1])[:n]

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

    @contextmanager
    def context(self, name: str, origin: str = ""):
        """Context-manager form of ContextUtil.enter/exit."""
        token = CTX.enter(name, origin)
        try:
            yield
        finally:
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
        None too while the client is disabled (``enabled=False``).
        ``deadline_ms`` as in ``entry``; a shed request's future is already
        resolved, BLOCK_SYSTEM."""
        if not self.enabled:
            return None
        rid = self.registry.resource_id(resource)
        if rid is None:
            return None  # pass-through: never queued, never backpressured
        if self._bp_armed:
            reason = self._admission_shed(1 if prioritized else 0)
            if reason is not None:
                self._shed_blocked("admit", reason)
                if self.mode == "sync":
                    self.tick_once()  # keep the control loop stepping
                f: Future = Future()
                f.set_result((int(ERR.BLOCK_SYSTEM), 0))
                return f
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
            deadline_ms=int(deadline_ms),
        )
        with self._lock:
            if deadline_ms:
                self._deadlines_live = True
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
        so does everything while the client is disabled.  Items the
        backpressure sheds, or whose ``deadline_ms`` expires in the queue,
        get (BLOCK_SYSTEM, 0)."""
        if not self.enabled:
            return [(ERR.PASS, 0)] * len(resources)
        shed: List[Optional[str]] = [None] * len(resources)
        if self._bp_armed:
            for i in range(len(resources)):
                shed[i] = self._admission_shed(1 if (prioritized is not None and prioritized[i]) else 0)
        # the cluster consultation runs OUTSIDE self._lock (a token-server
        # round trip must not stall the tick thread) and is AGGREGATED: one
        # request per distinct (resource, argument) group with the summed
        # count, not one round trip an item
        pre_verdicts = [0] * len(resources)
        pre_waits = [0] * len(resources)
        if self._cluster_flow_by_res or self._cluster_param_by_res:
            groups: Dict[Tuple[str, Any], List[int]] = {}
            for i, name in enumerate(resources):
                if shed[i] is not None:
                    continue  # sheds CLOSED below: it consumes no token
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
            if deadline_ms:
                # armed under the queue lock, so the sweep's all-clear check
                # serializes with the items it must cover
                self._deadlines_live = True
            for i, name in enumerate(resources):
                rid = self.registry.resource_id(name)
                if rid is None:
                    # a full registry: contractually a pass-through; it never
                    # queues, so backpressure must not turn it into a block
                    futures.append(None)
                    continue
                if shed[i] is not None:
                    self._shed_blocked("admit", shed[i])
                    futures.append("shed")
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
                    deadline_ms=int(deadline_ms),
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
            if f == "shed":
                out.append((ERR.BLOCK_SYSTEM, 0))
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
        None while the client is disabled: the block passes through.
        ``deadline_ms`` (absolute engine-time ms, 0 = none) covers the whole
        block: its untaken remainder sheds CLOSED once it expires.  A block
        sheds whole, before it queues, only on the hard limits (FAIL_CLOSED,
        the admission bound, an injected admission fault)."""
        if not self.enabled:
            return None
        res = np.ascontiguousarray(res, dtype=np.int32)
        n = len(res)
        if self._bp_armed:
            reason = self._admission_shed(1)  # blocks shed only on hard limits
            if reason in ("fail_closed", "queue_full", "chaos"):
                self._shed_blocked("admit", reason, n)
                if self.mode == "sync":
                    self.tick_once()  # keep the control loop stepping
                f: Future = Future()
                f.set_result((np.full(n, ERR.BLOCK_SYSTEM, np.int8), np.zeros(n, np.int32)))
                return f
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
            deadline_ms=int(deadline_ms),
            future=Future(),
            unresolved=n,
            verdicts=np.zeros(n, np.int8),
            waits=np.zeros(n, np.int32),
        )
        if n == 0:
            blk.future.set_result((blk.verdicts, blk.waits))
            return blk.future
        with self._lock:
            if deadline_ms:
                self._deadlines_live = True
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
            except Exception:  # pragma: no cover - keep the loop alive  # stlint: disable=fail-open — a dead tick loop strands EVERY pending future; the failure is printed, the next tick retries
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
            self._tick_once_locked(now_ms)  # stlint: disable=blocking-under-lock — the tick IS the device dispatch: _tick_mutex exists to serialize exactly this work; readbacks ride the resolver thread, not this lock
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
        while True:
            # read every iteration: a live operating-point swap (a future's
            # callback, another thread) may change the batch shape between
            # two ticks of this loop, and a batch must fit the tick it runs on
            bs, cbs = self.cfg.batch_size, self.cfg.complete_batch_size
            if self._deadlines_live:
                # deadline-aware backpressure: work that has already expired
                # is worthless — shed it CLOSED here, BEFORE it costs a
                # device dispatch (one queue pass, only while a
                # deadline-carrying submission is live)
                self._sweep_expired(now_ms)
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
            fronts = self._drain_doors(bs - len(acq) - sum(t for _b, _o, t in blocks))
            if not acq and not blocks and comp is None and not fronts and now_ms is None:
                ad = self._adaptive
                if ad is not None and (ad.ladder.level > DG.NORMAL or ad.ceiling != float("inf")):
                    # the closed loop keeps stepping on EMPTY ticks: at
                    # FAIL_CLOSED everything sheds before the engine, and
                    # without this the ladder would never observe the calm
                    # that lets it descend
                    load, cpu = self._sys.sample()
                    self._adaptive_step(ad, self.time.now_ms(), load, cpu)
                # idle: flush any deferred readbacks before returning
                self._drain_resolves()
                return
            try:
                pending = self._run_tick(acq, comp, now_ms, blocks=blocks, fronts=fronts)
            except Exception:
                # a tick that cannot run decides nothing: its callers
                # get a fail-closed verdict, not an entry timeout
                self._fail_tick(_PendingTick(
                    acq=acq, blocks=blocks, inv_a=None, out=None, n_obj=len(acq), n_blk=0,
                    wire_lo=None, now_ms=0, fronts=fronts,
                ))
                raise
            self._pending_ticks.append(pending)
            _G_OCCUPANCY.set(len(self._pending_ticks))
            more = self._has_work() or any(d.pending() > 0 for d in self._front_doors)
            depth = self._pipeline_depth if more else 0
            while len(self._pending_ticks) > depth:
                self._hand_off(self._pending_ticks.pop(0))
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

    def _drain_doors(self, room: int) -> list:
        """Up to ``room`` engine items from the attached front doors, as
        ``[(door, (row, count, prio, corr, a0, a1)), ...]``.  The drain
        order rotates a tick (``_door_rr``), so a saturated first shard
        cannot starve the later shards' rings; concurrent acquire / release
        events (``kind >= 3``) are answered on the host
        (``handle_host_events``) and take no batch row."""
        fronts = []
        doors = self._front_doors
        if len(doors) > 1:
            rr = self._door_rr = (self._door_rr + 1) % len(doors)
            doors = doors[rr:] + doors[:rr]
        for door in doors:
            if room <= 0:
                break
            row, cnt, prio, corr, kind, a0, a1 = door.drain(room)
            if not len(row):
                continue
            host = kind >= 3
            if host.any():
                door.handle_host_events(kind[host], cnt[host], corr[host], a0[host], a1[host])
            eng = ~host
            if eng.any():
                # copies: the door reuses its drain buffers at the next drain
                cols = (row[eng], cnt[eng], prio[eng], corr[eng], a0[eng], a1[eng])
                fronts.append((door, cols))
                room -= len(cols[0])
        return fronts

    def _sweep_expired(self, now_ms: Optional[int]) -> None:
        """Shed already-expired queued work CLOSED before device dispatch
        (the admission half of deadline-aware backpressure; the watchdog
        covers work already ON the device)."""
        now = now_ms if now_ms is not None else self.time.now_ms()
        expired: List[AcquireRequest] = []
        exp_blocks: List[ArrayBlock] = []
        with self._lock:
            if any(r.deadline_ms and r.deadline_ms < now for r in self._acquires):
                keep = []
                for r in self._acquires:
                    (expired if r.deadline_ms and r.deadline_ms < now else keep).append(r)
                self._acquires = keep
            if any(b.deadline_ms and b.deadline_ms < now for b in self._acq_blocks):
                kept = []
                for b in self._acq_blocks:
                    (exp_blocks if b.deadline_ms and b.deadline_ms < now else kept).append(b)
                self._acq_blocks = kept
            if not any(r.deadline_ms for r in self._acquires) and not any(
                b.deadline_ms for b in self._acq_blocks
            ):
                # nothing deadline-carrying is left: disarm the sweep (the
                # flag re-arms under this same lock at the next deadline
                # submission, so nothing slips between)
                self._deadlines_live = False
        for r in expired:
            if r.future is not None and not r.future.done():
                r.future.set_result((int(ERR.BLOCK_SYSTEM), 0))
        if expired:
            self._shed_blocked("tick", "deadline", len(expired))
        for blk in exp_blocks:
            remaining = len(blk.res) - blk.taken
            blk.verdicts[blk.taken :] = ERR.BLOCK_SYSTEM
            blk.waits[blk.taken :] = 0
            blk.taken = len(blk.res)
            self._block_done(blk, remaining)
            self._shed_blocked("tick", "deadline", remaining)

    def _pool(self) -> ThreadPoolExecutor:
        """The resolver: ONE thread, so ticks resolve — and the
        observability planes fold — in dispatch order; stop() shuts it."""
        if self._resolver_pool is None:
            self._resolver_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sentinel-resolve")
        return self._resolver_pool

    def _hand_off(self, p: _PendingTick) -> None:
        """Resolve one dispatched tick in tick order: on the resolver thread
        while pipelining — or while earlier ticks are still queued there
        (a live ``pipeline_depth`` cut to 0 drains them, never overtakes
        them) — else inline."""
        if self._pipeline_depth > 0 or self._resolve_futs:
            self._resolve_futs.append(self._pool().submit(self._resolve_tick, p))
        else:
            self._resolve_tick(p)

    def _drain_resolves(self) -> None:
        """Flush deferred readbacks: pending ticks not yet handed to the
        resolver, then every in-flight resolution (bounded: a wedged
        readback is abandoned after 2 x entry_timeout_s, at least 5 s)."""
        while self._pending_ticks:
            self._hand_off(self._pending_ticks.pop(0))
        futs, self._resolve_futs = self._resolve_futs, []
        deadline = mono_s() + max(2.0 * self.entry_timeout_s, 5.0)
        for f in futs:
            try:
                f.result(timeout=max(0.0, deadline - mono_s()))  # stlint: disable=blocking-under-lock — the deadline above bounds the whole drain; a wedged readback is abandoned
            except _FutTimeout:
                _log.warning("resolve drain abandoned a wedged tick")
            except Exception as exc:  # stlint: disable=fail-open — the failed resolution already failed its tick CLOSED (_resolve_tick); the drain logs it and goes on to the rest
                _log.error("tick resolution failed: %r", exc, exc_info=exc)
        _G_OCCUPANCY.set(0)
        _G_RESOLVER_Q.set(0)

    def _warm_shapes(self) -> None:
        """Run both batch shapes once with no-op batches (builds the
        kernels before serving); each warm-up's host ms lands in
        ``sentinel_compile_ms{entry="engine.tick"}``."""
        tw = mono_s()
        self._resolve_tick(self._run_tick([], None, self.time.now_ms()))
        PROF.RETRACE.observe_compile_ms("engine.tick", (mono_s() - tw) * 1000.0)
        if self.cfg.batch_size > 256:
            filler = AcquireRequest(
                res=self.cfg.trash_row, count=0, prio=0, origin_id=-1,
                origin_node=self.cfg.trash_row, ctx_node=self.cfg.trash_row,
                ctx_name=-1, inbound=0,
            )
            tw = mono_s()
            self._resolve_tick(self._run_tick([filler] * 257, None, self.time.now_ms()))
            PROF.RETRACE.observe_compile_ms("engine.tick", (mono_s() - tw) * 1000.0)

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
        PyTorch: nothing to compile, the swap is immediate, inline before
        the tick that needs it).  A failure keeps the old capacity and is
        logged, never raised into the serving path (the
        ``runtime.seg.resize`` failpoint's raise)."""
        _C_SEG_RESIZE.inc()
        FL.note("seg.resize", seg_u=int(new_u), old_u=int(self.cfg.seg_u))
        h = OT.TRACER.begin("engine.seg_resize", seg_u=int(new_u))
        try:
            FP.hit(_FP_SEG_RESIZE)  # chaos: a raise keeps the old capacity
            cfg = dataclasses.replace(self.cfg, seg_u=int(new_u))
            with self._engine_lock:
                self.cfg = self.registry.cfg = cfg
                with PROF.expected_retrace("segment-resize"):
                    self._tick = E.make_tick(cfg, features=self._features)
                self._seg_over_ticks = 0
        except Exception:  # stlint: disable=fail-open — background resize: on failure serving continues on the old capacity, logged
            # serving continues on the old capacity (exact through the
            # per-item branch under seg_fallback, counted drops without);
            # the next overflow tries again
            _log.warning("seg_u resize to %d failed; serving continues on the old capacity", new_u,
                         exc_info=True)
        finally:
            OT.TRACER.end(h)

    def _record_seg_dropped(self, n: int) -> None:
        """Surface fail-closed segment-overflow drops (seg_fallback=False):
        the counter, the client's total, the block log (every rejection is
        logged) and a warning at most once a second."""
        _C_SEG_DROPPED.inc(n)
        with self._blk_lock:
            self.seg_dropped_total += n
        now = self.time.wall_ms()
        if self.block_log is not None:
            self.block_log.log(now, "__seg_overflow__", "SegCapacityDrop", "", n)
        sec = int(now // 1000)
        if sec != self._seg_drop_last_log_s:
            self._seg_drop_last_log_s = sec
            _log.warning(
                "segment capacity overflow: %d items FAILED CLOSED this tick (total %d) — "
                "seg_u=%d is undersized for the live traffic; raise seg_u or set seg_fallback=True",
                n, self.seg_dropped_total, ES.seg_capacity(self.cfg, self.cfg.batch_size),
            )

    def update_window_shape(
        self,
        sample_count: Optional[int] = None,
        window_ms: Optional[int] = None,
        minute_sample_count: Optional[int] = None,
        minute_window_ms: Optional[int] = None,
    ) -> None:
        """LIVE window reshaping — the IntervalProperty/SampleCountProperty
        analog (node/IntervalProperty.java): swap the engine onto a new
        window grid under the engine lock, MIGRATING current windowed
        totals so admission budgets don't reopen mid-flight (the reference
        resets node metrics instead).  A capacity change raises
        ``ValueError`` (``engine.migrate_state``)."""
        changes = {}
        if sample_count is not None:
            changes["second_sample_count"] = int(sample_count)
        if window_ms is not None:
            changes["second_window_ms"] = int(window_ms)
        if minute_sample_count is not None:
            changes["minute_sample_count"] = int(minute_sample_count)
        if minute_window_ms is not None:
            changes["minute_window_ms"] = int(minute_window_ms)
        if not changes:
            return
        new_cfg = dataclasses.replace(self.cfg, **changes)
        if new_cfg == self.cfg:
            return
        self._swap_engine(new_cfg, "window-reshape", **changes)

    def _swap_engine(self, new_cfg, cause: str, **span_attrs) -> None:
        """Build-then-swap the engine onto ``new_cfg`` LIVE: bind the new
        tick and run it at both batch shapes on a throwaway state while the
        old engine keeps serving (the first launches load kernel modules
        and plan the fused jobs), then migrate the state under the engine
        lock, so the swap itself is only the migration.  The new binding
        journals as an EXPECTED retrace under ``cause`` (obs/profile.py): a
        tuning or reshaping session keeps the surprise count flat.  The
        throwaway state re-claims this client's windows / sketch ledger
        entries at the new config's sizes, the shapes the migrated state
        lands in.

        Ticks dispatched before the swap resolve as they were built: each
        ``_PendingTick`` carries its own wire layout and readback buffer
        (the pool is keyed by wire size), and the migration is queued
        behind them on the card's stream."""
        _h = OT.TRACER.begin("client.engine_swap", cause=cause, **span_attrs)
        try:
            with PROF.ledger_owner(self._ledger_name), PROF.expected_retrace(cause):
                new_tick = E.make_tick(new_cfg, features=self._features)
            with PROF.ledger_owner(self._ledger_name):
                dummy = E.init_state(new_cfg, self.device)
            for bs in sorted({min(256, new_cfg.batch_size), new_cfg.batch_size}):
                dummy, _ = new_tick(
                    dummy,
                    self._rules_dev,
                    E.empty_acquire(new_cfg, self.device, b=bs),
                    E.empty_complete(new_cfg, self.device, b=min(bs, new_cfg.complete_batch_size)),
                    self.time.now_ms(),
                    0.0,
                    0.0,
                )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            del dummy
            t_wait = mono_s()
            with self._engine_lock:
                t_lock = mono_s()
                self._state = E.migrate_state(self._state, self.cfg, new_cfg, self.time.now_ms())
                self.cfg = new_cfg
                self.registry.cfg = new_cfg
                self._tick = new_tick
                self._wire_layouts = {}
            self.swap_lock_ms = (mono_s() - t_lock) * 1000.0
            self.swap_lock_wait_ms = (t_lock - t_wait) * 1000.0
            # ruleset tensors are capacity-shaped, not window-shaped — the
            # recompile only keeps future rule edits keyed to the active cfg
            self._recompile_rules()
        finally:
            OT.TRACER.end(_h)

    def apply_operating_point(self, op, cause: str = "tuner-retune") -> dict:
        """Apply a ``workload.OperatingPoint`` LIVE — the autotuner's
        actuator.  Host-only knobs (pipeline depth, audit cadence) are plain
        attribute writes with no effect on the bound tick; engine knobs
        (batch / sketch shapes) ride the same build-then-swap path as
        ``update_window_shape``, journaled as one expected retrace under
        ``cause``.  ``op`` is duck-typed (``engine_changes`` + the knob
        attributes), so the runtime never imports workload.

        Returns ``{"engine": bool, "host": [knob, ...]}``: what actually
        changed (an identity apply returns all-empty)."""
        applied = {"engine": False, "host": []}
        depth = getattr(op, "pipeline_depth", None)
        if depth is not None and int(depth) != self._pipeline_depth:
            self._pipeline_depth = max(0, int(depth))
            applied["host"].append("pipeline_depth")
        period = getattr(op, "audit_period", None)
        if period is not None and self._audit is not None and max(1, int(period)) != self._audit.period:
            self._audit.period = max(1, int(period))
            applied["host"].append("audit_period")
        changes = op.engine_changes(self.cfg)
        if changes:
            self._swap_engine(dataclasses.replace(self.cfg, **changes), cause, **changes)
            applied["engine"] = True
        return applied

    def register_window_property(self, prop) -> None:
        """Subscribe window shape to a SentinelProperty pushing dicts like
        {"sampleCount": 4, "intervalMs": 1000} — datasource-driven live
        reshaping (SampleCountProperty.register2Property analog)."""
        from sentinel_tpu_torch.datasource.property import SimplePropertyListener

        def apply(v):
            if not v:
                return
            # reference semantics: intervalMs is the TOTAL window and
            # sampleCount re-slices it — missing fields default to the
            # CURRENT values so a partial push never changes the other
            # dimension (a sampleCount-only push must not grow the window)
            cur_total = self.cfg.second_sample_count * self.cfg.second_window_ms
            sc = int(v.get("sampleCount") or self.cfg.second_sample_count)
            iv = int(v.get("intervalMs") or cur_total)
            if sc <= 0 or iv <= 0 or iv % sc:
                return
            self.update_window_shape(sample_count=sc, window_ms=iv // sc)

        prop.add_listener(SimplePropertyListener(apply))

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
            self._ledger_wire()  # cold: a new staging slot pair
        return s[self._stage_parity]

    def _ledger_wire(self) -> None:
        """Re-claim the wire pool (obs/profile.LEDGER) after a cold
        allocation: the two-slot staging buffers (pinned host memory on the
        card) plus the cached device constant columns.  The dirty-column
        copies (``_col_last``) churn with traffic and stay out: ledger
        entries change only on allocation events, never per tick."""
        nb = sum(s[0].nbytes + s[1].nbytes for s in self._stage.values()) + sum(
            PROF.tree_nbytes(c) for c in self._const_cols.values()
        )
        with PROF.ledger_owner(self._ledger_name):
            PROF.LEDGER.set("wire", "client.staging", nb)

    def _host_buffer(self, shape, dt) -> np.ndarray:
        if not self._pinned:
            return np.empty(shape, dt)
        tdt = torch.from_numpy(np.empty(0, dt)).dtype
        return torch.empty(shape, dtype=tdt, pin_memory=True).numpy()  # stlint: disable=host-sync — pinned HOST memory: a numpy view of it, nothing waits for the card

    def _flip_stage(self) -> None:
        """Flip the staging parity, then wait until the uploads that last
        read this parity's slots have run on the card (the event recorded
        behind them; it has almost always completed)."""
        self._stage_parity ^= 1
        ev = self._stage_events[self._stage_parity]
        if ev is not None:
            ev.synchronize()  # stlint: disable=host-sync — waits only for the uploads recorded a tick ago to have read this parity's staging slots (almost always done); reusing the slots without it would race the copy engine
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
                self._ledger_wire()  # cold: a new (field, dtype, shape) constant
            # the dirty ref would go stale while constant ticks bypass it
            self._col_last.pop(field, None)
            return c
        # the dirty-column delta is part of the packed transport:
        # packed_wire=False stays a full-upload reference client
        prev = self._col_last.get(field) if self.cfg.packed_wire else None
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

    def _run_tick(self, acq: List[AcquireRequest], comp, now_ms, blocks=(), fronts=()) -> _PendingTick:
        """Build the batch columns into the staging slots (presorted on the
        segment path), upload them through ``_dev_col``, run one tick and
        start its wire's readback into a host buffer; returns the
        ``_PendingTick``.  ``comp``: the drained ring-layout completion
        columns, or None.  The batch holds the object requests, then the
        block slices, then the drained front-door items (``fronts``:
        ``[(door, (row, count, prio, corr, a0, a1)), ...]``), whose param
        columns take the door's pre-hashed lanes ``a0`` / ``a1``."""
        cfg = self.cfg
        M = cfg.param_dims
        trash = cfg.trash_row
        n_blk = sum(t for _b, _o, t in blocks)
        # every attached door's drained engine items, concatenated; the
        # responses route back a door by slice
        front = tuple(np.concatenate([cols[j] for _d, cols in fronts]) for j in range(6)) if fronts else None
        n_front = 0 if front is None else len(front[0])
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
        B = self._shape_for(len(acq) + n_blk + n_front, cfg.batch_size)
        B2 = self._shape_for(0 if comp is None else len(comp[0]), cfg.complete_batch_size)
        # the clamp and the presort follow the ACTIVE path, as the
        # reference's do: the segment path needs the fused one, and the
        # plain path is exact to 65,535 without a clamp
        clamp = E._use_fused(cfg)
        presort = cfg.seg_effects and clamp
        inv = None
        segs_a = segs_c = 0
        au_cols = None
        if acq or n_blk or n_front:
            n = len(acq)
            f0 = n + n_blk  # the doors' items start here

            def arr(f, fill, dt=np.int32, blk_default=None, front_col=None):
                """Object requests at [0, n), block slices after them, then
                the front-door items (array copies, no per-item Python),
                padding to B."""
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
                if front_col is not None:
                    out[f0 : f0 + n_front] = front_col
                return out

            res_np = arr("res", trash, front_col=front[0] if n_front else None)
            cnt_np = arr("count", 0, blk_default=1, front_col=front[1] if n_front else None)
            if clamp:
                np.minimum(cnt_np, cfg.max_batch_count, out=cnt_np)  # the fused kernels' envelope
            if self._audit is not None:
                # the audit's shadow-fold input: the CLAMPED columns before
                # the presort (a fold is a sum: order is irrelevant) —
                # exactly the units the engine lands in the sketch; these
                # slots are not written again before observe() below
                au_cols = (res_np, cnt_np)
            prio_np = arr("prio", 0, front_col=front[2] if n_front else None)
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
            if n_front:
                # the door's param requests carry lane values hashed in C
                ph_np[f0 : f0 + n_front, 0] = front[4]
                if M > 1:
                    ph_np[f0 : f0 + n_front, 1] = front[5]
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
            if self._adaptive is not None and n:
                # the BBR minRT input: this tick's completion RT floor
                self._adaptive.signals.note_completions(n, float(rt_c.min()))
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
            # the acquire side's envelope, on the fused path only
            cap = cfg.max_batch_count if clamp else np.iinfo(np.int32).max
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
        t += FP.skew_ms(_FP_TICK_CLOCK)  # chaos: deterministic clock skew
        self._count_rotations(int(t))
        au = self._audit
        if au is not None:
            # audit-then-fold (obs/profile.py): the estimate read and the
            # shadow both cover the stream through the PREVIOUS tick — this
            # tick's batch lands on the card only in the dispatch below.
            # Outside _engine_lock; fails OPEN inside.
            au.observe(
                int(t),
                au_cols[0] if au_cols is not None else None,
                au_cols[1] if au_cols is not None else None,
                self._audit_attempts,
            )
        ad = self._adaptive
        if ad is not None:
            # the closed loop: signals row -> controller -> ladder and the
            # live system columns (disabled: the one check above)
            self._adaptive_step(ad, int(t), load, cpu)
        self._build_ms_sum += (mono_s() - t_build0) * 1000.0
        self._build_ticks += 1
        with self._engine_lock:
            self._state, out = self._tick(
                self._state, self._rules_dev, a, c, int(t), load, cpu, seg_fits=seg_fits
            )
            # under the lock a swap also takes: the layout of the config
            # this tick ran on, whatever swap comes after
            wire_lo = self._wire_layout(B) if out.wire is not None else None
        _disp_done = 0
        if _t_disp:
            _disp_done = OT.now_ns()
            OT.stage_ns("tick.dispatch", _t_disp, _disp_done - _t_disp, _H_DISPATCH, trace=tick_id)
        # start the readback NOW: the copy into a host buffer (pinned on the
        # card) is queued behind the tick, with an event the resolver waits
        # on.  Unpacked, the event alone: the resolver reads the tensors
        buf = None
        if out.wire is not None:
            buf = self._readback.take(out.wire.shape[0])
            buf.copy_(out.wire, non_blocking=True)
        event = None
        if out.wait_ms.is_cuda:
            event = torch.cuda.Event()
            event.record()
        p = _PendingTick(
            acq=acq, blocks=list(blocks), inv_a=inv, out=out, n_obj=len(acq), n_blk=n_blk,
            wire_lo=wire_lo, now_ms=int(t), buf=buf, event=event, fronts=list(fronts),
            tick_id=tick_id, dispatched_ns=_disp_done, check_dropped=bool(presort and not cfg.seg_fallback),
        )
        self._track_tick(p)  # watchdog coverage (a no-op while disarmed)
        return p

    def _count_rotations(self, t: int) -> None:
        """Advance the host mirror of the windows' rotation cadence for one
        stamped tick timestamp: a refresh at a new bucket rotates iff
        ``wid - last_rotated >= slack_buckets`` (the windows' refresh
        condition), otherwise slack deferred it."""
        for key, tr in self._rot_track.items():
            wms, g, last_wid, last_rot = tr
            wid = (t & 0xFFFFFFFF) // wms  # the uint32 view of the window id
            if last_wid is None:
                tr[2] = tr[3] = wid
                continue
            if wid == last_wid:
                continue
            if wid - last_rot >= g:
                _C_WIN_ROT[key].inc()
                tr[3] = wid
            else:
                _C_WIN_SLACK[key].inc()
            tr[2] = wid

    def _audit_attempts(self, rids, now_ms: int) -> np.ndarray:
        """SketchAudit's reader: the device sketch's windowed ATTEMPTS
        estimate (PASS + BLOCK planes — exactly the units the engine folds:
        ``acq.count`` per valid entry) of the tracked ids, through the
        port's own sketch path (``sketch.impl_for(cfg).estimate``: SALSA's
        running sums, or the count-min seed's).  The ids are padded to the
        audit's fixed K with the first sketch row.  One estimate under the
        engine lock (queued on the card's stream ahead of the next tick's
        in-place updates), then one readback: the audit tick's only host
        sync."""
        from sentinel_tpu_torch.sketch import impl_for

        k = len(rids)
        ids = list(rids) + [self.cfg.node_rows] * (self._audit.k - k)
        ids_dev = torch.tensor(ids, dtype=torch.int32, device=self.device)
        with self._engine_lock:
            est = impl_for(self.cfg).estimate(self._state.gs, int(now_ms), ids_dev, self._audit_scfg)
            att = est[:k, W.EV_PASS] + est[:k, W.EV_BLOCK]
        return att.cpu().numpy()  # stlint: disable=host-sync — the sketch audit's one read per audit period (obs/profile.SketchAudit), its whole serving-path cost, as the reference's

    def _wire_layout(self, b: int) -> WIRE.WireLayout:
        lo = self._wire_layouts.get(b)
        if lo is None:
            lo = self._wire_layouts[b] = WIRE.layout_for(self.cfg, b)
        return lo

    def _resolve_tick(self, p: _PendingTick) -> None:
        """Decode one dispatched tick and fan its verdicts out — or, if
        anything on that path raises, fail the rest of the tick CLOSED
        (BLOCK_SYSTEM) instead of stranding its callers, and log the
        error; then return its readback buffer to the pool.  A tick the watchdog already failed
        over is not fanned out again (``_claim_tick``)."""
        try:
            self._resolve_tick_inner(p)
        except Exception as exc:  # stlint: disable=fail-open — items fail CLOSED (BLOCK_SYSTEM) below; nothing is admitted or stranded
            if not self._claim_tick(p, "failed"):
                with p.state_lock:
                    if p.state == "failed":
                        return  # the watchdog already failed this tick over
                # "done": this thread claimed the fan-out and broke partway —
                # finish the remaining consumers CLOSED (_fail_tick is safe
                # after a partial fan-out)
            _C_RESOLVE_FAILED.inc()
            FL.note("resolve.fail_closed", error=f"{type(exc).__name__}: {exc}", n_obj=p.n_obj, n_blk=p.n_blk)
            # logged, never raised: a sync client's entry() must see its
            # fail-closed verdict, not the resolver's exception
            _log.error("tick resolution failed (%r); failing %d object / %d block item(s) CLOSED",
                       exc, p.n_obj, p.n_blk, exc_info=True)
            self._fail_tick(p)
        finally:
            self._untrack_tick(p)
            if p.buf is not None:
                self._readback.give(p.buf)
                p.buf = None

    def _resolve_tick_inner(self, p: _PendingTick) -> None:
        """THE readback: wait for the tick's copy (its CUDA event), validate
        the packed wire; fold the telemetry row, timeline rows, hot block
        and explain records; then fan the verdicts out to the futures and
        the blocks.  A main section that fails validation fails every item
        of the tick CLOSED; the explain section fails OPEN on its own
        checksum (obs/explain.py).  Unpacked (``packed_wire=False``), the
        tick's tensors are read one by one instead (``_read_unpacked``)."""
        FP.hit(_FP_READBACK)  # chaos: a raise fails this tick closed
        FP.hit(_FP_WD_STALL)  # chaos: a delay here stalls the readback — the
        # stand-in for a hung device tick the watchdog must fail over
        if p.event is not None:
            p.event.synchronize()
        verdict, wait, stats = self._read_packed(p) if p.wire_lo is not None else self._read_unpacked(p)
        FP.hit(_FP_FANOUT)  # chaos: a raise BEFORE any consumer resolves
        if not self._claim_tick(p, "done"):
            return  # the watchdog failed this tick over while it was read back
        self._untrack_tick(p)
        _t_res = OT.t0()
        if p.inv_a is not None:
            # the wire's rows (bitmap and PASS_WAIT sidecar alike) are
            # positions in the sorted batch: back to submission order
            verdict, wait = verdict[p.inv_a], wait[p.inv_a]
        ad = self._adaptive
        if ad is not None:
            if stats is not None:
                # the device's accounting: valid items ARE the real items
                n_real = int(stats[E.STAT_VALID])
                passed = int(stats[E.STAT_PASS] + stats[E.STAT_PASS_WAIT])
                if n_real:
                    ad.signals.note_resolved(passed, n_real - passed)
                ad.signals.note_device_stats(stats)
            else:
                n_real = p.n_obj + p.n_blk + sum(len(cols[0]) for _d, cols in p.fronts)
                if n_real:
                    v = verdict[:n_real]
                    passed = int(((v == ERR.PASS) | (v == ERR.PASS_WAIT)).sum())
                    ad.signals.note_resolved(passed, n_real - passed)
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
        if p.fronts:
            # each door answers its own slice, in its drained corr order
            with self._respond_lock:
                for door, cols in p.fronts:
                    k = len(cols[0])
                    door.respond(cols[3], verdict[o : o + k].astype(np.int32), wait[o : o + k].astype(np.int32))
                    p.fronts_done += 1
                    o += k
        if _t_res:
            OT.stage(
                "tick.resolve", _t_res, _H_RESOLVE, trace=p.tick_id,
                attrs={"n_obj": p.n_obj, "n_blk": p.n_blk},
            )

    def _read_packed(self, p: _PendingTick):
        """Decode the tick's packed wire and fold its planes; returns
        ``(verdict, wait, stats)`` in batch order.  A main section that
        fails validation raises ``WireDecodeError`` (counted here), which
        ``_resolve_tick`` turns into a CLOSED tick."""
        lo, out, now_ms = p.wire_lo, p.out, p.now_ms
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
            # detected, never fanned out: _resolve_tick fails the tick
            # CLOSED and counts it, as it does any resolve error
            _C_PACKED_DECODE.inc()
            self.wire_decode_failures += 1
            raise
        self._span_device(p)
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
        return verdict, wait, frame.stats

    def _read_unpacked(self, p: _PendingTick):
        """The unpacked wire's reads, as the reference's client makes them:
        the verdict, then the telemetry row, the timeline rows and the hot
        block, each its own device-to-host read with its own bytes; then
        ``seg_dropped`` (from the telemetry row when it is on, else a
        4-byte read of its own), and the wait column only when a verdict
        may be PASS_WAIT.  Each read is a host sync on the resolving
        thread, after the tick's event: the designed readback points.
        Returns ``(verdict, wait, stats)`` in batch order."""
        out, now_ms = p.out, p.now_ms
        verdict = out.verdict.cpu().numpy()
        _C_WIRE["rx"].inc(verdict.nbytes)
        self._span_device(p)
        # the residual reads after the verdict's wait
        _t_rb = OT.t0()
        stats = None
        if out.stats is not None:
            stats = out.stats.cpu().numpy()
            _C_WIRE["rx"].inc(stats.nbytes)
            self._fold_device_stats(stats)
        if out.res_stats is not None and self.timeline is not None:
            rs = out.res_stats.cpu().numpy()
            TLM._C_WIRE["rx"].inc(rs.nbytes)  # the timeline's own wire path
            self.timeline.note_tick(rs, now_ms, self.time.wall_ms(now_ms) - now_ms)
        if out.hot is not None and self.hotset is not None:
            hot = out.hot.cpu().numpy()
            _C_WIRE["rx"].inc(hot.nbytes)
            self.hotset.fold(hot)
        if p.check_dropped:
            if stats is not None:
                dropped = int(stats[E.STAT_SEG_DROPPED])
            else:
                dropped = int(out.seg_dropped.cpu())
                _C_WIRE["rx"].inc(4)
            if dropped:
                self._record_seg_dropped(dropped)
        # the engine zeroes the wait of every item that is not PASS_WAIT:
        # skip the column unless the telemetry row (or, without it, the
        # verdicts) says some item waits
        if stats is not None:
            waits = stats[E.STAT_PASS_WAIT] > 0
        else:
            waits = bool((verdict == ERR.PASS_WAIT).any())
        if waits:
            wait = out.wait_ms.cpu().numpy()
            _C_WIRE["rx"].inc(wait.nbytes)
        else:
            wait = np.zeros(verdict.shape[0], np.int32)
        if _t_rb:
            OT.stage("tick.readback", _t_rb, _H_READBACK, trace=p.tick_id)
        return verdict, wait, stats

    @staticmethod
    def _span_device(p: _PendingTick) -> None:
        """``tick.device``: dispatch -> verdicts host-visible: device compute
        and the copy, plus the queue wait when pipelined (spans of
        successive ticks may overlap: that overlap IS the pipelining)."""
        if p.dispatched_ns and OT.TRACER.enabled:
            OT.stage_ns(
                "tick.device", p.dispatched_ns, OT.now_ns() - p.dispatched_ns, _H_DEVICE, trace=p.tick_id
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
        its object requests, and the block slices and door slices the
        normal fan-out had not reached (no double decrement, no door
        answered twice)."""
        for r in p.acq:
            if r.future is not None and not r.future.done():
                r.future.set_result((int(ERR.BLOCK_SYSTEM), 0))
        for blk, off, take in p.blocks[p.blocks_done :]:
            blk.verdicts[off : off + take] = ERR.BLOCK_SYSTEM
            blk.waits[off : off + take] = 0
            self._block_done(blk, take)
            p.blocks_done += 1
        if p.fronts_done < len(p.fronts):
            with self._respond_lock:
                for door, cols in p.fronts[p.fronts_done :]:
                    # advance FIRST: a door whose respond fails here failed
                    # the normal path too, and retrying it would raise out of
                    # this handler and strand every other consumer
                    p.fronts_done += 1
                    k = len(cols[0])
                    try:
                        door.respond(cols[3], np.full(k, ERR.BLOCK_SYSTEM, np.int32), np.zeros(k, np.int32))
                    except Exception:  # stlint: disable=fail-open — the door transport itself is broken; its clients time out while every OTHER consumer still fails closed
                        _log.error("front-door respond failed during the fail-closed fan-out; its clients "
                                   "will time out", exc_info=True)

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


#: the exact rows' one readback, int32 [n, 8]: the five event counts, the RT
#: total and minimum (float32 carried as int32 bits), the concurrency
_RD_RT_TOT, _RD_RT_MIN, _RD_CONC = W.NUM_EVENTS, W.NUM_EVENTS + 1, W.NUM_EVENTS + 2


def _stats_dicts(counts: np.ndarray, rt_tot: np.ndarray, rt_min, conc, interval_s: float) -> List[Dict[str, float]]:
    """The stats dicts of n resources from their windowed counts [n, NE]
    and RT totals [n] (``rt_min`` / ``conc``: [n] arrays, or None for the
    sketch's 0.0 / 0) — the reference's per-row float arithmetic,
    vectorized in float64."""
    qps = counts[:, : W.NUM_EVENTS].astype(np.float64) / interval_s
    succ = counts[:, W.EV_SUCCESS].astype(np.float64)
    avg = np.zeros_like(succ)
    np.divide(rt_tot.astype(np.float64), succ, out=avg, where=succ > 0)
    n = counts.shape[0]
    mins = [0.0] * n if rt_min is None else np.where(rt_min >= W.RT_MIN_INIT, 0.0, rt_min.astype(np.float64)).tolist()
    threads = [0] * n if conc is None else conc.tolist()
    return [
        {
            "passQps": p_,
            "blockQps": b_,
            "successQps": s_,
            "exceptionQps": e_,
            "occupiedPassQps": o_,
            "avgRt": a_,
            "minRt": m_,
            "curThreadNum": t_,
        }
        for p_, b_, s_, e_, o_, a_, m_, t_ in zip(
            qps[:, W.EV_PASS].tolist(), qps[:, W.EV_BLOCK].tolist(), qps[:, W.EV_SUCCESS].tolist(),
            qps[:, W.EV_EXCEPTION].tolist(), qps[:, W.EV_OCCUPIED].tolist(), avg.tolist(), mins, threads,
        )
    ]


class ClientStats:
    """Read-side node statistics (the ClusterNode/StatisticNode getters:
    passQps/blockQps/successQps/exceptionQps/avgRt/curThreadNum).

    Every read enqueues its gathers under the client's engine lock, on the
    stream the ticks run on (the device's current stream), so it reads the
    state as of a tick boundary; the gathered rows are new tensors, so the
    copy to the host completes after the lock is released and a reader
    never holds up a tick for the length of its readback.  The exact rows
    come back in ONE copy: the counts, the RT total and minimum (float32
    as int32 bits) and the concurrency stacked into one int32 tensor.
    ``last_read`` holds the host ms of the last read's parts:
    ``lock_wait_ms`` (waiting for the engine lock: a tick's dispatch holds
    it), ``lock_ms`` (the lock held: the gathers' enqueue), ``read_ms``
    (lock release to the rows host-visible) and, for ``snapshot``,
    ``dict_ms`` (building the dicts) — for the exact rows and, with
    ``sketch_`` in front, for the sketch ids."""

    def __init__(self, client: SentinelClient):
        self._c = client
        self.last_read: Dict[str, float] = {}

    def _sec_cfg(self) -> W.WindowConfig:
        cfg = self._c.cfg
        return W.WindowConfig(cfg.second_sample_count, cfg.second_window_ms)

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        """The row ids as an int64 tensor on the client's device (through
        pinned memory on the card, so the copy does not wait on a tick)."""
        t = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
        if self._c.device.type == "cuda":
            return t.pin_memory().to(self._c.device, non_blocking=True)
        return t

    def _readback(self, dev: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Queue ``dev``'s copy into a host buffer (pinned on the card) and
        an event behind it; the caller waits on the event outside the lock."""
        if not dev.is_cuda:
            return dev, None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _gather_exact(self, state, rows_dev: torch.Tensor, now_ms: int) -> torch.Tensor:
        """int32 [n, 8] on the state's device: the second window's
        masked counts and RT total / minimum of ``rows_dev`` and their
        concurrency, stacked for one readback (a new tensor)."""
        sec_cfg = self._sec_cfg()
        counts = W.gather_window_counts(state.win_sec, now_ms, rows_dev, sec_cfg)
        rt_tot, rt_min = W.gather_window_rt(state.win_sec, now_ms, rows_dev, sec_cfg)
        return torch.cat(
            [
                counts,
                rt_tot.view(torch.int32)[:, None],
                rt_min.view(torch.int32)[:, None],
                state.concurrency[rows_dev][:, None],
            ],
            dim=1,
        )

    def _read_exact(self, rows: np.ndarray, now_ms: int) -> np.ndarray:
        """int32 [n, 8] for exact rows ``rows`` at ``now_ms``: ONE
        gather of the second window and the concurrency, ONE readback."""
        c = self._c
        rows_dev = self._to_device(rows)
        t0 = mono_s()
        with c._engine_lock:
            t1 = mono_s()
            host, ev = self._readback(self._gather_exact(c._state, rows_dev, now_ms))
        t2 = mono_s()
        if ev is not None:
            ev.synchronize()
        self.last_read.update(
            lock_wait_ms=(t1 - t0) * 1000.0, lock_ms=(t2 - t1) * 1000.0, read_ms=(mono_s() - t2) * 1000.0
        )
        return host.numpy()

    def _rows_dicts(self, m: np.ndarray) -> List[Dict[str, float]]:
        """The stats dicts of ``_read_exact``'s rows."""
        rt = m[:, _RD_RT_TOT : _RD_RT_MIN + 1].copy().view(np.float32)
        return _stats_dicts(m, rt[:, 0], rt[:, 1], m[:, _RD_CONC], self._sec_cfg().interval_ms / 1000.0)

    def _row_stats(self, row: int) -> Dict[str, float]:
        return self._rows_dicts(self._read_exact(np.asarray([row]), self._c.time.now_ms()))[0]

    def resource(self, name: str) -> Optional[Dict[str, float]]:
        """The resource's windowed stats (None when it was never seen);
        a sketch id reads the global sketch's estimates."""
        rid = self.registry_peek(name)
        if rid is None:
            return None
        if self._c.registry.is_sketch_id(rid):
            return self._sketch_stats([rid])[0]
        return self._row_stats(rid)

    def origin(self, resource: str, origin: str) -> Optional[Dict[str, float]]:
        """Per-(resource, caller) stats — the ClusterNode.getOriginNode
        read (ClusterBuilderSlot origin rows).  None until that caller has
        been seen (the row is created on first entry with the origin)."""
        row = self._c.registry.origin_row_if_exists(resource, origin)
        return None if row is None else self._row_stats(row)

    def _sketch_stats(self, rids, now_ms: Optional[int] = None) -> list:
        """Windowed sketch estimates for sketch-id resources (SALSA or the
        count-min seed, per cfg.sketch_salsa) in ONE device read; pass and
        block are small overestimates bounded by the sketch (eps, delta)."""
        from sentinel_tpu_torch.ops import gsketch as GS
        from sentinel_tpu_torch.sketch import impl_for

        c = self._c
        scfg = E.sketch_config(c.cfg)
        now = c.time.now_ms() if now_ms is None else now_ms
        rids_dev = self._to_device(np.asarray(rids)).to(torch.int32)
        t0 = mono_s()
        with c._engine_lock:
            ta = mono_s()
            host, ev = self._readback(impl_for(c.cfg).estimate(c._state.gs, now, rids_dev, scfg))
        t1 = mono_s()
        if ev is not None:
            ev.synchronize()
        est = host.numpy()
        t2 = mono_s()
        out = _stats_dicts(
            est, est[:, GS.RT_PLANE].astype(np.float64) / GS.RT_SCALE, None, None, scfg.interval_ms / 1000.0
        )
        self.last_read.update(
            sketch_lock_wait_ms=(ta - t0) * 1000.0,
            sketch_lock_ms=(t1 - ta) * 1000.0,
            sketch_read_ms=(t2 - t1) * 1000.0,
            sketch_dict_ms=(mono_s() - t2) * 1000.0,
        )
        return out

    def snapshot(self, now_ms: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        """Trailing-second stats for ALL registered resources in ONE
        device read of the exact rows — the walk of the ClusterNode map
        that MetricTimerListener does per second.  Sketch-id resources
        (beyond the exact row space) come from the global sketch in a
        second read."""
        c = self._c
        resources = c.registry.resources()
        if not resources:
            return {}
        # ONE timestamp for the whole snapshot, so the trailing window
        # cannot slide between the exact and the sketch read
        now_ms = c.time.now_ms() if now_ms is None else now_ms
        is_sketch = c.registry.is_sketch_id
        exact = {n: r for n, r in resources.items() if not is_sketch(r)}
        sketch = {n: r for n, r in resources.items() if is_sketch(r)}
        out: Dict[str, Dict[str, float]] = {}
        if exact:
            m = self._read_exact(np.fromiter(exact.values(), np.int64, len(exact)), now_ms)
            t = mono_s()
            out.update(zip(exact.keys(), self._rows_dicts(m)))
            self.last_read["dict_ms"] = (mono_s() - t) * 1000.0
        if sketch:
            out.update(zip(sketch.keys(), self._sketch_stats(list(sketch.values()), now_ms=now_ms)))
        return out

    def entry_node(self) -> Dict[str, float]:
        return self._row_stats(self._c.cfg.entry_node_row)

    def registry_peek(self, name: str) -> Optional[int]:
        return self._c.registry.peek_resource_id(name)
