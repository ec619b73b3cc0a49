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

The client runs on the card unless it is asked for the CPU:
``SentinelClient(device=None)`` picks ``"cuda"`` and raises where no CUDA
device exists.  Not ported yet (ROADMAP.md): param-flow rules (loading
them raises), cluster mode, the native completion ring, pipelined
readback, adaptive protection, the obs planes.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.core import rules as R
from sentinel_tpu_torch.core.config import EngineConfig, app_name as cfg_app_name, platform_config
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime import context as CTX
from sentinel_tpu_torch.runtime.registry import Registry
from sentinel_tpu_torch.utils.system_status import SystemStatusSampler
from sentinel_tpu_torch.utils.time_source import TimeSource, VirtualTimeSource, mono_s


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


@dataclass
class Completion:
    res: int
    origin_node: int
    ctx_node: int
    inbound: int
    rt: float
    success: int
    error: int


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


class Entry:
    """Live entry handle (the reference's Entry/CtEntry).  ``exit()``
    records RT + success; ``trace(exc)`` marks a business exception."""

    __slots__ = (
        "client", "resource", "res", "origin_node", "ctx_node", "inbound",
        "count", "create_ms", "wait_ms", "_errors", "_exited",
    )

    def __init__(self, client, resource, res, origin_node, ctx_node, inbound, count, create_ms, wait_ms=0):
        self.client = client
        self.resource = resource
        self.res = res
        self.origin_node = origin_node
        self.ctx_node = ctx_node
        self.inbound = inbound
        self.count = count
        self.create_ms = create_ms
        self.wait_ms = wait_ms
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
        if self.kind == "param-flow" and rules:
            raise NotImplementedError(
                "not ported to sentinel_tpu_torch yet: param-flow rules "
                "(ROADMAP.md Queue A: param)"
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
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._stop_evt = threading.Event()
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
        self._started = False

    # -- rule compilation ---------------------------------------------------

    def _select_features(self) -> frozenset:
        """Engine stages the current rule set needs ('nodes' and 'occupy'
        stay on; 'warmup' joins when a warm-up shaper exists)."""
        feats = {"nodes", "occupy", "flow"}
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
        return frozenset(feats)

    def _recompile_rules(self) -> None:
        flow = [r for r in self.flow_rules.get() if not r.cluster_mode]
        rules_dev = E.compile_ruleset(
            self.cfg,
            self.registry,
            flow_rules=flow,
            degrade_rules=self.degrade_rules.get(),
            authority_rules=self.authority_rules.get(),
            system_rules=self.system_rules.get(),
            device=self.device,
        )
        feats = self._select_features()
        with self._engine_lock:
            self._rules_dev = rules_dev
            if feats != self._features:
                self._features = feats
                self._tick = E.make_tick(self.cfg, features=feats)

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
        ``args`` are accepted for signature parity; param-flow rules are
        not ported, so no argument is hashed."""
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
            count, self.time.now_ms(), wait_ms,
        )
        CTX.push_entry(e)
        return e

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
        """Drain the queues and run engine ticks until both are empty."""
        with self._tick_mutex:
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

    def _upload(self, x: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(x)
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device)

    def _run_tick(self, acq: List[AcquireRequest], comp: List[Completion], now_ms):
        """Build + upload the batch columns (the uploads finish before the
        tick starts), run one tick; returns (TickOutput, wire layout)."""
        cfg = self.cfg
        trash = cfg.trash_row
        cap = cfg.max_batch_count
        B = self._shape_for(len(acq), cfg.batch_size)
        B2 = self._shape_for(len(comp), cfg.complete_batch_size)
        wd_a = WIRE.acquire_wire_dtypes(cfg)
        wd_c = WIRE.complete_wire_dtypes(cfg)

        cols = {}
        for f, fill, dt in _ACQ_COLS:
            col = np.full(B, trash if fill is None else fill, dt)
            if acq:
                col[: len(acq)] = [getattr(r, f) for r in acq]
            if f == "count":
                np.minimum(col, cap, out=col)  # the fused kernels' envelope
            cols[f] = self._upload(col, wd_a.get(f))
        a = E.AcquireBatch(
            param_hash=torch.zeros((B, cfg.param_dims), dtype=torch.int32, device=self.device),
            **cols,
        )
        cols = {}
        for f, fill, dt in _COMP_COLS:
            col = np.full(B2, trash if fill is None else fill, dt)
            if comp:
                col[: len(comp)] = [getattr(c, f) for c in comp]
            if f in ("success", "error"):
                np.minimum(col, cap, out=col)
            cols[f] = self._upload(col, wd_c.get(f))
        c = E.CompleteBatch(
            param_hash=torch.zeros((B2, cfg.param_dims), dtype=torch.int32, device=self.device),
            **cols,
        )
        load, cpu = self._sys.sample()
        t = now_ms if now_ms is not None else self.time.now_ms()
        with self._engine_lock:
            self._state, out = self._tick(self._state, self._rules_dev, a, c, int(t), load, cpu)
        return out, self._wire_layout(B)

    def _wire_layout(self, b: int) -> WIRE.WireLayout:
        lo = self._wire_layouts.get(b)
        if lo is None:
            lo = self._wire_layouts[b] = WIRE.layout_for(self.cfg, b)
        return lo

    def _resolve(self, acq: List[AcquireRequest], dispatched) -> None:
        """THE readback: one copy of the packed wire, validated; verdicts
        fan out to the futures.  A wire that fails validation fails every
        item of the tick CLOSED."""
        out, lo = dispatched
        try:
            frame = WIRE.unpack(out.wire.cpu().numpy().tobytes(), lo)
            wait = frame.wait
            if wait is None:  # more PASS_WAIT rows than the sidecar holds
                wait = out.wait_ms.cpu().numpy()
        except WIRE.WireDecodeError:
            self.wire_decode_failures += 1
            self._fail_closed(acq)
            return
        except Exception:
            # a failed readback (device fault) fails the tick CLOSED too;
            # the tick loop reports the error
            self._fail_closed(acq)
            raise
        for i, r in enumerate(acq):
            if r.future is not None:
                r.future.set_result((int(frame.verdict[i]), int(wait[i])))

    @staticmethod
    def _fail_closed(acq: List[AcquireRequest]) -> None:
        """Resolve every still-waiting request of a tick as BLOCK_SYSTEM."""
        for r in acq:
            if r.future is not None and not r.future.done():
                r.future.set_result((int(ERR.BLOCK_SYSTEM), 0))
