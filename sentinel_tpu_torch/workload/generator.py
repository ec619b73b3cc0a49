"""Seeded deterministic traffic generator and the closed loop's service
model.

The port's copy of ``sentinel_tpu/workload/generator.py``.
``TrafficGenerator`` turns a ``WorkloadSpec`` (shapes.py) into a per-step
stream of ``OfferedEvent``s that is a PURE function of the spec's seed —
per-shape PRNG streams are derived exactly like the chaos plane's
``FaultPlan.spec_rng`` (seed × odd multiplier + stream index), event
counts use error-diffusion accumulation (no entropy at all), and
keys/params come only from those streams.  Two runs at one seed replay
bit-identically, and the port's stream equals the reference's event for
event.

Drivers push the stream through each real adapter surface on the
clock of the caller's ``SentinelClient`` (virtual or real):

* ``drive_client``     — ``check_batch`` bulk decisions
* ``drive_gateway``    — ``GatewayAdapter.entries_for`` with real
  ``RequestAttributes`` (param floods hit the per-param rule path)
* ``drive_asgi``       — ``SentinelASGIMiddleware`` scopes
* ``drive_streaming``  — ``guard_stream`` async generators
* ``drive_grpc``       — ``SentinelServerInterceptor`` handlers (None
  where the optional ``grpc`` package is absent)

``ServiceModel`` is the queueing backend the closed tuner loop rides:
the same FIFO service model `adaptive/simload.py` established — admitted
events batch into ticks whose cost and firing rule derive from the
ACTIVE ``OperatingPoint`` through a small documented tick-cost model —
so modeled request latency (the ``sentinel_workload_req_ms`` histogram
the SLO objective judges) is engine-time pure and replays exactly.

Chaos: ``workload.gen.emit`` fires once per generator step while armed;
a raise drops that step's whole emission (counted exactly in
``sentinel_workload_emit_drops_total`` — offered accounting never sees
the dropped events, so verdict accounting stays green by construction).
"""

from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.obs.registry import REGISTRY
from sentinel_tpu_torch.workload.operating_point import OperatingPoint
from sentinel_tpu_torch.workload.shapes import WorkloadSpec

FP_GEN_EMIT = FP.register(
    "workload.gen.emit",
    "traffic-generator per-step emission (a raise drops the step's events)",
    FP.HIT_ACTIONS,
)

_C_OFFERED = {}
_C_OFFERED_LOCK = threading.Lock()


def _c_offered(shape: str):
    c = _C_OFFERED.get(shape)
    if c is None:
        with _C_OFFERED_LOCK:
            c = _C_OFFERED.get(shape)
            if c is None:
                c = _C_OFFERED[shape] = REGISTRY.counter(
                    "sentinel_workload_offered_total",
                    "events the traffic generator offered, by shape",
                    labels={"shape": shape},
                )
    return c


_C_PASSED = REGISTRY.counter(
    "sentinel_workload_passed_total",
    "offered events the driven surface admitted",
)
_C_BLOCKED = REGISTRY.counter(
    "sentinel_workload_blocked_total",
    "offered events the driven surface blocked",
)
_C_EMIT_DROPS = REGISTRY.counter(
    "sentinel_workload_emit_drops_total",
    "generator steps whose emission an armed workload.gen.emit fault dropped",
)
_H_REQ_MS = REGISTRY.histogram(
    "sentinel_workload_req_ms",
    "modeled end-to-end request latency under the workload service model "
    "(queue wait + service, engine-time pure)",
)


class OfferedEvent(NamedTuple):
    """One offered request — everything any adapter driver needs."""

    step: int
    t_ms: int
    key: str
    shape: str
    param: Optional[str]


class TrafficGenerator:
    """Deterministic event stream for one ``WorkloadSpec``."""

    def __init__(self, spec: WorkloadSpec, start_ms: int = 1_000):
        self.spec = spec
        self.start_ms = int(start_ms)

    def _stream_rng(self, idx: int) -> random.Random:
        # the chaos plan derivation (plans.FaultPlan.spec_rng): adjacent
        # seeds must not share streams, stream i is independent of i+1
        return random.Random(
            (int(self.spec.seed) * 0x9E3779B1 + idx) & 0xFFFFFFFF
        )

    def events(self) -> Iterator[Tuple[int, List[OfferedEvent]]]:
        """Yield ``(step, events_this_step)``; counts by error-diffusion
        (zero entropy), keys/params from per-shape seeded streams."""
        spec = self.spec
        rngs = [self._stream_rng(i) for i in range(len(spec.shapes))]
        accs = [0.0] * len(spec.shapes)
        default_cdf = spec.keys._cdf()
        shape_cdf = [
            (s.keys._cdf() if getattr(s, "keys", None) is not None else None)
            for s in spec.shapes
        ]
        for step in range(spec.steps):
            t_ms = self.start_ms + step * spec.step_ms
            out: List[OfferedEvent] = []
            for i, shape in enumerate(spec.shapes):
                accs[i] += float(shape.rate_at(step))
                n = int(accs[i])
                accs[i] -= n
                if n <= 0:
                    continue
                mix = getattr(shape, "keys", None) or spec.keys
                cdf = shape_cdf[i] or default_cdf
                rng = rngs[i]
                for _ in range(n):
                    key = mix.key_for(step, rng.random(), cdf)
                    out.append(
                        OfferedEvent(
                            step=step,
                            t_ms=t_ms,
                            key=key,
                            shape=shape.name,
                            param=getattr(shape, "param", None),
                        )
                    )
            try:
                FP.hit(FP_GEN_EMIT)  # chaos: a raise drops this step
            except Exception:
                _C_EMIT_DROPS.inc()
                yield step, []
                continue
            for ev in out:
                _c_offered(ev.shape).inc()
            yield step, out

    def all_events(self) -> List[OfferedEvent]:
        """The flattened stream (replay-diff surface for tests)."""
        return [ev for _step, evs in self.events() for ev in evs]


# -- service model -----------------------------------------------------------


@dataclass
class ServiceModel:
    """Batched FIFO queueing backend whose behavior derives from the
    active ``OperatingPoint`` — the simload precedent (a service model
    over REAL client decisions) extended with a documented tick-cost
    model so the tuner has a genuine multi-knob tradeoff surface with an
    INTERIOR optimum:

    - a tick costs ``tick_fixed_us + batch_size * per_item_us`` plus
      window-rotation work ``rot_unit_us * sample_count / g`` where
      ``g = ceil(slack_frac * sample_count)`` (slack windows batch
      expiry — arXiv 1703.01166) and an amortized online-audit charge
      ``audit_us / audit_period``;
    - the service budget allows ``budget_us * overlap / tick_us`` ticks
      per step, ``overlap = 1 + 0.35 * min(pipeline_depth, 4)``
      (pipelining overlaps host/device work with diminishing returns)
      — the SMALL-batch failure mode: under a flash crowd the tick rate
      caps throughput and the backlog queues;
    - a tick fires only when ``batch_size`` items are waiting or the
      oldest has aged ``flush_steps`` — the LARGE-batch failure mode:
      at baseline rates requests sit waiting for the batch to fill;
    - each pipeline slot adds ``pipe_wait_frac * step_ms`` of readback
      delay to every request's latency.

    All arithmetic on explicit inputs over virtual step counts —
    engine-time pure, replays exactly.
    """

    step_ms: int = 10
    tick_fixed_us: float = 250.0
    per_item_us: float = 2.0
    rot_unit_us: float = 18.0
    audit_us: float = 900.0
    budget_us: float = 900.0
    flush_steps: int = 8
    svc_steps: int = 1
    pipe_wait_frac: float = 0.5

    def tick_us(self, op: OperatingPoint) -> float:
        nb = max(1, op.sketch_sample_count or 2)
        g = max(1, math.ceil(op.sketch_slack_frac * nb))
        rot = self.rot_unit_us * nb / g
        audit = self.audit_us / max(1, op.audit_period)
        return self.tick_fixed_us + op.batch_size * self.per_item_us + rot + audit

    def ticks_per_step(self, op: OperatingPoint) -> int:
        overlap = 1.0 + 0.35 * min(op.pipeline_depth, 4)
        return max(1, int(self.budget_us * overlap / self.tick_us(op)))

    def extra_wait_ms(self, op: OperatingPoint) -> float:
        """Pipeline readback delay: each occupied slot holds a fraction
        of a step in front of every request's completion."""
        return op.pipeline_depth * self.pipe_wait_frac * self.step_ms


class ServiceBackend:
    """The FIFO itself: admitted events enter ``submit``; ``advance``
    fires full (or flush-aged) batches within the step's tick budget and
    returns completions with modeled latency."""

    def __init__(self, model: ServiceModel, op: OperatingPoint):
        self.model = model
        self.op = op
        self._backlog: List[Tuple[int, int]] = []  # (submit_step, rid)
        self._in_service: List[Tuple[int, int, int]] = []  # (done, submit, rid)

    def set_op(self, op: OperatingPoint) -> None:
        self.op = op

    def submit(self, step: int, rid: int) -> None:
        self._backlog.append((step, rid))

    def depth(self) -> int:
        return len(self._backlog) + len(self._in_service)

    def advance(self, step: int) -> List[Tuple[float, int]]:
        """Serve one step; returns completions as (latency_ms, rid)."""
        m, op = self.model, self.op
        done = [e for e in self._in_service if e[0] <= step]
        out: List[Tuple[float, int]] = []
        if done:
            self._in_service = [e for e in self._in_service if e[0] > step]
            svc_ms = m.tick_us(op) / 1000.0 + m.extra_wait_ms(op)
            for _due, sub, rid in done:
                out.append(((step - sub) * m.step_ms + svc_ms, rid))
        ticks = m.ticks_per_step(op)
        while ticks > 0 and self._backlog:
            aged = step - self._backlog[0][0] >= m.flush_steps
            if len(self._backlog) < op.batch_size and not aged:
                break  # wait for the batch to fill (the big-batch cost)
            for _ in range(min(op.batch_size, len(self._backlog))):
                sub, rid = self._backlog.pop(0)
                self._in_service.append((step + m.svc_steps, sub, rid))
            ticks -= 1
        return out


# -- adapter drivers ---------------------------------------------------------


@dataclass
class DriveResult:
    submitted: int = 0
    passed: int = 0
    blocked: int = 0
    latencies_ms: List[float] = None  # filled by closed-loop drivers

    def __post_init__(self):
        if self.latencies_ms is None:
            self.latencies_ms = []


def _account(res: DriveResult, passed: bool) -> None:
    res.submitted += 1
    if passed:
        res.passed += 1
        _C_PASSED.inc()
    else:
        res.blocked += 1
        _C_BLOCKED.inc()


def drive_client(
    client,
    gen: TrafficGenerator,
    resource_of: Optional[Callable[[OfferedEvent], str]] = None,
    backend: Optional[ServiceBackend] = None,
    on_step: Optional[Callable[[int, int], None]] = None,
) -> DriveResult:
    """Bulk check_batch driving on the caller's clock; with a
    ``ServiceBackend`` the admitted events flow through the queueing
    model, completions feed ``submit_completion_block`` and the modeled
    latencies land in ``sentinel_workload_req_ms``."""
    vt = client.time
    res = DriveResult()
    name_of = resource_of or (lambda ev: ev.key)
    rid_cache: Dict[str, int] = {}
    step_ms = gen.spec.step_ms

    def _complete(step: int) -> None:
        done = backend.advance(step)
        if not done:
            return
        lats = np.asarray([l for l, _r in done], np.float32)
        rids = np.asarray([r for _l, r in done], np.int32)
        for lat in lats:
            res.latencies_ms.append(float(lat))
            _H_REQ_MS.observe(float(lat))
        client.submit_completion_block(
            res=rids,
            rt=lats,
            success=np.ones(len(done), np.int32),
            inbound=np.ones(len(done), np.int32),
        )

    for step, evs in gen.events():
        if backend is not None:
            _complete(step)
        if evs:
            names = [name_of(ev) for ev in evs]
            params = [ev.param for ev in evs]
            verdicts = client.check_batch(
                names,
                params=params if any(p is not None for p in params) else None,
                inbound=True,
            )
            for ev, name, (v, _w) in zip(evs, names, verdicts):
                ok = v in (ERR.PASS, ERR.PASS_WAIT)
                _account(res, ok)
                if ok and backend is not None:
                    rid = rid_cache.get(name)
                    if rid is None:
                        rid = rid_cache[name] = client.registry.resource_id(name)
                    backend.submit(step, rid)
        if on_step is not None:
            on_step(step, len(evs))
        vt.sleep_ms(step_ms)
    # drain: let queued work finish so latency accounting is complete
    if backend is not None:
        step = gen.spec.steps
        guard = step + 4000
        while backend.depth() and step < guard:
            _complete(step)
            if on_step is not None:
                on_step(step, 0)
            vt.sleep_ms(step_ms)
            step += 1
    return res


def drive_gateway(adapter, gen: TrafficGenerator, route_id: str = "wl-route") -> DriveResult:
    """Every event becomes one ``entries_for`` acquisition with real
    ``RequestAttributes`` (key → path, param → X-Wl-Param header +
    url param so param-parse strategies see it)."""
    from sentinel_tpu_torch.adapters.gateway import RequestAttributes
    from sentinel_tpu_torch.core.errors import BlockException

    vt = adapter.client.time
    res = DriveResult()
    for _step, evs in gen.events():
        for ev in evs:
            req = RequestAttributes(
                path=f"/{ev.key}",
                client_ip="10.0.0.1",
                host="wl.example",
                headers={"X-Wl-Param": ev.param or ""},
                url_params={"p": ev.param or ""},
            )
            try:
                entries = adapter.entries_for(route_id, req)
            except BlockException:
                _account(res, False)
                continue
            for e in entries:
                e.exit()
            _account(res, True)
        vt.sleep_ms(gen.spec.step_ms)
    return res


def drive_asgi(middleware, gen: TrafficGenerator) -> DriveResult:
    """One ASGI scope per event (GET /{key}); 429 counts as blocked."""
    import asyncio

    res = DriveResult()
    vt = middleware.client.time

    async def one(ev: OfferedEvent) -> int:
        sent = []

        async def send(msg):
            sent.append(msg)

        async def receive():
            return {"type": "http.request"}

        scope = {
            "type": "http",
            "method": "GET",
            "path": f"/{ev.key}",
            "headers": [(b"x-wl-param", (ev.param or "").encode())],
        }
        await middleware(scope, receive, send)
        return sent[0]["status"]

    for _step, evs in gen.events():
        for ev in evs:
            _account(res, asyncio.run(one(ev)) != middleware.block_status)
        vt.sleep_ms(gen.spec.step_ms)
    return res


def drive_streaming(client, gen: TrafficGenerator, chunks: int = 2) -> DriveResult:
    """Each event opens a guarded async stream (``guard_stream``) and
    consumes it to completion; a BlockException on first pull counts as
    blocked."""
    import asyncio

    from sentinel_tpu_torch.adapters.streaming import guard_stream
    from sentinel_tpu_torch.core.errors import BlockException

    res = DriveResult()
    vt = client.time

    async def one(ev: OfferedEvent) -> bool:
        async def source():
            for i in range(chunks):
                yield i

        try:
            async for _chunk in guard_stream(
                ev.key, source(), client=client, inbound=True
            ):
                pass
        except BlockException:
            return False
        return True

    for _step, evs in gen.events():
        for ev in evs:
            _account(res, asyncio.run(one(ev)))
        vt.sleep_ms(gen.spec.step_ms)
    return res


def drive_grpc(client, gen: TrafficGenerator) -> Optional[DriveResult]:
    """Unary-unary handlers through ``SentinelServerInterceptor`` —
    returns None when the optional grpc dependency is absent (the image
    contract: never require an install)."""
    try:
        import grpc  # noqa: F401
    except ImportError:
        return None
    import grpc

    from sentinel_tpu_torch.adapters.grpc_adapter import SentinelServerInterceptor

    res = DriveResult()
    vt = client.time
    interceptor = SentinelServerInterceptor(client=client)

    class _Ctx:
        def abort(self, code, details):
            raise _Aborted()

    class _Aborted(Exception):
        pass

    def inner(request, context):
        return "ok"

    base = grpc.unary_unary_rpc_method_handler(inner)
    for _step, evs in gen.events():
        for ev in evs:
            class _Details:
                method = f"/{ev.key}"
                invocation_metadata = ()

            handler = interceptor.intercept_service(lambda d: base, _Details())
            try:
                handler.unary_unary("req", _Ctx())
                _account(res, True)
            except _Aborted:
                _account(res, False)
        vt.sleep_ms(gen.spec.step_ms)
    return res
