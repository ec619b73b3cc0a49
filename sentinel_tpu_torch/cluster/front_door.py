"""Native token-server front door: C epoll ingestion, per-tick Python.

The port of ``sentinel_tpu/cluster/front_door.py``.  The asyncio token
server (cluster/server.py) costs ~100-300 us of Python per request on its
event loop.  This front door moves the per-REQUEST work into C
(native/sentinel_host.cpp ``sx_front_*``):

    socket -> frame parse -> flow-id map -> acquire ring      (C io thread)
    ring -> engine batch columns -> tick -> verdicts          (Python tick)
    verdict ring -> response frames -> socket                 (C io thread)

Python executes once per TICK: the SentinelClient's tick loop drains the
door's acquire ring straight into engine batch lanes (numpy columns that
go up through the client's pinned staging like every other column) and
answers through ``respond`` on the resolver thread — no Python objects,
no futures, no per-request code.

Protocol: PING, MSG_TYPE_FLOW, MSG_TYPE_PARAM_FLOW (values hashed in C
with hash_param parity; doubles answer STATUS_FAIL) and CONCURRENT
acquire/release (TTL token table on the host, batched per tick) — every
token type on ONE port, the TokenServerHandler.java:61-75 dispatch map.
SO_REUSEPORT sharding (``reuseport=True``, several doors on one port)
runs one io thread a door on the same port for multi-core hosts.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.cluster.rules import flow_resource, param_resource
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.native.loader import load_native
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.record_log import record_log

#: param rules the ENGINE cannot enforce on any transport (no hash lane for
#: their param_idx): the log warning alone is invisible to monitoring, so
#: the misconfiguration is a /metrics fact too.  Counts SIGHTINGS: every
#: rule-map rebuild that still carries the bad rule increments, so a
#: non-flat curve means the condition persists.
_C_UNENFORCEABLE = _OBS.counter(
    "sentinel_front_door_unenforceable_rules",
    "param rules seen without a hash lane for their param_idx (engine "
    "cannot enforce them); incremented per rule-map rebuild",
)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def resolve_param_lane(service, fid: int, name: str):
    """Hash lane for a decision param rule, or None when the C ring cannot
    serve it.  Lane-less rules (engine-unenforceable) warn AND count in
    ``sentinel_front_door_unenforceable_rules``; lane > 1 rules only warn —
    the asyncio server still enforces those."""
    lane = service.client.param_lane(name, 0)
    if lane is not None and lane <= 1:
        return lane
    if lane is None:
        # no hash lane at all: the ENGINE cannot enforce this rule on any
        # transport — a misconfiguration, not a front-door limitation
        _C_UNENFORCEABLE.inc()
        record_log().warning(
            "front door: param rule %s on %r has no hash lane for param_idx 0 — the rule is not "
            "enforceable (raise param_dims or consolidate indices)", fid, name,
        )
    else:
        record_log().warning(
            "front door: param rule %s on %r maps to lane %d (ring carries lanes 0-1); served by "
            "the asyncio server only", fid, name, lane,
        )
    return None


class NativeFrontDoor:
    """Owns one sx_front instance and its flow-id → engine-row map.

    Attach to a SentinelClient with ``client.attach_front_door(door)``;
    the client's tick loop then serves the door's traffic.  Rule mapping
    follows a DefaultTokenService's flow and param rules (``follow``)."""

    def __init__(
        self,
        port: int = 0,
        ring_pow2: int = 1 << 16,
        pending: int = 1 << 16,
        fmap_pow2: int = 1 << 12,
        max_qps: Optional[float] = None,
        reuseport: bool = False,
    ):
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native library unavailable — the front door needs a C++ compiler")
        self._f = self._lib.sx_front_new(port, ring_pow2, pending, fmap_pow2, 1 if reuseport else 0)
        if not self._f:
            raise RuntimeError("sx_front_new failed (bind error?)")
        if max_qps is not None:
            self._lib.sx_front_set_guard(self._f, int(max_qps))
        self._started = False
        self._service = None  # set by follow(); serves concurrent tokens
        # tick-side drain buffers (single consumer: the tick thread)
        self._buf_n = 0
        self._bufs = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return int(self._lib.sx_front_port(self._f))

    def start(self) -> None:
        if not self._started:
            if self._lib.sx_front_start(self._f) != 0:
                raise RuntimeError("sx_front_start failed")
            self._started = True

    def stop(self) -> None:
        if self._started:
            self._lib.sx_front_stop(self._f)
            self._started = False

    def close(self) -> None:
        if self._f:
            self._lib.sx_front_free(self._f)
            self._f = None

    # -- rule mapping --------------------------------------------------------

    def map_flow(self, flow_id: int, row: int) -> None:
        self._lib.sx_front_map_flow(self._f, int(flow_id), int(row))

    def map_param(self, flow_id: int, row: int, lane: int = 0) -> None:
        self._lib.sx_front_map_param(self._f, int(flow_id), int(row), int(lane))

    def follow(self, service) -> None:
        """Track a DefaultTokenService's cluster flow AND param rules:
        whenever either (re)loads, rebuild the id → engine-row maps.  Also
        binds the service for host-managed CONCURRENT tokens."""
        self._service = service

        def _sync(*_a) -> None:
            reg = service.client.registry
            # clear-then-rebuild so DELETED rules stop resolving (the map
            # has no per-key delete; a clear briefly answers NO_RULE, the
            # same window the asyncio server has mid-reload)
            self._lib.sx_front_clear_flows(self._f)
            for fid in service.flow_rules.all_ids():
                row = reg.resource_id(flow_resource(fid))
                if row is not None:
                    self.map_flow(fid, row)
            for fid in service.param_rules.all_ids():
                name = param_resource(fid)
                row = reg.resource_id(name)
                if row is None:
                    continue
                # the decision rule's param_idx is 0; its hash lane is
                # wherever the compile assigned idx 0.  The C ring carries
                # two hash lanes and sx_front_map_param rejects lane > 1 —
                # such rules keep flowing through the asyncio server
                lane = resolve_param_lane(service, fid, name)
                if lane is None:
                    continue
                self.map_param(fid, row, lane)

        service.flow_rules.add_listener(_sync)
        service.param_rules.add_listener(_sync)
        _sync()

    # -- tick-side API -------------------------------------------------------

    def pending(self) -> int:
        """Acquire-ring backlog (the tick loop drains again without waiting)."""
        return int(self._lib.sx_front_acq_backlog(self._f))

    def drain(self, max_n: int):
        """(row, count, prio, corr, kind, a0, a1) int32 arrays of length
        n <= max_n.  kind = wire MSG_TYPE: 1 flow, 2 param (a0 / a1 = hash
        lanes), 3 / 4 concurrent acquire / release (a0 / a1 = the 64-bit
        id's halves).  The buffers are allocated once (single consumer: the
        tick thread); callers consume the views before the next drain."""
        if self._bufs is None or self._buf_n < max_n:
            self._bufs = tuple(np.empty(max_n, np.int32) for _ in range(7))
            self._buf_n = max_n
        row, cnt, prio, corr, kind, a0, a1 = self._bufs
        n = self._lib.sx_front_drain_acquires2(
            self._f, max_n, _ptr(row), _ptr(cnt), _ptr(prio), _ptr(corr), _ptr(kind), _ptr(a0), _ptr(a1)
        )
        return row[:n], cnt[:n], prio[:n], corr[:n], kind[:n], a0[:n], a1[:n]

    def handle_host_events(self, kind, cnt, corr, a0, a1) -> None:
        """Serve CONCURRENT acquire / release events against the followed
        service's token manager and answer through the typed respond path.
        A dict operation an event (~µs): concurrent-mode traffic is orders
        below flow traffic (the reference's TokenCacheNodeManager)."""
        svc = self._service
        n = len(kind)
        status = np.empty(n, np.int32)
        tok_hi = np.zeros(n, np.int32)
        tok_lo = np.zeros(n, np.int32)
        for i in range(n):
            ident = (int(np.uint32(a0[i])) << 32) | int(np.uint32(a1[i]))
            if svc is None:
                status[i] = C.STATUS_FAIL
            elif kind[i] == C.MSG_TYPE_CONCURRENT_ACQUIRE:
                r = svc.request_concurrent_token(ident, int(cnt[i]))
                status[i] = r.status
                tok_hi[i] = np.uint32((r.token_id >> 32) & 0xFFFFFFFF).astype(np.int32)
                tok_lo[i] = np.uint32(r.token_id & 0xFFFFFFFF).astype(np.int32)
            else:
                status[i] = svc.release_concurrent_token(ident).status
        corr = np.ascontiguousarray(corr, np.int32)
        waits = np.zeros(n, np.int32)
        self._lib.sx_front_respond_ex(self._f, n, _ptr(corr), _ptr(status), _ptr(waits), _ptr(tok_hi), _ptr(tok_lo))

    def respond(self, corr: np.ndarray, verdicts: np.ndarray, waits: np.ndarray) -> None:
        """Answer drained acquires: engine verdicts map to wire statuses."""
        status = np.where(
            verdicts == ERR.PASS,
            np.int32(C.STATUS_OK),
            np.where(verdicts == ERR.PASS_WAIT, np.int32(C.STATUS_SHOULD_WAIT), np.int32(C.STATUS_BLOCKED)),
        ).astype(np.int32)
        corr = np.ascontiguousarray(corr, np.int32)
        waits = np.ascontiguousarray(waits, np.int32)
        self._lib.sx_front_respond(self._f, len(corr), _ptr(corr), _ptr(status), _ptr(waits))
