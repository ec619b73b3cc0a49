"""Cluster token client: xid-correlated requests with auto-reconnect.

The port's copy of ``sentinel_tpu/cluster/client.py``.  Each connection
teardown is journalled in the flight recorder (``obs.flight``:
``cluster.conn.teardown`` with its kind and the requests it stranded).

The reference pairs a Netty channel with a xid→promise map
(DefaultClusterTokenClient.java:45, TokenClientPromiseHolder); here a plain
socket plus a daemon reader thread resolves per-request Futures.  Failures
degrade, never break: a dead server yields STATUS_FAIL results and the
runtime falls back to local rule checking
(FlowRuleChecker.fallbackToLocalOrPass:166 — see runtime/client.py wiring).
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
from concurrent.futures import CancelledError, Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sentinel_tpu_torch.adaptive.degrade import Backoff
from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.token_service import TokenResult, TokenService
from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.time_source import mono_s

_H_RPC = _OBS.histogram(
    "sentinel_cluster_rpc_ms",
    "token-server request/response round-trip (successful responses only; "
    "failures count in sentinel_cluster_rpc_failures_total)",
)
# degraded round-trips, labeled by failure KIND so chaos scenarios (and
# operators) can assert WHICH fault fired instead of reading one lump:
#   connect   — could not (re)establish the server connection
#   send      — the request write failed mid-frame
#   timeout   — no response within timeout_ms (includes server-side drops
#               of malformed/corrupted frames, whose xid never resolves)
#   conn_lost — the connection died while the request was in flight
#   decode    — a response frame arrived but failed to parse (the caller
#               still times out, counted separately under `timeout`)
_RPC_FAIL_HELP = (
    "token-server round-trips that degraded, by failure kind "
    "(connect|send|timeout|conn_lost|decode)"
)
_C_RPC_FAIL = {
    k: _OBS.counter(
        "sentinel_cluster_rpc_failures_total", _RPC_FAIL_HELP, labels={"kind": k}
    )
    for k in ("connect", "send", "timeout", "conn_lost", "decode")
}

#: frames currently awaiting a response across all cluster client
#: connections (multiplexing depth) — mirrors the xid→Future map exactly
_G_INFLIGHT = _OBS.gauge(
    "sentinel_cluster_inflight_frames",
    "request frames awaiting responses across all cluster client connections",
)

#: chaos failpoints (chaos/failpoints.py) on the round-trip path — the
#: exact points a real transport fault strikes, one flag check disarmed
_FP_CONNECT = FP.register(
    "cluster.rpc.connect", "token-server TCP connect", FP.HIT_ACTIONS
)
_FP_SEND = FP.register(
    "cluster.rpc.send",
    "token-server request frame write (per round-trip)",
    FP.PIPE_ACTIONS,
)
_FP_RECV = FP.register(
    "cluster.rpc.recv",
    "token-server response bytes (reader thread)",
    FP.PIPE_ACTIONS,
)

#: sentinel returned by _roundtrip for requests that can never be encoded
#: (oversized params) — a client-side problem, NOT a server failure, so it
#: must not flip the runtime into degraded mode
_BAD_REQUEST = P.ClusterResponse(xid=-1, type=0, status=C.STATUS_BAD_REQUEST)


class ClusterTokenClient(TokenService):
    def __init__(
        self,
        host: str,
        port: int,
        namespace: str = C.DEFAULT_NAMESPACE,
        timeout_ms: int = C.DEFAULT_REQUEST_TIMEOUT_MS,
        reconnect_interval_s: float = 2.0,
        reconnect_backoff_cap_s: float = 30.0,
    ):
        self.host = host
        self.port = port
        self.namespace = namespace
        self.timeout_ms = timeout_ms
        self.reconnect_interval_s = reconnect_interval_s
        # exponential backoff with FULL jitter between reconnect attempts
        # (adaptive/degrade.py): a fixed retry interval let N clients that
        # lost the same shard stampede it in lockstep the moment it came
        # back.  ``reconnect_interval_s`` is the base (attempt 0 ceiling)
        # and stays live-tunable — tests zero it for no-throttle mode.
        self._backoff = Backoff(
            reconnect_interval_s, cap_s=reconnect_backoff_cap_s
        )
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        # serializes sendall: concurrent partial writes from two threads
        # would interleave mid-frame and desync the server's FrameReader
        self._send_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._xid_counter = itertools.count(0)
        self._reader: Optional[threading.Thread] = None
        self._closed = False
        # negotiated protocol version for the CURRENT connection: starts
        # at 1, bumped to 2 when the server answers our HELLO, reset on
        # every teardown (a failover target may be an older build)
        self._peer_version = 1

    def _next_xid(self) -> int:
        # xid is an int32 on the wire; wrap within the positive range
        return next(self._xid_counter) % 0x7FFFFFFF + 1

    def _pend_add(self, xid: int, f: Future) -> None:
        self._pending[xid] = f
        _G_INFLIGHT.inc()

    def _pend_pop(self, xid: int) -> Optional[Future]:
        f = self._pending.pop(xid, None)
        if f is not None:
            _G_INFLIGHT.dec()
        return f

    # -- connection management ----------------------------------------------

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def start(self) -> None:
        self._ensure_connected()

    def close(self) -> None:
        self._closed = True
        self._teardown(kind="close")

    def _ensure_connected(self) -> bool:
        if self._sock is not None:
            return True
        if self._closed:
            return False
        # single-flight the connect: create_connection stalls up to its
        # 2 s timeout against a dead shard, and admission threads used to
        # QUEUE on this lock behind the connecting thread for that whole
        # window.  A busy lock now means someone else is already paying
        # the connect (or a teardown is mid-swap) — report unconnected
        # immediately and let the caller take its degraded fallback.
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self._sock is not None:
                return True
            # base stays live-tunable (tests zero reconnect_interval_s on
            # a built client); cap ramp-up via the jittered backoff
            self._backoff.base_s = self.reconnect_interval_s
            if not self._backoff.ready():
                return False
            try:
                FP.hit(_FP_CONNECT)
                s = socket.create_connection((self.host, self.port), timeout=2.0)  # stlint: disable=blocking-under-lock — single-flight: _lock is only ever taken with blocking=False here, so no admission thread waits out this connect; the sole blocking acquirer is _teardown, off the admission path
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # the CONNECT timeout must not linger as a read deadline:
                # create_connection leaves it on the socket, and a server
                # quiet for 2 s (a first tick's kernel build, idle lulls) would
                # time out the reader thread's recv and tear down a
                # HEALTHY connection (found by the chaos harness, scenario
                # cluster_partition).  Response waits are bounded by the
                # per-request future timeout, not the socket.
                s.settimeout(None)
            except OSError:
                self._backoff.failure()
                return False
            self._sock = s
            self._reader = threading.Thread(
                target=self._read_loop, args=(s,), name="sentinel-token-client", daemon=True
            )
            self._reader.start()
        finally:
            self._lock.release()
        # announce namespace so the server's census counts us (PING)
        try:
            self._send_nowait(
                P.ClusterRequest(self._next_xid(), C.MSG_TYPE_PING, namespace=self.namespace)
            )
        except OSError:
            # the socket accepted the connect but died on the first write:
            # as unhealthy as a refused connect — keep the backoff ramping
            # so a flapping server isn't hammered at line rate
            self._backoff.failure()
            self._teardown(kind="send_fail")
            return False
        # protocol negotiation rides behind the PING, off the request
        # path: a v2 server answers with its version; a v1 server's
        # decoder rejects the unknown type and drops the frame, so the
        # future never resolves and a reaper timer pins this connection
        # to v1 framing.  Either way no request ever waits on it.
        try:
            hx = self._next_xid()
            hf: Future = Future()

            def _hello_done(fut: Future) -> None:
                try:
                    rsp = fut.result(timeout=0)
                except Exception:  # stlint: disable=fail-open — HELLO is a best-effort probe: any failure leaves the peer on v1 legacy framing, the conservative direction
                    return
                if (
                    rsp is not None
                    and rsp.status == C.STATUS_OK
                    and rsp.remaining >= 2
                ):
                    # speak the highest version BOTH sides know
                    self._peer_version = min(
                        C.PROTOCOL_VERSION, int(rsp.remaining)
                    )

            hf.add_done_callback(_hello_done)
            self._pend_add(hx, hf)

            def _hello_reap() -> None:
                f2 = self._pend_pop(hx)
                if f2 is not None and not f2.done():
                    f2.set_result(None)  # v1 peer: HELLO went unanswered

            self._send_nowait(
                P.ClusterRequest(hx, C.MSG_TYPE_HELLO, count=C.PROTOCOL_VERSION)
            )
            t = threading.Timer(self.timeout_ms / 1000.0, _hello_reap)
            t.daemon = True
            t.start()
        except OSError:
            self._pend_pop(hx)
            # PING already proved the socket once; a HELLO write failure
            # just leaves the connection on v1 until the next reconnect
        # NO backoff reset here: a connect (or even a buffered write)
        # proves nothing about server health — an accept-then-die flapper
        # would hold the backoff at attempt 0 forever and the fleet would
        # hammer it at line rate.  The reset lives in _read_loop, on the
        # first DECODED response (a real healthy exchange).
        return True

    def _teardown(self, kind: str = "conn_lost") -> None:
        """Drop the connection and fail its in-flight requests (they
        resolve None: STATUS_FAIL at the caller).  ``kind`` says why (close
        / send_fail / conn_lost); the flight recorder journals it with the
        number of requests it stranded."""
        with self._lock:
            s, self._sock = self._sock, None
            pending, self._pending = self._pending, {}
            self._peer_version = 1  # renegotiate on the next connection
        if pending:
            _G_INFLIGHT.dec(len(pending))
        if s is not None:
            FL.note("cluster.conn.teardown", kind=kind, peer=f"{self.host}:{self.port}", in_flight=len(pending))
            try:
                s.close()
            except OSError:
                pass
        for f in pending.values():
            if not f.done():
                f.set_result(None)

    def _read_loop(self, s: socket.socket) -> None:
        frames = P.FrameReader()
        try:
            while True:
                data = s.recv(4096)
                if not data:
                    break
                # chaos: drop => treated as peer-close, corrupt/short-read
                # => decode failures / frame desync below
                data = FP.pipe(_FP_RECV, data)
                if not data:
                    break
                for body in frames.feed(data):
                    try:
                        # BATCH responses carry column slabs the legacy
                        # decoder would misparse — route on the type byte
                        if P.peek_type(body) == C.MSG_TYPE_BATCH:
                            rsp = P.decode_batch_response(body)
                        else:
                            rsp = P.decode_response(body)
                    except (ValueError, struct.error):
                        _C_RPC_FAIL["decode"].inc()
                        continue  # malformed frame; xid never resolves -> caller times out to STATUS_FAIL
                    if self._backoff.attempt:
                        # first decoded response = the healthy exchange
                        # that resets the reconnect backoff ramp
                        self._backoff.success()
                    f = self._pend_pop(rsp.xid)
                    if f is not None and not f.done():
                        f.set_result(rsp)
        except OSError:
            pass
        finally:
            if self._sock is s:
                self._teardown()

    def _send_nowait(self, req: P.ClusterRequest) -> None:
        raw = P.encode_request(req)
        s = self._sock
        if s is None:
            raise OSError("not connected")
        with self._send_lock:
            s.sendall(raw)  # stlint: disable=blocking-under-lock — _send_lock IS the socket-write framing lock: serializing sendall is its entire purpose; replies arrive via the mux reader thread, never under it

    def _roundtrip(self, req: P.ClusterRequest) -> Optional[P.ClusterResponse]:
        if not self._ensure_connected():
            _C_RPC_FAIL["connect"].inc()
            return None
        _t = OT.t0()
        _attrs = None
        if _t:
            # distributed trace context: adopt the caller's ambient trace
            # (or start a fresh wire trace), mint this round-trip's span
            # id, and ride both on the frame's optional trace tail — the
            # server's decision spans re-install them (obs.trace.maybe_ctx)
            # so `--merge` can join the two processes' dumps with flow
            # events.  All of it is behind the one t0() flag check.
            tid, parent = OT.current_ctx()
            if not tid:
                tid = OT.new_trace_id()
            req.trace_id = tid
            req.span_id = OT.new_span_id()
            _attrs = {"type": req.type, "span_id": req.span_id}
            if parent:
                _attrs["parent"] = parent
        try:
            raw = P.encode_request(req)
        except (ValueError, struct.error):
            return _BAD_REQUEST  # unencodable request; connection is fine
        f: Future = Future()
        self._pend_add(req.xid, f)
        try:
            s = self._sock
            if s is None:
                raise OSError("not connected")
            # chaos: raise => this send path's degrade; drop/corrupt =>
            # the server never answers this xid => timeout kind
            raw = FP.pipe(_FP_SEND, raw)
            with self._send_lock:
                s.sendall(raw)  # stlint: disable=blocking-under-lock — _send_lock IS the socket-write framing lock: serializing sendall is its entire purpose; replies arrive via the mux reader thread, never under it
        except OSError:
            self._pend_pop(req.xid)
            self._teardown(kind="send_fail")
            _C_RPC_FAIL["send"].inc()
            if _t:
                # failures skip the latency histogram (a timeout-ceiling
                # sample would corrupt the success-path percentiles; the
                # failure RATE lives in _C_RPC_FAIL) — the span keeps the
                # duration for trace-level diagnosis
                OT.stage(
                    "cluster.rpc", _t, trace=req.trace_id,
                    attrs=dict(_attrs, ok=False),
                )
            return None
        try:
            rsp = f.result(timeout=self.timeout_ms / 1000.0)
        except (_FutTimeout, CancelledError):
            self._pend_pop(req.xid)
            _C_RPC_FAIL["timeout"].inc()
            if _t:
                OT.stage(
                    "cluster.rpc", _t, trace=req.trace_id,
                    attrs=dict(_attrs, ok=False),
                )
            return None  # -> STATUS_FAIL at the TokenService surface (degrade, never PASS)
        if rsp is None:
            _C_RPC_FAIL["conn_lost"].inc()  # connection died mid-wait (_teardown resolved us)
        if _t:
            OT.stage(
                "cluster.rpc", _t, _H_RPC if rsp is not None else None,
                trace=req.trace_id,
                attrs=dict(_attrs, ok=rsp is not None),
            )
        return rsp

    # -- TokenService --------------------------------------------------------

    def request_token(self, flow_id: int, count: int = 1, prioritized: bool = False) -> TokenResult:
        rsp = self._roundtrip(
            P.ClusterRequest(
                self._next_xid(), C.MSG_TYPE_FLOW, flow_id=flow_id, count=count, priority=prioritized
            )
        )
        if rsp is None:
            return TokenResult(C.STATUS_FAIL)
        return TokenResult(rsp.status, remaining=rsp.remaining, wait_ms=rsp.wait_ms)

    def request_token_batch(self, flow_id: int, units: int) -> TokenResult:
        if self._peer_version >= 3:
            # v3 peers answer over a BATCH frame so a deny carries its
            # provenance (_T_PROV); one entry is still one round trip
            return self.request_batch([(C.BATCH_KIND_FLOW_BATCH, flow_id, units)])[0]
        rsp = self._roundtrip(
            P.ClusterRequest(
                self._next_xid(), C.MSG_TYPE_FLOW_BATCH, flow_id=flow_id, count=units
            )
        )
        if rsp is None:
            return TokenResult(C.STATUS_FAIL)
        return TokenResult(rsp.status, remaining=rsp.remaining, wait_ms=rsp.wait_ms)

    @property
    def peer_version(self) -> int:
        return self._peer_version

    def request_batch(
        self, entries: Sequence[Tuple[int, ...]]
    ) -> List[TokenResult]:
        """Many token requests in ONE wire exchange.

        ``entries`` is a sequence of ``(kind, flow_id, count)`` or
        ``(kind, flow_id, count, flags)`` tuples (kind is a
        C.BATCH_KIND_* constant).  Against a v2 peer the whole list rides
        one BATCH frame; against a v1 peer the entries are pipelined as
        individual frames on the same connection — all sends first, then
        one collection pass — so wall clock is one round-trip either
        way.  Transport failure fails every entry CLOSED (STATUS_FAIL):
        partial answers from a corrupted frame are never applied."""
        n = len(entries)
        if n == 0:
            return []
        if not self._ensure_connected():
            _C_RPC_FAIL["connect"].inc()
            return [TokenResult(C.STATUS_FAIL)] * n
        if self._peer_version >= 2 and n <= C.MAX_BATCH_ENTRIES:
            return self._request_batch_v2(entries)
        return self._request_batch_v1(entries)

    def _request_batch_v2(self, entries) -> List[TokenResult]:
        n = len(entries)
        flags = np.array([e[3] if len(e) > 3 else 0 for e in entries], np.uint8)
        if self._peer_version >= 3:
            # ask a v3 server to explain its denies (_T_PROV block); a v2
            # server never sees the flag, so its frames stay byte-identical
            flags |= np.uint8(C.BATCH_FLAG_EXPLAIN)
        req = P.ClusterBatchRequest(
            xid=self._next_xid(),
            kinds=np.array([e[0] for e in entries], np.uint8),
            ids=np.array([e[1] for e in entries], np.int64),
            counts=np.array([e[2] for e in entries], np.int32),
            flags=flags,
        )
        _t = OT.t0()
        _attrs = None
        if _t:
            tid, parent = OT.current_ctx()
            if not tid:
                tid = OT.new_trace_id()
            req.trace_id = tid
            req.span_id = OT.new_span_id()
            _attrs = {"type": C.MSG_TYPE_BATCH, "n": n, "span_id": req.span_id}
            if parent:
                _attrs["parent"] = parent
        try:
            raw = P.encode_batch_request(req)
        except (ValueError, struct.error):
            return [TokenResult(C.STATUS_BAD_REQUEST)] * n
        f: Future = Future()
        self._pend_add(req.xid, f)
        try:
            s = self._sock
            if s is None:
                raise OSError("not connected")
            raw = FP.pipe(_FP_SEND, raw)
            with self._send_lock:
                s.sendall(raw)  # stlint: disable=blocking-under-lock — _send_lock IS the socket-write framing lock: serializing sendall is its entire purpose; replies arrive via the mux reader thread, never under it
        except OSError:
            self._pend_pop(req.xid)
            self._teardown(kind="send_fail")
            _C_RPC_FAIL["send"].inc()
            if _t:
                OT.stage(
                    "cluster.rpc", _t, trace=req.trace_id,
                    attrs=dict(_attrs, ok=False),
                )
            return [TokenResult(C.STATUS_FAIL)] * n
        try:
            rsp = f.result(timeout=self.timeout_ms / 1000.0)
        except (_FutTimeout, CancelledError):
            self._pend_pop(req.xid)
            _C_RPC_FAIL["timeout"].inc()
            rsp = None
        if rsp is None and not self.connected:
            _C_RPC_FAIL["conn_lost"].inc()
        if _t:
            OT.stage(
                "cluster.rpc", _t, _H_RPC if rsp is not None else None,
                trace=req.trace_id, attrs=dict(_attrs, ok=rsp is not None),
            )
        # whole-frame fail-closed: a non-OK frame status or an entry-count
        # mismatch means NO entry verdict can be trusted
        if (
            rsp is None
            or not isinstance(rsp, P.ClusterBatchResponse)
            or rsp.status != C.STATUS_OK
            or len(rsp) != n
        ):
            return [TokenResult(C.STATUS_FAIL)] * n
        out = []
        for i in range(n):
            pv = rsp.prov[i] if rsp.prov is not None else None
            out.append(
                TokenResult(
                    int(rsp.statuses[i]),
                    remaining=int(rsp.remainings[i]),
                    wait_ms=int(rsp.waits[i]),
                    token_id=int(rsp.token_ids[i]),
                    prov_kind=pv[0] if pv else None,
                    prov_rule=pv[1] if pv else None,
                    prov_observed=pv[2] if pv else None,
                    prov_limit=pv[3] if pv else None,
                )
            )
        return out

    _BATCH_KIND_TO_MSG = {
        C.BATCH_KIND_FLOW: C.MSG_TYPE_FLOW,
        C.BATCH_KIND_FLOW_BATCH: C.MSG_TYPE_FLOW_BATCH,
        C.BATCH_KIND_LEASE: C.MSG_TYPE_LEASE,
    }

    def _request_batch_v1(self, entries) -> List[TokenResult]:
        n = len(entries)
        out: List[Optional[TokenResult]] = [None] * n
        waiters: List[Tuple[int, int, Future]] = []
        for i, e in enumerate(entries):
            mt = self._BATCH_KIND_TO_MSG.get(int(e[0]))
            if mt is None:
                out[i] = TokenResult(C.STATUS_BAD_REQUEST)
                continue
            prio = bool((e[3] if len(e) > 3 else 0) & C.BATCH_FLAG_PRIORITIZED)
            req = P.ClusterRequest(
                self._next_xid(), mt, flow_id=int(e[1]), count=int(e[2]),
                priority=prio,
            )
            f: Future = Future()
            self._pend_add(req.xid, f)
            try:
                raw = FP.pipe(_FP_SEND, P.encode_request(req))
                s = self._sock
                if s is None:
                    raise OSError("not connected")
                with self._send_lock:
                    s.sendall(raw)  # stlint: disable=blocking-under-lock — _send_lock IS the socket-write framing lock: serializing sendall is its entire purpose; replies arrive via the mux reader thread, never under it
            except (ValueError, struct.error):
                self._pend_pop(req.xid)
                out[i] = TokenResult(C.STATUS_BAD_REQUEST)
                continue
            except OSError:
                self._pend_pop(req.xid)
                self._teardown(kind="send_fail")
                _C_RPC_FAIL["send"].inc()
                out[i] = TokenResult(C.STATUS_FAIL)
                continue
            waiters.append((i, req.xid, f))
        # one shared deadline for the whole pipeline: the responses were
        # all in flight before the first wait started
        end = mono_s() + self.timeout_ms / 1000.0
        for i, xid, f in waiters:
            try:
                rsp = f.result(timeout=max(0.0, end - mono_s()))
            except (_FutTimeout, CancelledError):
                self._pend_pop(xid)
                _C_RPC_FAIL["timeout"].inc()
                rsp = None
            if rsp is None:
                out[i] = TokenResult(C.STATUS_FAIL)
            else:
                out[i] = TokenResult(
                    rsp.status, remaining=rsp.remaining,
                    wait_ms=rsp.wait_ms, token_id=rsp.token_id,
                )
        return [r if r is not None else TokenResult(C.STATUS_FAIL) for r in out]

    def request_param_token(self, flow_id: int, count: int, params: List[Any]) -> TokenResult:
        rsp = self._roundtrip(
            P.ClusterRequest(
                self._next_xid(), C.MSG_TYPE_PARAM_FLOW, flow_id=flow_id, count=count, params=params
            )
        )
        if rsp is None:
            return TokenResult(C.STATUS_FAIL)
        return TokenResult(rsp.status, remaining=rsp.remaining, wait_ms=rsp.wait_ms)

    def request_lease(self, flow_id: int, units: int) -> TokenResult:
        rsp = self._roundtrip(
            P.ClusterRequest(
                self._next_xid(), C.MSG_TYPE_LEASE, flow_id=flow_id, count=units
            )
        )
        if rsp is None:
            return TokenResult(C.STATUS_FAIL)
        return TokenResult(rsp.status, remaining=rsp.remaining, wait_ms=rsp.wait_ms)

    def request_concurrent_token(self, flow_id: int, count: int = 1) -> TokenResult:
        rsp = self._roundtrip(
            P.ClusterRequest(
                self._next_xid(), C.MSG_TYPE_CONCURRENT_ACQUIRE, flow_id=flow_id, count=count
            )
        )
        if rsp is None:
            return TokenResult(C.STATUS_FAIL)
        return TokenResult(rsp.status, token_id=rsp.token_id)

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        rsp = self._roundtrip(
            P.ClusterRequest(self._next_xid(), C.MSG_TYPE_CONCURRENT_RELEASE, token_id=token_id)
        )
        if rsp is None:
            return TokenResult(C.STATUS_FAIL)
        return TokenResult(rsp.status)
