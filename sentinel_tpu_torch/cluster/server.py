"""Cluster token server: TCP front door over the decision engine.

The port's copy of ``sentinel_tpu/cluster/server.py``.

The reference's Netty server (NettyTransportServer.java:88-93 pipeline →
TokenServerHandler.java:61-75 dispatch) becomes an asyncio TCP server in a
daemon thread: frames decode on the event loop, token decisions execute in a
small thread pool (the decision client's check_batch blocks on the engine
tick, which must not stall the loop).

Connection bookkeeping mirrors ConnectionManager/ConnectionGroup: a client's
first PING carries its namespace; the per-namespace connected count scales
AVG_LOCAL thresholds (DefaultTokenService.refresh_connected_count).  Idle
connections are reaped on a timer (ScanIdleConnectionTask).
"""

from __future__ import annotations

import asyncio
import logging
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService, TokenResult
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.utils.time_source import mono_s

_log = logging.getLogger(__name__)

#: chaos failpoint covering server-side request processing (worker-pool
#: types incl. RES_CHECK shard chunks); a raise converts to STATUS_FAIL.
#: Its HIT COUNT doubles as the chaos harness's server-side "chunks
#: processed" probe — the no-replay invariant reads it.
_FP_PROCESS = FP.register(
    "cluster.server.process", "token server request processing", FP.HIT_ACTIONS
)

#: chaos failpoint on the protocol-v2 BATCH frame transport: corrupt /
#: short_read mangle the frame bytes before decode, which must fail the
#: WHOLE frame closed — partial answers are never applied
_FP_BATCH = FP.register(
    "cluster.batch.frame", "protocol-v2 batch frame transport", FP.PIPE_ACTIONS
)


class ConnectionManager:
    """namespace → live connection census (ConnectionManager/ConnectionGroup)."""

    def __init__(self, on_change=None):
        self._lock = threading.Lock()
        self._groups: Dict[str, set] = {}
        self._conn_ns: Dict[int, str] = {}
        self._on_change = on_change

    def register(self, conn_id: int, namespace: str) -> None:
        with self._lock:
            old = self._conn_ns.get(conn_id)
            if old is not None:
                self._groups.get(old, set()).discard(conn_id)
            self._conn_ns[conn_id] = namespace
            self._groups.setdefault(namespace, set()).add(conn_id)
        if self._on_change:
            self._on_change()

    def remove(self, conn_id: int) -> None:
        with self._lock:
            ns = self._conn_ns.pop(conn_id, None)
            if ns is not None:
                self._groups.get(ns, set()).discard(conn_id)
        if ns is not None and self._on_change:
            self._on_change()

    def connected_count(self, namespace: str) -> int:
        return len(self._groups.get(namespace, ()))


class ClusterTokenServer:
    """Standalone token server (SentinelDefaultTokenServer analog).

    ``start()`` spins the asyncio loop in a daemon thread and returns once
    the socket is listening; ``port`` may be 0 to bind an ephemeral port
    (tests) — the bound port is then available as ``.port``.
    """

    def __init__(
        self,
        token_service: DefaultTokenService,
        host: str = "0.0.0.0",
        port: Optional[int] = None,
        idle_seconds: Optional[int] = None,
        workers: int = 8,
    ):
        self.service = token_service
        self.host = host
        cfg = token_service.config.transport
        self.port = cfg.port if port is None else port
        self.idle_seconds = cfg.idle_seconds if idle_seconds is None else idle_seconds
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="tok")
        # census changes fire on the event loop (PING / disconnect); the
        # reprojection they may trigger recompiles engine rules, so run it
        # on the worker pool instead of stalling the loop
        def _census_changed():
            try:
                self._pool.submit(token_service.refresh_connected_count)
            except RuntimeError:
                pass  # pool already shut down (server stopping)

        self.connections = ConnectionManager(on_change=_census_changed)
        self.service.connected_count_fn = self.connections.connected_count
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._conn_seq = 0
        self._last_active: Dict[int, float] = {}
        self._writers: Dict[int, asyncio.StreamWriter] = {}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run_loop, name="sentinel-token-server", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("token server failed to start")

    def stop(self) -> None:
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # drop the queued work and wait out the running: a census refresh
        # left behind would reproject this server's rules onto the decision
        # client after stop() returned, over whatever the caller loads next
        self._pool.shutdown(wait=True, cancel_futures=True)

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def _boot():
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self.port
            )
            self.port = self._server.sockets[0].getsockname()[1]
            loop.create_task(self._idle_scan())
            loop.create_task(self._expire_scan())
            self._started.set()

        loop.run_until_complete(_boot())
        try:
            loop.run_forever()
        finally:
            if self._server is not None:
                self._server.close()
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            loop.close()

    # -- periodic tasks ------------------------------------------------------

    async def _idle_scan(self) -> None:
        # close idle sockets (ScanIdleConnectionTask): the census entry is
        # removed by the handler's finally-block, and a still-alive client
        # reconnects + re-PINGs, so connectedCount stays truthful
        while True:
            await asyncio.sleep(min(self.idle_seconds, 30))
            cutoff = mono_s() - self.idle_seconds
            for cid, last in list(self._last_active.items()):
                if last < cutoff:
                    w = self._writers.get(cid)
                    if w is not None:
                        try:
                            w.close()
                        except Exception:
                            pass

    async def _expire_scan(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            self.service.concurrent.expire(self.service.client.time.now_ms())

    # -- per-connection protocol --------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._conn_seq += 1
        cid = self._conn_seq
        frames = P.FrameReader()
        self._last_active[cid] = mono_s()
        self._writers[cid] = writer
        loop = asyncio.get_running_loop()
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    break
                self._last_active[cid] = mono_s()
                for body in frames.feed(data):
                    if P.peek_type(body) == C.MSG_TYPE_BATCH:
                        loop.create_task(self._batch_and_reply(body, writer))
                        continue
                    try:
                        req = P.decode_request(body)
                    except (ValueError, struct.error, IndexError):
                        # malformed frame — drop it, server stays up
                        # (IndexError: _unpack_params indexing a truncated
                        # param buffer; must not escape to the connection
                        # handler and kill every pipelined request)
                        continue
                    if req.type == C.MSG_TYPE_PING:
                        self.connections.register(cid, req.namespace or C.DEFAULT_NAMESPACE)
                        writer.write(
                            P.encode_response(
                                P.ClusterResponse(req.xid, req.type, C.STATUS_OK)
                            )
                        )
                        continue
                    if req.type == C.MSG_TYPE_HELLO:
                        # version negotiation: answer our protocol version
                        # inline.  A v1 server never gets here — its
                        # decoder rejects type HELLO, the frame is dropped
                        # above, and the client's HELLO times out, pinning
                        # the connection to v1 framing.
                        writer.write(
                            P.encode_response(
                                P.ClusterResponse(
                                    req.xid, req.type, C.STATUS_OK,
                                    remaining=C.PROTOCOL_VERSION,
                                    trace_id=req.trace_id, span_id=req.span_id,
                                )
                            )
                        )
                        continue
                    # one task per request: pipelined requests on a single
                    # connection run concurrently so they coalesce into
                    # engine micro-batches (xid correlation makes
                    # out-of-order replies safe); awaiting inline would
                    # serialize a connection at one tick per request.
                    # FLOW requests take the fully-async path (a queued
                    # future, no worker thread) so in-flight count is
                    # unbounded; other types go through the worker pool.
                    if req.type == C.MSG_TYPE_FLOW:
                        loop.create_task(self._flow_and_reply(req, writer))
                    else:
                        loop.create_task(self._process_and_reply(req, writer))
                await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        except Exception:  # stlint: disable=fail-open — connection dies (finally cleans census), peer times out to STATUS_FAIL and degrades
            _log.exception("token server connection error")
        finally:
            self._last_active.pop(cid, None)
            self._writers.pop(cid, None)
            self.connections.remove(cid)
            try:
                writer.close()
            except Exception:
                pass

    async def _process_and_reply(
        self, req: P.ClusterRequest, writer: asyncio.StreamWriter
    ) -> None:
        loop = asyncio.get_running_loop()
        rsp = await loop.run_in_executor(self._pool, self._process, req)
        try:
            writer.write(P.encode_response(rsp))
            await writer.drain()
        except (ConnectionResetError, OSError):
            pass  # peer vanished mid-reply

    async def _flow_and_reply(
        self, req: P.ClusterRequest, writer: asyncio.StreamWriter
    ) -> None:
        """Thread-free token grant: request_token_async queues the acquire
        into the decision engine's next micro-batch and the reply writes
        when its future resolves — no per-request worker, so the in-flight
        ceiling is the engine batch size, not the pool size."""
        try:
            # adopt the frame's trace context for the synchronous part of
            # the decision (the token.decision span begins in here), so
            # the server-side span carries the client's trace id + parent
            with OT.maybe_ctx(req.trace_id, req.span_id):
                fut = self.service.request_token_async(
                    req.flow_id, req.count, req.priority
                )
            # bounded wait: a wedged engine must produce STATUS_FAIL, not a
            # silently hung connection (the worker-pool path got this from
            # check_batch's entry timeout)
            r = await asyncio.wait_for(
                asyncio.wrap_future(fut),
                timeout=self.service.client.entry_timeout_s + 1.0,
            )
            rsp = P.ClusterResponse(
                req.xid, req.type, r.status, remaining=r.remaining,
                wait_ms=r.wait_ms, trace_id=req.trace_id, span_id=req.span_id,
            )
        except Exception:  # stlint: disable=fail-open — converted to STATUS_FAIL: an explicit degrade signal, never a PASS
            _log.exception("token request failed")
            rsp = P.ClusterResponse(
                req.xid, req.type, C.STATUS_FAIL,
                trace_id=req.trace_id, span_id=req.span_id,
            )
        try:
            writer.write(P.encode_response(rsp))
            await writer.drain()
        except (ConnectionResetError, OSError):
            pass  # peer vanished mid-reply

    async def _batch_and_reply(self, body: bytes, writer: asyncio.StreamWriter) -> None:
        """Protocol-v2 BATCH frame: chaos pipe → strict decode → ONE
        worker-pool decision over the whole frame.

        Any transport mangling fails the WHOLE frame CLOSED: if the xid
        is still readable the client gets a single frame-level
        STATUS_FAIL covering every entry; otherwise the frame is dropped
        and the client times out.  Partial answers are never applied."""
        loop = asyncio.get_running_loop()
        try:
            breq = P.decode_batch_request(FP.pipe(_FP_BATCH, body))
        except Exception:  # stlint: disable=fail-open — this handler IS the fail-closed path: the whole frame is answered STATUS_FAIL (or dropped), partial answers never applied
            xid = None
            if len(body) >= 4:
                try:
                    xid = struct.unpack_from(">i", body, 0)[0]
                except struct.error:
                    xid = None
            if xid is not None:
                rsp = P.ClusterBatchResponse(
                    xid, C.STATUS_FAIL,
                    np.zeros(0, np.int8), np.zeros(0, np.int32),
                    np.zeros(0, np.int32), np.zeros(0, np.int64),
                )
                try:
                    writer.write(P.encode_batch_response(rsp))
                    await writer.drain()
                except (ConnectionResetError, OSError):
                    pass
            return
        rsp = await loop.run_in_executor(self._pool, self._process_batch, breq)
        try:
            writer.write(P.encode_batch_response(rsp))
            await writer.drain()
        except (ConnectionResetError, OSError):
            pass  # peer vanished mid-reply

    def _process_batch(self, breq: P.ClusterBatchRequest) -> P.ClusterBatchResponse:
        n = len(breq)
        # the frame's trace context rides this worker thread, so the
        # column decision spans adopt the caller's trace id
        with OT.maybe_ctx(breq.trace_id, breq.span_id):
            try:
                FP.hit(_FP_PROCESS)
                statuses, remainings, waits, token_ids, prov = self.service.decide_frame(
                    breq.kinds, breq.ids, breq.counts, breq.flags
                )
                status = C.STATUS_OK
                # v3 deny provenance: attach only for entries that asked
                # (BATCH_FLAG_EXPLAIN) — a pre-v3 client never set the
                # flag, so its response stays byte-identical to v2
                prov = [
                    pv if int(breq.flags[i]) & C.BATCH_FLAG_EXPLAIN else None
                    for i, pv in enumerate(prov)
                ]
                if not any(pv is not None for pv in prov):
                    prov = None
            except Exception:  # stlint: disable=fail-open — whole-frame STATUS_FAIL: every entry degrades, none passes
                _log.exception("batch frame processing failed")
                statuses = np.full(n, C.STATUS_FAIL, np.int8)
                remainings = np.zeros(n, np.int32)
                waits = np.zeros(n, np.int32)
                token_ids = np.zeros(n, np.int64)
                status = C.STATUS_FAIL
                prov = None
        return P.ClusterBatchResponse(
            breq.xid, status, statuses, remainings, waits, token_ids,
            trace_id=breq.trace_id, span_id=breq.span_id, prov=prov,
        )

    def _process(self, req: P.ClusterRequest) -> P.ClusterResponse:
        # install the frame's trace context on this worker thread so every
        # decision span recorded below (token.decision*, server.res_check)
        # adopts the caller's trace id and parents to its RPC span
        with OT.maybe_ctx(req.trace_id, req.span_id):
            rsp = self._process_inner(req)
        rsp.trace_id, rsp.span_id = req.trace_id, req.span_id
        return rsp

    def _process_inner(self, req: P.ClusterRequest) -> P.ClusterResponse:
        try:
            FP.hit(_FP_PROCESS)
            t = req.type
            if t == C.MSG_TYPE_FLOW:
                r = self.service.request_token(req.flow_id, req.count, req.priority)
            elif t == C.MSG_TYPE_FLOW_BATCH:
                r = self.service.request_token_batch(req.flow_id, req.count)
            elif t == C.MSG_TYPE_PARAM_FLOW:
                r = self.service.request_param_token(req.flow_id, req.count, req.params)
            elif t == C.MSG_TYPE_CONCURRENT_ACQUIRE:
                r = self.service.request_concurrent_token(req.flow_id, req.count)
            elif t == C.MSG_TYPE_CONCURRENT_RELEASE:
                r = self.service.release_concurrent_token(req.token_id)
            elif t == C.MSG_TYPE_LEASE:
                r = self.service.request_lease(req.flow_id, req.count)
            elif t == C.MSG_TYPE_RES_CHECK:
                # host-shard resource batch (the reference's
                # parallel/remote_shard.py):
                # params = flat (name, count, prio, origin, param) 5-tuples
                names = [str(x) for x in req.params[0::5]]
                counts = [int(x) for x in req.params[1::5]]
                prios = [bool(x) for x in req.params[2::5]]
                origins = [str(x) for x in req.params[3::5]]
                pvals = []
                for x in req.params[4::5]:
                    xs = str(x)
                    if not xs:
                        pvals.append(None)
                    elif xs.startswith("i:"):
                        try:
                            pvals.append(int(xs[2:]))
                        except ValueError:
                            pvals.append(xs[2:])
                    elif xs.startswith("s:"):
                        pvals.append(xs[2:])
                    else:  # legacy/bare value
                        pvals.append(xs)
                # server-side chunk span: adopts the ambient trace ctx
                # installed by _process, so the shard client's per-chunk
                # span and this one share a trace id across the wire
                with OT.TRACER.span("server.res_check", items=len(names)):
                    res = self.service.client.check_batch(
                        names,
                        counts=counts,
                        prioritized=prios,
                        origins=origins if any(origins) else None,
                        params=pvals if any(p is not None for p in pvals) else None,
                    )
                return P.ClusterResponse(
                    req.xid, t, C.STATUS_OK, items=[(int(v), int(w)) for v, w in res]
                )
            else:
                r = TokenResult(C.STATUS_BAD_REQUEST)
        except Exception:  # stlint: disable=fail-open — converted to STATUS_FAIL: an explicit degrade signal, never a PASS
            _log.exception("token request processing failed")
            r = TokenResult(C.STATUS_FAIL)
        return P.ClusterResponse(
            xid=req.xid,
            type=req.type,
            status=r.status,
            remaining=r.remaining,
            wait_ms=r.wait_ms,
            token_id=r.token_id,
        )
