"""Remote host shard for the ShardRouter — a real network client.

The round-1 router fanned out over in-process objects; this stub speaks
the cluster TCP protocol's RES_CHECK extension to a shard HOST process
(cluster/server.py answers it from its decision client), with the failure
behavior the reference's token client has (NettyTransportClient reconnect,
DefaultClusterTokenClient.java:45 degrade):

- one live connection, lazily (re)established; one reconnect attempt per
  call, then the call degrades
- degrade-on-shard-loss: ``fallback`` is either a local SentinelClient
  (fallbackToLocal — local rules enforce while the shard is gone) or None
  (fail-open PASS, the reference's pass-through default)
- a failed shard is retried after ``retry_interval_s`` so a restarted
  host picks the traffic back up

The port's copy of ``sentinel_tpu/parallel/remote_shard.py``; the host
answering the chunks is the port's ``ClusterTokenServer`` over a
``DefaultTokenService`` whose decision client runs its engine on the
card.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.core import errors as ERR
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.record_log import record_log

_H_CHUNK = _OBS.histogram(
    "sentinel_shard_chunk_ms",
    "remote-shard chunk write-to-response latency (pipelined window)",
)
_C_CHUNKS = _OBS.counter(
    "sentinel_shard_chunks_total", "remote-shard RES_CHECK chunks answered"
)
_C_CHUNKS_DEGRADED = _OBS.counter(
    "sentinel_shard_chunks_degraded_total",
    "remote-shard chunks that fell back locally (unreachable / forfeited / unencodable)",
)

#: chaos failpoints on the shard transport — mid-window partitions land
#: here (a recv `drop` reads as peer-close; send `drop`/`corrupt` leaves
#: the chunk unanswered until the socket timeout)
_FP_CONNECT = FP.register(
    "parallel.shard.connect", "shard host TCP connect", FP.HIT_ACTIONS
)
_FP_SEND = FP.register(
    "parallel.shard.send", "shard RES_CHECK chunk frame write", FP.PIPE_ACTIONS
)
_FP_RECV = FP.register(
    "parallel.shard.recv", "shard response bytes (per recv call)", FP.PIPE_ACTIONS
)


class RemoteShard:
    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: float = 3.0,
        fallback: Optional[Any] = None,
        retry_interval_s: float = 2.0,
    ):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.fallback = fallback
        self.retry_interval_s = retry_interval_s
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._xid = 0
        # span-degrade state: the shared hysteresis primitive
        # (adaptive/degrade.py) — enter on shard loss, serve fallback
        # through the cooldown, exit on the first healthy exchange; every
        # transition journaled as remote_shard.degrade.enter/exit
        from sentinel_tpu_torch.adaptive.degrade import Hysteresis

        self._hy = Hysteresis(
            "remote_shard.degrade",
            cooldown_s=retry_interval_s,
            attrs={"peer": f"{host}:{port}"},
        )

    # attribute-compatible view of the hysteresis cooldown (tests poke it)
    @property
    def _down_until(self) -> float:
        return self._hy.until

    @_down_until.setter
    def _down_until(self, v: float) -> None:
        self._hy.until = float(v)

    # -- connection ----------------------------------------------------------

    def _connect(self) -> socket.socket:
        FP.hit(_FP_CONNECT)
        s = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
        s.settimeout(self.timeout_s)
        return s

    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    @staticmethod
    def _read_response(s: socket.socket) -> P.ClusterResponse:
        """Read one length-prefixed response frame; raises OSError on any
        transport trouble (caller degrades)."""
        head = b""
        while len(head) < 2:
            chunk = FP.pipe(_FP_RECV, s.recv(2 - len(head)))
            if not chunk:
                raise OSError("peer closed")
            head += chunk
        (n,) = struct.unpack(">H", head)
        body = b""
        while len(body) < n:
            chunk = FP.pipe(_FP_RECV, s.recv(n - len(body)))
            if not chunk:
                raise OSError("peer closed")
            body += chunk
        try:
            return P.decode_response(body)
        except (ValueError, struct.error, IndexError) as e:
            # a frame that parses as a length but not as a response means
            # the stream is desynced — surface it as transport trouble so
            # the caller's OSError path closes the socket and degrades
            # instead of the admission path crashing
            raise OSError(f"undecodable response frame: {e}") from e

    # -- shard surface -------------------------------------------------------

    #: items per wire chunk — ~20 B/item for typical names keeps a chunk
    #: around 3 KB, well under MAX_FRAME (65535) even with long resource
    #: names / origins / stringified params
    CHUNK = 128
    #: frames in flight per connection: big batches PIPELINE their chunks
    #: (send-ahead window) so shard-side engine ticks overlap this side's
    #: encode + socket IO instead of paying a full RTT per chunk
    WINDOW = 8

    def check_batch(
        self,
        resources: Sequence[str],
        counts: Optional[Sequence[int]] = None,
        origins: Optional[Sequence[str]] = None,
        params: Optional[Sequence[Any]] = None,
        prioritized: Optional[Sequence[bool]] = None,
        **kw,
    ) -> List[Tuple[int, int]]:
        n = len(resources)
        spans = [(lo, min(lo + self.CHUNK, n)) for lo in range(0, n, self.CHUNK)]
        # distributed trace context: one wire trace id per batch (the
        # ambient one if a caller installed it, else fresh), one span id
        # per chunk — the shard host's server.res_check span adopts them,
        # so a merged dump shows every chunk's client and server halves
        # on one timeline.  Zero work when tracing is off.
        trace_id = 0
        sids: Optional[List[int]] = None
        if OT.TRACER.enabled:
            trace_id, _parent = OT.current_ctx()
            if not trace_id:
                trace_id = OT.new_trace_id()
            sids = [OT.new_span_id() for _ in spans]
        wires = [
            self._encode_chunk(
                resources[lo:hi],
                counts[lo:hi] if counts else None,
                origins[lo:hi] if origins else None,
                params[lo:hi] if params else None,
                prioritized[lo:hi] if prioritized else None,
                trace_id=trace_id,
                span_id=sids[k] if sids else 0,
            )
            for k, (lo, hi) in enumerate(spans)
        ]
        rsps = self._rpc_pipeline(wires, trace_id=trace_id, sids=sids)
        out: List[Tuple[int, int]] = []
        for (lo, hi), rsp in zip(spans, rsps):
            k = hi - lo
            if (
                rsp is not None
                and rsp.status == C.STATUS_OK
                and len(rsp.items) == k
            ):
                out.extend((int(v), int(w)) for v, w in rsp.items)
            else:
                _C_CHUNKS_DEGRADED.inc()
                # degrade THIS span: local fallback rules, else fail-open
                if self.fallback is not None:
                    out.extend(
                        self.fallback.check_batch(
                            resources[lo:hi],
                            counts=counts[lo:hi] if counts else None,
                            origins=origins[lo:hi] if origins else None,
                            params=params[lo:hi] if params else None,
                            prioritized=prioritized[lo:hi] if prioritized else None,
                            **kw,
                        )
                    )
                else:
                    out.extend([(ERR.PASS, 0)] * k)
        return out

    def _encode_chunk(
        self, resources, counts, origins, params, prioritized,
        trace_id: int = 0, span_id: int = 0,
    ) -> Optional[bytes]:
        # wire layout: 5-tuples (name, count, prio, origin, param) with the
        # param TYPED via prefix — "i:<n>" int, "s:<text>" string, "" none —
        # so hash_param's int-vs-str dispatch matches local enforcement for
        # every value (a bare marker would collide with real strings)
        flat: List[Any] = []
        for i, name in enumerate(resources):
            pv = params[i] if params else None
            if isinstance(pv, bool):
                pv = int(pv)
            if isinstance(pv, int):
                pv_s = f"i:{pv}"
            elif pv is None:
                pv_s = ""
            else:
                pv_s = f"s:{pv}"
            flat += [
                name,
                counts[i] if counts else 1,
                bool(prioritized[i]) if prioritized else False,
                (origins[i] or "") if origins else "",
                pv_s,
            ]
        # encode BEFORE touching the socket: an oversized frame is a
        # CLIENT-side problem and must not close a healthy connection or
        # trip the cool-down (same convention as ClusterTokenClient's
        # bad-request sentinel) — it degrades just this span
        try:
            self._xid += 1
            return P.encode_request(
                P.ClusterRequest(
                    xid=self._xid, type=C.MSG_TYPE_RES_CHECK, params=flat,
                    trace_id=trace_id, span_id=span_id,
                )
            )
        except ValueError:
            record_log().warning(
                "RES_CHECK chunk exceeds frame cap — degrading this span"
            )
            return None

    def _rpc_pipeline(
        self, wires, trace_id: int = 0, sids: Optional[List[int]] = None
    ) -> List[Optional[P.ClusterResponse]]:
        """Windowed request/response exchange: up to WINDOW frames on the
        wire before the first read.  The token server runs a connection's
        pipelined frames concurrently on its worker pool, so answers may
        come back out of order: each response is paired with its chunk by
        xid (the reference's pairs them by arrival order, which hands a
        chunk another chunk's verdicts; ROADMAP.md Queue C).  A response
        whose xid no chunk in flight carries desyncs the stream: it is
        transport trouble, as an undecodable frame is.

        At-most-once on failure: answered chunks keep their responses,
        and any chunk WRITTEN to a socket that subsequently failed is
        treated as possibly-processed-with-the-response-lost — it is
        NEVER re-sent (the shard may already have admitted it; replaying
        would double-count admission, and WINDOW=8 pipelining would widen
        that to up to 8 chunks / 1024 items per failure).  Those spans
        come back as None and the caller degrades them (local fallback
        rules, else fail-open pass-through, exactly like an unreachable
        shard).  Only chunks never written to a socket ride the single
        reconnect attempt."""
        m = len(wires)
        rsps: List[Optional[P.ClusterResponse]] = [None] * m
        pending = [i for i in range(m) if wires[i] is not None]
        if not pending:
            return rsps
        # a frame is its 2-byte length, then the body: xid (int32) first
        chunk_of = {struct.unpack_from(">i", wires[i], 2)[0]: i for i in pending}
        with self._lock:
            if self._hy.cooling:
                return rsps
            for attempt in (0, 1):  # one reconnect, like the netty client
                # chunks written to THIS attempt's socket; on failure they
                # are forfeited (degraded), not retried — see docstring
                inflight: List[int] = []
                t_sent: dict = {}  # chunk idx -> send stamp (tracing only)
                try:
                    if self._sock is None:
                        self._sock = self._connect()  # stlint: disable=blocking-under-lock — _lock is this connection's pipeline mutex: it serializes frames on ONE socket (the lock guards the socket itself, not shared engine state); reconnect cost is paid by the one pipelining thread
                    s = self._sock
                    queue = list(pending)
                    while queue and len(inflight) < self.WINDOW:
                        i = queue.pop(0)
                        # count as written BEFORE sendall: a mid-write
                        # failure may still deliver a parseable frame
                        inflight.append(i)
                        _t = OT.t0()
                        if _t:
                            t_sent[i] = _t
                        s.sendall(FP.pipe(_FP_SEND, wires[i]))  # stlint: disable=blocking-under-lock — _lock is this connection's pipeline mutex: it serializes frames on ONE socket (the lock guards the socket itself, not shared engine state)
                    while inflight:
                        rsp = self._read_response(s)  # stlint: disable=blocking-under-lock — _lock is this connection's pipeline mutex: it serializes frames on ONE socket (the lock guards the socket itself, not shared engine state)
                        i = chunk_of.get(rsp.xid)
                        if i not in inflight:
                            raise OSError(f"response xid {rsp.xid} answers no chunk in flight")
                        inflight.remove(i)
                        rsps[i] = rsp
                        _C_CHUNKS.inc()
                        _t = t_sent.pop(i, 0)
                        if _t:
                            # write→response of one pipelined chunk: the
                            # send-ahead WINDOW means later chunks' spans
                            # include queueing behind earlier ones
                            OT.stage(
                                "shard.chunk", _t, _H_CHUNK, trace=trace_id,
                                attrs={
                                    "chunk": i,
                                    "inflight": len(inflight),
                                    "span_id": sids[i] if sids else 0,
                                },
                            )
                        pending.remove(i)
                        if queue:
                            j = queue.pop(0)
                            inflight.append(j)
                            _t = OT.t0()
                            if _t:
                                t_sent[j] = _t
                            s.sendall(FP.pipe(_FP_SEND, wires[j]))  # stlint: disable=blocking-under-lock — _lock is this connection's pipeline mutex: it serializes frames on ONE socket (the lock guards the socket itself, not shared engine state)
                    # a full healthy exchange is the probe that heals the
                    # shard (no-op unless a prior failure entered degrade)
                    self._hy.exit()
                    return rsps
                except OSError:
                    self._close()
                    for i in inflight:
                        # possibly processed shard-side, response lost —
                        # degrade this span instead of re-admitting it
                        pending.remove(i)
                    if inflight:
                        record_log().warning(
                            "shard %s:%d failed with %d chunk(s) in flight "
                            "— degrading those spans (no replay)",
                            self.host,
                            self.port,
                            len(inflight),
                        )
                    if attempt == 1 or not pending:
                        # cool-down anchored at FAILURE time: connect
                        # timeouts can burn seconds inside the attempts,
                        # and an entry-time anchor would already be in
                        # the past, silently disabling the cool-down.
                        # Also armed when a mid-exchange failure forfeited
                        # every remaining chunk — a shard that dies after
                        # accepting the connection is as unhealthy as one
                        # that refused it, and without the cool-down every
                        # subsequent batch would re-pay the connect+write+
                        # fail latency and forfeit another window
                        self._hy.enter(cooldown_s=self.retry_interval_s)
                        record_log().warning(
                            "shard %s:%d unreachable — degrading for %.1fs",
                            self.host,
                            self.port,
                            self.retry_interval_s,
                        )
                        break
        return rsps

    def entry(self, resource: str, count: int = 1, prioritized: bool = False, **kw):
        """Single-entry surface for ShardRouter.entry: returns a handle
        whose exit is a no-op on the remote (the shard host records its own
        completions for locally-entered traffic; remote entries are
        token-style grants)."""
        v, w = self.check_batch([resource], counts=[count], prioritized=[prioritized])[0]
        if v in (ERR.PASS, ERR.PASS_WAIT):
            return _RemoteEntry()
        return None

    class stats:  # noqa: N801 — namespace matching the client surface
        @staticmethod
        def snapshot() -> dict:
            return {}

    def close(self) -> None:
        with self._lock:
            self._close()


class _RemoteEntry:
    def exit(self, count: Optional[int] = None) -> None:
        pass

    def trace(self, exc=None, count: int = 1) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.exit()
        return False
