"""Binary frame codec for the cluster token protocol.

The port's copy of ``sentinel_tpu/cluster/protocol.py``: every frame is
byte-identical to the reference's.

Framing: every frame is ``[len:uint16 BE][body]`` — the shape the
reference's Netty pipeline decodes with
``LengthFieldBasedFrameDecoder(1024, 0, 2, 0, 2)`` + ``LengthFieldPrepender(2)``
(NettyTransportServer.java:88-93).

Request body:  ``[xid:int32][type:uint8][payload]``
Response body: ``[xid:int32][type:uint8][status:int8][payload]``

Payloads (big-endian, mirroring the reference entity writers):
  PING               → [namespace:utf8]               (registers the connection)
  FLOW               → [flowId:int64][count:int32][priority:uint8]
                       (FlowRequestData.java:24-26)
  PARAM_FLOW         → [flowId:int64][count:int32][params…] with each param
                       type-tagged (ParamFlowRequestDataWriter semantics:
                       only primitives/strings serialize; others dropped)
  CONCURRENT_ACQUIRE → [flowId:int64][count:int32][prioritized:uint8]
  CONCURRENT_RELEASE → [tokenId:int64]
  LEASE              → [flowId:int64][units:int32][reserved:uint8]
                       (bounded-slack budget lease, the reference's
                       cluster/shard.py;
                       response: granted k in `remaining`, validity
                       window ms in `waitMs`)

  flow/param response       → [remaining:int32][waitMs:int32]
  concurrent acquire resp   → [tokenId:int64]
  others                    → empty

v2 BATCH frame layout (MSG_TYPE_BATCH, version-negotiated via HELLO —
a v1 peer never receives one; all v1 frames above stay byte-identical):

  request  → [xid:int32][type=14:uint8][n:uint16]
             n × [kind:uint8][id:int64][count:int32][flags:uint8]   (14 B)
             [optional 17-byte trace tail]
  response → [xid:int32][type=14:uint8][status:int8][n:uint16]
             n × [status:int8][remaining:int32][waitMs:int32][tokenId:int64]  (17 B)
             [optional v3 _T_PROV deny-provenance block — see _T_PROV]
             [optional 17-byte trace tail]

Entry columns are fixed-width big-endian, so pack/unpack is a single
zero-copy reinterpret (native sx_frame_* or a numpy structured-dtype
fallback — byte-identical by construction).  Decoding validates the
EXACT frame length (header + n×entry + optional tail): a corrupt or
short-read frame raises and the WHOLE frame fails closed — partial
answers are never applied.

  HELLO    → request  [version:uint8];  response carries the server's
             version in `remaining`.  A v1 server drops the unknown
             frame (client's HELLO times out → keeps speaking v1).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.native import ring as _NR
from sentinel_tpu_torch.obs.explain import fx_decode, fx_encode
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS

MAX_FRAME = 65535  # 2-byte length prefix ceiling; RES_CHECK batches chunk
# client-side (the reference's parallel/remote_shard.py), so ordinary
# frames stay small

#: wire byte accounting at THE codec choke point (every cluster frame —
#: client and server, requests and responses — passes through exactly one
#: encode and one decode), frame-length-prefix included.  Same metric name
#: as the host<->device accounting in runtime/client.py; the path label
#: separates them.
_WIRE_HELP = "bytes moved, by path (device|cluster) and direction (tx|rx)"
_C_WIRE_TX = _OBS.counter(
    "sentinel_wire_bytes_total", _WIRE_HELP,
    labels={"path": "cluster", "direction": "tx"},
)
_C_WIRE_RX = _OBS.counter(
    "sentinel_wire_bytes_total", _WIRE_HELP,
    labels={"path": "cluster", "direction": "rx"},
)

#: v2 BATCH frames through the codec — the RPC-coalescing win is visible
#: as this counter rising while per-decision RPC counts fall
_BATCH_HELP = "protocol v2 BATCH frames encoded/decoded, by direction"
_C_BATCH_TX = _OBS.counter(
    "sentinel_cluster_batch_frames_total", _BATCH_HELP, labels={"direction": "tx"}
)
_C_BATCH_RX = _OBS.counter(
    "sentinel_cluster_batch_frames_total", _BATCH_HELP, labels={"direction": "rx"}
)

# param type tags
_T_INT = 0
_T_LONG = 1
_T_DOUBLE = 2
_T_STRING = 3
_T_BOOL = 4
#: trace-context tag: a 17-byte ``[0x07][trace_id:u64][span_id:u64]``
#: block.  In variable-payload frames (PARAM_FLOW / RES_CHECK) it rides
#: the param stream as a final tagged element; in fixed-payload frames
#: it is an optional tail after the known payload size.  Version
#: tolerance: frames WITHOUT the block are byte-identical to the pre-
#: trace format (tracing-off peers interoperate bit-exactly with any
#: version), an old fixed-offset reader skips the tail of a traced
#: frame, and a reader that has never seen tag 7 rejects only traced
#: variable frames — which the transport already treats as a dropped
#: malformed frame (caller times out and degrades, never crashes).
_T_TRACE = 7
_TRACE_BLOCK = struct.Struct(">BQQ")
#: deny-provenance tag (protocol v3): an optional block in BATCH
#: responses — ``[0x08][count:u16]`` then ``count`` records of
#: ``[entry_idx:u16][kind:u8][rule:u64][observed:u32][limit:u32]``,
#: one per BLOCKED entry whose cause the server knows.  observed/limit
#: use the obs/explain.py fixed-point encoding (×256, 0xFFFFFFFF =
#: unknown) — the same words the device explain records carry, so a
#: remote block folds into the provenance plane exactly like a local
#: one.  Placement: after the result slab, BEFORE the trace tail.  Sent
#: only when the client requested it (BATCH_FLAG_EXPLAIN, v3+ peers);
#: frames without it are byte-identical to v2.
_T_PROV = 8
_PROV_HEAD = struct.Struct(">BH")
_PROV_ENTRY = struct.Struct(">HBQII")


@dataclass
class ClusterRequest:
    xid: int
    type: int
    flow_id: int = 0
    count: int = 1
    priority: bool = False
    token_id: int = 0
    namespace: str = ""
    params: List[Any] = field(default_factory=list)
    # distributed-trace context (0 = absent; see _T_TRACE above)
    trace_id: int = 0
    span_id: int = 0


@dataclass
class ClusterResponse:
    xid: int
    type: int
    status: int
    remaining: int = 0
    wait_ms: int = 0
    token_id: int = 0
    items: List[tuple] = field(default_factory=list)  # RES_CHECK verdicts
    # trace context echoed from the request (0 = absent)
    trace_id: int = 0
    span_id: int = 0


def _trace_tail(trace_id: int, span_id: int) -> bytes:
    """Optional 17-byte trace block; empty when no context is attached —
    untraced frames stay byte-identical to the legacy format."""
    if not trace_id:
        return b""
    return _TRACE_BLOCK.pack(_T_TRACE, trace_id & 2**64 - 1, span_id & 2**64 - 1)


def _read_trace_tail(p: bytes, off: int) -> Tuple[int, int]:
    """Trace block at ``off`` if present, else ``(0, 0)`` (legacy frame)."""
    if len(p) >= off + _TRACE_BLOCK.size and p[off] == _T_TRACE:
        _tag, tid, sid = _TRACE_BLOCK.unpack_from(p, off)
        return tid, sid
    return 0, 0


def _pack_params(params: List[Any]) -> bytes:
    out = bytearray()
    for p in params:
        # bool before int: bool is an int subclass in Python
        if isinstance(p, bool):
            out += struct.pack(">BB", _T_BOOL, 1 if p else 0)
        elif isinstance(p, int):
            if -(2**31) <= p < 2**31:
                out += struct.pack(">Bi", _T_INT, p)
            else:
                out += struct.pack(">Bq", _T_LONG, p)
        elif isinstance(p, float):
            out += struct.pack(">Bd", _T_DOUBLE, p)
        elif isinstance(p, str):
            b = p.encode("utf-8")
            out += struct.pack(">BH", _T_STRING, len(b)) + b
        # unsupported types are silently dropped (ParamFlowRequestDataWriter)
    return bytes(out)


def _unpack_params(buf: bytes) -> Tuple[List[Any], int, int]:
    """Decode a tagged param stream; returns ``(params, trace_id,
    span_id)`` — the trace block (tag 7) is surfaced out-of-band, never
    as a param value."""
    out: List[Any] = []
    trace_id = span_id = 0
    i = 0
    while i < len(buf):
        tag = buf[i]
        if tag == _T_TRACE:
            tid, sid = _read_trace_tail(buf, i)
            if tid:
                trace_id, span_id = tid, sid
                i += _TRACE_BLOCK.size
                continue
        i += 1
        if tag == _T_INT:
            out.append(struct.unpack_from(">i", buf, i)[0])
            i += 4
        elif tag == _T_LONG:
            out.append(struct.unpack_from(">q", buf, i)[0])
            i += 8
        elif tag == _T_DOUBLE:
            out.append(struct.unpack_from(">d", buf, i)[0])
            i += 8
        elif tag == _T_STRING:
            (n,) = struct.unpack_from(">H", buf, i)
            i += 2
            out.append(buf[i : i + n].decode("utf-8"))
            i += n
        elif tag == _T_BOOL:
            out.append(buf[i] != 0)
            i += 1
        else:
            raise ValueError(f"bad param tag {tag}")
    return out, trace_id, span_id


def encode_request(req: ClusterRequest) -> bytes:
    head = struct.pack(">iB", req.xid, req.type)
    t = req.type
    tail = _trace_tail(req.trace_id, req.span_id)
    if t == C.MSG_TYPE_PING:
        # PING's payload is the raw namespace string (whole remainder) —
        # no room for a skippable tail, and registration needs no trace
        payload = req.namespace.encode("utf-8")
    elif t in (C.MSG_TYPE_FLOW, C.MSG_TYPE_FLOW_BATCH, C.MSG_TYPE_LEASE):
        payload = struct.pack(">qiB", req.flow_id, req.count, 1 if req.priority else 0) + tail
    elif t == C.MSG_TYPE_PARAM_FLOW:
        payload = struct.pack(">qi", req.flow_id, req.count) + _pack_params(req.params) + tail
    elif t == C.MSG_TYPE_CONCURRENT_ACQUIRE:
        payload = struct.pack(">qiB", req.flow_id, req.count, 1 if req.priority else 0) + tail
    elif t == C.MSG_TYPE_CONCURRENT_RELEASE:
        payload = struct.pack(">q", req.token_id) + tail
    elif t == C.MSG_TYPE_RES_CHECK:
        # params = flat 5-tuples (name, count, prio, origin, typed-param)
        payload = _pack_params(req.params) + tail
    elif t == C.MSG_TYPE_HELLO:
        # version negotiation: the speaker's protocol version in `count`
        payload = struct.pack(">B", req.count & 0xFF) + tail
    else:
        raise ValueError(f"bad request type {t}")
    body = head + payload
    if len(body) > MAX_FRAME:
        raise ValueError("frame too large")
    _C_WIRE_TX.inc(len(body) + 2)
    return struct.pack(">H", len(body)) + body


def decode_request(body: bytes) -> ClusterRequest:
    _C_WIRE_RX.inc(len(body) + 2)  # +2: the stripped length prefix
    xid, t = struct.unpack_from(">iB", body, 0)
    p = body[5:]
    req = ClusterRequest(xid=xid, type=t)
    if t == C.MSG_TYPE_PING:
        req.namespace = p.decode("utf-8") if p else C.DEFAULT_NAMESPACE
    elif t in (
        C.MSG_TYPE_FLOW,
        C.MSG_TYPE_FLOW_BATCH,
        C.MSG_TYPE_CONCURRENT_ACQUIRE,
        C.MSG_TYPE_LEASE,
    ):
        req.flow_id, req.count, prio = struct.unpack_from(">qiB", p, 0)
        req.priority = prio != 0
        req.trace_id, req.span_id = _read_trace_tail(p, 13)
    elif t == C.MSG_TYPE_PARAM_FLOW:
        req.flow_id, req.count = struct.unpack_from(">qi", p, 0)
        req.params, req.trace_id, req.span_id = _unpack_params(p[12:])
    elif t == C.MSG_TYPE_CONCURRENT_RELEASE:
        (req.token_id,) = struct.unpack_from(">q", p, 0)
        req.trace_id, req.span_id = _read_trace_tail(p, 8)
    elif t == C.MSG_TYPE_RES_CHECK:
        req.params, req.trace_id, req.span_id = _unpack_params(p)
    elif t == C.MSG_TYPE_HELLO:
        req.count = p[0] if p else 1
        req.trace_id, req.span_id = _read_trace_tail(p, 1)
    else:
        raise ValueError(f"bad request type {t}")
    return req


def encode_response(rsp: ClusterResponse) -> bytes:
    head = struct.pack(">iBb", rsp.xid, rsp.type, rsp.status)
    if rsp.type in (
        C.MSG_TYPE_FLOW,
        C.MSG_TYPE_PARAM_FLOW,
        C.MSG_TYPE_FLOW_BATCH,
        C.MSG_TYPE_LEASE,
        C.MSG_TYPE_HELLO,  # v2 extension: server version in `remaining`
    ):
        payload = struct.pack(">ii", rsp.remaining, rsp.wait_ms)
    elif rsp.type == C.MSG_TYPE_CONCURRENT_ACQUIRE:
        payload = struct.pack(">q", rsp.token_id)
    elif rsp.type == C.MSG_TYPE_RES_CHECK:
        payload = struct.pack(">i", len(rsp.items)) + b"".join(
            struct.pack(">bi", v, w) for v, w in rsp.items
        )
    else:
        payload = b""
    # every response payload is either fixed-size or count-bounded, so an
    # appended trace tail is skipped cleanly even by a legacy reader
    body = head + payload + _trace_tail(rsp.trace_id, rsp.span_id)
    _C_WIRE_TX.inc(len(body) + 2)
    return struct.pack(">H", len(body)) + body


def decode_response(body: bytes) -> ClusterResponse:
    _C_WIRE_RX.inc(len(body) + 2)  # +2: the stripped length prefix
    xid, t, status = struct.unpack_from(">iBb", body, 0)
    p = body[6:]
    rsp = ClusterResponse(xid=xid, type=t, status=status)
    tail_off = 0
    if (
        t
        in (
            C.MSG_TYPE_FLOW,
            C.MSG_TYPE_PARAM_FLOW,
            C.MSG_TYPE_FLOW_BATCH,
            C.MSG_TYPE_LEASE,
            C.MSG_TYPE_HELLO,  # v2 extension: peer version in `remaining`
        )
        and len(p) >= 8
    ):
        rsp.remaining, rsp.wait_ms = struct.unpack_from(">ii", p, 0)
        tail_off = 8
    elif t == C.MSG_TYPE_CONCURRENT_ACQUIRE and len(p) >= 8:
        (rsp.token_id,) = struct.unpack_from(">q", p, 0)
        tail_off = 8
    elif t == C.MSG_TYPE_RES_CHECK and len(p) >= 4:
        (n,) = struct.unpack_from(">i", p, 0)
        off = 4
        # bounds-checked: a truncated/hostile frame yields a SHORT item
        # list (the caller length-checks and degrades), not struct.error
        for _ in range(max(n, 0)):
            if off + 5 > len(p):
                break
            v, w = struct.unpack_from(">bi", p, off)
            off += 5
            rsp.items.append((v, w))
        tail_off = off
    rsp.trace_id, rsp.span_id = _read_trace_tail(p, tail_off)
    return rsp


# ---------------------------------------------------------------------------
# protocol v2: BATCH frames (column entries, zero-copy pack/unpack)
# ---------------------------------------------------------------------------

_BATCH_REQ_HEAD = struct.Struct(">iBH")  # xid, type, n
_BATCH_RSP_HEAD = struct.Struct(">iBbH")  # xid, type, frame status, n


@dataclass
class ClusterBatchRequest:
    """One v2 frame carrying many flows' token requests as columns."""

    xid: int
    kinds: np.ndarray  # uint8[n] — C.BATCH_KIND_*
    ids: np.ndarray  # int64[n] — flow ids
    counts: np.ndarray  # int32[n] — units requested
    flags: np.ndarray  # uint8[n] — C.BATCH_FLAG_*
    trace_id: int = 0
    span_id: int = 0

    def __len__(self) -> int:
        return len(self.kinds)


@dataclass
class ClusterBatchResponse:
    """Per-entry verdict columns; ``status`` is the WHOLE-frame status
    (non-OK ⇒ no entry was applied — fail closed, never partially)."""

    xid: int
    status: int
    statuses: np.ndarray  # int8[n] — C.STATUS_* per entry
    remainings: np.ndarray  # int32[n] — granted units / remaining
    waits: np.ndarray  # int32[n] — wait/TTL ms per entry
    token_ids: np.ndarray  # int64[n] — concurrent token ids (0 otherwise)
    trace_id: int = 0
    span_id: int = 0
    # v3 deny provenance, entry-aligned: ``prov[i]`` is ``(kind, rule,
    # observed|None, limit|None)`` for a BLOCKED entry whose cause the
    # server knows, else None; the whole field is None on v2 frames
    prov: Optional[List[Optional[Tuple[int, int, Optional[float], Optional[float]]]]] = None

    def __len__(self) -> int:
        return len(self.statuses)


def encode_batch_request(req: ClusterBatchRequest) -> bytes:
    n = len(req.kinds)
    if not 0 < n <= C.MAX_BATCH_ENTRIES:
        raise ValueError(f"bad batch size {n}")
    body = (
        _BATCH_REQ_HEAD.pack(req.xid, C.MSG_TYPE_BATCH, n)
        + _NR.pack_batch_entries(req.kinds, req.ids, req.counts, req.flags)
        + _trace_tail(req.trace_id, req.span_id)
    )
    if len(body) > MAX_FRAME:
        raise ValueError("frame too large")
    _C_WIRE_TX.inc(len(body) + 2)
    _C_BATCH_TX.inc()
    return struct.pack(">H", len(body)) + body


def _prov_tail(prov) -> bytes:
    """Optional v3 deny-provenance block (entry-aligned list as stored on
    ClusterBatchResponse.prov); empty when no entry has provenance — the
    frame stays byte-identical to v2."""
    if not prov:
        return b""
    recs = [(i, pv) for i, pv in enumerate(prov) if pv is not None]
    if not recs:
        return b""
    out = bytearray(_PROV_HEAD.pack(_T_PROV, len(recs)))
    for i, (kind, rule, observed, limit) in recs:
        out += _PROV_ENTRY.pack(
            i,
            int(kind) & 0xFF,
            int(rule) & 2**64 - 1,
            fx_encode(observed),
            fx_encode(limit),
        )
    return bytes(out)


def _batch_payload(
    p: bytes, n: int, entry_size: int
) -> Tuple[bytes, int, int, Optional[list]]:
    """Strict-length entry slab + optional blocks.  The remainder after
    the count header must be EXACTLY ``n`` entries, optionally followed
    by a well-formed _T_PROV block (v3) and/or trace block — anything
    else (bit-flipped count byte, short read, trailing garbage) raises,
    and the caller rejects the whole frame: a corrupted BATCH frame
    never yields partial answers."""
    want = n * entry_size
    if len(p) < want:
        raise ValueError(f"bad batch frame length {len(p)} for {n} entries")
    off = want
    prov: Optional[list] = None
    if off < len(p) and p[off] == _T_PROV:
        if off + _PROV_HEAD.size > len(p):
            raise ValueError("truncated prov block")
        _tag, k = _PROV_HEAD.unpack_from(p, off)
        off += _PROV_HEAD.size
        if k > n or off + k * _PROV_ENTRY.size > len(p):
            raise ValueError(f"bad prov block count {k} for {n} entries")
        prov = [None] * n
        for _ in range(k):
            idx, kind, rule, obs_w, lim_w = _PROV_ENTRY.unpack_from(p, off)
            off += _PROV_ENTRY.size
            if idx >= n:
                raise ValueError(f"prov entry index {idx} out of range")
            prov[idx] = (kind, rule, fx_decode(obs_w), fx_decode(lim_w))
    tid = sid = 0
    if off < len(p):
        if len(p) == off + _TRACE_BLOCK.size and p[off] == _T_TRACE:
            tid, sid = _read_trace_tail(p, off)
        else:
            raise ValueError(f"bad batch frame length {len(p)} for {n} entries")
    return p[:want], tid, sid, prov


def decode_batch_request(body: bytes) -> ClusterBatchRequest:
    _C_WIRE_RX.inc(len(body) + 2)
    _C_BATCH_RX.inc()
    xid, t, n = _BATCH_REQ_HEAD.unpack_from(body, 0)
    if t != C.MSG_TYPE_BATCH:
        raise ValueError(f"not a batch frame (type {t})")
    if not 0 < n <= C.MAX_BATCH_ENTRIES:
        raise ValueError(f"bad batch size {n}")
    slab, tid, sid, _ = _batch_payload(body[_BATCH_REQ_HEAD.size :], n, _NR.BATCH_ENTRY_SIZE)
    kinds, ids, counts, flags = _NR.unpack_batch_entries(slab)
    return ClusterBatchRequest(
        xid=xid, kinds=kinds, ids=ids, counts=counts, flags=flags,
        trace_id=tid, span_id=sid,
    )


def encode_batch_response(rsp: ClusterBatchResponse) -> bytes:
    n = len(rsp.statuses)
    body = _BATCH_RSP_HEAD.pack(rsp.xid, C.MSG_TYPE_BATCH, rsp.status, n)
    if n:
        body += _NR.pack_batch_results(
            rsp.statuses, rsp.remainings, rsp.waits, rsp.token_ids
        )
        body += _prov_tail(rsp.prov)
    body += _trace_tail(rsp.trace_id, rsp.span_id)
    if len(body) > MAX_FRAME:
        raise ValueError("frame too large")
    _C_WIRE_TX.inc(len(body) + 2)
    _C_BATCH_TX.inc()
    return struct.pack(">H", len(body)) + body


def decode_batch_response(body: bytes) -> ClusterBatchResponse:
    _C_WIRE_RX.inc(len(body) + 2)
    _C_BATCH_RX.inc()
    xid, t, status, n = _BATCH_RSP_HEAD.unpack_from(body, 0)
    if t != C.MSG_TYPE_BATCH:
        raise ValueError(f"not a batch frame (type {t})")
    if not 0 <= n <= C.MAX_BATCH_ENTRIES:
        raise ValueError(f"bad batch size {n}")
    slab, tid, sid, prov = _batch_payload(body[_BATCH_RSP_HEAD.size :], n, _NR.BATCH_RESULT_SIZE)
    statuses, remainings, waits, tokens = _NR.unpack_batch_results(slab)
    return ClusterBatchResponse(
        xid=xid, status=status, statuses=statuses, remainings=remainings,
        waits=waits, token_ids=tokens, trace_id=tid, span_id=sid, prov=prov,
    )


def peek_type(body: bytes) -> int:
    """Frame type byte without a full decode (offset 4 in both request
    and response bodies) — lets transport loops route BATCH frames to
    the column codec and everything else to the legacy one."""
    return body[4] if len(body) >= 5 else -1


class FrameReader:
    """Incremental 2-byte-length-prefixed frame splitter."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        frames = []
        while True:
            if len(self._buf) < 2:
                break
            (n,) = struct.unpack_from(">H", self._buf, 0)
            if len(self._buf) < 2 + n:
                break
            frames.append(bytes(self._buf[2 : 2 + n]))
            del self._buf[: 2 + n]
        return frames
