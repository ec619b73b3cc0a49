"""ZooKeeper datasource over a minimal native wire client.

The reference binding (sentinel-datasource-zookeeper/.../
ZookeeperDataSource.java:1) rides Curator's NodeCache: an initial getData
on the rule path plus a data watcher that re-reads on change.  No ZK
client library ships in this image, so this module speaks the ZooKeeper
jute wire protocol directly — the small subset the datasource needs:

  * session handshake (ConnectRequest/ConnectResponse)
  * getData(path, watch=true)  [op 4]
  * exists(path, watch=true)   [op 3]  — for a not-yet-created rule node
  * ping                       [op 11, xid -2]
  * watcher events             [xid -1: re-arm + re-read]

Framing: every packet is a 4-byte big-endian length prefix; ints/longs
big-endian; strings/buffers are length-prefixed (-1 = null).  A reader
thread dispatches replies by xid and fires the datasource re-read on
watch events, giving the same push semantics as the reference's
NodeCacheListener.

The port's copy of ``sentinel_tpu/datasource/zookeeper.py``; it touches no tensor.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

from sentinel_tpu_torch.datasource.base import AbstractDataSource, Converter

OP_EXISTS = 3
OP_GET_DATA = 4
OP_PING = 11
XID_WATCHER = -1
XID_PING = -2
ERR_NONODE = -101


def _record(msg: str, *args, exc: bool = False) -> None:
    from sentinel_tpu_torch.utils.record_log import record_log

    record_log().info(msg, *args, exc_info=exc)


class _Buf:
    """jute reader over one received frame."""

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def i32(self) -> int:
        (v,) = struct.unpack_from(">i", self.d, self.o)
        self.o += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from(">q", self.d, self.o)
        self.o += 8
        return v

    def buf(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        v = self.d[self.o : self.o + n]
        self.o += n
        return v


def _ustr(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">i", len(b)) + b


class ZkClient:
    """Single-session ZooKeeper wire client (subset; see module doc)."""

    def __init__(
        self,
        host: str,
        port: int,
        session_timeout_ms: int = 30000,
        watch_cb: Optional[Callable[[str], None]] = None,
    ):
        self.watch_cb = watch_cb
        self._sock = socket.create_connection((host, port), timeout=10.0)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._xid = 0
        self._pending: Dict[int, Tuple[threading.Event, list]] = {}
        self._plock = threading.Lock()
        self._closed = threading.Event()
        # ConnectRequest: protoVersion, lastZxidSeen, timeOut, sessionId, passwd
        req = (
            struct.pack(">iqiq", 0, 0, session_timeout_ms, 0)
            + struct.pack(">i", 16)
            + b"\x00" * 16
        )
        self._send_frame(req)
        frame = self._recv_frame()
        b = _Buf(frame)
        b.i32()  # protocolVersion
        self.negotiated_timeout = b.i32()
        self.session_id = b.i64()
        self._reader = threading.Thread(
            target=self._read_loop, name="sentinel-zk-reader", daemon=True
        )
        self._reader.start()
        self._pinger = threading.Thread(
            target=self._ping_loop, name="sentinel-zk-ping", daemon=True
        )
        self._pinger.start()

    # -- framing ------------------------------------------------------------

    def _send_frame(self, payload: bytes) -> None:
        with self._wlock:
            self._sock.sendall(struct.pack(">i", len(payload)) + payload)  # stlint: disable=blocking-under-lock — _wlock is the frame-write lock: serializing sendall is its purpose; replies ride the reader thread under _plock

    def _recv_frame(self) -> bytes:
        hdr = self._recv_n(4)
        (n,) = struct.unpack(">i", hdr)
        return self._recv_n(n)

    def _recv_n(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("zookeeper connection closed")
            out += chunk
        return out

    # -- request/reply ------------------------------------------------------

    def _call(self, op: int, payload: bytes, timeout: float = 10.0) -> _Buf:
        with self._plock:
            self._xid += 1
            xid = self._xid
            evt: Tuple[threading.Event, list] = (threading.Event(), [])
            self._pending[xid] = evt
        self._send_frame(struct.pack(">ii", xid, op) + payload)
        if not evt[0].wait(timeout):
            with self._plock:
                self._pending.pop(xid, None)
            raise TimeoutError(f"zookeeper op {op} timed out")
        frame = evt[1][0]
        b = _Buf(frame)
        b.i32()  # xid
        b.i64()  # zxid
        err = b.i32()
        return b if err == 0 else self._raise(err)

    @staticmethod
    def _raise(err: int):
        if err == ERR_NONODE:
            raise KeyError("NoNode")
        raise OSError(f"zookeeper error {err}")

    def _read_loop(self) -> None:
        try:
            while not self._closed.is_set():
                frame = self._recv_frame()
                (xid,) = struct.unpack_from(">i", frame, 0)
                if xid == XID_WATCHER:
                    b = _Buf(frame)
                    b.i32()  # xid
                    b.i64()  # zxid
                    b.i32()  # err
                    b.i32()  # event type
                    b.i32()  # state
                    path = (b.buf() or b"").decode("utf-8")
                    if self.watch_cb is not None:
                        # OFF the reader thread: the callback re-reads the
                        # node (get_data), whose reply only the reader can
                        # deliver — calling back inline would deadlock
                        threading.Thread(
                            target=self._run_watch_cb,
                            args=(path,),
                            name="sentinel-zk-watch",
                            daemon=True,
                        ).start()
                    continue
                if xid == XID_PING:
                    continue
                with self._plock:
                    evt = self._pending.pop(xid, None)
                if evt is not None:
                    evt[1].append(frame)
                    evt[0].set()
        except Exception:
            if not self._closed.is_set():
                _record("[zk] reader loop ended", exc=True)
            # unblock every waiter (they'll observe the closed connection)
            with self._plock:
                for evt, _f in list(self._pending.values()):
                    evt.set()
                self._pending.clear()

    def _run_watch_cb(self, path: str) -> None:
        try:
            self.watch_cb(path)
        except Exception:
            _record("[zk] watch callback failed", exc=True)

    def _ping_loop(self) -> None:
        interval = max(self.negotiated_timeout / 3000.0, 1.0)
        while not self._closed.wait(interval):
            try:
                self._send_frame(struct.pack(">ii", XID_PING, OP_PING))
            except Exception:
                return

    # -- ops ----------------------------------------------------------------

    def get_data(self, path: str, watch: bool = False) -> bytes:
        b = self._call(OP_GET_DATA, _ustr(path) + (b"\x01" if watch else b"\x00"))
        return b.buf() or b""

    def exists(self, path: str, watch: bool = False) -> bool:
        try:
            self._call(OP_EXISTS, _ustr(path) + (b"\x01" if watch else b"\x00"))
            return True
        except KeyError:
            return False

    def close(self) -> None:
        self._closed.set()
        # shutdown first: close() alone does not wake the reader thread's
        # blocked recv
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class ZookeeperDataSource(AbstractDataSource):
    """getData + data watch on one rule node (ZookeeperDataSource.java:1,
    NodeCache semantics): initial read arms the watch; every fired watch
    re-reads AND re-arms (ZK watches are one-shot); a missing node arms an
    exists-watch and publishes when it appears."""

    def __init__(
        self,
        server_addr: str,  # host:port
        path: str,
        parser: Converter,
    ):
        if not path:
            raise ValueError("path can't be empty")
        super().__init__(parser)
        self.path = path
        host, _, port = server_addr.partition(":")
        self._zk = ZkClient(host, int(port or 2181), watch_cb=self._on_watch)
        self._refresh()

    def read_source(self) -> str:
        return self._zk.get_data(self.path, watch=True).decode("utf-8")

    def _refresh(self) -> None:
        try:
            self._property.update_value(self.load_config())
        except KeyError:
            # node absent: watch for creation instead
            self._zk.exists(self.path, watch=True)
        except Exception:
            _record("[zk-datasource] refresh failed", exc=True)

    def _on_watch(self, path: str) -> None:
        if path == self.path:
            self._refresh()

    def close(self) -> None:
        self._zk.close()
