"""Redis push datasource — a real store binding over a real wire.

The reference's sentinel-datasource-redis (RedisDataSource.java) works
like this: read the current rules from ``ruleKey`` once at startup, then
SUBSCRIBE to ``channelKey``; every published message carries the NEW rule
payload, which feeds the property listeners (the subscriber is the push
path; the key read only serves cold start).  This module reimplements
that binding with a from-scratch minimal RESP2 client (no redis library
in this image — and none needed: the protocol subset is GET, AUTH,
SELECT, SUBSCRIBE and the push frames).

Wire format (RESP2): requests are arrays of bulk strings
(``*N\\r\\n$len\\r\\n<bytes>\\r\\n``...); replies are simple strings ``+``,
errors ``-``, integers ``:``, bulk strings ``$`` and arrays ``*``.
Subscribe pushes arrive as 3-element arrays [b"message", channel, data].

Resilience: the subscriber thread reconnects with capped exponential
backoff and re-reads ``rule_key`` after every (re)connect, so missed
publishes during an outage are healed — same recovery shape as the
reference client's connection state listener.

The port's copy of ``sentinel_tpu/datasource/redis.py``; it touches no tensor.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from sentinel_tpu_torch.datasource.base import AbstractDataSource, Converter
from sentinel_tpu_torch.utils.record_log import record_log


class RespError(Exception):
    """Server replied with a RESP error (-ERR ...)."""


def encode_command(*args) -> bytes:
    """RESP array-of-bulk-strings request encoding."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        b = a if isinstance(a, bytes) else str(a).encode("utf-8")
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class _Reader:
    """Buffered RESP reply parser over a socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def _fill(self) -> None:
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("redis connection closed")
        self._buf += chunk

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            self._fill()
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            self._fill()
        data, self._buf = self._buf[:n], self._buf[n + 2 :]  # strip \r\n
        return data

    def read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode("utf-8")
        if kind == b"-":
            raise RespError(rest.decode("utf-8"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n < 0 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n < 0 else [self.read_reply() for _ in range(n)]
        raise RespError(f"unparseable RESP type byte {kind!r}")


class RedisConnection:
    """One RESP connection: connect + optional AUTH/SELECT + commands."""

    def __init__(
        self,
        host: str,
        port: int,
        password: Optional[str] = None,
        db: int = 0,
        timeout_s: float = 3.0,
    ):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.settimeout(timeout_s)
        self.reader = _Reader(self.sock)
        if password:
            self.execute("AUTH", password)
        if db:
            self.execute("SELECT", db)

    def execute(self, *args):
        self.sock.sendall(encode_command(*args))
        return self.reader.read_reply()

    def close(self) -> None:
        # shutdown first: close() alone does not wake a recv blocked on
        # this socket in another thread (the subscriber's read)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class RedisDataSource(AbstractDataSource):
    """Push-mode rule source bound to a redis server.

    - cold start / reconnect: ``GET rule_key`` seeds the property
    - live: ``SUBSCRIBE channel``; each message's payload IS the new rule
      content (reference publish convention, RedisDataSource.java)

    ``start()`` spawns the subscriber daemon; ``close()`` stops it.
    """

    def __init__(
        self,
        parser: Converter,
        host: str,
        port: int,
        rule_key: str,
        channel: str,
        password: Optional[str] = None,
        db: int = 0,
        reconnect_backoff_s: float = 0.2,
        max_backoff_s: float = 5.0,
    ):
        super().__init__(parser)
        self.host = host
        self.port = port
        self.rule_key = rule_key
        self.channel = channel
        self.password = password
        self.db = db
        self._backoff0 = reconnect_backoff_s
        self._max_backoff = max_backoff_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sub_conn: Optional[RedisConnection] = None
        self._connected = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self, timeout_s: float = 5.0) -> "RedisDataSource":
        self._thread = threading.Thread(
            target=self._run, name="sentinel-redis-ds", daemon=True
        )
        self._thread.start()
        self._connected.wait(timeout_s)
        return self

    def close(self) -> None:
        self._stop.set()
        conn = self._sub_conn  # snapshot: the thread's finally may None it
        if conn is not None:
            conn.close()  # unblocks the subscriber's blocking read
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def read_source(self) -> Optional[str]:
        conn = RedisConnection(self.host, self.port, self.password, self.db)
        try:
            raw = conn.execute("GET", self.rule_key)
            return raw.decode("utf-8") if raw is not None else None
        finally:
            conn.close()

    # -- subscriber loop ----------------------------------------------------

    def _push(self, source: Optional[str]) -> None:
        """Feed a payload to the property; a malformed payload is LOGGED,
        never allowed to tear down the subscription (the reference's
        datasources log converter errors and keep listening)."""
        if source is None:
            return  # key absent — keep current rules (reference null-check)
        try:
            value = self.load_config(source)
        except Exception as e:  # noqa: BLE001 — bad payload, keep old rules
            record_log().warning(
                "redis datasource %s: unparseable rule payload ignored (%s)",
                self.rule_key,
                e,
            )
            return
        self.get_property().update_value(value)

    def _run(self) -> None:
        backoff = self._backoff0
        while not self._stop.is_set():
            try:
                sub = RedisConnection(self.host, self.port, self.password, self.db)
                self._sub_conn = sub
                # seed / heal from the key, then enter push mode
                self._push(self.read_source())
                reply = sub.execute("SUBSCRIBE", self.channel)
                if not (isinstance(reply, list) and reply[0] == b"subscribe"):
                    raise RespError(f"unexpected SUBSCRIBE reply: {reply!r}")
                self._connected.set()
                backoff = self._backoff0
                # Block indefinitely between frames: a read timeout would
                # desynchronize the RESP parser mid-frame (read_reply is
                # not resumable).  close() unblocks the read by closing
                # the socket.
                sub.sock.settimeout(None)
                while not self._stop.is_set():
                    msg = sub.reader.read_reply()
                    if (
                        isinstance(msg, list)
                        and len(msg) == 3
                        and msg[0] == b"message"
                    ):
                        data = msg[2]
                        self._push(
                            data.decode("utf-8") if data is not None else None
                        )
            except Exception as e:  # noqa: BLE001 — reconnect on any failure
                if self._stop.is_set():
                    break
                record_log().warning(
                    "redis datasource %s:%s disconnected (%s); retrying in %.1fs",
                    self.host,
                    self.port,
                    e,
                    backoff,
                )
                self._stop.wait(backoff)
                backoff = min(backoff * 2, self._max_backoff)
            finally:
                conn, self._sub_conn = self._sub_conn, None
                if conn is not None:
                    conn.close()
