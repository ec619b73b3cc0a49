"""The port's remote and store datasources (``datasource/remote.py``,
``redis.py``, ``zookeeper.py``, ``stores.py``) against the JAX package's.

Each datasource of each package runs against its own instance of the
same in-process stub on 127.0.0.1 (this file's copies of the reference
tests' stubs: the HTTP handlers of tests/test_store_datasources.py and
tests/test_remote_datasource.py, ``StubRedis`` of
tests/test_redis_datasource.py, ``FakeZkServer``), with the same script:
an initial read, a change pushed by the store, the re-read.  Held equal:

- the request sequence each stub saw (method, path, query, the headers
  and body fields the protocol keys on: ETag, MD5, blocking index,
  notification id, base64 key, RESP commands, jute ops), with repeats of
  one long poll folded into one (how many polls a hold spans is timing);
- every value the datasource published to its property;
- RESP: ``encode_command`` over varied arguments byte for byte, and the
  reply parser on the same bytes;
- a push through Redis, ZooKeeper and Nacos flips enforcement on a sync
  port client on virtual time exactly as on the JAX client: equal verdict
  counts before and after;
- ``datasource.store.watch`` armed to raise: the loop logs, backs off and
  serves the next change, as the reference's does;
- every datasource's threads end on ``close()``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import socketserver
import struct
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu import chaos as JCH
from sentinel_tpu import datasource as JDS
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.datasource import redis as JR
from sentinel_tpu.datasource import stores as JS
from sentinel_tpu.datasource import zookeeper as JZ
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import chaos as TCH
from sentinel_tpu_torch import datasource as TDS
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.datasource import redis as TR
from sentinel_tpu_torch.datasource import stores as TS
from sentinel_tpu_torch.datasource import zookeeper as TZ
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

#: (datasource package, stores, redis, zookeeper, chaos) of each side
JAX = (JDS, JS, JR, JZ, JCH)
PORT = (TDS, TS, TR, TZ, TCH)
#: how long a stub holds a long poll before answering "no change"
HOLD_S = 0.3


class _Log:
    """The requests a stub saw, in order, with a wait for a condition."""

    def __init__(self):
        self.reqs = []
        self._cv = threading.Condition()

    def add(self, req):
        with self._cv:
            self.reqs.append(req)
            self._cv.notify_all()

    def wait_for(self, pred, timeout=8.0):
        with self._cv:
            return self._cv.wait_for(lambda: pred(self.reqs), timeout)

    def folded(self):
        """Consecutive repeats of one request folded into one."""
        out = []
        for r in self.reqs:
            if not out or out[-1] != r:
                out.append(r)
        return out


def _serve(handler_cls):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _collect(ds, listener_cls):
    got = []
    evt = threading.Event()

    def on(v):
        got.append(v)
        evt.set()

    ds.get_property().add_listener(listener_cls(on))
    return got, evt


def _wait(evt, got, pred, timeout=8.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if got and pred(got[-1]):
            return True
        evt.clear()
        evt.wait(0.05)
    return False


def _threads(ds):
    """The threads a datasource runs."""
    out = [getattr(ds, "_thread", None)]
    zk = getattr(ds, "_zk", None)
    if zk is not None:
        out += [zk._reader, zk._pinger]
    return [t for t in out if t is not None]


def _assert_stopped(ds):
    for t in _threads(ds):
        t.join(timeout=3.0)
        assert not t.is_alive(), t.name


class _Handler(BaseHTTPRequestHandler):
    state: dict
    log: _Log

    def log_message(self, *a):
        pass

    def _reply(self, code, body=b"", headers=()):
        self.send_response(code)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _url(self):
        u = urllib.parse.urlparse(self.path)
        return u.path, {k: v[-1] for k, v in sorted(urllib.parse.parse_qs(u.query).items())}


def _handler(base, state, log):
    return type("H", (base,), {"state": state, "log": log})


def _store(**first):
    """A stub's store: its fields, a version every change bumps, and the
    condition long polls hold on.  A hold ends on what the request asks
    about (an MD5, an index, a notification id, a revision), never on an
    event a racing request may have consumed."""
    return dict(first, version=1, cv=threading.Condition())


def _change(state, **fields):
    with state["cv"]:
        state.update(fields)
        state["version"] += 1
        state["cv"].notify_all()


def _hold(state, pred) -> bool:
    """Up to HOLD_S for ``pred(state)``: a long poll's hold."""
    with state["cv"]:
        return state["cv"].wait_for(lambda: pred(state), HOLD_S)


# -- the stubs ----------------------------------------------------------------


class _Nacos(_Handler):
    def do_GET(self):
        path, q = self._url()
        self.log.add(("GET", path, tuple(q.items())))
        self._reply(200, self.state["value"].encode())

    def do_POST(self):
        n = int(self.headers["Content-Length"])
        raw = urllib.parse.parse_qs(self.rfile.read(n).decode())
        listening = raw["Listening-Configs"][0]
        self.log.add(("POST", self.path, listening, self.headers["Long-Pulling-Timeout"]))
        data_id, group, md5 = listening.rstrip("\x01").split("\x02")[:3]
        changed = _hold(self.state, lambda s: hashlib.md5(s["value"].encode()).hexdigest() != md5)
        self._reply(200, urllib.parse.quote(f"{data_id}\x02{group}\x01").encode() if changed else b"")


class _Consul(_Handler):
    def do_GET(self):
        path, q = self._url()
        self.log.add(("GET", path, tuple(q.items())))
        if "index" in q:
            _hold(self.state, lambda s: s["index"] > int(q["index"]))
        body = json.dumps([{"Value": base64.b64encode(self.state["value"].encode()).decode()}]).encode()
        self._reply(200, body, [("X-Consul-Index", str(self.state["index"]))])


class _Apollo(_Handler):
    def do_GET(self):
        path, q = self._url()
        self.log.add(("GET", path, tuple(q.items())))
        if path == "/configfiles/json/my-app/default/application":
            self._reply(200, json.dumps({"flowRules": self.state["value"]}).encode())
            return
        nid = json.loads(q["notifications"])[0]["notificationId"]
        if not _hold(self.state, lambda s: s["nid"] > nid):
            self._reply(304)
            return
        self._reply(200, json.dumps([{"namespaceName": "application", "notificationId": self.state["nid"]}]).encode())


class _Eureka(_Handler):
    def do_GET(self):
        self.log.add(("GET", self.path, self.headers["Accept"]))
        self._reply(200, json.dumps({"instance": {"metadata": {"flowRules": self.state["value"]}}}).encode())


class _Etcd(_Handler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        n = int(self.headers["Content-Length"])
        req = json.loads(self.rfile.read(n).decode())
        self.log.add(("POST", self.path, json.dumps(req, sort_keys=True), self.headers["Content-Type"]))
        if self.path == "/v3/kv/range":
            # the revision the datasource has read: its next watch waits for a later one
            self.state["seen"] = self.state["version"]
            self._reply(200, json.dumps({"kvs": [{"value": base64.b64encode(self.state["value"].encode()).decode()}]})
                        .encode())
            return
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj):
            b = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
            self.wfile.flush()

        chunk({"result": {"created": True}})
        if _hold(self.state, lambda s: s["version"] > s["seen"]):
            chunk({"result": {"events": [{"type": "PUT"}]}})
        self.wfile.write(b"0\r\n\r\n")


class _Spring(_Handler):
    def do_GET(self):
        self.log.add(("GET", self.path))
        self._reply(200, json.dumps({"propertySources": [
            {"source": {"other": "x"}}, {"source": {"sentinel.rules": self.state["value"]}}]}).encode())


class _Etag(_Handler):
    """tests/test_remote_datasource.py's conditional-GET rules server."""

    def do_GET(self):
        self.log.add(("GET", self.path, self.headers.get("If-None-Match"), self.headers.get("X-Team")))
        if self.headers.get("If-None-Match") == self.state["etag"]:
            self._reply(304)
            return
        self._reply(200, self.state["value"].encode(), [("ETag", self.state["etag"])])


#: store -> (stub handler, its first value, the change, how the datasource
#: is built on (stores module, package, port, parser))
STORES = {
    "nacos": (_Nacos, dict(value="v1"), dict(value="v2"), lambda S, D, port, parser: S.NacosDataSource(
        f"127.0.0.1:{port}", "G", "rules", parser=parser, poll_timeout_ms=int(HOLD_S * 1000))),
    "consul": (_Consul, dict(value="c1", index=7), dict(value="c2", index=8),
               lambda S, D, port, parser: S.ConsulDataSource("127.0.0.1", port, "sentinel/rules", parser=parser,
                                                             watch_timeout_s=1)),
    "apollo": (_Apollo, dict(value="a1", nid=3), dict(value="a2", nid=4), lambda S, D, port, parser: S.ApolloDataSource(
        f"127.0.0.1:{port}", "my-app", "default", "application", "flowRules", "[]", parser=parser)),
    "etcd": (_Etcd, dict(value="t1"), dict(value="t2 new"),
             lambda S, D, port, parser: S.EtcdDataSource("127.0.0.1", port, "sentinel.rules", parser=parser)),
}
POLLED = {
    "eureka": (_Eureka, dict(value="e1"), dict(value="e2"), lambda S, D, port, parser: S.EurekaDataSource(
        "APP", "inst-1", ["http://127.0.0.1:1/eureka", f"http://127.0.0.1:{port}/eureka"], "flowRules",
        parser=parser, refresh_ms=60_000)),
    "spring": (_Spring, dict(value="s1"), dict(value="s2"), lambda S, D, port, parser: S.SpringCloudConfigDataSource(
        f"127.0.0.1:{port}", "my-app", "prod", "sentinel.rules", parser=parser, refresh_ms=60_000)),
    "http": (_Etag, dict(value="h1", etag="v1"), dict(value="h2", etag="v2"), lambda S, D, port, parser: D.HttpDataSource(
        f"http://127.0.0.1:{port}/rules", parser, refresh_ms=60_000, headers={"X-Team": "ops"})),
}


def _polls(reqs):
    """Requests that are long polls / watches (everything but reads)."""
    out = 0
    for r in reqs:
        if r[1] in ("/nacos/v1/cs/configs/listener", "/v3/watch", "/notifications/v2"):
            out += 1
        elif r[1].startswith("/v1/kv/") and dict(r[2]).get("index"):
            out += 1
    return out


def _run_push(side, store):
    DS, S, _R, _Z, _C = side
    handler, first, change, build = STORES[store]
    state = _store(**first)
    log = _Log()
    srv, port = _serve(_handler(handler, state, log))
    ds = build(S, DS, port, lambda s: ("parsed", s))
    try:
        got, evt = _collect(ds, DS.SimplePropertyListener)
        initial = ds.get_property().value
        assert log.wait_for(lambda r: _polls(r) >= 1)
        n_before = len(log.reqs)
        _change(state, **change)
        assert _wait(evt, got, lambda v: v == ("parsed", change["value"]))
        # the re-read, then the next poll on the new version
        assert log.wait_for(lambda r: _polls(r[n_before:]) >= 2)
    finally:
        ds.close()
        _stop(srv)
    _assert_stopped(ds)
    return initial, got, log.folded()


@pytest.mark.parametrize("store", list(STORES))
def test_push_stores_send_the_reference_requests_and_publish_its_values(store):
    want = _run_push(JAX, store)
    got = _run_push(PORT, store)
    assert got == want
    assert want[0] == ("parsed", STORES[store][1]["value"]) and want[1][-1] == ("parsed", STORES[store][2]["value"])


def _run_polled(side, store):
    DS, S, _R, _Z, _C = side
    handler, first, change, build = POLLED[store]
    state = dict(first)
    log = _Log()
    srv, port = _serve(_handler(handler, state, log))
    ds = build(S, DS, port, lambda s: s.upper())
    try:
        out = [ds.get_property().value, ds.refresh(), ds.get_property().value]
        state.update(change)
        out += [ds.refresh(), ds.get_property().value, ds.refresh()]
    finally:
        ds.close()
        _stop(srv)
    _assert_stopped(ds)
    return out, log.reqs


@pytest.mark.parametrize("store", list(POLLED))
def test_polled_sources_send_the_reference_requests_and_publish_its_values(store):
    """Eureka (falling through a dead replica), Spring Cloud Config and the
    conditional-GET HttpDataSource (ETag, 304 = no push), one
    deterministic refresh at a time."""
    want = _run_polled(JAX, store)
    got = _run_polled(PORT, store)
    assert got == want
    assert want[0][0] == POLLED[store][1]["value"].upper()
    assert want[0][4] == POLLED[store][2]["value"].upper()


def test_callback_datasource_publishes_as_the_reference():
    out = []
    for DS, *_ in (JAX, PORT):
        ds = DS.CallbackDataSource(DS.json_rule_converter("degrade"), initial=json.dumps([{"resource": "cb", "count": 3}]))
        seen, _evt = _collect(ds, DS.SimplePropertyListener)
        ds.update(json.dumps([{"resource": "cb-res", "count": 3, "grade": 2}]))
        ds.update("[]")
        with pytest.raises(NotImplementedError):
            ds.read_source()
        out.append([[r.to_dict() for r in v] for v in seen])
    assert out[1] == out[0] and out[0][1][0]["resource"] == "cb-res" and out[0][-1] == []


# -- redis ----------------------------------------------------------------------


class StubRedis:
    """A minimal RESP2 server (GET / SET / AUTH / SELECT / SUBSCRIBE /
    PUBLISH) that logs every command it parses."""

    def __init__(self):
        self.data = {}
        self.subscribers = {}
        self.lock = threading.Lock()
        self.log = _Log()
        self.conns = []
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                buf = b""
                sock = self.request
                outer.conns.append(sock)
                subscribed = []
                try:
                    while True:
                        try:
                            chunk = sock.recv(65536)
                        except OSError:
                            break
                        if not chunk:
                            break
                        buf += chunk
                        while True:
                            cmd, buf2 = outer._parse(buf)
                            if cmd is None:
                                break
                            buf = buf2
                            outer.log.add(tuple(cmd))
                            outer._dispatch(sock, cmd, subscribed)
                finally:
                    with outer.lock:
                        for ch in subscribed:
                            if sock in outer.subscribers.get(ch, []):
                                outer.subscribers[ch].remove(sock)

        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    @staticmethod
    def _parse(buf):
        if not buf.startswith(b"*"):
            return None, buf
        try:
            head, rest = buf.split(b"\r\n", 1)
            args = []
            for _ in range(int(head[1:])):
                if not rest.startswith(b"$"):
                    return None, buf
                lhead, rest = rest.split(b"\r\n", 1)
                ln = int(lhead[1:])
                if len(rest) < ln + 2:
                    return None, buf
                args.append(rest[:ln])
                rest = rest[ln + 2:]
            return args, rest
        except ValueError:
            return None, buf

    def _dispatch(self, sock, cmd, subscribed):
        name = cmd[0].upper().decode()
        if name == "GET":
            v = self.data.get(cmd[1].decode())
            sock.sendall(b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v.encode()), v.encode()))
        elif name == "SET":
            self.data[cmd[1].decode()] = cmd[2].decode()
            sock.sendall(b"+OK\r\n")
        elif name in ("AUTH", "SELECT"):
            sock.sendall(b"+OK\r\n")
        elif name == "SUBSCRIBE":
            with self.lock:
                self.subscribers.setdefault(cmd[1].decode(), []).append(sock)
            subscribed.append(cmd[1].decode())
            sock.sendall(b"*3\r\n$9\r\nsubscribe\r\n$%d\r\n%s\r\n:1\r\n" % (len(cmd[1]), cmd[1]))
        elif name == "PUBLISH":
            with self.lock:
                subs = list(self.subscribers.get(cmd[1].decode(), []))
            n = 0
            for s in subs:
                try:
                    s.sendall(b"*3\r\n$7\r\nmessage\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n"
                              % (len(cmd[1]), cmd[1], len(cmd[2]), cmd[2]))
                    n += 1
                except OSError:
                    pass
            sock.sendall(b":%d\r\n" % n)
        else:
            sock.sendall(b"-ERR unknown command\r\n")

    def subscriber_sockets(self):
        with self.lock:
            return [s for subs in self.subscribers.values() for s in subs]

    def close(self):
        """Stop serving and drop every connection, as a server going away."""
        self.server.shutdown()
        self.server.server_close()
        for c in self.conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def test_resp_encoding_and_parsing_equal_the_reference():
    args = [("GET", "k"), ("SET", "k", "v"), ("SET", "ключ", "значение"), ("SELECT", 3), ("AUTH", b"\x00\xffpw"),
            ("PUBLISH", "c", ""), ("ZADD", "z", 1.5, -2), ()]
    assert [TR.encode_command(*a) for a in args] == [JR.encode_command(*a) for a in args]
    replies = (b"+OK\r\n-ERR nope\r\n:42\r\n:-7\r\n$3\r\nabc\r\n$-1\r\n$0\r\n\r\n*-1\r\n"
               b"*3\r\n$9\r\nsubscribe\r\n$1\r\nc\r\n:1\r\n*2\r\n*1\r\n:1\r\n$2\r\nhi\r\n?bad\r\n")

    def parse(R):
        a, b = socket.socketpair()
        try:
            b.sendall(replies)
            r = R._Reader(a)
            out = []
            for _ in range(11):
                try:
                    out.append(r.read_reply())
                except Exception as e:  # RespError: its type name and message
                    out.append((type(e).__name__, str(e)))
            return out
        finally:
            a.close()
            b.close()

    want, got = parse(JR), parse(TR)
    assert got == want
    assert want[0] == "OK" and want[1] == ("RespError", "ERR nope") and want[-1][0] == "RespError"


def _run_redis(side, stub_factory):
    DS, _S, R, _Z, _C = side
    stub = stub_factory()
    key, chan = "sentinel:rules:flow", "sentinel:chan:flow"
    stub.data[key] = "r1"
    ds = R.RedisDataSource(lambda s: ("parsed", s), "127.0.0.1", stub.port, rule_key=key, channel=chan,
                           reconnect_backoff_s=0.05).start()
    try:
        got, evt = _collect(ds, DS.SimplePropertyListener)
        initial = ds.get_property().value
        op = R.RedisConnection("127.0.0.1", stub.port)
        try:
            op.execute("SET", key, "r2")
            assert op.execute("PUBLISH", chan, "r2") == 1
            assert _wait(evt, got, lambda v: v == ("parsed", "r2"))
            op.execute("PUBLISH", chan, "{not json but kept raw}")
            assert _wait(evt, got, lambda v: v == ("parsed", "{not json but kept raw}"))
        finally:
            op.close()
        # reconnect heal: the key changes with no publish, the subscriber's
        # socket dies, the re-GET after the reconnect publishes the key
        stub.data[key] = "r3"
        for s in stub.subscriber_sockets():
            s.shutdown(socket.SHUT_RDWR)
        assert _wait(evt, got, lambda v: v == ("parsed", "r3"))
        assert stub.log.wait_for(lambda r: sum(c[0] == b"SUBSCRIBE" for c in r) >= 2)
    finally:
        ds.close()
        stub.close()
    _assert_stopped(ds)
    return initial, got, stub.log.reqs


def test_redis_datasource_sends_the_reference_commands_and_publishes_its_values():
    want = _run_redis(JAX, StubRedis)
    got = _run_redis(PORT, StubRedis)
    assert got == want
    assert [c[0] for c in want[2]][:2] == [b"GET", b"SUBSCRIBE"]


# -- zookeeper ------------------------------------------------------------------


class FakeZkServer:
    """The jute subset ZkClient uses (connect, getData, exists, ping);
    ``set_data`` fires one-shot watches as an ensemble does.  Logs each
    request's (xid, op, path, watch)."""

    def __init__(self):
        self.nodes = {}
        self.watches = {}
        self.log = _Log()
        self._lock = threading.Lock()
        self._conns = []
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    @staticmethod
    def _recv_n(conn, n):
        out = b""
        while len(out) < n:
            c = conn.recv(n - len(out))
            if not c:
                raise ConnectionError
            out += c
        return out

    def _recv_frame(self, conn):
        (n,) = struct.unpack(">i", self._recv_n(conn, 4))
        return self._recv_n(conn, n)

    @staticmethod
    def _send_frame(conn, payload):
        conn.sendall(struct.pack(">i", len(payload)) + payload)

    @staticmethod
    def _stat():
        return struct.pack(">qqqqiiiqiiq", 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0)

    def _serve_conn(self, conn):
        try:
            frame = self._recv_frame(conn)
            proto, zxid, timeout, sid = struct.unpack_from(">iqiq", frame, 0)
            self.log.add(("connect", proto, zxid, timeout, sid, frame[24:]))
            self._send_frame(conn, struct.pack(">iiq", 0, timeout, 0x1234) + struct.pack(">i", 16) + b"\x00" * 16)
            while True:
                frame = self._recv_frame(conn)
                xid, op = struct.unpack_from(">ii", frame, 0)
                if xid == -2:
                    self._send_frame(conn, struct.pack(">iqi", -2, 0, 0))
                    continue
                (plen,) = struct.unpack_from(">i", frame, 8)
                path = frame[12:12 + plen].decode()
                watch = frame[12 + plen] == 1
                self.log.add((xid, op, path, watch))
                with self._lock:
                    data = self.nodes.get(path)
                    # as an ensemble: a getData of a missing node leaves no
                    # watch, and a connection's watch on a path fires once
                    if watch and (data is not None or op == 3) and conn not in self.watches.get(path, []):
                        self.watches.setdefault(path, []).append(conn)
                if data is None:
                    self._send_frame(conn, struct.pack(">iqi", xid, 0, -101))
                elif op == 4:
                    self._send_frame(conn, struct.pack(">iqi", xid, 0, 0) + struct.pack(">i", len(data)) + data
                                     + self._stat())
                else:
                    self._send_frame(conn, struct.pack(">iqi", xid, 0, 0) + self._stat())
        except (ConnectionError, OSError):
            pass

    def set_data(self, path, data):
        with self._lock:
            created = path not in self.nodes
            self.nodes[path] = data
            conns = self.watches.pop(path, [])
        b = path.encode()
        for conn in conns:
            try:
                self._send_frame(conn, struct.pack(">iqi", -1, 0, 0) + struct.pack(">ii", 1 if created else 3, 3)
                                 + struct.pack(">i", len(b)) + b)
            except OSError:
                pass

    def close(self):
        self._srv.close()
        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()


def _run_zk(side, path, first):
    DS, _S, _R, Z, _C = side
    srv = FakeZkServer()
    if first is not None:
        srv.nodes[path] = first
    ds = Z.ZookeeperDataSource(f"127.0.0.1:{srv.port}", path, parser=lambda s: ("parsed", s))
    try:
        got, evt = _collect(ds, DS.SimplePropertyListener)
        initial = ds.get_property().value
        for v in (b"z2", b"z3"):  # watches are one-shot and re-armed
            srv.set_data(path, v)
            assert _wait(evt, got, lambda x, v=v: x == ("parsed", v.decode()))
        # the connect, then one getData a read (an absent node: one exists too)
        assert srv.log.wait_for(lambda r: len(r) >= (4 if first is not None else 5))
    finally:
        ds.close()
        srv.close()
    _assert_stopped(ds)
    return initial, got, srv.log.reqs


@pytest.mark.parametrize("first", [b"z1", None], ids=["present", "absent"])
def test_zookeeper_datasource_sends_the_reference_frames_and_publishes_its_values(first):
    """getData with a watch, the re-read and re-arm on each fired watch;
    an absent node arms an exists-watch and publishes on creation."""
    want = _run_zk(JAX, "/sentinel/rules", first)
    got = _run_zk(PORT, "/sentinel/rules", first)
    assert got == want
    assert want[0] == (None if first is None else ("parsed", "z1"))
    assert want[2][1] == (1, 4, "/sentinel/rules", True)
    assert (first is None) == ((2, 3, "/sentinel/rules", True) in want[2])


# -- the watch failpoint ----------------------------------------------------------


def _run_fault(side, monkeypatch):
    DS, S, _R, _Z, C = side
    monkeypatch.setattr(S._PushLoopDataSource, "_ERROR_BACKOFF_S", 0.05)
    state = _store(value="v1")
    log = _Log()
    srv, port = _serve(_handler(_Nacos, state, log))
    plan = C.FaultPlan(seed=3, faults=[C.FaultSpec("datasource.store.watch", "raise", max_fires=2)])
    with C.armed(plan) as armed:
        ds = S.NacosDataSource(f"127.0.0.1:{port}", "G", "rules", parser=str.upper,
                               poll_timeout_ms=int(HOLD_S * 1000))
        try:
            got, evt = _collect(ds, DS.SimplePropertyListener)
            assert log.wait_for(lambda r: _polls(r) >= 1)
            _change(state, value="v2")
            assert _wait(evt, got, lambda v: v == "V2")
            alive = ds._thread.is_alive()
        finally:
            ds.close()
            _stop(srv)
        fired = armed.injected()
    _assert_stopped(ds)
    return got, alive, fired, log.folded()


def test_a_raising_watch_failpoint_keeps_the_loop_alive_as_the_reference(monkeypatch):
    want = _run_fault(JAX, monkeypatch)
    got = _run_fault(PORT, monkeypatch)
    assert got == want
    assert want[1] is True and want[2] == {"datasource.store.watch:raise": 2}


# -- enforcement through a push -------------------------------------------------


@pytest.fixture(scope="module")
def clients():
    jc = JaxClient(cfg=jax_small_cfg(device_telemetry=False, timeline_k=0, explain_k=0), time_source=JaxVT(1_000),
                   mode="sync")
    upload = jc._dev_col  # a private copy per upload (ROADMAP.md Queue C)
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    tc = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, device_telemetry=False,
                                                timeline_k=0, explain_k=0),
                        time_source=VirtualTimeSource(1_000), mode="sync", device="cpu")
    jc.start()
    tc.start()
    yield jc, tc
    jc.stop()
    tc.stop()


def _rules(count):
    return json.dumps([{"resource": "api", "count": count}])


def _passes(c, m, n=12):
    ok = 0
    for _ in range(n):
        try:
            with c.entry("api"):
                ok += 1
        except m.BlockException:
            pass
    return ok


def _loaded(c, count):
    """An event the first load of a flow rule at ``count`` sets.  The rule
    managers call their listeners after the recompile: polling
    ``flow_rules.get()`` instead would race a load on the datasource's
    thread, which sets the rules before it compiles them."""
    evt = threading.Event()

    def on_load(rules):
        if rules and rules[0].count == count:
            evt.set()
            c.flow_rules._listeners.remove(on_load)

    c.flow_rules.add_listener(on_load)
    return evt


def _push_redis(side, c):
    DS, _S, R, _Z, _C = side
    stub = StubRedis()
    stub.data["k"] = _rules(1000)
    ds = R.RedisDataSource(DS.json_rule_converter("flow"), "127.0.0.1", stub.port, rule_key="k", channel="ch").start()

    def push():
        op = R.RedisConnection("127.0.0.1", stub.port)
        op.execute("PUBLISH", "ch", _rules(2))
        op.close()

    def close():
        if side is PORT:
            ds.close()
            _assert_stopped(ds)  # while the stub still holds the connection
            stub.close()
        else:  # the server goes first, or the reference's close() waits out its join
            stub.close()
            ds.close()

    return ds, push, close


def _push_zk(side, c):
    DS, _S, _R, Z, _C = side
    srv = FakeZkServer()
    srv.nodes["/r"] = _rules(1000).encode()
    ds = Z.ZookeeperDataSource(f"127.0.0.1:{srv.port}", "/r", parser=DS.json_rule_converter("flow"))

    def close():
        if side is PORT:
            ds.close()
            _assert_stopped(ds)  # while the server still holds the connection
            srv.close()
        else:  # the server goes first, or the reference's close() waits out its join
            srv.close()
            ds.close()

    return ds, lambda: srv.set_data("/r", _rules(2).encode()), close


def _push_nacos(side, c):
    DS, S, _R, _Z, _C = side
    state = _store(value=_rules(1000))
    srv, port = _serve(_handler(_Nacos, state, _Log()))
    ds = S.NacosDataSource(f"127.0.0.1:{port}", "G", "rules", parser=DS.json_rule_converter("flow"),
                           poll_timeout_ms=int(HOLD_S * 1000))

    def push():
        _change(state, value=_rules(2))

    def close():
        ds.close()
        _stop(srv)

    return ds, push, close


@pytest.mark.parametrize("store", ["redis", "zookeeper", "nacos"])
def test_a_push_flips_enforcement_as_on_the_jax_client(clients, store):
    make = {"redis": _push_redis, "zookeeper": _push_zk, "nacos": _push_nacos}[store]
    out = []
    for side, c, m in ((JAX, clients[0], jst), (PORT, clients[1], tst)):
        c.time.advance(1100)
        ds, push, close = make(side, c)
        try:
            c.flow_rules.register_property(ds.get_property())  # loads the first rules on this thread
            assert [r.count for r in c.flow_rules.get()] == [1000.0]
            before = _passes(c, m)
            live = _loaded(c, 2.0)
            push()
            assert live.wait(8.0)
            c.time.advance(1100)  # a fresh window
            after = _passes(c, m)
        finally:
            # Redis and ZooKeeper: the port's threads end on close() while the
            # stub still holds the connection; the reference's stay blocked in
            # recv until the server drops it (ROADMAP.md Queue C)
            close()
        _assert_stopped(ds)
        out.append((before, after, [r.to_dict() for r in c.flow_rules.get()]))
    assert out[1] == out[0]
    assert out[0][:2] == (12, 2)
