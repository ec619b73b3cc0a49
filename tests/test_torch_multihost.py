"""The port's multi-host routing over a real wire: remote shard hosts
(``sentinel_tpu_torch.parallel.remote_shard.RemoteShard``) behind the
port's ``ShardRouter``, against the JAX package's.

The counterparts of tests/test_multihost.py, tests/test_remote_shard_replay.py
and tests/test_chaos.py::test_remote_shard_mid_window_partition_no_replay:

- two port shard-host processes (this file run as a script: a port
  ``SentinelClient(device="cpu")`` behind a port ``ClusterTokenServer`` on
  127.0.0.1, printing ``PORT <n>``; tests/test_torch_imports.py checks it
  imports neither jax nor the JAX package): one mixed batch comes back in input order with each host's
  rule enforced, verdict for verdict as the reference router gives them
  over in-process reference clients holding the same rules;
- one host killed mid-test: its spans degrade to the local fallback
  client (the reference's ``RemoteShard`` and fallback, pointed at the
  same dead host, give the same verdicts), the other host keeps
  serving, and a replacement host takes the traffic back after the
  cooldown is lapsed;
- the replay contract, through both packages' ``RemoteShard`` over the
  same scripted sockets and then through the port's own failpoints on a
  real port token server: answered chunks keep their verdicts, chunks
  written to a socket that failed degrade and are never replayed, chunks
  not yet written ride the one reconnect;
- answers that come back out of order, as a token server's worker pool
  returns them: the port pairs each with its chunk by xid (scripted, and
  over a real threaded host), where the reference pairs them by arrival
  and misplaces verdicts — the one place the port departs from it
  (ROADMAP.md Queue C).

Verdicts, waits and counts are integers: equal.
"""

from __future__ import annotations

import json
import os
import signal
import struct
import subprocess
import sys
import time
import types
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def shard_host_main(argv: List[str]) -> None:
    """A shard host: the port's client (threaded, CPU) + token service +
    token server answering RES_CHECK on an ephemeral port; prints ``PORT
    <n>`` once listening, then serves until killed.  ``argv[0]``: the flow
    rules as JSON, ``[{"resource": ..., "count": ...}]``."""
    sys.path.insert(0, ROOT)
    import threading

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient

    rules = json.loads(argv[0]) if argv else []
    client = SentinelClient(cfg=small_engine_config(), mode="threaded", tick_interval_ms=2.0, device="cpu")
    client.start()
    client.flow_rules.load([st.FlowRule(resource=r["resource"], count=r["count"]) for r in rules])
    server = ClusterTokenServer(DefaultTokenService(client), host="127.0.0.1", port=0)
    server.start()
    print(f"PORT {server.port}", flush=True)
    threading.Event().wait()


if __name__ == "__main__":
    shard_host_main(sys.argv[1:])

import pytest  # noqa: E402


def _launch(rules: list):
    """A shard host process (this file as a script) on the CPU."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), json.dumps(rules)], stdout=subprocess.PIPE,
                            text=True, cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def _port(proc) -> int:
    line = proc.stdout.readline().strip()
    assert line.startswith("PORT "), f"shard host failed to start: {line!r}"
    return int(line.split()[1])


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=10)


@pytest.fixture(scope="module")
def two_hosts():
    """Two port shard hosts, each enforcing a rule on one resource it owns."""
    from sentinel_tpu_torch.parallel.router import shard_of

    a_res = next(f"svc-{i}" for i in range(100) if shard_of(f"svc-{i}", 2) == 0)
    b_res = next(f"svc-{i}" for i in range(100) if shard_of(f"svc-{i}", 2) == 1)
    procs = {}
    try:
        # both hosts boot at once: each prints its port when listening
        for key, res, count in (("a", a_res, 3), ("b", b_res, 5)):
            procs[key] = _launch([{"resource": res, "count": count}])
        ports = {key: _port(proc) for key, proc in procs.items()}
        yield types.SimpleNamespace(a_res=a_res, b_res=b_res, pa=procs["a"], pb=procs["b"], porta=ports["a"],
                                    portb=ports["b"])
    finally:
        for proc in procs.values():
            _stop(proc)


def _ref_client(vt):
    import numpy as np

    from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
    from sentinel_tpu.runtime.client import SentinelClient as JaxClient

    c = JaxClient(cfg=jax_small_cfg(), time_source=vt, mode="sync")
    upload = c._dev_col  # a private copy per upload (ROADMAP.md Queue C: jnp.asarray may alias)
    c._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    c.start()
    return c


def test_a_mixed_batch_over_two_host_processes(two_hosts):
    import sentinel_tpu as jst
    from sentinel_tpu.parallel.router import ShardRouter as JRouter
    from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.parallel.remote_shard import RemoteShard
    from sentinel_tpu_torch.parallel.router import ShardRouter

    h = two_hosts
    router = ShardRouter([RemoteShard("127.0.0.1", h.porta, timeout_s=10),
                          RemoteShard("127.0.0.1", h.portb, timeout_s=10)])
    names = [h.a_res, h.b_res] * 8
    try:
        results = [tuple(map(int, r)) for r in router.check_batch(names)]
    finally:
        for s in router.shards:
            s.close()
    assert sum(1 for i in range(0, 16, 2) if results[i][0] == ERR.PASS) == 3  # host A's rule
    assert sum(1 for i in range(1, 16, 2) if results[i][0] == ERR.PASS) == 5  # host B's rule
    # the reference router over in-process reference clients with the same rules
    vt = JVT(1_000)
    hosts = [_ref_client(vt), _ref_client(vt)]
    try:
        hosts[0].flow_rules.load([jst.FlowRule(resource=h.a_res, count=3)])
        hosts[1].flow_rules.load([jst.FlowRule(resource=h.b_res, count=5)])
        want = [tuple(map(int, r)) for r in JRouter(hosts).check_batch(names)]
    finally:
        for c in hosts:
            c.stop()
    assert results == want


def test_a_host_killed_mid_test_degrades_and_recovers(two_hosts):
    import sentinel_tpu as jst
    from sentinel_tpu.parallel.remote_shard import RemoteShard as JRemote
    from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.parallel.remote_shard import RemoteShard
    from sentinel_tpu_torch.parallel.router import ShardRouter
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    h = two_hosts
    # local fallbacks with a TIGHTER rule, so degraded enforcement shows
    vt, jvt = VirtualTimeSource(), JVT()
    fb = SentinelClient(cfg=small_engine_config(), time_source=vt, device="cpu")
    fb.start()
    fb.flow_rules.load([st.FlowRule(resource=h.b_res, count=1)])
    jfb = _ref_client(jvt)
    jfb.flow_rules.load([jst.FlowRule(resource=h.b_res, count=1)])
    shard_b = RemoteShard("127.0.0.1", h.portb, timeout_s=10, fallback=fb, retry_interval_s=1.0)
    router = ShardRouter([RemoteShard("127.0.0.1", h.porta, timeout_s=10), shard_b])
    jshard_b = JRemote("127.0.0.1", h.portb, timeout_s=10, fallback=jfb, retry_interval_s=1.0)
    pb2 = None
    try:
        healthy = router.check_batch([h.b_res, h.b_res])
        assert all(v in (ERR.PASS, ERR.BLOCK_FLOW) for v, _ in healthy)
        h.pb.send_signal(signal.SIGKILL)
        h.pb.wait(timeout=10)
        # degraded: host B's spans go to the local fallback (count 1 a
        # window); host A keeps answering remotely
        vt.advance(1500)
        jvt.advance(1500)
        got = [tuple(map(int, router.check_batch([h.b_res])[0])) for _ in range(4)]
        want = [tuple(map(int, jshard_b.check_batch([h.b_res])[0])) for _ in range(4)]
        assert got == want
        assert [v for v, _ in got] == [ERR.PASS] + [ERR.BLOCK_FLOW] * 3
        assert shard_b._down_until > 0.0 and jshard_b._down_until > 0.0
        assert router.check_batch([h.a_res])[0][0] in (ERR.PASS, ERR.BLOCK_FLOW)
        # a replacement host on a new port takes over once the cooldown lapses
        pb2 = _launch([{"resource": h.b_res, "count": 5}])
        portb2 = _port(pb2)
        shard_b.port = portb2
        shard_b._down_until = 0.0
        revived = router.check_batch([h.b_res] * 6)
        assert [v for v, _ in revived] == [ERR.PASS] * 5 + [ERR.BLOCK_FLOW]
        assert not shard_b._hy.active  # the healthy exchange exited the degrade
    finally:
        if pb2 is not None:
            _stop(pb2)
        fb.stop()
        jfb.stop()
        jshard_b.close()
        for s in router.shards:
            s.close()


# -- the replay contract over scripted sockets (both packages) -------------------


def _pkg(name):
    if name == "port":
        from sentinel_tpu_torch.cluster import constants as C
        from sentinel_tpu_torch.cluster import protocol as P
        from sentinel_tpu_torch.core import errors as ERR
        from sentinel_tpu_torch.parallel.remote_shard import RemoteShard
    else:
        from sentinel_tpu.cluster import constants as C
        from sentinel_tpu.cluster import protocol as P
        from sentinel_tpu.core import errors as ERR
        from sentinel_tpu.parallel.remote_shard import RemoteShard
    return types.SimpleNamespace(C=C, P=P, ERR=ERR, RemoteShard=RemoteShard)


class _ScriptedSocket:
    """An in-memory server: every frame sent is decoded and, for the first
    ``answer_n`` requests, answered PASS; ``recv`` raises OSError once the
    scripted answers run out."""

    def __init__(self, m, answer_n: int):
        self.m, self.answer_n = m, answer_n
        self.requests = []
        self._out = b""

    def sendall(self, raw: bytes) -> None:
        m = self.m
        (n,) = struct.unpack(">H", raw[:2])
        req = m.P.decode_request(raw[2:2 + n])
        self.requests.append((req.xid, list(req.params)))
        if len(self.requests) <= self.answer_n:
            k = len(req.params) // 5  # RES_CHECK: 5-tuples per item
            self._out += m.P.encode_response(
                m.P.ClusterResponse(req.xid, m.C.MSG_TYPE_RES_CHECK, m.C.STATUS_OK, items=[(m.ERR.PASS, 0)] * k))

    def recv(self, n: int) -> bytes:
        if not self._out:
            raise OSError("scripted failure")
        chunk, self._out = self._out[:n], self._out[n:]
        return chunk

    def settimeout(self, t) -> None:
        pass

    def close(self) -> None:
        pass


class _RecordingFallback:
    def __init__(self, m, wait=0):
        self.m, self.wait = m, wait
        self.batches = []

    def check_batch(self, resources, **kw):
        self.batches.append(list(resources))
        return [(self.m.ERR.PASS, self.wait)] * len(resources)


def _scripted_shard(m, sockets, fallback=None):
    s = m.RemoteShard("scripted", 0, fallback=fallback, retry_interval_s=60.0)
    s.CHUNK = 4  # small chunks -> several frames a batch
    it = iter(sockets)

    def connect():
        nxt = next(it)
        if isinstance(nxt, Exception):
            raise nxt
        return nxt

    s._connect = connect
    return s


def _replay_cases(name) -> dict:
    m = _pkg(name)
    names = [f"r{i}" for i in range(12)]
    out = {}
    # 3 chunks pipelined; one answered, then the server dies
    sock, fb = _ScriptedSocket(m, 1), _RecordingFallback(m)
    shard = _scripted_shard(m, [sock], fallback=fb)
    first = shard.check_batch(names)
    armed = shard._down_until > 0.0
    second = shard.check_batch(names[:4])
    out["written"] = (first, sock.requests, fb.batches, armed, second, len(sock.requests))
    # a refused connect writes nothing: every chunk rides the reconnect
    good, fb = _ScriptedSocket(m, 99), _RecordingFallback(m)
    shard = _scripted_shard(m, [OSError("connect refused"), good], fallback=fb)
    out["unwritten"] = (shard.check_batch(names[:8]), good.requests, fb.batches)
    # no fallback: forfeited spans take the documented pass-through
    sock = _ScriptedSocket(m, 1)
    shard = _scripted_shard(m, [sock], fallback=None)
    out["no_fallback"] = (shard.check_batch(names[:8]), sock.requests)
    return out


def test_the_replay_contract_over_scripted_sockets_equals_the_reference():
    port, ref = _replay_cases("port"), _replay_cases("ref")
    assert port == ref
    names = [f"r{i}" for i in range(12)]
    first, requests, batches, armed, second, after = port["written"]
    assert len(first) == 12 and all(v == 0 for v, _ in first)
    assert len(requests) == 3 and [x for x, _ in requests] == [1, 2, 3]  # each chunk written once
    assert batches == [names[4:8], names[8:12], names[:4]]  # the two forfeited spans, then the cooled-down batch
    assert armed and after == 3  # the cooldown kept the wire untouched
    out, good, fb = port["unwritten"]
    assert len(good) == 2 and fb == [] and all(v == 0 for v, _ in out)
    out, reqs = port["no_fallback"]
    assert len(reqs) == 2 and all(v == 0 for v, _ in out)


class _ReorderingSocket(_ScriptedSocket):
    """Holds every frame of a window and answers them last first, each
    chunk with its own verdict (chunk k: BLOCK_FLOW when k is even), as a
    token server whose worker pool finished them in that order would."""

    def __init__(self, m, window, xid_shift=0):
        super().__init__(m, answer_n=0)
        self.window, self.xid_shift = window, xid_shift
        self.held = []

    def sendall(self, raw: bytes) -> None:
        m = self.m
        (n,) = struct.unpack(">H", raw[:2])
        req = m.P.decode_request(raw[2:2 + n])
        self.requests.append((req.xid, list(req.params)))
        k = len(self.requests) - 1
        verdict = m.ERR.BLOCK_FLOW if k % 2 == 0 else m.ERR.PASS
        self.held.append(m.P.encode_response(m.P.ClusterResponse(
            req.xid + self.xid_shift, m.C.MSG_TYPE_RES_CHECK, m.C.STATUS_OK,
            items=[(verdict, k)] * (len(req.params) // 5))))
        if len(self.held) == self.window:
            self._out += b"".join(reversed(self.held))
            self.held = []

    def recv(self, n: int) -> bytes:
        if not self._out and self.held:
            self._out += b"".join(reversed(self.held))
            self.held = []
        return super().recv(n)


def _reordered(name, xid_shift=0):
    m = _pkg(name)
    fb = _RecordingFallback(m, wait=99)
    shard = _scripted_shard(m, [_ReorderingSocket(m, window=4, xid_shift=xid_shift)], fallback=fb)
    out = shard.check_batch([f"r{i}" for i in range(16)])  # 4 chunks of 4: one window
    return [tuple(map(int, r)) for r in out], fb.batches, shard._down_until > 0.0


def test_answers_out_of_order_are_paired_by_xid_where_the_reference_pairs_by_arrival():
    """The token server runs a connection's pipelined RES_CHECK frames on
    its worker pool, so a window's answers can arrive out of order (a
    threaded host answered 15 of 20 eight-chunk batches so on this box).
    The port pairs each answer with its chunk by xid; the reference pairs
    them by arrival and hands a chunk another chunk's verdicts (ROADMAP.md
    Queue C: a reference fault the port does not copy)."""
    from sentinel_tpu_torch.core import errors as ERR

    port, _fb, _armed = _reordered("port")
    own = {k: (ERR.PASS if k % 2 else ERR.BLOCK_FLOW, k) for k in range(4)}  # chunk k's verdict and marker
    assert port == [own[k] for k in range(4) for _ in range(4)]
    ref, _fb, _armed = _reordered("ref")
    assert ref == [own[k] for k in (3, 2, 1, 0) for _ in range(4)]  # the window reversed
    # an answer no chunk in flight carries desyncs the stream: every chunk
    # of the window degrades (never a verdict handed to the wrong span)
    out, batches, armed = _reordered("port", xid_shift=100)
    assert out == [(0, 99)] * 16 and len(batches) == 4 and armed


def test_verdicts_land_on_their_own_items_through_a_threaded_host():
    """A real port token server (eight workers) over a threaded port host
    client that blocks every item of alternate 128-item chunks: through the
    port's RemoteShard every item gets its own chunk's verdict, batch after
    batch, whatever order the answers come back in."""
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import errors as ERR
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.parallel.remote_shard import RemoteShard
    from sentinel_tpu_torch.runtime.client import SentinelClient

    c = SentinelClient(cfg=small_engine_config(max_resources=8192, max_nodes=16384, max_flow_rules=2048,
                                               batch_size=256), mode="threaded", device="cpu")
    c.start()
    names = [f"n{i}" for i in range(1024)]
    c.flow_rules.load([st.FlowRule(resource=x, count=0) for i, x in enumerate(names) if (i // 128) % 2 == 0])
    svc = DefaultTokenService(c)
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0)
    server.start()
    shard = RemoteShard("127.0.0.1", server.port, timeout_s=10)
    try:
        want = [ERR.BLOCK_FLOW if (i // 128) % 2 == 0 else ERR.PASS for i in range(1024)]
        for _ in range(6):
            assert [v for v, _w in shard.check_batch(names)] == want
    finally:
        shard.close()
        server.stop()
        svc.close()
        c.stop()


def _partition_run(name) -> tuple:
    """tests/test_chaos.py's mid-window partition through one package: a
    token server (a sync decision client on virtual time), a RemoteShard of
    4-item chunks, a healthy window of three chunks, then a window whose
    first response read drops under an armed failpoint."""
    if name == "port":
        import sentinel_tpu_torch as st
        from sentinel_tpu_torch.chaos import failpoints as FP
        from sentinel_tpu_torch.chaos.plans import FaultPlan, FaultSpec
        from sentinel_tpu_torch.cluster.server import ClusterTokenServer
        from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
        from sentinel_tpu_torch.core.config import small_engine_config
        from sentinel_tpu_torch.obs.registry import REGISTRY
        from sentinel_tpu_torch.runtime.client import SentinelClient
        from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

        decision = SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                                  device="cpu")
        decision.start()
    else:
        import sentinel_tpu as st
        from sentinel_tpu.chaos import failpoints as FP
        from sentinel_tpu.chaos.plans import FaultPlan, FaultSpec
        from sentinel_tpu.cluster.server import ClusterTokenServer
        from sentinel_tpu.cluster.token_service import DefaultTokenService
        from sentinel_tpu.obs.registry import REGISTRY
        from sentinel_tpu.utils.time_source import VirtualTimeSource

        decision = _ref_client(VirtualTimeSource(1_000))
    m = _pkg(name)
    svc = DefaultTokenService(decision)
    svc.flow_rules.load("default", [st.FlowRule(resource="res-101", count=100.0, cluster_mode=True,
                                                cluster_flow_id=101)])
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0)
    server.start()
    decision.registry.resource_id("chaos/warm")
    f = decision.submit_acquire("chaos/warm")
    if f is not None:
        f.result(timeout=120.0)
    fb = _RecordingFallback(m, wait=7)  # wait 7 tells degraded spans from remote ones
    shard = m.RemoteShard("127.0.0.1", server.port, timeout_s=2.0, fallback=fb, retry_interval_s=60.0)
    shard.CHUNK = 4
    names = [f"chaos/part{i}" for i in range(12)]
    answered0 = REGISTRY.counter("sentinel_shard_chunks_total").value
    degraded0 = REGISTRY.counter("sentinel_shard_chunks_degraded_total").value

    def server_chunks(stt, want, deadline_s=10.0):
        deadline = time.monotonic() + deadline_s
        while stt.hit_counts().get("cluster.server.process", 0) < want and time.monotonic() < deadline:
            time.sleep(0.01)
        return stt.hit_counts().get("cluster.server.process", 0)

    try:
        with FP.armed(FaultPlan(seed=0, faults=[])) as stt:
            out_a = shard.check_batch(names)
            seen_a = server_chunks(stt, 3)
        plan = FaultPlan(seed=0, faults=[FaultSpec("parallel.shard.recv", "drop", max_fires=1)])
        with FP.armed(plan) as stt:
            out_b = shard.check_batch(names)
            seen_b = server_chunks(stt, 3)
    finally:
        shard.close()
        server.stop()
        svc.close()
        decision.stop()
    answered = REGISTRY.counter("sentinel_shard_chunks_total").value - answered0
    degraded = REGISTRY.counter("sentinel_shard_chunks_degraded_total").value - degraded0
    return ([tuple(map(int, r)) for r in out_a], [tuple(map(int, r)) for r in out_b], fb.batches, seen_a, seen_b,
            answered, degraded, shard._down_until > 0.0)


def test_a_mid_window_partition_through_the_ports_failpoints_is_never_replayed():
    port = _partition_run("port")
    assert port == _partition_run("ref")
    out_a, out_b, batches, seen_a, seen_b, answered, degraded, armed = port
    names = [f"chaos/part{i}" for i in range(12)]
    assert [w for _v, w in out_a] == [0] * 12  # remote verdicts
    assert [w for _v, w in out_b] == [7] * 12  # every span of the partitioned window degraded
    assert batches == [names[0:4], names[4:8], names[8:12]]
    assert seen_a == 3 and seen_b == 3  # the host saw each written chunk once
    assert (answered, degraded) == (3, 3) and armed
