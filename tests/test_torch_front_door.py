"""The native front door (cluster/front_door.py) and the client's door
drain, against the JAX package's.

Over real sockets on 127.0.0.1 (port 0, every read with a timeout):

* the counterparts of tests/test_front_door.py — flow round trip, param
  flow (C-side hashing at ``hash_param`` parity, per-value budgets,
  multi-value joins, doubles answered FAIL), concurrent tokens (the TTL
  token table on the host), a pipelined burst, and REUSEPORT shards.  The
  burst and the shards run on a threaded port client with the real
  clock, as the reference's tests do; the first three and the burst also
  run request by request on sync clients of both packages on virtual
  time, whose responses must be equal frame for frame;
* ``sentinel_front_door_unenforceable_rules`` (tests/test_chaos.py:362):
  a decision param rule whose lane gateway rules took counts once a
  sighting, a healthy one maps without counting — on both packages;
* step 0's parity test of the tick's column assembly with three sources
  at once: a sync client on virtual time under ``platform_config()`` at
  small widths (the presort on, batch 512), ticks that hold API acquires,
  an ``ArrayBlock`` (param lanes included) and the items of two doors
  (flow and param frames, prioritized ones among them), across a light
  tick (at most 256 items) and full ones (a door burst past 256).  The
  verdicts, the waits, every response frame and the packed readback
  equal the reference's tick by tick.

The JAX client of the parity test runs ``platform_config()``'s host path
with its jitted plain tick (``tests/torch_harness.jax_host_client``).
Statuses, waits and wire words are integers, compared for equality.
"""

from __future__ import annotations

import socket
import struct
import time

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.cluster import front_door as JFD
from sentinel_tpu.cluster import protocol as JP
from sentinel_tpu.cluster.rules import flow_resource as j_flow_resource
from sentinel_tpu.cluster.rules import param_resource as j_param_resource
from sentinel_tpu.cluster.token_service import DefaultTokenService as JService
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.core.rule_tensors import hash_param as j_hash_param
from sentinel_tpu.obs.registry import REGISTRY as JREG
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

import sentinel_tpu_torch as st
from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.cluster import front_door as FD
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.rules import flow_resource, param_resource
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core.config import platform_config, small_engine_config
from sentinel_tpu_torch.core.rule_tensors import hash_param
from sentinel_tpu_torch.native.loader import load_native
from sentinel_tpu_torch.obs.registry import REGISTRY
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import wire as WIRE
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.torch_harness import jax_host_client

pytestmark = pytest.mark.skipif(load_native() is None, reason="no C++ compiler for the native library")

#: one side of a comparison: the package's client, service, door and codec
PORT = dict(pkg=st, client=SentinelClient, service=DefaultTokenService, door=FD.NativeFrontDoor, P=P,
            flow_resource=flow_resource, param_resource=param_resource, hash_param=hash_param)
REF = dict(pkg=jst, client=JaxClient, service=JService, door=JFD.NativeFrontDoor, P=JP,
           flow_resource=j_flow_resource, param_resource=j_param_resource, hash_param=j_hash_param)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the front door closed the connection")
        buf += chunk
    return buf


def _read_responses(sock, codec, n: int, deadline_s: float = 10.0) -> dict:
    """xid -> (status, remaining, wait_ms, token_id) of ``n`` response frames."""
    got, buf = {}, b""
    end = time.monotonic() + deadline_s
    while len(got) < n and time.monotonic() < end:
        try:
            chunk = sock.recv(65536)
        except socket.timeout:
            continue
        if not chunk:
            break
        buf += chunk
        while len(buf) >= 2:
            (ln,) = struct.unpack(">H", buf[:2])
            if len(buf) - 2 < ln:
                break
            r = codec.decode_response(buf[2 : 2 + ln])
            got[r.xid] = (r.status, r.remaining, r.wait_ms, r.token_id)
            buf = buf[2 + ln :]
    assert len(got) == n, f"only {len(got)}/{n} answered"
    return got


def _wait_pending(doors, n: int, deadline_s: float = 10.0) -> None:
    end = time.monotonic() + deadline_s
    while sum(d.pending() for d in doors) < n:
        assert time.monotonic() < end, f"the doors hold {sum(d.pending() for d in doors)} of {n} frames"
        time.sleep(0.002)


class _SyncDoor:
    """A sync decision client on virtual time 1,000 (the small config, or
    ``cfg``), its token service (engine decisions), and ``n_doors`` doors
    following it, attached and started."""

    def __init__(self, side, cfg=None, n_doors=1, monkeypatch=None):
        self.side = side
        vt = (JVT if side is REF else VirtualTimeSource)(1_000)
        if side is REF:
            self.c = (jax_host_client(monkeypatch, cfg, vt) if cfg is not None
                      else JaxClient(cfg=jax_small_cfg(), time_source=vt, mode="sync"))
        else:
            self.c = SentinelClient(cfg=cfg or small_engine_config(), time_source=vt, mode="sync", device="cpu")
        self.c.start()
        self.svc = side["service"](self.c, use_token_column=False)
        self.doors = []
        for _ in range(n_doors):
            d = side["door"](port=0)
            d.follow(self.svc)
            self.c.attach_front_door(d)
            d.start()
            self.doors.append(d)
        self.socks = [socket.create_connection(("127.0.0.1", d.port), timeout=5) for d in self.doors]

    def rpc(self, req, ring: int = 1, door: int = 0):
        """One request: wait until its frame is in the ring (``ring=0``:
        the C side answers it alone), tick once at the current virtual ms,
        read the response."""
        self.socks[door].sendall(self.side["P"].encode_request(req))
        if ring:
            _wait_pending(self.doors[door : door + 1], ring)
            self.c.tick_once(self.c.time.now_ms())
        return _read_responses(self.socks[door], self.side["P"], 1)[req.xid]

    def close(self):
        for s in self.socks:
            s.close()
        for d in self.doors:
            d.stop()
        self.c.stop()
        for d in self.doors:
            d.close()
        self.svc.close()


def _both(fn):
    """Run ``fn(side)`` on the reference and on the port; their results."""
    return fn(REF), fn(PORT)


def _flow_roundtrip(side):
    d = _SyncDoor(side)
    try:
        R, Pc = side["pkg"], side["P"]
        d.svc.flow_rules.load("default", [R.FlowRule(resource="res-101", count=3.0, cluster_mode=True,
                                                     cluster_flow_id=101)])
        out = [d.rpc(Pc.ClusterRequest(xid=1, type=C.MSG_TYPE_PING, namespace="default"), ring=0)]
        out += [d.rpc(Pc.ClusterRequest(xid=10 + i, type=C.MSG_TYPE_FLOW, flow_id=101)) for i in range(5)]
        out.append(d.rpc(Pc.ClusterRequest(xid=99, type=C.MSG_TYPE_FLOW, flow_id=777), ring=0))
        # an unknown type is answered FAIL, not hung (a raw frame: the
        # encoder refuses to build one)
        raw = struct.pack(">iB", 100, 99)
        d.socks[0].sendall(struct.pack(">H", len(raw)) + raw)
        (n2,) = struct.unpack(">H", _recv_exact(d.socks[0], 2))
        bad = Pc.decode_response(_recv_exact(d.socks[0], n2))
        out.append((bad.xid, bad.status))
        return out
    finally:
        d.close()


def test_flow_roundtrip_equals_the_reference():
    ref, port = _both(_flow_roundtrip)
    assert port == ref
    assert port[0][0] == C.STATUS_OK
    statuses = [r[0] for r in port[1:6]]
    assert statuses.count(C.STATUS_OK) == 3 and statuses.count(C.STATUS_BLOCKED) == 2
    assert port[6][0] == C.STATUS_NO_RULE and port[7] == (100, C.STATUS_FAIL)


def _param_flow(side):
    d = _SyncDoor(side)
    try:
        R, Pc = side["pkg"], side["P"]
        d.svc.param_rules.load("default", [R.ParamFlowRule(resource="res-55", param_idx=0, count=2.0,
                                                           cluster_mode=True, cluster_flow_id=55)])
        out = []
        for xid, values in enumerate([["alice"], ["alice"], ["alice"], ["bob"], [7], [7], [7],
                                      ["carol", "alice"], ["carol"]], start=1):
            req = Pc.ClusterRequest(xid=xid, type=C.MSG_TYPE_PARAM_FLOW, flow_id=55, count=1, params=values)
            out.append(d.rpc(req))
        out.append(d.rpc(Pc.ClusterRequest(xid=10, type=C.MSG_TYPE_PARAM_FLOW, flow_id=55, count=1,
                                           params=[3.5]), ring=0))
        out.append(d.rpc(Pc.ClusterRequest(xid=12, type=C.MSG_TYPE_PARAM_FLOW, flow_id=777, count=1,
                                           params=["x"]), ring=0))
        return out
    finally:
        d.close()


def test_param_flow_equals_the_reference():
    ref, port = _both(_param_flow)
    assert port == ref
    ok, blocked = C.STATUS_OK, C.STATUS_BLOCKED
    assert [r[0] for r in port] == [ok, ok, blocked, ok, ok, ok, blocked, blocked, ok, C.STATUS_FAIL,
                                    C.STATUS_NO_RULE]


def _concurrent(side):
    d = _SyncDoor(side)
    try:
        R, Pc = side["pkg"], side["P"]
        d.svc.flow_rules.load("default", [R.FlowRule(resource="res-101", count=3.0, cluster_mode=True,
                                                     cluster_flow_id=101)])
        got = [d.rpc(Pc.ClusterRequest(xid=200 + i, type=C.MSG_TYPE_CONCURRENT_ACQUIRE, flow_id=101, count=1))
               for i in range(4)]
        ok = [r for r in got if r[0] == C.STATUS_OK]
        rel = d.rpc(Pc.ClusterRequest(xid=300, type=C.MSG_TYPE_CONCURRENT_RELEASE, token_id=ok[0][3]))
        again = d.rpc(Pc.ClusterRequest(xid=301, type=C.MSG_TYPE_CONCURRENT_RELEASE, token_id=ok[0][3]))
        more = d.rpc(Pc.ClusterRequest(xid=302, type=C.MSG_TYPE_CONCURRENT_ACQUIRE, flow_id=101, count=1))
        # token ids come from the service's own counter: compare their order
        ids = sorted({r[3] for r in ok})
        return [r[:3] for r in got], [ids.index(r[3]) for r in ok], rel[:3], again[:3], more[0]
    finally:
        d.close()


def test_concurrent_tokens_equal_the_reference():
    ref, port = _both(_concurrent)
    assert port == ref
    statuses = [r[0] for r in port[0]]
    assert statuses.count(C.STATUS_OK) == 3 and statuses.count(C.STATUS_BLOCKED) == 1
    assert sorted(port[1]) == [0, 1, 2]  # three distinct tokens
    assert port[2][0] == C.STATUS_RELEASE_OK and port[3][0] == C.STATUS_ALREADY_RELEASE
    assert port[4] == C.STATUS_OK  # the freed slot is reusable


def _burst(side):
    d = _SyncDoor(side)
    try:
        R, Pc = side["pkg"], side["P"]
        d.svc.flow_rules.load("default", [R.FlowRule(resource="res-101", count=3.0, cluster_mode=True,
                                                     cluster_flow_id=101)])
        n = 500
        d.socks[0].sendall(b"".join(Pc.encode_request(Pc.ClusterRequest(xid=i, type=C.MSG_TYPE_FLOW,
                                                                         flow_id=101)) for i in range(n)))
        _wait_pending(d.doors, n)
        d.c.tick_once(d.c.time.now_ms())  # the loop drains the ring across 64-item ticks
        return _read_responses(d.socks[0], Pc, n)
    finally:
        d.close()


def test_a_pipelined_burst_equals_the_reference_frame_for_frame():
    ref, port = _both(_burst)
    assert port == ref
    assert sum(1 for v in port.values() if v[0] == C.STATUS_OK) == 3


@pytest.fixture()
def threaded_door():
    """The reference test's setup on the port: a threaded client with the
    real clock serving one door."""
    c = SentinelClient(cfg=small_engine_config(), mode="threaded", tick_interval_ms=2.0, device="cpu")
    c.start()
    svc = DefaultTokenService(c, use_token_column=False)
    svc.flow_rules.load("default", [st.FlowRule(resource="res-101", count=3.0, cluster_mode=True,
                                                cluster_flow_id=101)])
    door = FD.NativeFrontDoor(port=0)
    door.follow(svc)
    c.attach_front_door(door)
    door.start()
    yield door, c
    door.stop()
    c.stop()
    door.close()
    svc.close()


def test_a_pipelined_burst_on_the_threaded_loop_answers_every_frame(threaded_door):
    door, _c = threaded_door
    s = socket.create_connection(("127.0.0.1", door.port), timeout=5)
    try:
        n = 500
        s.sendall(b"".join(P.encode_request(P.ClusterRequest(xid=i, type=C.MSG_TYPE_FLOW, flow_id=101))
                           for i in range(n)))
        got = _read_responses(s, P, n)
        assert sum(1 for v in got.values() if v[0] == C.STATUS_OK) >= 1
        assert all(v[0] in (C.STATUS_OK, C.STATUS_BLOCKED) for v in got.values())
    finally:
        s.close()


def test_reuseport_shards_serve_one_engine():
    """SO_REUSEPORT: two doors on ONE port, each with its own io thread;
    the kernel spreads the connections and both shards' traffic rides the
    same engine batches."""
    c = SentinelClient(cfg=small_engine_config(), mode="threaded", tick_interval_ms=2.0, device="cpu")
    c.start()
    svc = DefaultTokenService(c, use_token_column=False)
    svc.flow_rules.load("default", [st.FlowRule(resource="res-7", count=1000.0, cluster_mode=True,
                                                cluster_flow_id=7)])
    doors = [FD.NativeFrontDoor(port=0, reuseport=True)]
    port = doors[0].port
    doors.append(FD.NativeFrontDoor(port=port, reuseport=True))
    try:
        for d in doors:
            d.follow(svc)
            c.attach_front_door(d)
            d.start()
        ok = 0
        for i in range(24):
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            try:
                s.sendall(P.encode_request(P.ClusterRequest(xid=i, type=C.MSG_TYPE_FLOW, flow_id=7)))
                ok += _read_responses(s, P, 1)[i][0] == C.STATUS_OK
            finally:
                s.close()
        assert ok == 24
    finally:
        for d in doors:
            d.stop()
        c.stop()
        for d in doors:
            d.close()
        svc.close()


def _unenforceable(side, reg, counter):
    R = side["pkg"]
    made = []

    def client():
        c = (JaxClient(cfg=jax_small_cfg(), time_source=JVT(1_000), mode="sync") if side is REF else
             SentinelClient(cfg=small_engine_config(), time_source=VirtualTimeSource(1_000), mode="sync",
                            device="cpu"))
        c.start()
        made.append(c)
        return c

    try:
        decision = client()
        svc = side["service"](decision, use_token_column=False)
        name = side["param_resource"](7)
        # gateway rules claim both hash lanes of the shared resource first,
        # so the cluster decision rule's param_idx 0 gets none
        decision.gateway_param_rules.load([R.ParamFlowRule(resource=name, count=5.0, param_idx=1),
                                           R.ParamFlowRule(resource=name, count=5.0, param_idx=2)])
        svc.param_rules.load("default", [R.ParamFlowRule(resource="res-7", count=3.0, cluster_mode=True,
                                                         cluster_flow_id=7)])
        before = counter.value
        lane = (JFD if side is REF else FD).resolve_param_lane(svc, 7, name)
        counted = counter.value - before
        door = side["door"](port=0)
        door.follow(svc)  # the rule-map rebuild sights it again
        door.close()
        sighted = counter.value - before
        text = reg.exposition()
        svc2 = side["service"](client(), use_token_column=False)
        svc2.param_rules.load("default", [R.ParamFlowRule(resource="res-8", count=3.0, cluster_mode=True,
                                                          cluster_flow_id=8)])
        before2 = counter.value
        lane2 = (JFD if side is REF else FD).resolve_param_lane(svc2, 8, side["param_resource"](8))
        return lane, counted, sighted, "sentinel_front_door_unenforceable_rules" in text, lane2, \
            counter.value - before2
    finally:
        for c in made:
            c.stop()


def test_front_door_unenforceable_param_rule_counts():
    """tests/test_chaos.py:362 on both packages: a decision param rule
    whose param_idx 0 lost its hash lane increments the counter (once a
    sighting: a door's rule-map rebuild sights it again), not only the
    log; a healthy rule maps to lane 0 without counting."""
    ref = _unenforceable(REF, JREG, JFD._C_UNENFORCEABLE)
    port = _unenforceable(PORT, REGISTRY, FD._C_UNENFORCEABLE)
    assert port == ref == (None, 1, 2, True, 0, 0)


# -- step 0: three sources in one tick ---------------------------------------------------------

#: platform_config()'s flags and small widths, batch 512 (light ticks at 256)
MIXED = dict(max_resources=64, max_nodes=128, max_flow_rules=64, max_degrade_rules=32, max_param_rules=8,
             batch_size=512, complete_batch_size=64, param_width=512)
PLATFORM_FLAGS = dict(use_mxu_tables=True, fused_effects=True, seg_effects=True, seg_fallback=True)
#: (API acquires, block items, door-1 frames, door-2 frames) of each step;
#: the first is a light tick, the others full ones (a door burst past 256)
STEPS = [(20, 30, 40, 30), (30, 40, 150, 150), (5, 0, 300, 0)]


def _frames(codec, rng, n, xid0, fids, pfid, values):
    """n frames: flow frames on ``fids`` (one in four prioritized) and param
    frames on ``pfid`` with int and string values."""
    out = []
    for i in range(n):
        if rng.random() < 0.4:
            v = values[int(rng.integers(len(values)))]
            out.append(codec.ClusterRequest(xid=xid0 + i, type=C.MSG_TYPE_PARAM_FLOW, flow_id=pfid, count=1,
                                            params=[v]))
        else:
            out.append(codec.ClusterRequest(xid=xid0 + i, type=C.MSG_TYPE_FLOW, flow_id=int(rng.choice(fids)),
                                            count=int(rng.integers(1, 3)), priority=bool(rng.random() < 0.25)))
    return out


def _mixed_run(side, monkeypatch):
    cfg = (jax_small_cfg(**PLATFORM_FLAGS, **MIXED) if side is REF else platform_config(**MIXED))
    d = _SyncDoor(side, cfg=cfg, n_doors=2, monkeypatch=monkeypatch)
    R, Pc, c = side["pkg"], side["P"], d.c
    ticks = []
    real = c._run_tick

    def spy(*a, **kw):
        p = real(*a, **kw)
        ticks.append(p)
        return p

    c._run_tick = spy
    try:
        d.svc.flow_rules.load("default", [
            R.FlowRule(resource="f7", count=120.0, cluster_mode=True, cluster_flow_id=7),
            R.FlowRule(resource="f8", count=40.0, cluster_mode=True, cluster_flow_id=8),
        ])
        d.svc.param_rules.load("default", [R.ParamFlowRule(resource="p55", param_idx=0, count=6.0,
                                                           cluster_mode=True, cluster_flow_id=55)])
        names = [side["flow_resource"](7), side["flow_resource"](8)]
        pname = side["param_resource"](55)
        rows = np.array([c.registry.resource_id(n) for n in names + [pname]], np.int32)
        values = ["alice", "bob", 7, 11, "carol"]
        hashes = np.array([side["hash_param"](v) for v in values], np.int32)
        rng = np.random.default_rng(16)
        out, xid = [], 1
        for n_api, n_blk, n_d1, n_d2 in STEPS:
            c.mode = "threaded"  # queue without ticking
            api = [c.submit_acquire(names[int(rng.integers(2))], count=int(rng.integers(1, 3)),
                                    prioritized=bool(rng.random() < 0.3)) for _ in range(n_api)]
            blk = None
            if n_blk:
                pick = rng.integers(0, 3, n_blk)
                ph = np.zeros((n_blk, c.cfg.param_dims), np.int32)
                ph[:, 0] = np.where(pick == 2, hashes[rng.integers(0, len(values), n_blk)], 0)
                blk = c.submit_block(rows[pick], counts=rng.integers(1, 3, n_blk).astype(np.int32),
                                     param_hash=ph)
            c.mode = "sync"
            sent = []
            for k, n in enumerate((n_d1, n_d2)):
                fr = _frames(Pc, rng, n, xid, [7, 8], 55, values)
                xid += n
                if fr:
                    d.socks[k].sendall(b"".join(Pc.encode_request(f) for f in fr))
                sent.append(len(fr))
            _wait_pending(d.doors, n_d1 + n_d2)
            n_before = len(ticks)
            c.tick_once(c.time.now_ms())
            shapes = [int(p.out.wire.shape[0]) for p in ticks[n_before:]]
            rsp = {k: _read_responses(d.socks[k], Pc, sent[k]) if sent[k] else {} for k in range(2)}
            out.append(dict(
                api=[tuple(map(int, f.result(timeout=5))) for f in api],
                blk=None if blk is None else [np.asarray(x).tolist() for x in blk.result(timeout=5)],
                doors=rsp,
                wires=[np.asarray(p.out.wire.cpu() if hasattr(p.out.wire, "cpu") else p.out.wire).tolist()
                       for p in ticks[n_before:]],
                shapes=shapes,
                los=[p.wire_lo for p in ticks[n_before:]],
            ))
            c.time.advance(40)
        return out
    finally:
        c._run_tick = real
        d.close()


def test_a_tick_of_api_items_a_block_and_door_items_equals_the_reference(monkeypatch):
    ref = _mixed_run(REF, monkeypatch)
    port = _mixed_run(PORT, monkeypatch)
    assert len(port) == len(ref) == len(STEPS)
    for i, (t, j) in enumerate(zip(port, ref)):
        assert t["api"] == j["api"], i
        assert t["blk"] == j["blk"], i
        assert t["doors"] == j["doors"], i
        assert len(t["wires"]) == len(j["wires"]) == 1, i  # one tick a step: everything fits a batch
        (tw,), (jw,) = t["wires"], j["wires"]
        # every word equal but two: the telemetry row's live-segment count,
        # which the reference's plain tick does not have (it reports 0; the
        # port runs the segment path), and the checksum over it
        (lo,) = t["los"]
        skip = {3, lo.off_stats + E.STAT_SEG_LIVE}
        assert len(tw) == len(jw) == lo.total, i
        bad = [k for k, (a, b) in enumerate(zip(tw, jw)) if (a - b) % (1 << 32) and k not in skip]
        assert not bad, f"step {i}: the packed wire differs at {bad}"
        WIRE.unpack(np.asarray(tw, np.int64).astype(np.uint32).view(np.int32).tobytes(), lo)
    # the first step is a light tick, the others full ones
    assert [s["los"][0].b for s in port] == [256, 512, 512]
    statuses = {v[0] for s in port for rsp in s["doors"].values() for v in rsp.values()}
    assert {C.STATUS_OK, C.STATUS_BLOCKED} <= statuses
    assert any(v[0] == C.STATUS_SHOULD_WAIT and v[2] > 0
               for s in port for rsp in s["doors"].values() for v in rsp.values())
