"""The port's cluster token layer against the JAX package's.

Each check hands both packages the same inputs — seeded numpy streams,
the same rules, the same virtual time — and compares the answers:

- the token column (``ops/token_col.decide_batch``) element for element,
  with the whole state after every chunk, across bucket rollover, with
  padding, slot-run heads, partial, strict and forced entries; and a
  state run in the JAX package, carried across and continued in both;
- the column batcher's ``project()`` (slots kept, recycled and grown)
  with the decisions that follow it;
- the protocol's frames byte for byte (v1, v2 BATCH, the v3 provenance
  block, the trace tail), and each package decoding the other's;
- ``HostWindow``;
- ``DefaultTokenService`` verdict for verdict on one scripted stream, on
  both decision paths (the column and the decision client's engine).

``observed`` and the column's float state are compared exactly: they are
sums of integers below 2^24.
"""

import types

import jax
import numpy as np
import pytest
import torch

from sentinel_tpu.cluster import constants as JC
from sentinel_tpu.cluster import protocol as JP
from sentinel_tpu.cluster import token_service as JTS
from sentinel_tpu.cluster.rules import ClusterServerConfigManager as JCfgMgr
from sentinel_tpu.cluster.rules import ServerFlowConfig as JSFC
from sentinel_tpu.core import rules as JR
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.ops import token_col as JTC
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.host_window import HostWindow as JHostWindow
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

from sentinel_tpu_torch import state as S
from sentinel_tpu_torch.cluster import constants as TC_
from sentinel_tpu_torch.cluster import protocol as TP
from sentinel_tpu_torch.cluster import token_service as TTS
from sentinel_tpu_torch.cluster.rules import ClusterServerConfigManager as TCfgMgr
from sentinel_tpu_torch.cluster.rules import ServerFlowConfig as TSFC
from sentinel_tpu_torch.core import rules as TR
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.ops import token_col as TTC
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.host_window import HostWindow as THostWindow
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

NO_PLANES = dict(device_telemetry=False, timeline_k=0, explain_k=0)
CAP = 256


# -- the token column ------------------------------------------------------------


def column_chunk(rng, n_slots: int, n: int, zipf: bool = True) -> tuple:
    """One presorted chunk as the batcher builds it: n live entries (Zipf
    slots, asks 1..8 with a few large ones), padded to CAP with slot 0 /
    units 0, heads at each slot run's first entry, a mix of partial,
    strict and forced entries."""
    if zipf:
        w = 1.0 / np.arange(1, n_slots + 1) ** 1.1
        s = rng.choice(n_slots, size=n, p=w / w.sum())
    else:
        s = rng.integers(0, n_slots, n)
    s = np.sort(s).astype(np.int32)
    u = rng.integers(1, 9, n).astype(np.int32)
    u[rng.random(n) < 0.05] = 1 << 21  # past the 2^20 clip
    kind = rng.random(n)
    slots = np.zeros(CAP, np.int32)
    units = np.zeros(CAP, np.int32)
    heads = np.arange(CAP, dtype=np.int32)
    partial = np.zeros(CAP, bool)
    forced = np.zeros(CAP, bool)
    slots[:n], units[:n] = s, u
    partial[:n] = kind < 0.4
    forced[:n] = kind > 0.9
    newseg = np.ones(n, bool)
    newseg[1:] = s[1:] != s[:-1]
    heads[:n] = np.maximum.accumulate(np.where(newseg, np.arange(n), 0))
    return slots, units, heads, partial, forced


def assert_col_state_equal(tstate, jstate):
    want = jax.tree.map(np.asarray, jstate)
    got = S.to_numpy(tstate)
    for name in ("counts", "rt_sum", "rt_min", "epochs", "run", "run_rt", "run_rt_min", "rot_wid"):
        np.testing.assert_array_equal(getattr(got.win, name), getattr(want.win, name), err_msg=name)
    np.testing.assert_array_equal(got.limits, want.limits)


def _limits(rng, n_slots):
    return rng.integers(0, 40, n_slots).astype(np.float32) + rng.choice([0.0, 0.5], n_slots).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decide_batch_matches_the_reference_element_for_element(seed):
    rng = np.random.default_rng(seed)
    n_slots = 64
    limits = _limits(rng, n_slots)
    js = JTC.set_limits(JTC.init_state(n_slots), limits)
    ts = TTC.set_limits(TTC.init_state(n_slots, "cpu"), torch.from_numpy(limits))
    decide = JTC.jitted_decide()
    now = 1_000 + int(rng.integers(0, 100))
    granted_any = denied_any = 0
    for i in range(24):
        cols = column_chunk(rng, n_slots, int(rng.integers(1, CAP + 1)), zipf=i % 3 != 2)
        jg, jo, js = decide(js, np.int32(now), *cols)
        tg, to, ts = TTC.decide_batch(ts, now, *(torch.from_numpy(c) for c in cols))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert tg.dtype == torch.int32 and to.dtype == torch.float32
        assert_col_state_equal(ts, js)
        granted_any += int((tg > 0).sum())
        denied_any += int(((tg == 0) & (torch.from_numpy(cols[1]) > 0)).sum())
        # across buckets (100 ms), some chunks inside one bucket, and a
        # jump past the whole window
        now += int(rng.choice([0, 7, 60, 100, 250, 1_300]))
    assert granted_any and denied_any


def test_a_reference_column_state_carried_across_continues_identically():
    rng = np.random.default_rng(7)
    n_slots = 32
    limits = _limits(rng, n_slots)
    js = JTC.set_limits(JTC.init_state(n_slots), limits)
    decide = JTC.jitted_decide()
    now = 5_000
    for _ in range(6):
        _g, _o, js = decide(js, np.int32(now), *column_chunk(rng, n_slots, 200))
        now += 40
    ts = S.token_col_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert_col_state_equal(ts, js)
    for _ in range(6):
        cols = column_chunk(rng, n_slots, 180)
        jg, jo, js = decide(js, np.int32(now), *cols)
        tg, to, ts = TTC.decide_batch(ts, now, *(torch.from_numpy(c) for c in cols))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        now += 55
    assert_col_state_equal(ts, js)
    assert TTC.ms_to_next_bucket(1_234) == JTC.ms_to_next_bucket(1_234) == 66


def _fake_service(time_source, device=None):
    """What a column batcher reads of its service: the decision client's
    clock, device, timeline (off) and registry."""
    client = types.SimpleNamespace(time=time_source, timeline=None, registry=None, device=device)
    return types.SimpleNamespace(client=client)


def _decide_now(batcher, entries, now):
    """Decide ``entries`` as ONE drain of the batcher's worker would (in
    chunks of CAPACITY), on this thread: the worker drains whatever was
    queued when it woke, so batches it forms from concurrent submissions
    depend on timing (the within-batch prefix charges requested units)."""
    from concurrent.futures import Future

    queued = [(*e, Future()) for e in entries]
    with batcher._s_lock:
        for i in range(0, len(queued), batcher.CAPACITY):
            batcher._decide_chunk(queued[i : i + batcher.CAPACITY], now)
    return [q[-1].result(timeout=0) for q in queued]


def test_project_keeps_recycles_and_grows_slots_as_the_reference():
    """Both batchers through the same rule pushes and decisions: retained
    flows keep their slot and ledger, a dropped flow's slot is recycled
    zeroed, capacity doubles from 8; every answer and the state after each
    step are equal."""
    jvt, tvt = JaxVT(10_000), VirtualTimeSource(10_000)
    jb = JTS.TokenColumnBatcher(_fake_service(jvt))
    tb = TTS.TokenColumnBatcher(_fake_service(tvt, torch.device("cpu")))
    rng = np.random.default_rng(3)
    pushes = [
        {f: float(f % 7 + 2) for f in range(1, 7)},
        {f: float(f % 5 + 3) for f in (2, 3, 5, 40, 41)},  # drops 1, 4, 6; recycles for 40, 41
        {f: float(f % 9 + 1) for f in list(range(2, 8)) + list(range(100, 115))},  # grows 8 -> 32
        {f: 4.0 for f in (3, 100, 101)},
    ]
    try:
        for k, thr in enumerate(pushes):
            jb.project(thr)
            tb.project(thr)
            assert tb._slots == jb._slots and tb._cap == jb._cap
            assert_col_state_equal(tb._state, jb._state)
            fids = sorted(thr) + [999]  # 999: no rule, grants 0
            for step in range(3):
                entries = [(int(rng.choice(fids)), int(rng.integers(1, 5)), bool(rng.random() < 0.5),
                            bool(rng.random() < 0.1)) for _ in range(int(rng.integers(1, 300)))]
                now = jvt.now_ms()
                assert _decide_now(tb, entries, now) == _decide_now(jb, entries, now), (k, step)
                assert_col_state_equal(tb._state, jb._state)
                jvt.advance(70)
                tvt.advance(70)
    finally:
        jb.close()
        tb.close()


# -- the protocol ------------------------------------------------------------------------


def _requests(P, C):
    return [
        P.ClusterRequest(xid=1, type=C.MSG_TYPE_PING, namespace="ns-é"),
        P.ClusterRequest(xid=2, type=C.MSG_TYPE_FLOW, flow_id=12345678901, count=3, priority=True),
        P.ClusterRequest(xid=3, type=C.MSG_TYPE_FLOW_BATCH, flow_id=7, count=500, trace_id=2**63 + 5, span_id=9),
        P.ClusterRequest(xid=4, type=C.MSG_TYPE_PARAM_FLOW, flow_id=5, count=1,
                         params=[42, 2**40, 3.5, "user-x", True, object()]),
        P.ClusterRequest(xid=5, type=C.MSG_TYPE_PARAM_FLOW, flow_id=5, count=2, params=["a"], trace_id=3, span_id=4),
        P.ClusterRequest(xid=6, type=C.MSG_TYPE_CONCURRENT_ACQUIRE, flow_id=9, count=2),
        P.ClusterRequest(xid=7, type=C.MSG_TYPE_CONCURRENT_RELEASE, token_id=2**40, trace_id=1, span_id=1),
        P.ClusterRequest(xid=8, type=C.MSG_TYPE_LEASE, flow_id=11, count=64),
        P.ClusterRequest(xid=9, type=C.MSG_TYPE_RES_CHECK, params=["r", 1, False, "", "i:3"]),
        P.ClusterRequest(xid=10, type=C.MSG_TYPE_HELLO, count=C.PROTOCOL_VERSION),
    ]


def _responses(P, C):
    return [
        P.ClusterResponse(xid=3, type=C.MSG_TYPE_FLOW, status=C.STATUS_SHOULD_WAIT, remaining=10, wait_ms=250),
        P.ClusterResponse(xid=4, type=C.MSG_TYPE_PARAM_FLOW, status=C.STATUS_BLOCKED, trace_id=77, span_id=8),
        P.ClusterResponse(xid=5, type=C.MSG_TYPE_CONCURRENT_ACQUIRE, status=C.STATUS_OK, token_id=2**33),
        P.ClusterResponse(xid=6, type=C.MSG_TYPE_CONCURRENT_RELEASE, status=C.STATUS_RELEASE_OK),
        P.ClusterResponse(xid=7, type=C.MSG_TYPE_RES_CHECK, status=C.STATUS_OK, items=[(0, 0), (2, 15)]),
        P.ClusterResponse(xid=8, type=C.MSG_TYPE_HELLO, status=C.STATUS_OK, remaining=3),
        P.ClusterResponse(xid=9, type=C.MSG_TYPE_LEASE, status=C.STATUS_OK, remaining=64, wait_ms=1000),
    ]


def _batch_frames(P, C, tid=0):
    req = P.ClusterBatchRequest(
        xid=11,
        kinds=np.array([C.BATCH_KIND_FLOW, C.BATCH_KIND_FLOW_BATCH, C.BATCH_KIND_LEASE], np.uint8),
        ids=np.array([101, 2**40, -7], np.int64),
        counts=np.array([1, 500, 32], np.int32),
        flags=np.array([C.BATCH_FLAG_PRIORITIZED, C.BATCH_FLAG_EXPLAIN, 0], np.uint8),
        trace_id=tid,
        span_id=tid and 5,
    )
    rsp = P.ClusterBatchResponse(
        xid=11, status=C.STATUS_OK,
        statuses=np.array([C.STATUS_BLOCKED, C.STATUS_OK, C.STATUS_BLOCKED], np.int8),
        remainings=np.array([0, 77, 0], np.int32),
        waits=np.array([0, 0, 1000], np.int32),
        token_ids=np.array([0, 0, 2**35], np.int64),
        trace_id=tid,
        span_id=tid and 6,
        # v3 provenance: observed / limit on the 1/256 grid, one unknown
        prov=[(1, 101, 12.5, 10.0), None, (1, 2**40, None, 3.25)],
    )
    return req, rsp


def test_protocol_frames_are_byte_identical_to_the_reference():
    for jr, tr in zip(_requests(JP, JC), _requests(TP, TC_)):
        raw = TP.encode_request(tr)
        assert raw == JP.encode_request(jr), tr.type
        # each decodes the other's frame to the same fields
        jd, td = JP.decode_request(raw[2:]), TP.decode_request(raw[2:])
        assert vars(jd) == vars(td)
    for jr, tr in zip(_responses(JP, JC), _responses(TP, TC_)):
        raw = TP.encode_response(tr)
        assert raw == JP.encode_response(jr), tr.type
        assert vars(JP.decode_response(raw[2:])) == vars(TP.decode_response(raw[2:]))
    for tid in (0, 2**64 - 3):
        (jq, js), (tq, ts) = _batch_frames(JP, JC, tid), _batch_frames(TP, TC_, tid)
        for enc_t, enc_j, dec_t, dec_j, a, b in (
            (TP.encode_batch_request, JP.encode_batch_request, TP.decode_batch_request,
             JP.decode_batch_request, tq, jq),
            (TP.encode_batch_response, JP.encode_batch_response, TP.decode_batch_response,
             JP.decode_batch_response, ts, js),
        ):
            raw = enc_t(a)
            assert raw == enc_j(b)
            got, want = dec_t(raw[2:]), dec_j(raw[2:])
            for f in vars(want):
                g, w = getattr(got, f), getattr(want, f)
                if isinstance(w, np.ndarray):
                    np.testing.assert_array_equal(g, w)
                else:
                    assert g == w, f
        assert TP.peek_type(raw[2:]) == TC_.MSG_TYPE_BATCH
    # a frame whose length is not exactly n entries fails whole, in both
    raw = TP.encode_batch_request(_batch_frames(TP, TC_)[0])[2:]
    for bad in (raw[:-1], raw + b"\x00"):
        with pytest.raises(ValueError):
            TP.decode_batch_request(bad)
        with pytest.raises(ValueError):
            JP.decode_batch_request(bad)
    # the frame splitter on a stream cut at every byte
    stream = b"".join(TP.encode_request(r) for r in _requests(TP, TC_))
    fr = TP.FrameReader()
    bodies = [b for i in range(len(stream)) for b in fr.feed(stream[i:i + 1])]
    assert bodies == JP.FrameReader().feed(stream)


def test_host_window_matches_the_reference():
    rng = np.random.default_rng(11)
    jw, tw = JHostWindow(10, 1000, events=2), THostWindow(10, 1000, events=2)
    now = 10_000
    for _ in range(400):
        op = rng.integers(0, 4)
        ev = int(rng.integers(0, 2))
        if op == 0:
            c = int(rng.integers(1, 4))
            jw.add(now, c, ev)
            tw.add(now, c, ev)
        elif op == 1:
            assert tw.sum(now, ev) == jw.sum(now, ev)
            assert tw.qps(now, ev) == jw.qps(now, ev)
        else:
            lim = float(rng.integers(1, 30))
            assert tw.try_pass(now, lim) == jw.try_pass(now, lim)
        now += int(rng.choice([0, 3, 40, 150, 1_200]))


# -- DefaultTokenService ------------------------------------------------------------------


def _flow_rule(m, fid, count, threshold_type):
    return m.FlowRule(resource=f"res-{fid}", count=count, cluster_mode=True, cluster_flow_id=fid,
                      cluster_threshold_type=threshold_type)


def _service(pkg, use_token_column):
    """A DefaultTokenService on a sync decision client (virtual time), a
    namespace guard of 8 QPS on "guarded", a 1 s concurrent-token TTL."""
    if pkg == "jax":
        vt = JaxVT(1_000)
        dec = JaxClient(cfg=jax_small_cfg(**NO_PLANES), time_source=vt, mode="sync")
        # every column upload a private copy (ROADMAP.md Queue C: on the CPU
        # jnp.asarray may alias the client's reused staging buffers)
        upload = dec._dev_col
        dec._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
        cfgm, sfc, mod, m, C = JCfgMgr(), JSFC, JTS, JR, JC
    else:
        vt = VirtualTimeSource(1_000)
        dec = SentinelClient(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES), time_source=vt,
                             mode="sync", device="cpu")
        cfgm, sfc, mod, m, C = TCfgMgr(), TSFC, TTS, TR, TC_
    dec.start()
    cfgm.set_flow_config("guarded", sfc(max_allowed_qps=8.0))
    svc = mod.DefaultTokenService(dec, config=cfgm, concurrent_ttl_ms=1000, use_token_column=use_token_column)
    census = {"n": 1}
    svc.connected_count_fn = lambda ns: census["n"]
    svc.flow_rules.load("default", [
        _flow_rule(m, 101, 5, C.FLOW_THRESHOLD_GLOBAL),
        _flow_rule(m, 102, 2, C.FLOW_THRESHOLD_AVG_LOCAL),
        _flow_rule(m, 103, 100, C.FLOW_THRESHOLD_GLOBAL),
    ])
    svc.flow_rules.load("guarded", [_flow_rule(m, 201, 1000, C.FLOW_THRESHOLD_GLOBAL)])
    svc.param_rules.load("default", [m.ParamFlowRule(resource="p", count=2, cluster_mode=True, cluster_flow_id=55,
                                                     duration_in_sec=1)])
    return svc, dec, vt, census


def _tr(r):
    return (r.status, r.remaining, r.wait_ms, r.token_id, r.prov_kind, r.prov_rule, r.prov_observed, r.prov_limit)


def _script(svc, vt, census, C, rng):
    """One scripted stream through every service entry point."""
    out = []
    for step in range(70):
        op = int(rng.integers(0, 9))
        fid = int(rng.choice([101, 102, 103, 999]))
        if op <= 1:
            for _ in range(int(rng.integers(1, 9))):
                out.append(("tok", _tr(svc.request_token(fid, int(rng.integers(1, 3)), bool(rng.random() < 0.5)))))
        elif op == 2:
            out.append(("batch", _tr(svc.request_token_batch(fid, int(rng.integers(0, 7))))))
        elif op == 3:
            for _ in range(int(rng.integers(1, 5))):
                out.append(("param", _tr(svc.request_param_token(55, 1, [str(rng.choice(["alice", "bob"]))]))))
        elif op == 4:
            for _ in range(int(rng.integers(1, 9))):
                r = svc.request_concurrent_token(fid, 1)
                out.append(("conc", _tr(r)))
                if r.token_id and rng.random() < 0.3:
                    out.append(("rel", _tr(svc.release_concurrent_token(r.token_id))))
            out.append(("rel-unknown", _tr(svc.release_concurrent_token(10**9))))
        elif op == 5:
            out.append(("guard", [_tr(svc.request_token(201)) for _ in range(int(rng.integers(1, 12)))]))
        elif op == 6:
            # one entry a flow: the frame's entries reach the column batcher
            # one by one, and how its worker groups them is timing
            n = int(rng.integers(1, 6))
            kinds = rng.choice([C.BATCH_KIND_FLOW, C.BATCH_KIND_FLOW_BATCH, C.BATCH_KIND_LEASE, 9], n).astype(np.uint8)
            ids = rng.choice([101, 102, 103, 201, 999], n, replace=False).astype(np.int64)
            counts = rng.integers(-1, 6, n).astype(np.int32)
            flags = rng.choice([0, C.BATCH_FLAG_PRIORITIZED], n).astype(np.uint8)
            st, rem, wt, tok, prov = svc.decide_frame(kinds, ids, counts, flags)
            out.append(("frame", st.tolist(), rem.tolist(), wt.tolist(), tok.tolist(), prov))
        elif op == 7:
            census["n"] = int(rng.integers(1, 4))
            svc.refresh_connected_count()
            out.append(("census", census["n"]))
        else:
            svc.concurrent.expire(vt.now_ms())
            out.append(("cur", svc.concurrent.current(fid)))
        vt.advance(int(rng.choice([0, 0, 30, 120, 400])))
    return out


@pytest.mark.parametrize("use_token_column", [True, False])
def test_default_token_service_matches_the_reference_verdict_for_verdict(use_token_column):
    got = {}
    for pkg, C in (("jax", JC), ("port", TC_)):
        svc, dec, vt, census = _service(pkg, use_token_column)
        try:
            got[pkg] = _script(svc, vt, census, C, np.random.default_rng(5))
            if use_token_column:
                got[pkg + "-state"] = svc.col._state
        finally:
            svc.close()
            dec.stop()
    assert got["port"] == got["jax"]
    kinds = {(o[0], o[1][0]) for o in got["port"] if o[0] in ("tok", "batch", "param", "conc")}
    # the stream reaches grants, denies, SHOULD_WAIT, partial grants and
    # unknown flows on the token paths
    assert {("tok", TC_.STATUS_OK), ("tok", TC_.STATUS_BLOCKED), ("tok", TC_.STATUS_SHOULD_WAIT),
            ("tok", TC_.STATUS_NO_RULE), ("param", TC_.STATUS_BLOCKED), ("conc", TC_.STATUS_BLOCKED)} <= kinds
    guard = [t[0] for o in got["port"] if o[0] == "guard" for t in o[1]]
    assert TC_.STATUS_TOO_MANY_REQUEST in guard
    if use_token_column:
        assert_col_state_equal(got["port-state"], got["jax-state"])
