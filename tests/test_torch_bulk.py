"""The port's bulk client API and pipelined readback against the JAX
package's client.

Both clients run in mode="sync" on virtual time with the same rules and
the same seeded column arrays: ``submit_block`` (blocks larger than the
batch span ticks; negative ids are padding), ``submit_acquire`` object
requests queued into the same ticks as the blocks, ``check_batch``,
``check_batch_ids``, ``submit_completion_block`` and ``entry_async``.
Their verdicts and waits must be EQUAL.  The port runs on the CPU (its
kernels' plain versions) on the per-item fused path, the segment path
without the fallback, and the segment path with ``seg_fallback=True`` at
a capacity the blocks overflow; the JAX client runs its default CPU
engine path, as tests/test_torch_client.py explains.  RTs are whole
virtual milliseconds, so the fused path's 1/8 ms RT quantization is
exact on both sides.
"""

import asyncio

import numpy as np
import pytest
import torch

import sentinel_tpu as jst
from sentinel_tpu.core import config as JCFG
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import state as S
from sentinel_tpu_torch.core import api as TAPI
from sentinel_tpu_torch.core.config import platform_config, small_engine_config
from sentinel_tpu_torch.runtime import client as TC
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.test_torch_client import NO_PLANES, SEG, SINGLE_LANE, _rules

NAMES = ["a", "b", "c", "d", "w", "o", "x", "y"]
#: one origin a resource: the segment path presorts by (resource, origin,
#: ...), which keeps the arrival order among a resource's items only while
#: they share their other keys (the reference's presort does the same)
ORIGIN = {"d": "bad", "o": "good"}
PATHS = {
    "fused": dict(use_mxu_tables=True, fused_effects=True, **NO_PLANES),
    "seg": dict(SEG),
    "fallback": dict(SEG, **SINGLE_LANE, seg_fallback=True, seg_u=8),
}


def _load(client, m):
    for n in NAMES:
        client.registry.resource_id(n)
    for o in ("bad", "good"):
        client.registry.origin_id(o)
    # no system rule: its within-tick rank runs over the whole batch, which
    # the segment path presorts (the per-resource ranks keep their order)
    rules = _rules(m)
    client.flow_rules.load(rules["flow"])
    client.degrade_rules.load(rules["degrade"])
    client.authority_rules.load(rules["authority"])


def _jax_client():
    jc = JaxClient(cfg=jax_small_cfg(**NO_PLANES), time_source=JaxVT(1_000), mode="sync")
    # the reference's device-column cache aliases its staging buffers
    # (ROADMAP.md Queue C): hand it copies, as tests/test_torch_client.py does
    upload = jc._dev_col
    jc._dev_col = lambda field, x, fill: upload(field, np.array(x, copy=True), fill)
    jc.start()
    _load(jc, jst)
    return jc


def _port_client(flags, depth=0, device="cpu"):
    tc = SentinelClient(
        cfg=small_engine_config(**flags), time_source=VirtualTimeSource(1_000), mode="sync",
        device=device, pipeline_depth=depth,
    )
    tc.start()
    _load(tc, tst)
    return tc


def _block_columns(client, rng, n):
    """One block's columns: ids of NAMES (and some -1), counts 1..3, some
    prioritized and inbound items, ORIGIN's origins."""
    reg = client.registry
    pick = rng.integers(0, len(NAMES), n)
    res = np.array([reg.peek_resource_id(NAMES[i]) for i in pick], np.int32)
    res[rng.random(n) < 0.05] = -1
    origin = [ORIGIN.get(NAMES[i], "") for i in pick]
    trash = client.cfg.trash_row
    onode = np.array(
        [reg.origin_node_row(NAMES[i], o) if o and r >= 0 else trash for i, o, r in zip(pick, origin, res)],
        np.int32,
    )
    oid = np.array([reg.origin_id(o) if o else -1 for o in origin], np.int32)
    return dict(
        res=res,
        counts=rng.integers(1, 4, n).astype(np.int32),
        prio=(rng.random(n) < 0.2).astype(np.int32),
        origin_id=oid,
        origin_node=onode,
        inbound=(rng.random(n) < 0.4).astype(np.int32),
    )


def _drive(client, m, seed: int, steps: int = 5):
    """Per step: a few object requests and one block queued into the same
    ticks (the block up to 2.5 batches long), the step's exits as one
    completion block, one check_batch and one check_batch_ids.  Returns
    every verdict and wait, in order."""
    rng = np.random.default_rng(seed)
    out = []
    prev = None
    for step in range(steps):
        # queue without ticking, then ONE tick_once decides the lot
        client.mode = "threaded"
        objs = [
            client.submit_acquire(str(rng.choice(NAMES)), count=int(rng.integers(1, 3)),
                                  prioritized=bool(rng.random() < 0.3), inbound=bool(rng.random() < 0.5))
            for _ in range(int(rng.integers(1, 8)))
        ]
        cols = _block_columns(client, rng, int(rng.integers(40, 160)))
        fut = client.submit_block(**cols)
        if prev is not None:
            res, cnt, inb = prev
            client.submit_completion_block(
                res, rng.integers(1, 40, len(res)).astype(np.float32), success=cnt,
                error=(rng.random(len(res)) < 0.3).astype(np.int32), inbound=inb,
            )
        client.mode = "sync"
        assert not fut.done()
        client.tick_once()
        v, w = fut.result(timeout=5)
        out.append(("block", v.tolist(), w.tolist()))
        out.append(("objs", [f.result(timeout=5) for f in objs]))
        passed = ((v == 0) | (v == 6)) & (cols["res"] >= 0)
        prev = (cols["res"][passed], cols["counts"][passed], cols["inbound"][passed])
        names = [str(n) for n in rng.choice(NAMES, 12)]
        out.append(("check_batch", client.check_batch(
            names, counts=[1] * 12, origins=[ORIGIN.get(n, "") for n in names],
        )))
        ids = np.array([client.registry.peek_resource_id(n) for n in rng.choice(NAMES, 20)], np.int32)
        v2, w2 = client.check_batch_ids(ids)
        out.append(("ids", v2.tolist(), w2.tolist()))
        client.time.advance(int(rng.integers(150, 700)))
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_bulk_api_matches_jax_client(path):
    jc, tc = _jax_client(), _port_client(PATHS[path])
    try:
        want = _drive(jc, jst, 5)
        got = _drive(tc, tst, 5)
    finally:
        jc.stop()
        tc.stop()
    assert got == want
    flat = [v for o in got if o[0] in ("block", "ids") for v in o[1]]
    assert {0, 1, 5} <= set(flat)  # passes, flow and authority blocks among the block verdicts
    assert tc.seg_dropped_total == 0
    if path == "fallback":
        # the blocks overflow seg_u=8: those ticks took the per-item branch
        assert tc.seg_fallback_ticks > 0


def test_pipelined_readback_gives_the_same_verdicts_and_state():
    """pipeline_depth 2 against 0: the same scenario, the same verdicts,
    waits and engine state, leaf for leaf."""
    flags = PATHS["fallback"]
    c0, c2 = _port_client(flags, 0), _port_client(flags, 2)
    try:
        a = _drive(c0, tst, 8)
        b = _drive(c2, tst, 8)
        la, lb = S.leaves(c0._state), S.leaves(c2._state)
        for k in la:
            assert torch.equal(la[k], lb[k]), k
    finally:
        c0.stop()
        c2.stop()
    assert a == b


@pytest.mark.cuda
def test_pipelined_readback_on_the_card_matches_the_jax_client():
    """On the card: pinned readback buffers behind CUDA events, at
    pipeline_depth 2, against the JAX client and against depth 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    jc = _jax_client()
    c0, c2 = _port_client(PATHS["fallback"], 0, "cuda"), _port_client(PATHS["fallback"], 2, "cuda")
    try:
        want, a, b = _drive(jc, jst, 5), _drive(c0, tst, 5), _drive(c2, tst, 5)
        assert c2._readback.take(4).is_pinned()
    finally:
        for c in (jc, c0, c2):
            c.stop()
    assert a == b == want


def test_a_readback_buffer_is_reused_only_after_its_tick_resolved(monkeypatch):
    """Three blocks of 5 batches each at pipeline_depth 3, the resolver
    slowed down so that several ticks are in flight: each tick is decoded
    from a buffer that still holds exactly its own wire, and no buffer is
    handed out while an unresolved tick owns it."""
    import time

    c = _port_client(PATHS["seg"], depth=3)
    in_flight = {}
    taken = []
    real_take, real_give = c._readback.take, c._readback.give

    def take(n):
        buf = real_take(n)
        assert buf.data_ptr() not in in_flight, "a buffer was reused before its tick resolved"
        in_flight[buf.data_ptr()] = buf
        taken.append(len(in_flight))
        return buf

    def give(buf):
        del in_flight[buf.data_ptr()]
        real_give(buf)

    monkeypatch.setattr(c._readback, "take", take)
    monkeypatch.setattr(c._readback, "give", give)
    real_inner = c._resolve_tick_inner
    decoded_from_own = []

    def slow_inner(p):
        time.sleep(0.02)
        decoded_from_own.append(torch.equal(p.buf, p.out.wire))
        real_inner(p)

    monkeypatch.setattr(c, "_resolve_tick_inner", slow_inner)
    rng = np.random.default_rng(5)
    try:
        c.mode = "threaded"
        futs = [c.submit_block(**_block_columns(c, rng, 5 * c.cfg.batch_size)) for _ in range(3)]
        c.mode = "sync"
        c.tick_once()
        for f in futs:
            v, _w = f.result(timeout=5)
            assert len(v) == 5 * c.cfg.batch_size
    finally:
        c.stop()
    assert len(decoded_from_own) == 15 and all(decoded_from_own)
    assert max(taken) >= 3  # several ticks really were in flight at once
    assert not in_flight and c._readback.allocated == max(taken)


def test_unknown_resources_pass_through():
    """A full registry: submit_acquire returns None and check_batch answers
    (PASS, 0) for the name it cannot intern, in both clients."""
    out = []
    for c in (_jax_client(), _port_client(PATHS["seg"])):
        try:
            i = 0
            while c.registry.resource_id(f"fill{i}") is not None:
                i += 1
            out.append((c.submit_acquire("one-too-many"),
                        c.check_batch(["one-too-many", "a"], origins=["", ""])))
        finally:
            c.stop()
    assert out[0] == out[1]
    assert out[1][0] is None and out[1][1][0] == (0, 0)


def test_entry_async_matches_jax_client():
    async def run(c):
        seen = []
        for _ in range(6):
            try:
                e = await c.entry_async("a")
                seen.append("pass")
                e.exit()
            except Exception as exc:  # BlockException of either package
                seen.append(type(exc).__name__)
        return seen

    jc, tc = _jax_client(), _port_client(PATHS["seg"])
    try:
        want, got = asyncio.run(run(jc)), asyncio.run(run(tc))
    finally:
        jc.stop()
        tc.stop()
    assert got == want == ["pass"] * 3 + ["FlowException"] * 3


def test_seg_u_grows_after_four_overflowing_ticks_under_the_fallback():
    """seg_fallback=True: an overflowing tick is exact through the per-item
    branch, so seg_u grows only at the fourth, to ceil((1.25 * peak + 128)
    / 128) * 128 at most the batch, and only past the full shape's
    capacity (the reference's rule)."""
    c = SentinelClient(
        cfg=small_engine_config(**dict(SEG, seg_fallback=True, seg_u=8), batch_size=512, complete_batch_size=512),
        time_source=VirtualTimeSource(1_000), mode="sync", device="cpu",
    )
    for _ in range(3):
        c._note_seg_count(100, 512)
    assert c.cfg.seg_u == 8
    c._note_seg_count(100, 512)
    assert c.cfg.seg_u == 256 and c._seg_over_ticks == 0
    c._note_seg_count(50, 512)  # fits: nothing counted
    assert c._seg_over_ticks == 0


def test_deadlines_raise_until_ported():
    """Deadline-aware backpressure is ported: ``deadline_ms`` no longer
    raises on the bulk API.  An expired block sheds CLOSED before it
    reaches the engine (tests/test_torch_adaptive.py has the rest); a live
    one is decided as without a deadline."""
    from sentinel_tpu_torch.core.errors import BLOCK_SYSTEM

    c = _port_client(PATHS["seg"])
    try:
        now = c.time.now_ms()
        v, w = c.check_batch_ids(np.array([1, 1], np.int32), deadline_ms=now - 1)
        assert (v == BLOCK_SYSTEM).all() and (w == 0).all()
        v_live, _ = c.submit_block(np.array([1], np.int32), deadline_ms=now + 5).result(timeout=5)
        assert v_live.tolist() == [0]
    finally:
        c.stop()


def test_platform_config_flags_equal_the_reference_accelerator_default(monkeypatch):
    monkeypatch.setattr(JCFG, "_backend_is_tpu", lambda: True)
    ref, mine = JCFG.platform_engine_config(), platform_config()
    for f in ("use_mxu_tables", "fused_effects", "seg_effects", "seg_fallback"):
        assert getattr(mine, f) == getattr(ref, f) is True, f


def test_register_init_func_runs_in_order_once():
    seen = []
    tst.reset()
    TAPI.register_init_func(lambda c: seen.append(("late", c.device.type)), order=5)
    TAPI.register_init_func(lambda c: seen.append(("early", c.device.type)), order=-1)
    try:
        tst.init(cfg=small_engine_config(use_mxu_tables=True, fused_effects=True, **NO_PLANES), mode="sync", device="cpu")
        tst.init()
        assert seen == [("early", "cpu"), ("late", "cpu")]
    finally:
        tst.reset()
        del TAPI._init_funcs[:]
    assert TC.ArrayBlock.__dataclass_fields__["unresolved"].default == 0
