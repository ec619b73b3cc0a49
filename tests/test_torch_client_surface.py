"""The port's client host surface against the JAX package's client.

Both clients run in mode="sync" on virtual time.  The extension points
(``enabled``, ``entry_hooks``, the ordered custom slots, the metric
extension SPI) on one scripted stream: the same verdicts, the same
callback sequences, the same windowed stats after; a hook's or a slot's
BlockException is re-raised and the engine records the block.  The
upload accounting: on one stream the bytes each tick uploads
(``sentinel_wire_bytes_total{direction="tx"}``), the columns it skips
(``sentinel_wire_cols_skipped_total``) and the bytes it reads back equal
the JAX client's tick for tick, on the fused and the segment host paths
(the JAX client: tests/torch_harness.jax_host_client).  Then the port
alone: a tick writes none of its batch inputs (the cached device columns
are shared across ticks), the completion ring's overflow loses nothing,
and the two-slot staging gives depth 2 the verdicts of depth 0 (pinned
at depth 4 on the card).
"""

import sys
import threading

import numpy as np
import pytest
import torch

import sentinel_tpu as jst
from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.metrics import extension as JMEXT
from sentinel_tpu.runtime import client as JCL
from sentinel_tpu.runtime import slots as JSLOTS
from sentinel_tpu.utils.time_source import VirtualTimeSource as JaxVT

import sentinel_tpu_torch as tst
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.metrics import extension as TMEXT
from sentinel_tpu_torch.native import EventRing
from sentinel_tpu_torch.runtime import client as TCL
from sentinel_tpu_torch.runtime import slots as TSLOTS
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource
from tests.test_torch_client import NO_PLANES, SEG, _jax_client
from tests.torch_harness import jax_host_client

FUSED = dict(use_mxu_tables=True, fused_effects=True, **NO_PLANES)
#: the JAX client's host flags for each path (its tick: tests/torch_harness.jax_host_client)
JAX_HOST = {"fused": dict(FUSED, use_mxu_tables=True), "seg": dict(SEG, use_mxu_tables=True)}
PORT = {"fused": FUSED, "seg": SEG}
NAMES = ("a", "h", "s", "x")


def _port_client(flags=FUSED, **kw):
    return SentinelClient(cfg=small_engine_config(**flags), time_source=VirtualTimeSource(1_000), mode="sync",
                          device="cpu", **kw)


def _instrument(client, m, slots_mod, log):
    """A hook that rejects every third "h" and any "h" with the argument
    "deny"; a slot (order -1)
    that rejects "s" on every third entry; a recording slot (order 5);
    every call appended to ``log``."""

    seen_h = []

    def hook(resource, origin, args):
        log.append(("hook", resource, origin, tuple(args or ())))
        if resource == "h":
            seen_h.append(1)
            if len(seen_h) % 3 == 0 or (args and args[0] == "deny"):
                raise m.AuthorityException(resource)

    class Blocker(slots_mod.ProcessorSlot):
        order = -1
        seen = 0

        def on_entry(self, ctx):
            log.append(("blocker.entry", ctx.resource, ctx.count, ctx.prioritized))
            if ctx.resource == "s":
                Blocker.seen += 1
                if Blocker.seen % 3 == 0:
                    raise m.FlowException(ctx.resource)

        def on_exit(self, ctx):
            log.append(("blocker.exit", ctx.resource, _exc_name(ctx.block_exception)))

    class Recorder(slots_mod.ProcessorSlot):
        order = 5

        def on_entry(self, ctx):
            ctx.attachments["t"] = ctx.resource
            log.append(("slot.entry", ctx.resource, ctx.origin, tuple(ctx.args or ())))

        def on_exit(self, ctx):
            log.append(("slot.exit", ctx.resource, ctx.rt_ms, ctx.success, ctx.errors,
                        _exc_name(ctx.block_exception), ctx.attachments.get("t")))

    client.entry_hooks.append(hook)
    client.slots.register(Recorder())
    client.slots.register(Blocker())


def _exc_name(e):
    return None if e is None else type(e).__name__


def _extension(mext, log):
    class Ext(mext.MetricExtension):
        def on_pass(self, resource, count, origin, args=None):
            log.append(("on_pass", resource, count, origin, tuple(args or ())))

        def on_block(self, resource, count, origin, block_exception, args=None):
            log.append(("on_block", resource, count, origin, _exc_name(block_exception)))

        def on_complete(self, resource, rt_ms, success, origin):
            log.append(("on_complete", resource, rt_ms, success, origin))

        def on_exception(self, resource, count, origin):
            log.append(("on_exception", resource, count, origin))

    return Ext()


def _drive_surface(client, m, seed):
    """Entries with arguments and origins over NAMES, some exits with a
    business error; a disabled stretch in the middle.  Returns the
    outcomes and the ticks run while disabled."""
    client.flow_rules.load([m.FlowRule(resource="a", count=3)])
    client.degrade_rules.load([m.DegradeRule(resource="x", grade=m.CB_STRATEGY_ERROR_COUNT, count=2,
                                             time_window=1, min_request_amount=1)])
    rng = np.random.default_rng(seed)
    out, held = [], []
    for i in range(72):
        if i == 20:
            client.enabled = False
            ticks0 = client._build_ticks
            e = client.entry("a")
            e.exit()
            out.append(("disabled", type(e).__name__, client.submit_acquire("a"), client.submit_block(np.ones(3, np.int32)),
                        client.check_batch(["a", "x"]), [v.tolist() for v in client.check_batch_ids(np.ones(2, np.int32))]))
            disabled_ticks = client._build_ticks - ticks0
            client.enabled = True
        res = str(rng.choice(NAMES))
        args = [str(rng.choice(["ok", "deny", "v"]))][: int(rng.integers(0, 2))]
        origin = str(rng.choice(["", "peer"]))
        try:
            e = client.entry(res, args=args, origin=origin, prioritized=bool(rng.random() < 0.2))
            out.append(("pass", res, e.wait_ms))
            held.append(e)
        except m.BlockException as exc:
            out.append((type(exc).__name__, res))
        client.time.advance(int(rng.integers(0, 90)))
        while held and rng.random() < 0.5:
            e = held.pop(int(rng.integers(0, len(held))))
            if e.resource == "x" or rng.random() < 0.2:
                e.trace(RuntimeError("business"))
            e.exit()
    for e in held:
        e.exit()
    return out, disabled_ticks


def test_hooks_slots_and_metric_spi_match_the_jax_client():
    jc, tc = _jax_client(), _port_client()
    jlog, tlog = [], []
    jext, text = _extension(JMEXT, jlog), _extension(TMEXT, tlog)
    _instrument(jc, jst, JSLOTS, jlog)
    _instrument(tc, tst, TSLOTS, tlog)
    JMEXT.register_extension(jext)
    TMEXT.register_extension(text)
    jc.start()
    tc.start()
    try:
        want, jticks = _drive_surface(jc, jst, 3)
        got, tticks = _drive_surface(tc, tst, 3)
        jstats = {n: jc.stats.resource(n) for n in NAMES}
        tstats = {n: tc.stats.resource(n) for n in NAMES}
    finally:
        JMEXT.unregister_extension(jext)
        TMEXT.unregister_extension(text)
        jc.stop()
        tc.stop()
    assert got == want
    assert tlog == jlog
    assert tstats == jstats
    assert jticks == tticks == 0  # disabled: pass-through, no tick
    kinds = {o[0] for o in got}
    assert {"pass", "FlowException", "AuthorityException", "DegradeException", "disabled"} <= kinds
    # the hook's and the slot's blocks were recorded by the engine as blocks
    assert tstats["h"]["blockQps"] + tstats["s"]["blockQps"] > 0
    calls = {e[0] for e in tlog}
    assert {"hook", "slot.entry", "slot.exit", "blocker.exit", "on_pass", "on_block", "on_complete",
            "on_exception"} <= calls


def test_a_throwing_extension_is_counted_and_contained():
    from sentinel_tpu_torch.obs.registry import REGISTRY

    class Bad(TMEXT.MetricExtension):
        def on_pass(self, *a):
            raise RuntimeError("bad extension")

    bad = Bad()
    c = REGISTRY.get("sentinel_extension_errors_total")
    n0 = c.value
    TMEXT.register_extension(bad)
    tc = _port_client()
    tc.start()
    try:
        tc.entry("a").exit()
    finally:
        TMEXT.unregister_extension(bad)
        tc.stop()
    assert c.value == n0 + 1
    assert bad not in TMEXT.get_extensions()


def _wire_values(tx, rx, skipped):
    return tx.value, rx.value, skipped.value


def _drive_wire(client, m, seed):
    """One stream, one tick a call: object entries and exits (the ring),
    bulk blocks (one repeated: its columns are skipped), constant and
    varying columns, narrow counts, completion blocks.  Returns each
    tick's (tx bytes, rx bytes, columns skipped) and the verdicts."""
    mod = JCL if m is jst else TCL
    counters = (mod._C_WIRE["tx"], mod._C_WIRE["rx"], mod._C_COLS_SKIPPED)
    client.flow_rules.load([m.FlowRule(resource="a", count=20)])
    for n in ("a", "b", "c", "d"):
        client.registry.resource_id(n)
    rng = np.random.default_rng(seed)
    ids_of = np.array([client.registry.peek_resource_id(n) for n in ("a", "b", "c", "d")], np.int32)
    steps, verdicts = [], []

    def step(fn):
        before = _wire_values(*counters)
        r = fn()
        steps.append(tuple(b - a for a, b in zip(before, _wire_values(*counters))))
        return r

    held = []
    for name in ("a", "b", "a"):
        held.append(step(lambda: client.entry(name)))
    for e in held:
        step(e.exit)
    blk = ids_of[rng.integers(0, 4, 40)]
    for k in range(3):  # the same block three times: varying columns skip
        verdicts.append(step(lambda: client.check_batch_ids(blk))[0])
    cnt = rng.integers(1, 4, 40).astype(np.int32)
    verdicts.append(step(lambda: client.check_batch_ids(blk, counts=cnt))[0])
    verdicts.append(step(lambda: client.check_batch_ids(blk, counts=cnt, prio=np.ones(40, np.int32)))[0])
    step(lambda: client.submit_completion_block(blk, np.full(40, 2.0, np.float32)))
    step(lambda: client.submit_completion_block(blk, np.full(40, 2.0, np.float32), error=cnt % 2))
    blk2 = ids_of[rng.integers(0, 4, 100)]
    verdicts.append(step(lambda: client.check_batch_ids(blk2))[0])  # 100 > batch 64: two ticks
    return steps, [v.tolist() for v in verdicts]


@pytest.mark.parametrize("path", ["fused", "seg"])
def test_upload_bytes_and_skipped_columns_match_the_jax_client_tick_for_tick(monkeypatch, path):
    jc = jax_host_client(monkeypatch, jax_small_cfg(**JAX_HOST[path]), JaxVT(1_000))
    tc = _port_client(PORT[path])
    jc.start()
    tc.start()
    try:
        want, wv = _drive_wire(jc, jst, 5)
        got, gv = _drive_wire(tc, tst, 5)
    finally:
        jc.stop()
        tc.stop()
    assert gv == wv
    assert got == want
    assert sum(s[0] for s in got) > 0 and sum(s[1] for s in got) > 0
    assert sum(s[2] for s in got) > 0  # the repeated block's columns were skipped


def test_a_tick_writes_none_of_its_batch_inputs():
    """The device columns are cached and shared across ticks: the engine
    must never write one in place (torch bumps a tensor's _version on
    every in-place write)."""
    for flags in (FUSED, SEG, dict(SEG, seg_fallback=True, seg_u=8)):
        tc = _port_client(flags)
        tc.start()
        tc.flow_rules.load([tst.FlowRule(resource="a", count=2)])
        tc.degrade_rules.load([tst.DegradeRule(resource="b", grade=tst.CB_STRATEGY_ERROR_COUNT, count=1,
                                               time_window=1, min_request_amount=1)])
        seen = []
        real = tc._tick

        def watch(state, rules, a, c, *args, **kw):
            leaves = [t for t in (*a, *c) if isinstance(t, torch.Tensor)]
            before = [t._version for t in leaves]
            out = real(state, rules, a, c, *args, **kw)
            seen.append((before, [t._version for t in leaves]))
            return out

        tc._tick = watch
        ids = np.array([tc.registry.resource_id(n) for n in "abcdabcdaabbccdd" * 4], np.int32)
        for k in range(3):
            v, _w = tc.check_batch_ids(ids)
            tc.submit_completion_block(ids[v == 0], np.full(int((v == 0).sum()), 3.0, np.float32),
                                       error=np.ones(int((v == 0).sum()), np.int32))
        tc.stop()
        assert len(seen) >= 6
        for before, after in seen:
            assert before == after


def test_completion_ring_overflow_loses_no_exit():
    """A ring of 8 slots under more exits than it holds, from threads: the
    overflow list takes the rest, every exit lands (THREAD-grade
    concurrency back to 0) and the tick drains ring, overflow and blocks."""
    tc = SentinelClient(cfg=small_engine_config(**FUSED), mode="threaded", device="cpu", entry_timeout_s=30.0)
    tc._comp_ring = EventRing(8)
    tc.start()
    tc.flow_rules.load([tst.FlowRule(resource="t", count=1e6, grade=tst.GRADE_THREAD)])
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker():
            try:
                held = [tc.entry("t") for _ in range(12)]
                for e in held:
                    e.exit()
            except Exception as exc:  # re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=worker) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    rid = tc.registry.peek_resource_id("t")
    for _ in range(200):
        tc.tick_once()
        if int(tc._state.concurrency[rid]) == 0:
            break
    tc.stop()
    assert int(tc._state.concurrency[rid]) == 0
    assert not tc._comp_overflow and len(tc._comp_ring) == 0


def test_overflow_completions_drain_after_the_ring_in_order():
    tc = _port_client()
    tc._comp_ring = EventRing(4)
    tc.start()
    rid = tc.registry.resource_id("r")
    tc.mode = "threaded"  # queue without ticking
    for k in range(7):
        tc._submit_completion(TCL.Completion(res=rid, origin_node=tc.cfg.trash_row, ctx_node=tc.cfg.trash_row,
                                             inbound=k % 2, rt=float(k), success=1, error=0))
    tc.submit_completion_block(np.full(3, rid, np.int32), np.array([7.0, 8.0, 9.0], np.float32))
    assert len(tc._comp_ring) == 4 and len(tc._comp_overflow) == 3
    comp = tc._drain_completions(64)
    tc.mode = "sync"
    tc.stop()
    np.testing.assert_array_equal(comp[5], np.arange(10, dtype=np.float32))  # rt: ring, overflow, block
    np.testing.assert_array_equal(comp[4] & 1, [0, 1, 0, 1, 0, 1, 0, 0, 0, 0])
    assert tc._drain_completions(64) is None


def _bulk_stream(client, seed):
    """Blocks through the bulk API: varying ids, a repeated block, counts,
    completions of the passes; verdicts and waits of every block."""
    client.flow_rules.load([tst.FlowRule(resource="a", count=30), tst.FlowRule(resource="b", count=5)])
    ids_of = np.array([client.registry.resource_id(n) for n in ("a", "b", "c")], np.int32)
    rng = np.random.default_rng(seed)
    out = []
    prev = None
    for k in range(8):
        ids = prev if k % 3 == 2 else ids_of[rng.integers(0, 3, int(rng.integers(20, 150)))]
        prev = ids
        fut = client.submit_block(ids, counts=rng.integers(1, 3, len(ids)).astype(np.int32))
        v, w = fut.result(timeout=60)
        out.append((v.tolist(), w.tolist()))
        ok = v == 0
        client.submit_completion_block(ids[ok], np.full(int(ok.sum()), 2.0, np.float32))
        client.time.advance(120)
    return out


def _staged_clients(device, depths, flags=SEG):
    out = []
    for d in depths:
        c = SentinelClient(cfg=small_engine_config(**flags), time_source=VirtualTimeSource(1_000), mode="sync",
                           device=device, pipeline_depth=d)
        c.start()
        out.append(c)
    return out


def test_staging_at_depth_2_equals_depth_0():
    c0, c2 = _staged_clients("cpu", (0, 2))
    try:
        a, b = _bulk_stream(c0, 11), _bulk_stream(c2, 11)
        # the staging slots alternate: both parities hold columns
        assert all(len(s) == 2 for s in c2._stage.values()) and c2._stage_parity in (0, 1)
    finally:
        c0.stop()
        c2.stop()
    assert a == b


@pytest.mark.cuda
def test_pinned_staging_at_depth_4_equals_depth_0_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    c0, c4 = _staged_clients("cuda", (0, 4))
    try:
        a, b = _bulk_stream(c0, 11), _bulk_stream(c4, 11)
        slot = next(iter(c4._stage.values()))[0]
        assert torch.from_numpy(slot).is_pinned()
    finally:
        c0.stop()
        c4.stop()
    assert a == b
