"""The port's metric log (metrics/node, writer, searcher, timer) against the
JAX package's.

The line codec, the writer's files and ``.idx`` seek index, its rolling
and trimming, and the searcher's reads must be byte for byte and node for
node the reference's; ``MetricTimerListener.run_once`` over the port's
``stats.snapshot`` must write the lines the reference's writes over its
own, on the same scripted stream (both clients in mode="sync" on one
virtual clock each, the wall-clock epoch of both clocks pinned to one
value); and a client built with ``metric_log=True`` writes through its own
timer.

Tolerances: the files are compared as bytes and the nodes as dataclasses
(every field equal), since the line format prints integers bare and
floats with ``repr``.
"""

import os

import numpy as np

import sentinel_tpu as jst
from sentinel_tpu import metrics as JM

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import metrics as TM
from tests.test_torch_stats import _pair

WALL_EPOCH_MS = 1_700_000_000_000


def _nodes(m, sec):
    return [
        m.MetricNode(resource="resA", pass_qps=sec + 1, success_qps=sec + 1, rt=12.5 + sec),
        m.MetricNode(resource="GET:/api/v1|weird name\n", block_qps=2, concurrency=sec % 3),
        m.MetricNode(resource="idle"),  # inactive: skipped
        m.MetricNode(resource="frac", exception_qps=0.1 * sec, occupied_pass_qps=1.5, classification=1),
    ]


def _files(base, app):
    """{basename: bytes} of every metric file and its index."""
    out = {}
    for f in TM.list_metric_files(str(base), app):
        for p in (f, f + ".idx"):
            with open(p, "rb") as fh:
                out[os.path.basename(p)] = fh.read()
    return out


def test_line_codec_matches_reference():
    for sec in range(4):
        for jn, tn in zip(_nodes(JM, sec), _nodes(TM, sec)):
            jn.timestamp = tn.timestamp = 1_700_000_000_000 + sec * 1000
            assert tn.to_line() == jn.to_line()
            assert TM.MetricNode.from_line(jn.to_line()) == tn
            assert tn.is_active() == jn.is_active()


def test_writer_files_and_searcher_reads_match_reference(tmp_path):
    t0 = 1_700_000_000_000
    for m, d in ((JM, tmp_path / "jax"), (TM, tmp_path / "torch")):
        w = m.MetricWriter(str(d), "app1", single_file_size=600)
        for sec in range(12):
            w.write(t0 + sec * 1000 + 37, _nodes(m, sec))
        w.close()
    want, got = _files(tmp_path / "jax", "app1"), _files(tmp_path / "torch", "app1")
    assert got == want and len(want) >= 4  # rolled at least once
    js = JM.MetricSearcher(str(tmp_path / "jax"), "app1")
    ts = TM.MetricSearcher(str(tmp_path / "torch"), "app1")
    for begin in (0, t0, t0 + 5000, t0 + 5500, t0 + 11_000, t0 + 20_000):
        for count in (1, 3, 6000):
            assert [n.to_line() for n in ts.find(begin, count)] == [n.to_line() for n in js.find(begin, count)]
    for begin, end, res in ((t0, t0 + 3000, "resA"), (t0 + 2000, t0 + 9000, None),
                            (0, 2**62, "GET:/api/v1|weird name\n"), (t0, t0 + 4000, "absent")):
        assert ([n.to_line() for n in ts.find_by_time_and_resource(begin, end, res)]
                == [n.to_line() for n in js.find_by_time_and_resource(begin, end, res)])
    assert len(ts.find(t0)) == 36 and len(ts.find(t0, 4)) == 6  # never truncated mid-second


def test_writer_rolls_and_trims_as_reference(tmp_path):
    t0 = 1_700_000_000_000
    for m, d in ((JM, tmp_path / "jax"), (TM, tmp_path / "torch")):
        w = m.MetricWriter(str(d), "app2", single_file_size=500, total_file_count=3)
        for sec in range(40):
            w.write(t0 + sec * 1000, [m.MetricNode(resource="r", pass_qps=1)])
        w.close()
    want, got = _files(tmp_path / "jax", "app2"), _files(tmp_path / "torch", "app2")
    assert got == want
    assert 2 <= len(want) <= 6


def _stream(c, m, rng):
    """A few seconds of entries on three resources: passes, blocks, exits
    with RTs, one error, entries held open across a second."""
    held = []
    for i in range(90):
        name = ("timed", "blocked", "slow")[int(rng.integers(3))]
        try:
            e = c.entry(name, inbound=bool(rng.random() < 0.5))
        except m.BlockException:
            e = None
        if e is not None:
            if rng.random() < 0.1:
                held.append(e)
            else:
                c.time.advance(int(rng.integers(1, 30)))
                if rng.random() < 0.05:
                    e.trace(RuntimeError("x"))
                e.exit()
        c.time.advance(int(rng.integers(5, 40)))
        if i % 30 == 29:
            c.tick_once()
            yield
    for e in held:
        e.exit()


def test_timer_run_once_writes_the_reference_lines(tmp_path):
    """run_once over each client's snapshot, three times along one
    stream: the written files equal byte for byte, and the searcher gives
    back exactly the written lines."""
    jc, tc = _pair()
    try:
        counts, written = [], []
        for c, m, M, d in ((jc, jst, JM, tmp_path / "jax"), (tc, tst, TM, tmp_path / "torch")):
            c.time.wall_epoch_ms = WALL_EPOCH_MS
            c.flow_rules.load([m.FlowRule(resource="timed", count=100), m.FlowRule(resource="blocked", count=2)])
            timer = M.MetricTimerListener(c, M.MetricWriter(str(d), "app3"))
            n = []
            for _ in _stream(c, m, np.random.default_rng(11)):
                n.append(timer.run_once())
            timer.writer.close()
            counts.append(n)
            written.append(_files(d, "app3"))
        lines = [ln for k, v in written[1].items() if not k.endswith(".idx") for ln in v.decode().splitlines()]
        found = TM.MetricSearcher(str(tmp_path / "torch"), "app3").find(0)
    finally:
        jc.stop()
        tc.stop()
    assert counts[1] == counts[0] and sum(counts[0]) >= 6
    assert written[1] == written[0]
    assert [n.to_line() for n in found] == lines
    assert {n.resource for n in found} == {"timed", "blocked", "slow"}
    assert any(n.block_qps > 0 for n in found) and any(n.rt > 0 for n in found)


def test_client_metric_log_option_writes_through_its_timer(tmp_path):
    """``metric_log=True``: start() builds the client's MetricTimerListener
    (its thread runs only in threaded mode), stop() closes it."""
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.runtime.client import SentinelClient
    from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

    c = SentinelClient(cfg=small_engine_config(fused_effects=True), time_source=VirtualTimeSource(5_000),
                       mode="sync", device="cpu", metric_log=True, metric_log_dir=str(tmp_path), app_name="mlog")
    c.start()
    try:
        assert c.metric_timer is not None and c.metric_timer._thread is None
        for _ in range(3):
            c.entry("r").exit()
            c.time.advance(10)
        assert c.metric_timer.run_once() == 1
    finally:
        c.stop()
    assert c.metric_timer is None
    (node,) = TM.MetricSearcher(str(tmp_path), "mlog").find(0)
    assert node.resource == "r" and node.pass_qps == 3 and node.success_qps == 3
