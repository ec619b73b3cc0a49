"""The port's property / datasource layer (datasource/property, base,
converters) and property-driven rules against the JAX package's.

The scenarios of tests/test_datasource.py run on both packages side by
side: the property's fan-out and skip-unchanged, the late listener's
replay, the file poller's mtime detection, the writable round trip, and a
file push driving a client's flow rules through ``register_property`` —
there both clients run in mode="sync" on one virtual clock each and must
give the same verdicts.  Then the edges: a failed read through the
``datasource.refresh.read`` / ``datasource.file.read`` failpoints (the
rules stay and the poll re-arms), a half-written file, an oversized file,
a ``None`` push (rules kept) against an empty list (rules cleared),
re-registration (the old property no longer drives the manager), and the
manager's push listeners.

Tolerances: everything compared here is exact (rule lists, listener
sequences, file bytes, verdicts).
"""

import json
import os
import time

import pytest

import sentinel_tpu as jst
from sentinel_tpu import datasource as JD
from sentinel_tpu.chaos import failpoints as JFP
from sentinel_tpu.chaos.plans import FaultPlan as JPlan, FaultSpec as JSpec

import sentinel_tpu_torch as tst
from sentinel_tpu_torch import datasource as TD
from sentinel_tpu_torch.chaos import failpoints as TFP
from sentinel_tpu_torch.chaos.plans import FaultPlan as TPlan, FaultSpec as TSpec
from tests.test_torch_stats import _pair

def _rules_json(rules):
    return [json.dumps(r.__dict__, sort_keys=True, default=str) for r in rules]


def _touch(p, text):
    p.write_text(text)
    t = time.time() + 5 + len(text) % 7
    os.utime(str(p), (t, t))


def test_property_fanout_skip_unchanged_and_late_listener():
    got = []
    for D in (JD, TD):
        prop = D.DynamicSentinelProperty()
        seen = []
        prop.add_listener(D.SimplePropertyListener(seen.append))
        flags = [prop.update_value(1), prop.update_value(1), prop.update_value(2)]
        late = []
        prop.add_listener(D.SimplePropertyListener(late.append))
        noop = D.NoOpSentinelProperty()
        noop.add_listener(D.SimplePropertyListener(late.append))
        got.append((seen, flags, late, prop.value, noop.update_value(3)))
    assert got[1] == got[0] == ([None, 1, 2], [True, False, True], [2], 2, False)


def test_file_refreshable_datasource_matches_reference(tmp_path):
    out = []
    for D, name in ((JD, "jax"), (TD, "torch")):
        p = tmp_path / f"{name}-flow-rules.json"
        p.write_text(json.dumps([{"resource": "a", "count": 10}]))
        ds = D.FileRefreshableDataSource(str(p), D.json_rule_converter("flow"), refresh_ms=60_000)
        try:
            first = _rules_json(ds.get_property().get_value())
            unchanged = ds.refresh()
            _touch(p, json.dumps([{"resource": "b", "count": 5}, {"resource": "c", "count": 1, "grade": 0}]))
            changed = ds.refresh()
            second = _rules_json(ds.get_property().get_value())
        finally:
            ds.close()
        out.append((first, unchanged, changed, second))
    assert out[1] == out[0]
    assert out[0][1] is False and out[0][2] is True and len(out[0][3]) == 2


def test_file_writable_datasource_roundtrip_bytes_match(tmp_path):
    texts = []
    for D, m, name in ((JD, jst, "jax"), (TD, tst, "torch")):
        p = tmp_path / f"{name}.json"
        w = D.FileWritableDataSource(str(p), D.json_rule_encoder)
        w.write([m.FlowRule(resource="hello", count=20.0), m.FlowRule(resource="x", count=1, grade=m.GRADE_THREAD)])
        back = D.json_rule_converter("flow")(p.read_text())
        assert back[0].resource == "hello" and back[0].count == 20.0 and back[1].grade == m.GRADE_THREAD
        texts.append(p.read_bytes())
    assert texts[1] == texts[0]


def test_datasource_drives_engine_like_reference(tmp_path):
    """File push → property → FlowRuleManager → engine recompile →
    enforcement, verdict for verdict on both clients."""
    jc, tc = _pair()
    out = []
    try:
        for c, D, m, name in ((jc, JD, jst, "jax"), (tc, TD, tst, "torch")):
            p = tmp_path / f"{name}-rules.json"
            p.write_text(json.dumps([{"resource": "svc", "count": 2}]))
            ds = D.FileRefreshableDataSource(str(p), D.json_rule_converter("flow"), refresh_ms=60_000)
            try:
                c.flow_rules.register_property(ds.get_property())
                verdicts = []
                for _ in range(6):
                    try:
                        with c.entry("svc"):
                            verdicts.append("pass")
                    except m.FlowException:
                        verdicts.append("block")
                _touch(p, json.dumps([{"resource": "svc", "count": 100}]))
                pushed = ds.refresh()
                c.time.advance(1_100)
                after = []
                for _ in range(5):
                    try:
                        with c.entry("svc"):
                            after.append("pass")
                    except m.FlowException:
                        after.append("block")
                out.append((verdicts, pushed, c.flow_rules.get()[0].count, after))
            finally:
                ds.close()
    finally:
        jc.stop()
        tc.stop()
    assert out[1] == out[0]
    assert out[0][0] == ["pass", "pass"] + ["block"] * 4 and out[0][3] == ["pass"] * 5


@pytest.mark.parametrize("site", ["datasource.refresh.read", "datasource.file.read"])
def test_failed_read_keeps_rules_and_rearms_like_reference(tmp_path, site):
    """A raise at the failpoint: refresh() answers False, the property
    keeps its value, and the next poll (failpoint disarmed) picks the file
    up; a half-written file likewise, then its completed version."""
    out = []
    for D, FP, Plan, Spec, name in ((JD, JFP, JPlan, JSpec, "jax"), (TD, TFP, TPlan, TSpec, "torch")):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps([{"resource": "a", "count": 1}]))
        ds = D.FileRefreshableDataSource(str(p), D.json_rule_converter("flow"), refresh_ms=60_000)
        try:
            steps = []
            _touch(p, json.dumps([{"resource": "b", "count": 2}]))
            with FP.armed(Plan(seed=1, faults=[Spec(site, "raise")])):
                steps.append(ds.refresh())
            steps.append(_rules_json(ds.get_property().get_value()))
            steps.append(ds.refresh())
            _touch(p, '[{"resource": "c", "cou')
            steps.append(ds.refresh())
            steps.append(_rules_json(ds.get_property().get_value()))
            p.write_text(json.dumps([{"resource": "c", "count": 3}]))
            steps.append(ds.refresh())
            steps.append(_rules_json(ds.get_property().get_value()))
        finally:
            ds.close()
        out.append(steps)
    assert out[1] == out[0]
    assert out[0][0] is False and out[0][2] is True and out[0][3] is False and out[0][5] is True


def test_oversized_file_and_directory_are_refused_like_reference(tmp_path):
    out = []
    for D, name in ((JD, "jax"), (TD, "torch")):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps([{"resource": "big", "count": 1}] * 50))
        ds = D.FileRefreshableDataSource(str(p), D.json_rule_converter("flow"), refresh_ms=60_000, max_size=64)
        try:
            out.append(ds.get_property().get_value())
        finally:
            ds.close()
        with pytest.raises(ValueError):
            D.FileRefreshableDataSource(str(tmp_path), D.json_rule_converter("flow"))
        with pytest.raises(ValueError):
            D.AutoRefreshDataSource(D.json_rule_converter("flow"), refresh_ms=0)
    assert out == [None, None]


def test_property_pushes_none_empty_and_reregistration_like_reference():
    """None keeps the rules, [] clears them; a second register_property
    detaches the first property; add_listener sees every load."""
    jc, tc = _pair()
    out = []
    try:
        for c, D, m in ((jc, JD, jst), (tc, TD, tst)):
            loads = []
            c.flow_rules.add_listener(lambda rules: loads.append([r.resource for r in rules]))
            p1, p2 = D.DynamicSentinelProperty(), D.DynamicSentinelProperty()
            c.flow_rules.register_property(p1)  # replays None: keeps the (empty) rules
            p1.update_value([m.FlowRule(resource="x", count=0)])
            blocked = c.try_entry("x") is None
            p1.update_value(None)
            kept = [r.resource for r in c.flow_rules.get()]
            p1.update_value([])
            cleared = c.flow_rules.get()
            c.flow_rules.register_property(p2)
            p1.update_value([m.FlowRule(resource="stale", count=1)])
            p2.update_value([m.FlowRule(resource="y", count=1)])
            out.append((loads, blocked, kept, cleared, [r.resource for r in c.flow_rules.get()],
                        c.try_entry("x") is not None))
    finally:
        jc.stop()
        tc.stop()
    assert out[1] == out[0]
    assert out[0] == ([["x"], [], ["y"]], True, ["x"], [], ["y"], True)
