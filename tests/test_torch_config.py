"""The configuration layers, the lazy package exports and three metric
series, against the JAX package's.

* ``core.config``: ``set_config`` overrides win over the environment, the
  properties file and the defaults; ``reset_overrides`` drops them;
  ``get_int`` parses or falls back — equal to the reference's on the same
  keys, values and environment.
* ``sentinel_tpu_torch.AdaptiveConfig`` / ``AdaptiveController`` resolve
  lazily to the adaptive package's classes, as the reference's do.
* The metric series the reference's serving path exports:
  ``sentinel_window_rotations_total{window}`` and
  ``sentinel_window_slack_skips_total{window}`` (derived on the host from
  each tick's stamped timestamp) and ``sentinel_engine_tick_builds_total``
  (one a tick binding the cache did not hold).  The same serving run on
  both packages — a sync client on the sketch tier's build (a 60 x 1 s
  minute window, ``sketch_slack_frac`` 0.05: purges batched every three
  buckets), across bucket boundaries of both windows — moves each series
  by the same amount, and each is in the port's exposition.

Counts are integers and compared for equality.
"""

from __future__ import annotations

import pytest

import sentinel_tpu as jst
from sentinel_tpu.core import config as JCFG
from sentinel_tpu.obs.registry import REGISTRY as JREG
from sentinel_tpu.ops import engine as JE
from sentinel_tpu.runtime.client import SentinelClient as JaxClient
from sentinel_tpu.utils.time_source import VirtualTimeSource as JVT

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import config as CFG
from sentinel_tpu_torch.obs.registry import REGISTRY
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.runtime.client import SentinelClient
from sentinel_tpu_torch.utils.time_source import VirtualTimeSource

KEY = "csp.sentinel.test.knob"
ENV = "CSP_SENTINEL_TEST_KNOB"


@pytest.fixture(autouse=True)
def _clean_overrides():
    yield
    CFG.reset_overrides()
    JCFG.reset_overrides()


@pytest.mark.parametrize(
    "env, override, default",
    [(None, None, 0), ("17", None, 0), ("17", "42", 0), (None, "x", 9), ("bad", None, 5), (None, 7, 0)],
)
def test_the_layers_resolve_as_the_reference_resolves_them(monkeypatch, env, override, default):
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    got = {}
    for name, mod in (("ref", JCFG), ("port", CFG)):
        if override is not None:
            mod.set_config(KEY, override)
        seen = (mod.get_config(KEY), mod.get_config(KEY, "dflt"), mod.get_int(KEY, default),
                mod.get_config("csp.sentinel.app.name"), mod.app_name())
        mod.reset_overrides()
        got[name] = (seen, mod.get_config(KEY), mod.get_int(KEY, default))
    assert got["port"] == got["ref"]
    if override is not None:
        assert got["port"][0][0] == str(override)  # the override wins over the environment
        assert got["port"][1] == env  # ... and is gone after reset_overrides()


def test_an_override_names_the_app():
    for mod in (JCFG, CFG):
        mod.set_config("csp.sentinel.app.name", "front-door-app")
    assert CFG.app_name() == JCFG.app_name() == "front-door-app"


@pytest.mark.parametrize("name", ["AdaptiveConfig", "AdaptiveController"])
def test_the_adaptive_names_resolve_lazily(name):
    from sentinel_tpu_torch import adaptive

    assert getattr(st, name) is getattr(adaptive, name)
    assert getattr(st, name).__module__.startswith("sentinel_tpu_torch.adaptive")
    assert getattr(jst, name).__name__ == getattr(st, name).__name__
    with pytest.raises(AttributeError):
        st.NoSuchName  # noqa: B018


#: the sketch tier's build (bench.py's: 60 buckets of 1 s, slack 0.05) at small widths
SKETCH = dict(sketch_stats=True, sketch_width=256, sketch_depth=2, sketch_sample_count=60, sketch_window_ms=1000)
SERIES = [
    ("sentinel_window_rotations_total", {"window": "second"}),
    ("sentinel_window_rotations_total", {"window": "sketch"}),
    ("sentinel_window_slack_skips_total", {"window": "second"}),
    ("sentinel_window_slack_skips_total", {"window": "sketch"}),
    ("sentinel_engine_tick_builds_total", None),
]


def _values(reg):
    out = []
    for name, labels in SERIES:
        m = reg.get(name, labels)
        out.append(0.0 if m is None else float(m.value))
    return out


def _serve(c, R):
    """Rules, then 40 entries 230 ms apart (about nine seconds: boundaries of
    both windows), each exited."""
    c.flow_rules.load([R.FlowRule(resource="cfg/a", count=3)])
    verdicts = []
    for i in range(40):
        try:
            c.entry("cfg/a" if i % 2 else "cfg/b").exit()
            verdicts.append(0)
        except Exception as exc:  # a BlockException of either package
            verdicts.append(type(exc).__name__)
        c.time.advance(230)
    return verdicts


def test_the_three_series_move_as_the_reference_moves_them():
    with JE._TICK_CACHE_LOCK:
        JE._TICK_CACHE.clear()
    with E._TICK_CACHE_LOCK:
        E._TICK_CACHE.clear()
    j0, t0 = _values(JREG), _values(REGISTRY)
    jc = JaxClient(cfg=JCFG.small_engine_config(**SKETCH), time_source=JVT(1_000), mode="sync")
    jc.start()
    tc = SentinelClient(cfg=CFG.small_engine_config(**SKETCH), time_source=VirtualTimeSource(1_000), mode="sync",
                        device="cpu")
    tc.start()
    try:
        jv = _serve(jc, jst)
        tv = _serve(tc, st)
    finally:
        jc.stop()
        tc.stop()
    assert tv == jv
    dj = [b - a for a, b in zip(j0, _values(JREG))]
    dt = [b - a for a, b in zip(t0, _values(REGISTRY))]
    assert dt == dj
    rot_s, rot_k, skip_s, skip_k, builds = dt
    assert rot_s > 0 and rot_k > 0 and skip_k > 0 and skip_s == 0 and builds >= 1
    text = REGISTRY.exposition()
    for name, _labels in SERIES:
        assert name in text
