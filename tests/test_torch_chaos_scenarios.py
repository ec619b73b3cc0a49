"""The port's ``fast`` chaos scenarios against the reference's, at seed 7
(tests/test_chaos.py::test_fast_scenario_invariants_green on both
packages): equal ``injected`` counts, and the same invariants in the same
order with equal verdicts and equal details — the details carry each
scenario's deterministic counts (submitted / passed / blocked, token
counts, metric deltas, transitions, chunk counts).  ``tuner_fail_open``
is in test_torch_chaos_tuner.py (the reference's eager run of it alone
takes about a minute).

``shard_reconnect`` drives a ``RemoteShard`` under a token server's
worker pool: the reference's pairs pipelined answers by arrival order,
the port's by xid (ROADMAP Queue C).  Every name of the scenario has the
same verdict, so the two pairings give equal results here.
"""

from __future__ import annotations

import pytest

from sentinel_tpu.chaos import failpoints as JFP
from sentinel_tpu_torch.chaos import failpoints as TFP


@pytest.fixture(autouse=True)
def _disarm_guard():
    yield
    TFP.disarm()
    JFP.disarm()


def _fast_scenarios():
    from sentinel_tpu_torch.chaos.runner import SCENARIOS

    return [n for n, s in SCENARIOS.items() if s.fast and n != "tuner_fail_open"]


def compare_with_the_reference(name: str, seed: int = 7) -> None:
    from sentinel_tpu.chaos.runner import SCENARIOS as REF
    from sentinel_tpu.chaos.runner import run_scenario as ref_run
    from sentinel_tpu_torch.chaos.runner import SCENARIOS, report, run_scenario

    assert (SCENARIOS[name].fast, SCENARIOS[name].eager) == (REF[name].fast, REF[name].eager)
    want = ref_run(name, seed)
    got = run_scenario(name, seed, device="cpu")
    assert got.ok, report([got])
    mine, ref = got.to_dict(), want.to_dict()
    for d in (mine, ref):
        d.pop("duration_s")
    assert mine == ref


@pytest.mark.parametrize("name", _fast_scenarios())
def test_the_fast_scenario_equals_the_reference(name):
    compare_with_the_reference(name)


def test_the_fast_set_is_the_references():
    from sentinel_tpu.chaos.runner import SCENARIOS as REF
    from sentinel_tpu_torch.chaos.runner import SCENARIOS

    assert list(SCENARIOS) == list(REF)
    assert [n for n, s in SCENARIOS.items() if s.fast] == [n for n, s in REF.items() if s.fast]
    assert len(_fast_scenarios()) == 8
