"""``tuner_fail_open`` on the port against the reference at seed 7: the
workload autotuner's raising steps fail OPEN to the last-good point and
dropped generator emissions are counted exactly, in both packages, with
equal injected counts and invariant verdicts and details (the helper is
test_torch_chaos_scenarios.py's).  A file of its own: the reference's
eager run of this scenario takes about a minute."""

from __future__ import annotations

import pytest

from sentinel_tpu.chaos import failpoints as JFP
from sentinel_tpu_torch.chaos import failpoints as TFP
from tests.test_torch_chaos_scenarios import compare_with_the_reference


@pytest.fixture(autouse=True)
def _disarm_guard():
    yield
    TFP.disarm()
    JFP.disarm()


def test_tuner_fail_open_equals_the_reference():
    compare_with_the_reference("tuner_fail_open")
