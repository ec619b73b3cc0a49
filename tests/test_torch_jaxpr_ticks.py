"""The jaxpr tier's MXU, sketch-salsa, packed-wire and fused-seg tick
entries against the JAX package: each entry's recorded output on the
port's canonical inputs equals the reference's tick (jitted) on the
reference's ``_mk_tick_inputs`` — integers equal, floats within rtol
1e-6 / atol 1e-4.  (The plain and cluster-token ticks:
tests/test_torch_jaxpr_analysis.py.)"""

from __future__ import annotations

import pytest

from tests import torch_entries as TE

NAMES = ["tick/mxu", "tick/sketch-salsa", "tick/packed-wire"]

_ENTRIES = {}


def _entry(name):
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import build_entries

    if not _ENTRIES:
        _ENTRIES.update((e.name, e) for e in build_entries("cpu", NAMES))
    return _ENTRIES[name]


@pytest.mark.parametrize("name", NAMES)
def test_tick_outputs_equal_the_references(name):
    _args, out = TE.reference_tick(name)
    TE.assert_outputs_match(name, _entry(name), out)


def test_fused_seg_tick_outputs_equal_the_references():
    """The segment path: on the CPU the entry reaches the kernels' plain
    versions (no launch counter moves), and its output is the reference's."""
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import build_entries

    (entry,) = build_entries("cpu", ["tick/fused-seg"])
    assert entry.shadow_error is None and sum(entry.kernel_launches.values()) == 0
    _args, out = TE.reference_tick("tick/fused-seg")
    TE.assert_outputs_match("tick/fused-seg", entry, out)
