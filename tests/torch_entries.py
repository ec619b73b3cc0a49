"""Shared checks of the port's jaxpr-tier entries against the JAX package
(tests/test_torch_jaxpr_*.py): the reference's tick on the reference's
canonical inputs, and the port's recorded entry on the port's."""

from __future__ import annotations

import functools

import numpy as np


def reference_ticks():
    """The reference's config and features of each tick entry
    (sentinel_tpu/analysis/jaxpr/entrypoints.py)."""
    from sentinel_tpu.cluster.token_service import DECISION_FEATURES
    from sentinel_tpu.core.config import small_engine_config as cfg
    from sentinel_tpu.ops import engine as JE

    return {
        "tick/plain": (cfg(), JE.ALL_FEATURES),
        "tick/mxu": (cfg(use_mxu_tables=True), JE.ALL_FEATURES),
        "tick/sketch-salsa": (cfg(sketch_stats=True, sketch_width=256, hotset_k=8), JE.ALL_FEATURES),
        "tick/fused-seg": (cfg(use_mxu_tables=True, fused_effects=True, seg_effects=True), JE.ALL_FEATURES),
        "tick/packed-wire": (
            cfg(packed_wire=True, sketch_stats=True, sketch_width=256, hotset_k=8, timeline_k=8), JE.ALL_FEATURES,
        ),
        "tick/cluster-token": (cfg(), DECISION_FEATURES),
    }


def reference_tick(name: str):
    """(inputs, (state, TickOutput)) of the reference's tick entry on its
    canonical inputs, jitted."""
    import jax

    from sentinel_tpu.analysis.jaxpr.entrypoints import _mk_tick_inputs
    from sentinel_tpu.ops import engine as JE

    cfg, features = reference_ticks()[name]
    args = _mk_tick_inputs(cfg)
    fn = functools.partial(JE.tick, cfg=cfg, features=features)
    return args, jax.jit(fn)(*args)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4, err_msg=what)
    elif got.dtype.itemsize == want.dtype.itemsize:
        # int32 against uint32 (the wire): the same bits
        assert got.tobytes() == want.tobytes(), what
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def assert_outputs_match(name: str, port_entry, ref_out) -> None:
    """The port's recorded tick output (state, TickOutput) equals the
    reference's: integers equal, floats within rtol 1e-6 / atol 1e-4."""
    import jax
    import torch

    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import tick_configs

    cfg = tick_configs()[name][0]
    js, jo = ref_out
    ts, to = port_entry.outputs
    want = S.leaves(S.state_from_numpy(cfg, jax.tree.map(np.asarray, js), "cpu"))
    got = S.leaves(ts)
    assert want.keys() == got.keys()
    for k in want:
        _close(got[k].cpu().numpy(), want[k].numpy(), f"{name} state {k}")
    for f in jo._fields:
        a, b = getattr(jo, f), getattr(to, f)
        assert (a is None) == (b is None), f"{name} output {f}"
        if a is not None:
            b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            _close(b, np.asarray(a), f"{name} output {f}")


def assert_inputs_match(name: str, ref_args, port_args) -> None:
    """The port's canonical tick inputs equal the reference's: the state,
    the compiled rules, the empty batches leaf by leaf, and the scalars."""
    import jax

    from sentinel_tpu_torch import state as S
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import tick_configs

    cfg = tick_configs()[name][0]
    js, jr, ja, jc, jnow, jload, jcpu = ref_args
    ts, tr, ta, tc, tnow, tload, tcpu = port_args
    pairs = [
        (S.leaves(S.state_from_numpy(cfg, jax.tree.map(np.asarray, js), "cpu")), S.leaves(ts)),
        (S.leaves(S.ruleset_from_numpy(cfg, jax.tree.map(np.asarray, jr), "cpu")), S.leaves(tr)),
    ]
    for want, got in pairs:
        assert want.keys() == got.keys()
        for k in want:
            _close(got[k].cpu().numpy(), want[k].numpy(), f"{name} input {k}")
    for jb, tb in ((ja, ta), (jc, tc)):
        assert jb._fields == tb._fields
        for f in jb._fields:
            _close(getattr(tb, f).cpu().numpy(), np.asarray(getattr(jb, f)), f"{name} batch {f}")
    assert tnow == int(jnow) and np.float32(tload) == np.float32(jload) and np.float32(tcpu) == np.float32(jcpu)
