"""The port's packed wire against the JAX package's: byte-identical
buffers for the same verdicts and waits (ties in the PASS_WAIT sidecar,
sidecar overflow, ragged bitmap words), and the decoder's fail-closed
checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
from sentinel_tpu.ops import wire as JWIRE
from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.ops import wire as WIRE

FLAGS = dict(fused_effects=True, use_mxu_tables=True, device_telemetry=False,
             timeline_k=0, explain_k=0, packed_wire=True)


@pytest.mark.parametrize("b,n_wait", [(64, 0), (64, 5), (97, 64), (131, 80)])
def test_wire_bytes_match_jax(b, n_wait):
    rng = np.random.default_rng(b + n_wait)
    verdict = rng.integers(0, 7, b).astype(np.int8)
    wait = np.zeros(b, np.int32)
    rows = rng.choice(b, n_wait, replace=False)
    wait[rows] = rng.integers(1, 4, n_wait)  # few distinct values: many ties
    with jax.disable_jit():
        want = np.asarray(
            JWIRE.pack_tick_output(jax_small_cfg(**FLAGS), jnp.asarray(verdict), jnp.asarray(wait), 0, None, None, None)
        )
    got = WIRE.pack_tick_output(small_engine_config(**FLAGS), torch.as_tensor(verdict), torch.as_tensor(wait)).numpy()
    assert got.tobytes() == want.tobytes()
    lo = WIRE.layout_for(small_engine_config(**FLAGS), b)
    assert lo == tuple(JWIRE.layout_for(jax_small_cfg(**FLAGS), b))
    frame = WIRE.unpack(got.tobytes(), lo)
    np.testing.assert_array_equal(frame.verdict, verdict)
    if n_wait <= lo.exc_k:
        np.testing.assert_array_equal(frame.wait, wait)
    else:
        assert frame.wait is None  # overflow: the client reads wait_ms instead


def test_unpack_fails_closed_on_corruption():
    cfg = small_engine_config(**FLAGS)
    buf = WIRE.pack_tick_output(cfg, torch.zeros(64, dtype=torch.int8), torch.zeros(64, dtype=torch.int32))
    data = buf.numpy().tobytes()
    lo = WIRE.layout_for(cfg, 64)
    WIRE.unpack(data, lo)
    for bad in (data[:-4], b"\0" * len(data), data[:20] + bytes([data[20] ^ 1]) + data[21:]):
        with pytest.raises(WIRE.WireDecodeError):
            WIRE.unpack(bad, lo)


@pytest.mark.parametrize("b,tl_k,ex_k", [(64, 8, 16), (97, 63, 4), (256, 20, 100)])
def test_wire_bytes_with_the_planes_match_jax(b, tl_k, ex_k):
    """The stats row, the timeline block and the explain section packed by
    both packages from the same values: byte-identical buffers, the explain
    section behind the main checksum and with its own."""
    from sentinel_tpu_torch.ops import engine as E

    flags = dict(FLAGS, device_telemetry=True, timeline_k=tl_k, explain_k=ex_k)
    jcfg, tcfg = jax_small_cfg(**flags), small_engine_config(**flags)
    lo = WIRE.layout_for(tcfg, b)
    assert lo == tuple(JWIRE.layout_for(jcfg, b))
    rng = np.random.default_rng(b)
    verdict = rng.integers(0, 7, b).astype(np.int8)
    wait = np.where(verdict == 6, rng.integers(1, 9, b), 0).astype(np.int32)
    stats = rng.normal(size=E.N_STATS).astype(np.float32) * 1e3
    res_stats = rng.normal(size=(lo.tl_rows, E.TL_COLS)).astype(np.float32)
    n_blocked = int(rng.integers(0, b))
    records = rng.integers(0, 2**32, (lo.expl_k, 4), dtype=np.uint64)
    with jax.disable_jit():
        want = np.asarray(JWIRE.pack_tick_output(
            jcfg, jnp.asarray(verdict), jnp.asarray(wait), 3, jnp.asarray(stats), jnp.asarray(res_stats), None,
            (jnp.uint32(n_blocked), jnp.asarray(records.astype(np.uint32))),
        ))
    got = WIRE.pack_tick_output(
        tcfg, torch.as_tensor(verdict), torch.as_tensor(wait), 3, torch.as_tensor(stats),
        torch.as_tensor(res_stats), (torch.tensor(n_blocked), torch.as_tensor(records.astype(np.int64))),
    ).numpy()
    assert got.tobytes() == want.tobytes()
    frame = WIRE.unpack(got.tobytes(), lo)
    np.testing.assert_array_equal(frame.stats, stats)
    np.testing.assert_array_equal(frame.res_stats, res_stats)
    assert frame.seg_dropped == 3 and frame.expl.shape == (2 + 4 * lo.expl_k,)
    assert frame.expl[0] == n_blocked
    np.testing.assert_array_equal(frame.expl[2:].reshape(-1, 4), records.astype(np.uint32))
