"""seg_build: the tick's segment build, one side at a time.

On the CPU, ``segscan.seg_build_plain`` — and the engine's
``prepare_completions`` / ``prepare_acquire``, which reach it through the
wrapper — against the JAX package's ``prepare_completions`` /
``prepare_acquire`` (its B4 Pallas kernel in interpret mode, as
tests/test_torch_segscan.py runs it), on the live slots: integers equal,
floats within rtol 1e-6 / atol 1e-4 (the tolerance of the engine tests;
the minima are exact in practice).  Dead slots hold junk in the JAX
package (an unstable sort) and item 0's values in the port.

On the card (marked ``cuda``; skipped without one) the kernel against the
plain version, bit for bit, on every output and every slot.  This module
imports JAX only inside the CPU tests, so the card's tests run without it.
"""

import types

import numpy as np
import pytest
import torch

from sentinel_tpu_torch.core.config import small_engine_config
from sentinel_tpu_torch.ops import engine_seg as ES
from sentinel_tpu_torch.ops import segment as SG
from sentinel_tpu_torch.ops import segscan as SC

#: batch lengths: one item, a partial 256-item block, past one block, a tile
NS = [1, 64, 300, 2048]
COMP_KEYS = ("res", "ctx_node", "origin_node")
ACQ_KEYS = ("res", "ctx_node", "origin_node", "origin_id", "ctx_name")


def _batch(n: int, seed: int, trash_row: int) -> dict:
    """A presorted batch: runs of equal resources (one changing exactly at
    item 256, one run spanning 512), trash-row padding at the end, contexts
    and origins mostly constant within a run, RTs on the 1/8 ms grid with
    zeros and values past ``statistic_max_rt``."""
    rng = np.random.default_rng(seed)
    res = np.sort(rng.integers(0, max(2, min(n // 6, trash_row - 1)), n)).astype(np.int32)
    if n > 256:
        res[256:] += 1  # a key change exactly at the 256 boundary
    if n > 700:
        res[400:700] = res[400]  # one run across the boundary at 512
    pad = n // 8
    if pad:
        res[n - pad:] = trash_row
    ctx = np.where(rng.random(n) < 0.1, rng.integers(0, 5, n), res % 3).astype(np.int32)
    origin = np.where(rng.random(n) < 0.2, rng.integers(0, 4, n), trash_row).astype(np.int32)
    return dict(
        res=res, ctx_node=ctx, origin_node=origin,
        origin_id=rng.integers(-1, 3, n).astype(np.int32), ctx_name=rng.integers(-1, 2, n).astype(np.int32),
        success=rng.integers(0, 3, n).astype(np.int32), error=rng.integers(0, 2, n).astype(np.int32),
        rt=(rng.integers(0, 48_000, n) / 8.0).astype(np.float32),
    )


def _segments(cols: dict, keys) -> int:
    h = SG.heads_from_keys(*[torch.as_tensor(cols[k]) for k in keys])
    return int(h.sum())


def _stats(cfg, t: dict) -> SC.SegStats:
    return SC.SegStats(t["success"], t["error"], t["rt"], cfg.trash_row, cfg.max_batch_count, cfg.statistic_max_rt)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("side", ["completions", "acquire"])
def test_seg_build_plain_matches_the_reference(side, overflow, n):
    import jax

    from sentinel_tpu.core.config import small_engine_config as jax_small_cfg
    from sentinel_tpu.ops import engine_seg as JES

    cfg0 = small_engine_config(batch_size=n, complete_batch_size=n)
    cols = _batch(n, 100 * n + overflow, cfg0.trash_row)
    keys = COMP_KEYS if side == "completions" else ACQ_KEYS
    n_seg = _segments(cols, keys)
    seg_u = max(1, n_seg // 2) if overflow else 0  # 0: the automatic capacity
    kw = dict(batch_size=n, complete_batch_size=n, seg_u=seg_u)
    cfg, jcfg = small_engine_config(**kw), jax_small_cfg(**kw)
    U = ES.seg_capacity(cfg, n)
    assert not overflow or n_seg <= 1 or n_seg > U
    t = {k: torch.as_tensor(v) for k, v in cols.items()}
    with jax.disable_jit():
        jb = types.SimpleNamespace(**{k: jax.numpy.asarray(v) for k, v in cols.items()})
        if side == "completions":
            jctx, jcarry = JES.prepare_completions(jcfg, jb, frozenset())
            ctx, carry = ES.prepare_completions(cfg, types.SimpleNamespace(**t), frozenset())
        else:
            jctx, jcarry = JES.prepare_acquire(jcfg, jb)
            ctx, carry = ES.prepare_acquire(cfg, types.SimpleNamespace(**t))
    plain = SC.seg_build_plain([t[k] for k in keys], U, _stats(cfg, t) if side == "completions" else None)
    live = np.asarray(jctx.live)
    assert live.shape == (U,) and np.array_equal(ctx.live.numpy(), live)
    for f in ("head", "sid", "n_seg", "ok"):
        np.testing.assert_array_equal(getattr(ctx, f).numpy(), np.asarray(getattr(jctx, f)), err_msg=f)
    np.testing.assert_array_equal(ctx.seg_end.numpy()[live], np.asarray(jctx.seg_end)[live])
    assert int(ctx.n_seg) == n_seg and bool(ctx.ok) == (n_seg <= U)
    for k in keys:
        np.testing.assert_array_equal(getattr(carry, k).numpy()[live], np.asarray(getattr(jcarry, k))[live], err_msg=k)
    if side == "completions":
        assert carry.split == jcarry.split and len(carry.ce) == len(jcarry.ce) == 4
        for i, (a, b) in enumerate(zip(carry.ce, jcarry.ce)):
            np.testing.assert_array_equal(a.numpy()[live], np.asarray(b)[live], err_msg=f"ce {i}")
        np.testing.assert_allclose(carry.min_rt.numpy()[live], np.asarray(jcarry.min_rt)[live], rtol=1e-6, atol=1e-4)
        assert np.all(carry.min_rt.numpy()[~live] == SC.BIG)
        got = plain.ce + [plain.min_rt] + plain.keys
        want = carry.ce + [carry.min_rt] + [getattr(carry, k) for k in keys]
    else:
        assert bool(carry.res_sorted) == bool(jcarry.res_sorted) and bool(plain.res_sorted)
        got, want = plain.keys, [getattr(carry, k) for k in keys]
    # the engine's path on the CPU is the plain version, every slot included
    for a, b in zip(list(plain.ctx) + got, list(ctx) + want):
        assert torch.equal(a, b)


def test_the_kernels_digit_columns_are_cum_cols_columns():
    """The column spec the kernel takes (a plane as it is, or one base-256
    digit of it) gives cum_cols' split and columns."""
    rng = np.random.default_rng(3)
    for maxes in ((255, 255, 40_000), (1, 300, 2**31 - 1), (65_535, 255, 8)):
        planes = [torch.as_tensor(rng.integers(-5, m + 1, 50).astype(np.int32)) for m in maxes]
        C, split = SG.cum_cols(planes, list(maxes))
        plane_of, shift_of, n, split2 = SC._digit_columns(maxes)
        assert split2 == split and n == len(C)
        for c in range(n):
            v = planes[plane_of[c]]
            col = v if shift_of[c] < 0 else (v >> shift_of[c]) & 0xFF
            assert torch.equal(torch.cumsum(col, 0, dtype=torch.int32), C[c])


def test_seg_build_refuses_what_the_kernel_does_not_take():
    k = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        SC.seg_build([], 2)
    with pytest.raises(ValueError):
        SC.seg_build([k] * 6, 2)
    with pytest.raises(ValueError):
        SC.seg_build([k, k[:3]], 2)
    with pytest.raises(ValueError):
        SC.seg_build([k], 2, SC.SegStats(k, k, torch.zeros(5), 0, 255, 5000))
    with pytest.raises(ValueError):  # not all on the CPU, not on one CUDA device
        SC.seg_build([k, torch.zeros(4, dtype=torch.int32, device="meta")], 2)


def _card_batch(n, seed, trash_row, rts):
    """_batch on the card with its RTs replaced by ``rts`` where given."""
    cols = _batch(n, seed, trash_row)
    if rts is not None:
        cols["rt"] = np.resize(np.asarray(rts, np.float32), n)
    return {k: torch.as_tensor(v).cuda() for k, v in cols.items()}


@pytest.mark.cuda
def test_seg_build_kernel_equals_plain_on_the_card():
    """Both sides, N from 1 past two tiles to 131,072, the automatic and an
    overflowing capacity, a capacity past N, an unsorted batch, and RTs
    that are NaN, infinite, negative, huge, ties at 1/16 ms: every output
    and every slot equal, one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = small_engine_config()
    odd = [float("nan"), float("inf"), -float("inf"), -3.5, 0.0, -0.0, 3.4e38, 2.9e38, 1e30, 0.0625, 0.1875,
           5000.0, 5000.0625, 7.0, 1e-40]
    SC.reset_launches()
    calls = 0
    for n in (1, 4, 255, 256, 257, 2048, 2049, 6000, 131_072):
        for rts in (None, odd):
            t = _card_batch(n, n + len(rts or ()), cfg.trash_row, rts)
            if rts is not None:
                t["res"] = t["res"].flip(0)  # unsorted
            for side, keys in (("completions", COMP_KEYS), ("acquire", ACQ_KEYS)):
                stats = _stats(cfg, t) if side == "completions" else None
                n_seg = int(SG.heads_from_keys(*[t[k] for k in keys]).sum())
                for U in (ES.seg_capacity(cfg, n), max(1, n_seg // 2), n + 7):
                    kb = SC.seg_build([t[k] for k in keys], U, stats)
                    pb = SC.seg_build_plain([t[k] for k in keys], U, stats)
                    calls += 1
                    got = list(kb.ctx) + kb.keys + kb.ce + [kb.min_rt, kb.res_sorted]
                    want = list(pb.ctx) + pb.keys + pb.ce + [pb.min_rt, pb.res_sorted]
                    assert kb.split == pb.split
                    for i, (a, b) in enumerate(zip(got, want)):
                        assert (a is None and b is None) or torch.equal(a, b), (n, side, U, i)
    torch.cuda.synchronize()
    assert SC.LAUNCHES["seg_build"] == calls
