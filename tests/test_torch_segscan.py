"""seg_excl_cumsum / seg_excl_cumsum_wide / seg_incl_min: the port's plain
versions against the JAX package's Pallas kernels (interpret mode, as
tests/test_segment.py runs them), exactly; B4's plain version against
``block_min_inclusive`` under block-capped heads; and the CUDA kernels
against the plain versions on the card (marked ``cuda``; skipped without
one).  Integer sums and float minima do not depend on the order of
combination, so every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.ops import segment as JSG
from sentinel_tpu.ops import segscan as JSC
from sentinel_tpu_torch.ops import segment as SG
from sentinel_tpu_torch.ops import segscan as SC

#: item counts: one item, a partial block, exactly one 2,048-item tile, and
#: one item past it (a second tile, carried across)
NS = [1, 255, 2048, 2049]


def _heads(rng, n, kind):
    if kind == "dense":
        h = rng.random(n) < 0.5
    elif kind == "sparse":
        h = rng.random(n) < 0.01
    elif kind == "all":
        h = np.ones(n, bool)
    else:  # "first": one segment over the whole row
        h = np.zeros(n, bool)
    h[0] = True
    return h


def _jax(fn, *args):
    with jax.disable_jit():
        return np.asarray(fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", ["dense", "sparse", "all", "first"])
@pytest.mark.parametrize("V", [1, 2])
def test_seg_excl_cumsum_matches_pallas(n, kind, V):
    rng = np.random.default_rng(n * 10 + V)
    head = _heads(rng, n, kind)
    # the row total stays below 2^31: every value up to (2^31 - 1) // n
    v = rng.integers(0, (2**31 - 1) // n + 1, (V, n)).astype(np.int32)
    v[:, -1] = (2**31 - 1) // n  # totals at the int32 edge
    arg = v[0] if V == 1 else v
    want = _jax(JSC.seg_excl_cumsum_pl, head, arg)
    got = SC.seg_excl_cumsum(torch.as_tensor(head), torch.as_tensor(arg)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_seg_excl_cumsum_row_total_just_under_int32():
    n = 2049
    head = np.zeros(n, bool)
    head[0] = True
    v = np.full((1, n), (2**31 - 1) // n, np.int32)
    want = _jax(JSC.seg_excl_cumsum_pl, head, v)
    got = SC.seg_excl_cumsum(torch.as_tensor(head), torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(got[0, -1]) + int(v[0, -1]) > 2**31 - 2 * n  # the edge is reached


@pytest.mark.parametrize("n", [255, 4096])
def test_seg_excl_cumsum_wide_matches_pallas_past_int32(n):
    rng = np.random.default_rng(n)
    head = _heads(rng, n, "sparse")
    v = np.full(n, (1 << 24) - 1, np.int32)
    v[::3] = rng.integers(0, 1 << 24, v[::3].shape[0])
    want = _jax(JSC.seg_excl_cumsum_wide_pl, head, v)
    got = SC.seg_excl_cumsum_wide(torch.as_tensor(head), torch.as_tensor(v)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if n == 4096:
        assert got.max() > 2**31  # segment totals genuinely past int32


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", ["dense", "sparse", "all", "first"])
def test_seg_incl_min_matches_pallas(n, kind):
    """Any heads (the Pallas kernel is a true segmented min with a carry
    across tiles); absent items at 3.0e38; N not a multiple of the tile
    (the JAX wrapper pads with fill and head = 1)."""
    rng = np.random.default_rng(7 * n + len(kind))
    head = _heads(rng, n, kind)
    v = (rng.integers(1, 4000, n) / 8.0).astype(np.float32)
    v[rng.random(n) < 0.2] = 3.0e38
    want = _jax(JSC.seg_incl_min_pl, head, v, 3.0e38)
    got = SC.seg_incl_min(torch.as_tensor(head), torch.as_tensor(v)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [96, 512, 3000])
def test_seg_incl_min_agrees_with_block_min_under_block_capped_heads(n):
    """The engine's contract (heads_from_keys puts a head at every 256th
    position): there B4 equals block_min_inclusive, the port's and the
    JAX package's."""
    rng = np.random.default_rng(23 + n)
    head = rng.random(n) < 0.07
    head[np.arange(n) % SG.BLOCK == 0] = True
    v = (rng.random(n) * 100.0).astype(np.float32)
    b4 = SC.seg_incl_min_plain(torch.as_tensor(head), torch.as_tensor(v)).numpy()
    blk = SG.block_min_inclusive(torch.as_tensor(head), torch.as_tensor(v), 3.0e38).numpy()
    jblk = _jax(JSG.block_min_inclusive, head, v, 3.0e38)
    np.testing.assert_array_equal(b4, blk)
    np.testing.assert_array_equal(b4, jblk)
    # without the block heads the two differ: B4 carries across blocks
    free = np.zeros(n, bool)
    free[0] = True
    v2 = np.linspace(1.0, 2.0, n, dtype=np.float32)[::-1].copy()
    v2[0] = 0.5
    carried = SC.seg_incl_min_plain(torch.as_tensor(free), torch.as_tensor(v2)).numpy()
    assert np.all(carried == 0.5)
    if n > SG.BLOCK:
        reset = SG.block_min_inclusive(torch.as_tensor(free), torch.as_tensor(v2), 3.0e38).numpy()
        assert reset[SG.BLOCK] != 0.5


@pytest.mark.parametrize("n", [255, 4096])
def test_the_combined_launchs_wide_row_equals_seg_excl_cumsum_wide(n):
    """seg_excl_cumsum_many, plain path: its narrow rows are
    seg_excl_cumsum's and each wide row is seg_excl_cumsum_wide's, bit for
    bit, and the JAX package's wide Pallas function's."""
    rng = np.random.default_rng(40 + n)
    head = _heads(rng, n, "sparse")
    narrow = rng.integers(0, (2**31 - 1) // n + 1, (2, n)).astype(np.int32)
    wide = np.full((2, n), (1 << 24) - 1, np.int32)
    wide[1, ::3] = rng.integers(0, 1 << 24, wide[1, ::3].shape[0])
    h = torch.as_tensor(head)
    got_n, got_w = SC.seg_excl_cumsum_many(h, torch.as_tensor(narrow), torch.as_tensor(wide))
    assert got_n.dtype == torch.int32 and got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_n.numpy(), SC.seg_excl_cumsum(h, torch.as_tensor(narrow)).numpy())
    for r in range(2):
        np.testing.assert_array_equal(got_w[r].numpy(), SC.seg_excl_cumsum_wide(h, torch.as_tensor(wide[r])).numpy())
        np.testing.assert_array_equal(got_w[r].numpy(), _jax(JSC.seg_excl_cumsum_wide_pl, head, wide[r]))
    if n == 4096:
        assert got_w.max() > 2**31
    only_wide = SC.seg_excl_cumsum_many(h, wide=torch.as_tensor(wide))
    assert only_wide[0] is None and torch.equal(only_wide[1], got_w)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    SC.reset_launches()
    head = torch.tensor([True, False, True])
    SC.seg_excl_cumsum(head, torch.tensor([1, 2, 3], dtype=torch.int32))
    SC.seg_excl_cumsum_wide(head, torch.tensor([1, 2, 3], dtype=torch.int32))
    SC.seg_incl_min(head, torch.tensor([1.0, 2.0, 3.0]))
    SC.seg_build([torch.tensor([1, 1, 2], dtype=torch.int32)], 2)
    assert SC.LAUNCHES == {"seg_excl_cumsum": 0, "seg_incl_min": 0, "seg_build": 0}
    with pytest.raises(ValueError):  # not all on the CPU, not on one CUDA device
        SC.seg_excl_cumsum(head, torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        SC.seg_incl_min(torch.tensor([True, False]), torch.zeros(3))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_seg_excl_cumsum_kernel_matches_plain_on_the_card():
    _card()
    rng = np.random.default_rng(5)
    SC.reset_launches()
    calls = 0
    for n in (1, 255, 2048, 2049, 131_072):
        for kind in ("dense", "sparse", "all", "first"):
            head = torch.as_tensor(_heads(rng, n, kind)).cuda()
            v = torch.as_tensor(rng.integers(0, (2**31 - 1) // n + 1, (4, n)).astype(np.int32)).cuda()
            assert torch.equal(SC.seg_excl_cumsum(head, v), SC.seg_excl_cumsum_plain(head, v))
            w = torch.as_tensor(rng.integers(0, 1 << 24, n).astype(np.int32)).cuda()
            assert torch.equal(SC.seg_excl_cumsum_wide(head, w), SG.seg_excl_cumsum_wide(head, w))
            # narrow and wide rows in one launch, segment totals past 2^31;
            # on one segment also int32 values of both signs outside the
            # contract (the plain version's cumsum minus the running maximum
            # of segment bases is a segmented sum only while its cumulative
            # sums rise, or over one segment)
            odd = rng.integers(-(2**31), 2**31 - 1, n) if kind == "first" else rng.integers(0, 1 << 24, n)
            wide = torch.stack([w, torch.full_like(w, (1 << 24) - 1), torch.as_tensor(odd.astype(np.int32)).cuda()])
            got = SC.seg_excl_cumsum_many(head, v[:2], wide)
            want = SC.seg_excl_cumsum_many_plain(head, v[:2], wide)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            calls += 3
    assert SC.LAUNCHES["seg_excl_cumsum"] == calls


@pytest.mark.cuda
def test_seg_incl_min_kernel_matches_plain_on_the_card():
    _card()
    rng = np.random.default_rng(6)
    SC.reset_launches()
    calls = 0
    for n in (1, 255, 2048, 2049, 131_072):
        for kind in ("dense", "sparse", "all", "first"):
            head = torch.as_tensor(_heads(rng, n, kind)).cuda()
            v = (rng.integers(1, 4000, n) / 8.0).astype(np.float32)
            v[rng.random(n) < 0.2] = 3.0e38
            v = torch.as_tensor(v).cuda()
            assert torch.equal(SC.seg_incl_min(head, v), SC.seg_incl_min_plain(head, v))
            calls += 1
    assert SC.LAUNCHES["seg_incl_min"] == calls
