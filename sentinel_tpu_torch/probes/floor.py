"""What one kernel launch costs on this card: per launch and per step,
eager against a CUDA graph.

Counterpart of the JAX package's ``benchmarks/probe_pallas_floor.py`` and
``benchmarks/probe_pallas_floor2.py``, with the same data
(``np.random.default_rng(0)``, B = 131,072 ids in [0, 16384), K = 96
repetitions) and the same questions, asked of the card:

(a) ``probe_copy`` (``x + 1``) shared by 1, 4, 64 and 512 blocks and by
    its default grid (``kernels.COPY_ITEMS`` items a thread) — the
    counterpart of the TPU grid's 1 / 4 / 64 steps, sequential or
    parallel;
(b) K eager launches on one stream (the probes' "pipelined dispatches")
    against ONE CUDA graph that holds K launches (their "inside
    ``lax.scan``": no host work between launches), for the kernel and for
    ``x + 1`` in PyTorch;
(c) two launches a step;
(d) ``probe_hist_count`` at the five ``(n, n_lo)`` output shapes and at
    4,096 / 8,192 items a block, and ``probe_hist_planes`` at the 5-plane
    shape.

Per step each row gives device ms (CUDA events around K steps queued
behind a sleep, so no host time is inside), host microseconds to enqueue,
and wall ms until the card is done.  The launches run back to back on the
same operands, so the 50 MB L2 holds them.

    python3 -m sentinel_tpu_torch.probes.floor
"""

from __future__ import annotations

import numpy as np
import torch

from sentinel_tpu_torch.probes import kernels as PK
from sentinel_tpu_torch.probes import timing as TM

B = 131072
K = 96
#: the (n, n_lo) output shapes of the count-histogram probe
COUNT_SHAPES = ((16392, 512), (16392, 128), (16384, 128), (16384, 512), (32777, 128))
#: the 5-plane probe's shape
PLANES_N, PLANES_N_LO = 16392, 128


def data(device="cuda"):
    """(ids int32 [B] in [0, 16384), vals int32 [B, 5] in [0, 200))."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 16384, B, dtype=np.int32)
    vals = rng.integers(0, 200, (B, 5), dtype=np.int32)
    return torch.as_tensor(ids).to(device), torch.as_tensor(vals).to(device)


def _chain(op, x, per_step: int = 1):
    """A step that applies ``op(src, out=dst)`` ``per_step`` times, each
    reading what the last wrote (two buffers, swapped)."""
    bufs = [x.clone(), torch.empty_like(x)]

    def step():
        for _ in range(per_step):
            op(bufs[0], bufs[1])
            bufs.reverse()

    return step


def run() -> list:
    """The table's rows, each ``dict(name, mode, launches, device_ms,
    host_us, wall_ms)`` per step."""
    TM.require_card()
    ids, vals = data()
    rows = []

    def row(name, mode, launches, t):
        rows.append(dict(name=name, mode=mode, launches=launches, **t))

    def copy(blocks):
        return lambda src, dst: PK.probe_copy(src, blocks, out=dst)

    def torch_add(src, dst):
        torch.add(src, 1, out=dst)

    # (a) the copy shared by 1 / 4 / 64 / 512 blocks and by its default grid
    default = f"default grid ({-(-B // (256 * PK.COPY_ITEMS))} blocks)"
    for blocks, label in ((1, "1 block"), (4, "4 blocks"), (64, "64 blocks"), (512, "512 blocks"), (0, default)):
        row(f"probe_copy {label}", "eager", 1, TM.eager(_chain(copy(blocks), ids), K))
    # (b) K eager launches against one graph of K launches
    row(f"probe_copy {default}", "graph", 1, TM.graphed(_chain(copy(0), ids), K))
    row("probe_copy 1 block", "graph", 1, TM.graphed(_chain(copy(1), ids), K))
    row("torch x + 1", "eager", 1, TM.eager(_chain(torch_add, ids), K))
    row("torch x + 1", "graph", 1, TM.graphed(_chain(torch_add, ids), K))
    # (c) two launches a step
    row(f"2x probe_copy {default}", "eager", 2, TM.eager(_chain(copy(0), ids, 2), K))
    row(f"2x probe_copy {default}", "graph", 2, TM.graphed(_chain(copy(0), ids, 2), K))
    # (d) the histograms
    for n, n_lo in COUNT_SHAPES:
        out = torch.empty(PK.padded_shape(n, n_lo), dtype=torch.float32, device=ids.device)
        step = lambda n=n, n_lo=n_lo, out=out: PK.probe_hist_count(ids, n, n_lo, out=out)
        row(f"probe_hist_count n={n} n_lo={n_lo}", "eager", 1, TM.eager(step, K))
        if (n, n_lo) == (PLANES_N, PLANES_N_LO):
            row(f"probe_hist_count n={n} n_lo={n_lo}", "graph", 1, TM.graphed(step, K))
    n, n_lo = PLANES_N, PLANES_N_LO
    out = torch.empty(PK.padded_shape(n, n_lo), dtype=torch.float32, device=ids.device)
    for ipb in (4096, 8192):
        row(f"probe_hist_count n={n} n_lo={n_lo} items_per_block={ipb}", "eager", 1,
            TM.eager(lambda ipb=ipb: PK.probe_hist_count(ids, n, n_lo, ipb, out=out), K))
    out5 = torch.empty((5,) + PK.padded_shape(n, n_lo), dtype=torch.float32, device=ids.device)
    step5 = lambda: PK.probe_hist_planes(ids, vals, n, n_lo, out=out5)
    row(f"probe_hist_planes 5 planes n={n} n_lo={n_lo}", "eager", 1, TM.eager(step5, K))
    row(f"probe_hist_planes 5 planes n={n} n_lo={n_lo}", "graph", 1, TM.graphed(step5, K))
    return rows


def format_rows(rows) -> list:
    return [
        f"{r['name']:58s} {r['mode']:6s} {r['launches']} launch(es) a step: device {r['device_ms']:.5f} ms, "
        f"host {r['host_us']:.2f} us, wall {r['wall_ms']:.5f} ms"
        for r in rows
    ]


def main() -> None:
    TM.require_card()
    print(f"{TM.card_line()}; B = {B} items, K = {K} steps a row; per step")
    for line in format_rows(run()):
        print(line)


if __name__ == "__main__":
    main()
