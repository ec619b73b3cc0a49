"""Timing helpers of the probes: K launches on one stream, eager or as one
CUDA graph.  Everything here needs a CUDA card and raises without one."""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

#: SM clock assumed when sizing the sleep that hides the host's enqueue
_CYCLES_PER_S = 2.0e9
#: host-clock passes a row takes the least of
_REPEATS = 3


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure a CUDA card and none is available")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _timed(run: Callable[[], None], k: int) -> dict:
    """``run`` enqueues k steps.  Host microseconds a step to enqueue them
    and wall ms a step until the card is done (the least of three
    passes); then device ms a step, from CUDA events around one pass queued
    behind a sleep longer than its enqueue, so the events bracket device
    work only."""
    require_card()
    run()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(_REPEATS):
        t0 = time.perf_counter()
        run()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append(t1 - t0)
        wall.append(t2 - t0)
    torch.cuda._sleep(int(max(3.0 * max(host), 1e-4) * _CYCLES_PER_S))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    return dict(device_ms=a.elapsed_time(b) / k, host_us=min(host) / k * 1e6, wall_ms=min(wall) / k * 1e3)


def eager(step: Callable[[], None], k: int) -> dict:
    """k eager calls of ``step`` on the current stream (pipelined
    dispatches): per step, device ms, host enqueue us, wall ms."""

    def run():
        for _ in range(k):
            step()

    return _timed(run, k)


def graphed(step: Callable[[], None], k: int) -> dict:
    """k calls of ``step`` captured into ONE CUDA graph, timed per replay:
    per step, device ms, host us (of the one replay call), wall ms.
    ``step`` must allocate nothing the caller keeps and must not sync."""
    require_card()
    step()  # builds the kernels and warms allocations outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(k):
            step()
    return _timed(g.replay, k)
