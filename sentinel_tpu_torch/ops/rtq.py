"""Service-level RT quantiles — windowed log-bucket histogram.

The PyTorch counterpart of ``sentinel_tpu/ops/rtq.py``: completions land
in 64 log2-spaced bins up to statistic_max_rt, one ring column per second
window bucket, scoped to the global ENTRY node (inbound traffic).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sentinel_tpu_torch.ops import window as W

BINS = 64


class RtqConfig(NamedTuple):
    sample_count: int
    window_ms: int
    max_rt: float  # statistic_max_rt

    @property
    def interval_ms(self) -> int:
        return self.sample_count * self.window_ms


class RtqState(NamedTuple):
    counts: torch.Tensor  # int32 [nb, BINS]
    epochs: torch.Tensor  # int32 [nb]


def init_rtq(cfg: RtqConfig, device) -> RtqState:
    return RtqState(
        counts=torch.zeros((cfg.sample_count, BINS), dtype=torch.int32, device=device),
        epochs=torch.full(
            (cfg.sample_count,), -(cfg.sample_count + 1), dtype=torch.int32,
            device=device,
        ),
    )


def _log_scale(cfg: RtqConfig) -> float:
    return (BINS - 1) / float(np.log2(cfg.max_rt + 2.0))


def bin_of(rt_ms: torch.Tensor, cfg: RtqConfig) -> torch.Tensor:
    """int32 bin per rt (log2-spaced edges)."""
    x = torch.log2(torch.clamp_min(rt_ms, 0.0) + 1.0) * _log_scale(cfg)
    return torch.clamp(x.to(torch.int32), 0, BINS - 1)


def add(
    state: RtqState,
    now_ms: int,
    rt_ms: torch.Tensor,  # f32 [B]
    valid: torch.Tensor,  # bool [B]
    cfg: RtqConfig,
) -> RtqState:
    """Land one completion batch in the current column (reset first when
    the column holds an older window id).  Updates ``counts`` in place."""
    wid = W.wid_of(now_ms, cfg.window_ms)
    idx = wid % cfg.sample_count
    stale = state.epochs[idx] != wid
    bins = bin_of(rt_ms, cfg)
    iota = torch.arange(BINS, dtype=torch.int32, device=rt_ms.device)
    hist = ((bins[:, None] == iota) & valid[:, None]).sum(dim=0, dtype=torch.int32)
    state.counts[idx] = torch.where(stale, 0, state.counts[idx]) + hist
    col = torch.arange(cfg.sample_count, device=rt_ms.device) == idx
    return state._replace(epochs=torch.where(col, wid, state.epochs).to(torch.int32))
