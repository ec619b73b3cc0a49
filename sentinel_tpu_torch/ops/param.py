"""Hot-parameter statistics: hashed (rule, value) rows on a global window.

PyTorch counterpart of ``sentinel_tpu/ops/param.py``:

    pcms   : int32 [depth, Q, nb]   windowed counts; row = hash_d(rule, value)
    epochs : int32 [nb]             ONE global bucket grid (param_bucket_ms)
    pconc  : int32 [depth, Q]       per-(rule, value) concurrency (THREAD grade)

All rules share the bucket grid; a rule's window is its duration in
buckets, grouped into at most ``param_classes`` duration classes whose
windowed tables are masked sums over the recent buckets.  Estimates take
the minimum over the depth rows (a count-min sketch: collisions only
overestimate, so enforcement errs towards blocking).

The reference hashes in uint32; PyTorch has no uint32 multiply, shift or
modulo on the CPU, so the hashes run in int64 masked to 32 bits after
every multiply and add, with logical shifts on the masked value.  On the
fused path the writes land through the scatter kernel (``param{d}`` and
``prel{d}`` jobs of ops/fused.scatter_many); on the plain path through
indexed histograms (ops/engine.py).  The reads here are plain indexed
gathers, as they are plain XLA gathers in the reference: ``estimate`` is
the plain path's class-table read, ``estimate_fused`` the fused path's
flat one, and the two give the same values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sentinel_tpu_torch.core.config import EngineConfig
from sentinel_tpu_torch.ops import tables as T

I32, I64, F32 = torch.int32, torch.int64, torch.float32

# depth-row hash multipliers (odd constants, splitmix-ish)
_MULTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0x9E3779B9)
_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> the same 32 bits as a nonnegative int64."""
    return x.to(I64) & _M32


def cms_cell(h: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """int32 [N, depth] — column index per depth row for hashes h [N].
    Only the first multiply-add differs between depth rows; the rest of
    the mix runs once over all of them (uint32 arithmetic in masked int64)."""
    hu = _u32(h)
    x = torch.stack(
        [hu * _MULTS[d % len(_MULTS)] + ((d * 0x7F4A7C15) & _M32) for d in range(depth)], dim=-1
    ) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    x = x ^ (x >> 12)
    return (x % width).to(I32)


def pair_rows(slots: torch.Tensor, hashes: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """int32 [N, depth] — pcms row per depth for (rule slot, value hash).
    The slot is folded into the hash input so distinct rules' identical
    values land on independent rows."""
    mixed = ((_u32(hashes) * 0x01000193) & _M32) ^ ((_u32(slots) * 0x9E3779B9) & _M32)
    # the reference passes the mix through int32; cms_cell reads its bits
    return cms_cell(mixed, depth, width)


def wid_of(now_ms: int, cfg: EngineConfig) -> int:
    """Global bucket id (floor division, also for negative times)."""
    return int(now_ms) // cfg.param_bucket_ms


def refresh(
    pcms: torch.Tensor, epochs: torch.Tensor, now_ms: int, cfg: EngineConfig
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Zero the global current bucket if stale; returns (pcms, epochs, idx).
    Fresh tensors: the caller's state is left as it was."""
    wid = wid_of(now_ms, cfg)
    idx = wid % cfg.param_sample_count
    keep = (epochs[idx] == wid).to(pcms.dtype)
    pcms = pcms.clone()
    pcms[:, :, idx] *= keep
    epochs = epochs.clone()
    epochs.select(0, idx).fill_(wid)  # a fill kernel: no host-to-device copy, no sync
    return pcms, epochs, idx


def class_tables(
    pcms: torch.Tensor,  # [depth, Q, nb] — already refreshed
    epochs: torch.Tensor,  # [nb]
    class_k: torch.Tensor,  # int32 [C] — window length in buckets per class
    now_ms: int,
    cfg: EngineConfig,
) -> torch.Tensor:
    """f32 [depth, Q, C]: windowed totals per duration class.  Class c sums
    the buckets whose epoch lies in (wid - k_c, wid].  A masked integer sum
    (the reference's f32 einsum at HIGHEST precision is exact below 2^24,
    where the two agree)."""
    wid = wid_of(now_ms, cfg)
    valid = (epochs[None, :] > wid - class_k[:, None]) & (epochs[None, :] <= wid)  # [C, nb]
    out = [
        torch.sum(torch.where(valid[c], pcms, 0), dim=2, dtype=I32)
        for c in range(valid.shape[0])
    ]
    return torch.stack(out, dim=2).to(F32)


def estimate(
    cfg: EngineConfig,
    wtab: torch.Tensor,  # [depth, Q, C] from class_tables
    rows: torch.Tensor,  # [N, depth] from pair_rows
    cls: torch.Tensor,  # int32 [N] — the rule's duration class per item
) -> torch.Tensor:
    """f32 [N] — windowed CMS estimate (min over depth) for each item: each
    depth row's [Q, C] table read at the item's row, saturated at
    256**param_est_digits - 1 before the read, its class picked out."""
    C = wtab.shape[2]
    cap = 256**cfg.param_est_digits - 1
    cls_l = torch.clamp(cls, 0, C - 1).to(torch.int64)[:, None]
    ests = []
    for d in range(wtab.shape[0]):
        g = T.big_gather(
            torch.clamp_max(wtab[d].to(I32), cap), rows[:, d], cfg.param_width, max_int=cap
        )  # [N, C]
        ests.append(torch.gather(g, 1, cls_l)[:, 0].to(F32))
    return torch.amin(torch.stack(ests, dim=0), dim=0).to(F32)


def estimate_fused(
    cfg: EngineConfig,
    wtab: torch.Tensor,  # [depth, Q, C] from class_tables
    rows: torch.Tensor,  # [N, depth] from pair_rows
    cls: torch.Tensor,  # int32 [N]
) -> torch.Tensor:
    """f32 [N] — windowed CMS estimate (min over depth) of each item's
    (row, class) cell, saturated at 256**param_est_digits - 1 BEFORE the
    read (beyond it the digit planes would wrap an overestimate into an
    underestimate)."""
    depth, Q, C = wtab.shape
    cap = 256**cfg.param_est_digits - 1
    idx = torch.clamp(rows, 0, Q - 1) * C + torch.clamp(cls, 0, C - 1)[:, None]
    ests = []
    for d in range(depth):
        flat = torch.clamp_max(wtab[d].reshape(-1).to(I32), cap)
        ests.append(T.lane_gather_1col(flat, idx[:, d], Q * C))
    return torch.amin(torch.stack(ests, dim=0), dim=0).to(F32)


def conc_estimate(cfg: EngineConfig, pconc: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """f32 [N] — current concurrency estimate (min over depth)."""
    cap = (1 << 24) - 1
    ests = [
        T.big_gather(torch.clamp_max(pconc[d], cap), rows[:, d], cfg.param_width, max_int=cap)
        for d in range(pconc.shape[0])
    ]
    return torch.amin(torch.stack(ests, dim=0), dim=0).to(F32)
