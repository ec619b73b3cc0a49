"""Packed host↔device wire format for the client tick path.

PyTorch counterpart of ``sentinel_tpu/ops/wire.py``.  The port's wire
buffer is BYTE-IDENTICAL to the JAX package's for the same tick, so the
host decoder and its fail-closed contract carry over unchanged.

Readback — ONE flat buffer of uint32 words per tick::

    word 0            WIRE_MAGIC (layout/version tag)
    word 1            n_wait   — count of PASS_WAIT rows with wait > 0
    word 2            seg_dropped — items failed closed past the segment
                      capacity (0 on the per-item path)
    word 3            checksum — uint32 sum of words {0,1,2} ∪ payload
    [bitmap]          ceil(B / 10) words; 10 verdicts per word, 3 bits each
    [sidecar]         EXC_K row indices then EXC_K wait values: the top-EXC_K
                      rows of wait_ms (ties: lower row first)
    [stats] [timeline] [hot] [explain]
                      optional blocks — none of them is emitted by this
                      engine yet (device telemetry, timeline, sketch and
                      explain records are not ported), so ``layout_for``
                      gives them zero words

torch has no full uint32 arithmetic, so the device side packs in int64
and masks to 32 bits; the buffer travels as an int32 tensor holding the
same bits.  ``unpack`` (host numpy) validates the magic, the length and
the checksum and raises :class:`WireDecodeError`; the client then fails the
tick CLOSED.

Upload — batch columns with a static value range travel narrow and widen
at tick entry: prio/inbound are 0/1 flags, pre_verdict a verdict code, and
count/success/error are clamped to ``cfg.max_batch_count`` by the client
(the fused path is the only path here, so the clamp always applies).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sentinel_tpu_torch.core.config import EngineConfig

#: layout/version tag — the JAX package's value
WIRE_MAGIC = 0x53_E1_71_12
VERDICT_BITS = 3
VERDICTS_PER_WORD = 10
_VMASK = (1 << VERDICT_BITS) - 1
HDR_WORDS = 4
#: PASS_WAIT sidecar capacity
EXC_K = 64
#: columns of a timeline row (the optional block this engine never emits)
TL_COLS = 8

_U32 = 0xFFFFFFFF


class WireDecodeError(Exception):
    """The fused readback failed validation (bad magic, wrong length, or
    checksum mismatch).  The client turns this into a fail-CLOSED tick."""


class WireLayout(NamedTuple):
    """Static offset table for one (config, batch shape) pair."""

    b: int
    exc_k: int
    n_stats: int
    tl_rows: int
    tl_cols: int
    hot_rows: int
    expl_k: int
    off_bitmap: int
    n_bitmap: int
    off_exc: int
    off_stats: int
    off_tl: int
    off_hot: int
    off_expl: int
    total: int


def layout_for(cfg: EngineConfig, b: int) -> WireLayout:
    """The wire layout this config emits at batch shape ``b``.  The port's
    engine emits none of the optional blocks (it raises for the flags that
    would), so they take zero words."""
    n_stats = tl_rows = hot_rows = expl_k = 0
    exc_k = min(EXC_K, b)
    n_bitmap = -(-b // VERDICTS_PER_WORD)
    off_bitmap = HDR_WORDS
    off_exc = off_bitmap + n_bitmap
    off_stats = off_exc + 2 * exc_k
    off_tl = off_stats + n_stats
    off_hot = off_tl + tl_rows * TL_COLS
    off_expl = off_hot + hot_rows * 2
    total = off_expl
    return WireLayout(
        b=b, exc_k=exc_k, n_stats=n_stats, tl_rows=tl_rows, tl_cols=TL_COLS,
        hot_rows=hot_rows, expl_k=expl_k, off_bitmap=off_bitmap,
        n_bitmap=n_bitmap, off_exc=off_exc, off_stats=off_stats,
        off_tl=off_tl, off_hot=off_hot, off_expl=off_expl, total=total,
    )


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) → int32 tensor with the same bit patterns."""
    x = x & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_tick_output(cfg: EngineConfig, verdict, wait_ms, seg_dropped=0) -> torch.Tensor:
    """Pack one tick's verdicts and pacing sidecar into the wire buffer
    (an int32 tensor of uint32 bit patterns), on the verdicts' device."""
    b = verdict.shape[0]
    dev = verdict.device
    lo = layout_for(cfg, b)
    v = torch.zeros((lo.n_bitmap * VERDICTS_PER_WORD,), dtype=torch.int64, device=dev)
    v[:b] = verdict.to(torch.int64) & _VMASK
    shifts = torch.arange(VERDICTS_PER_WORD, dtype=torch.int64, device=dev) * VERDICT_BITS
    # lanes occupy disjoint bit ranges, so the OR-fold is a plain sum
    bitmap = torch.sum(v.reshape(lo.n_bitmap, VERDICTS_PER_WORD) << shifts[None, :], dim=1)
    w64 = wait_ms.to(torch.int64)
    n_wait = torch.sum(w64 > 0)
    # top-K by wait value, ties to the lower row (the reference's top_k
    # order): one ascending sort of (-wait, row)
    rows = torch.arange(b, dtype=torch.int64, device=dev)
    order = torch.sort(((-w64) << 32) | rows).values & _U32
    wi = order[: lo.exc_k]
    wv = w64[wi]
    payload = torch.cat([bitmap, wi, wv & _U32])
    # scalars are filled on the device: a host tensor here would be an
    # upload (and a stream sync) inside the tick
    magic = torch.full((), WIRE_MAGIC, dtype=torch.int64, device=dev)
    if isinstance(seg_dropped, torch.Tensor):  # the segment path's device count
        dropped = seg_dropped.to(torch.int64).reshape(())
    else:
        dropped = torch.full((), int(seg_dropped), dtype=torch.int64, device=dev)
    cksum = (magic + n_wait + dropped + torch.sum(payload)) & _U32
    hdr = torch.stack([magic, n_wait, dropped & _U32, cksum])
    return _to_i32_bits(torch.cat([hdr, payload]))


# -- host side ----------------------------------------------------------------


class WireFrame(NamedTuple):
    """One decoded tick readback (host numpy)."""

    verdict: np.ndarray  # int8 [B]
    wait: Optional[np.ndarray]  # int32 [B]; None = sidecar overflowed
    n_wait: int
    seg_dropped: int


def unpack(data: bytes, lo: WireLayout) -> WireFrame:
    """Validate and unpack one readback.  Raises :class:`WireDecodeError`
    on any integrity failure (length, magic, checksum)."""
    if len(data) != lo.total * 4:
        raise WireDecodeError(f"wire length {len(data)} B != layout {lo.total * 4} B")
    buf = np.frombuffer(data, dtype=np.uint32)
    if int(buf[0]) != WIRE_MAGIC:
        raise WireDecodeError(f"bad wire magic {int(buf[0]):#x}")
    expect = (
        int(buf[0]) + int(buf[1]) + int(buf[2])
        + int(np.sum(buf[HDR_WORDS : lo.off_expl], dtype=np.uint64))
    ) & _U32
    if int(buf[3]) != expect:
        raise WireDecodeError(f"wire checksum mismatch ({int(buf[3]):#x} != {expect:#x})")
    n_wait = int(buf[1])
    words = buf[lo.off_bitmap : lo.off_bitmap + lo.n_bitmap]
    shifts = np.arange(VERDICTS_PER_WORD, dtype=np.uint32) * VERDICT_BITS
    verdict = (
        ((words[:, None] >> shifts[None, :]) & _VMASK).reshape(-1)[: lo.b].astype(np.int8)
    )
    wait: Optional[np.ndarray]
    if n_wait == 0:
        wait = np.zeros(lo.b, np.int32)
    elif n_wait <= lo.exc_k:
        idx = buf[lo.off_exc : lo.off_exc + lo.exc_k].astype(np.int64)
        vals = buf[lo.off_exc + lo.exc_k : lo.off_stats].astype(np.int32)
        live = vals > 0
        if int(idx[live].max(initial=0)) >= lo.b:
            raise WireDecodeError("wait sidecar row index out of range")
        wait = np.zeros(lo.b, np.int32)
        wait[idx[live]] = vals[live]
    else:
        wait = None  # overflow: caller reads the full wait_ms column
    return WireFrame(verdict=verdict, wait=wait, n_wait=n_wait, seg_dropped=int(buf[2]))


# -- narrow upload dtypes ------------------------------------------------------


def _count_dtype(cfg: EngineConfig):
    """Narrowest dtype that carries the clamped count columns exactly."""
    if cfg.max_batch_count <= 0xFF:
        return torch.uint8
    if cfg.max_batch_count <= 0x7FFF:
        return torch.int16
    return torch.int32


def acquire_wire_dtypes(cfg: EngineConfig) -> dict:
    """field -> torch dtype for AcquireBatch columns narrower than int32."""
    if not cfg.packed_wire:
        return {}
    out = {"prio": torch.int8, "inbound": torch.int8, "pre_verdict": torch.int8}
    cd = _count_dtype(cfg)
    if cd is not torch.int32:
        out["count"] = cd
    return out


def complete_wire_dtypes(cfg: EngineConfig) -> dict:
    if not cfg.packed_wire:
        return {}
    out = {"inbound": torch.int8}
    cd = _count_dtype(cfg)
    if cd is not torch.int32:
        out["success"] = cd
        out["error"] = cd
    return out


def _widen(batch, fields):
    reps = {}
    for f in fields:
        x = getattr(batch, f)
        if x.dtype != torch.int32:
            reps[f] = x.to(torch.int32)
    return batch._replace(**reps) if reps else batch


def widen_acquire(acq):
    """Restore int32 for narrow-uploaded acquire columns at tick entry."""
    return _widen(acq, ("count", "prio", "inbound", "pre_verdict"))


def widen_complete(comp):
    return _widen(comp, ("inbound", "success", "error"))
