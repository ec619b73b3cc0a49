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
    [stats]           N_STATS words — the float32 telemetry row, as bits
    [timeline]        timeline_k * TL_COLS words — float32, as bits
    [hot]             hotset_k * 2 words — the sketch tier's hot-set
                      candidates, float32 (sketch id, windowed pass
                      estimate) as bits
    [explain]         2 + explain_k * EXPLAIN_WORDS words — provenance
                      records for up to explain_k BLOCKED rows
                      (obs/explain.py owns the record encoding):
                      ``[n_blocked, sec_sum, records...]`` with its OWN
                      additive checksum ``sec_sum`` seeded with
                      EXPLAIN_MAGIC.  The section sits OUTSIDE the main
                      checksum: a corrupt explain section drops the tick's
                      explanations only (fail-OPEN), while main-section
                      corruption still fails every verdict CLOSED.

Optional blocks appear iff the config emits them (``layout_for`` mirrors
the reference's conditions), so the layout is a pure function of
(EngineConfig, batch shape).

torch has no full uint32 arithmetic, so the device side packs in int64
and masks to 32 bits; the buffer travels as an int32 tensor holding the
same bits.  ``unpack`` (host numpy) validates the magic, the length and
the main checksum and raises :class:`WireDecodeError`; the client then
fails the tick CLOSED.  It hands the explain words back raw: their
checksum is checked by ``obs/explain.decode_section``.

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
#: seed of the explain section's own checksum — distinct from the main
#: checksum so a flip in either section is attributed to that section
EXPLAIN_MAGIC = 0x0B_5E_CF_A1
#: uint32 words per explain record (obs/explain.py packs/unpacks them)
EXPLAIN_WORDS = 4

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
    """The wire layout this config emits at batch shape ``b`` — the
    reference's conditions exactly (ops/engine.tick's emission)."""
    from sentinel_tpu_torch.ops import engine as E

    n_stats = E.N_STATS if cfg.device_telemetry else 0
    tl_rows = E.timeline_k(cfg) if cfg.device_telemetry else 0
    hot_rows = min(E.hotset_k(cfg), b)
    expl_k = min(E.explain_k(cfg), b)
    exc_k = min(EXC_K, b)
    n_bitmap = -(-b // VERDICTS_PER_WORD)
    off_bitmap = HDR_WORDS
    off_exc = off_bitmap + n_bitmap
    off_stats = off_exc + 2 * exc_k
    off_tl = off_stats + n_stats
    off_hot = off_tl + tl_rows * E.TL_COLS
    off_expl = off_hot + hot_rows * 2
    total = off_expl + (2 + expl_k * EXPLAIN_WORDS if expl_k else 0)
    return WireLayout(
        b=b, exc_k=exc_k, n_stats=n_stats, tl_rows=tl_rows, tl_cols=E.TL_COLS,
        hot_rows=hot_rows, expl_k=expl_k, off_bitmap=off_bitmap,
        n_bitmap=n_bitmap, off_exc=off_exc, off_stats=off_stats,
        off_tl=off_tl, off_hot=off_hot, off_expl=off_expl, total=total,
    )


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) → int32 tensor with the same bit patterns."""
    x = x & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _f32_words(x: torch.Tensor) -> torch.Tensor:
    """float32 values -> their bit patterns as int64 words (sign-extended:
    the checksum is a sum mod 2^32 and ``_to_i32_bits`` masks, so the high
    bits never show)."""
    return x.contiguous().view(torch.int32).reshape(-1).to(torch.int64)


def pack_tick_output(
    cfg: EngineConfig,
    verdict,
    wait_ms,
    seg_dropped=0,
    stats=None,  # float32 [N_STATS] or None
    res_stats=None,  # float32 [K, TL_COLS] or None
    expl=None,  # (n_blocked scalar, records int64 [K, 4] of uint32 words) or None
    hot=None,  # float32 [K, 2] or None
) -> torch.Tensor:
    """Pack one tick's outputs into the wire buffer (an int32 tensor of
    uint32 bit patterns), on the verdicts' device.  The blocks go in the
    layout's order: stats, timeline, hot, then the explain section."""
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
    parts = [bitmap, wi, wv & _U32]
    if lo.n_stats:
        parts.append(_f32_words(stats))
    if lo.tl_rows:
        parts.append(_f32_words(res_stats))
    if lo.hot_rows:
        parts.append(_f32_words(hot))
    payload = torch.cat(parts)
    # scalars are filled on the device: a host tensor here would be an
    # upload (and a stream sync) inside the tick
    magic = torch.full((), WIRE_MAGIC, dtype=torch.int64, device=dev)
    if isinstance(seg_dropped, torch.Tensor):  # the segment path's device count
        dropped = seg_dropped.to(torch.int64).reshape(())
    else:
        dropped = torch.full((), int(seg_dropped), dtype=torch.int64, device=dev)
    # the MAIN checksum stops at off_expl: the explain section carries its
    # own sec_sum, so its corruption fails OPEN without touching verdicts
    cksum = (magic + n_wait + dropped + torch.sum(payload)) & _U32
    out = [torch.stack([magic, n_wait, dropped & _U32, cksum]), payload]
    if lo.expl_k:
        n_blocked, records = expl  # records: uint32 words held in int64
        n_blocked = n_blocked.to(torch.int64).reshape(())
        flat = records.reshape(-1)
        sec_sum = (EXPLAIN_MAGIC + n_blocked + torch.sum(flat)) & _U32
        out += [torch.stack([n_blocked, sec_sum]), flat]
    return _to_i32_bits(torch.cat(out))


# -- host side ----------------------------------------------------------------


class WireFrame(NamedTuple):
    """One decoded tick readback (host numpy)."""

    verdict: np.ndarray  # int8 [B]
    wait: Optional[np.ndarray]  # int32 [B]; None = sidecar overflowed
    n_wait: int
    seg_dropped: int
    stats: Optional[np.ndarray] = None  # float32 [N_STATS]
    res_stats: Optional[np.ndarray] = None  # float32 [K, TL_COLS]
    hot: Optional[np.ndarray] = None  # float32 [K, 2]
    expl: Optional[np.ndarray] = None  # RAW uint32 explain words (unvalidated)


def unpack(data: bytes, lo: WireLayout) -> WireFrame:
    """Validate and unpack one readback.  Raises :class:`WireDecodeError`
    on any integrity failure (length, magic, main checksum); the explain
    section is not checked here — it fails open on its own sec_sum
    (obs/explain.decode_section), never the tick."""
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
    stats = res_stats = hot = None
    if lo.n_stats:
        stats = buf[lo.off_stats : lo.off_tl].view(np.float32)
    if lo.tl_rows:
        res_stats = buf[lo.off_tl : lo.off_hot].view(np.float32).reshape(lo.tl_rows, lo.tl_cols)
    if lo.hot_rows:
        hot = buf[lo.off_hot : lo.off_expl].view(np.float32).reshape(lo.hot_rows, 2)
    expl = buf[lo.off_expl : lo.total].copy() if lo.expl_k else None
    return WireFrame(
        verdict=verdict, wait=wait, n_wait=n_wait, seg_dropped=int(buf[2]), stats=stats,
        res_stats=res_stats, hot=hot, expl=expl,
    )


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
