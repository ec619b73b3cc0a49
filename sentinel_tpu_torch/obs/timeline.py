"""Per-resource metric timelines: device-batched top-K stat rows folded
into an indexed on-disk metric log, queryable by (resource, time range).

The port's copy of ``sentinel_tpu/obs/timeline.py``.  The reference
Sentinel's third observability channel is the per-second, per-resource
metric log: ``MetricWriter`` appends one line per active resource per
second with a second->offset index, and ``MetricSearcher`` serves the
dashboard's ``/metric?startTime&endTime`` pull.  Here:

* the engine emits a float32 ``[K, TL_COLS]`` matrix per tick — the
  top-K resource rows by windowed pass+block, selected **on the device**
  over the O(1) sliding-window sums it already keeps
  (``ops/engine._device_res_stats``) — so per-resource timelines cost K
  rows of readback, not a host re-scan of every resource row;
* ``TimelineRecorder`` is the write-behind fold: bucket reads are
  CUMULATIVE, so it keeps the last read per (resource, window bucket)
  and flushes exact per-second ``MetricRow`` records once the engine
  clock leaves the second;
* ``MetricLog`` is the reference-shaped store: append-only binary
  per-second records (CRC-framed), a second->offset index file per
  segment, size-based rotation with retention pruning, and a crash-safe
  reopen that truncates a torn tail and rebuilds a disagreeing index;
* ``MetricLog.find(resource, start_ms, end_ms)`` / the recorder's
  read-through ``find`` are the ``MetricSearcher`` analog.

The recorder feeds the flight recorder (``flight_section``: the last
~30 s of the hottest resources' rows), and registers itself for the
fleet-wide merge (``live_recorders``; obs/fleet.fleet_timeline).

The timeline is OBSERVABILITY, never an admission dependency: a failed
log write (full disk, chaos ``datasource.metriclog.write``) fails OPEN —
the row is dropped from disk (kept in the memory ring), counted in
``sentinel_timeline_write_failures_total``, and decisions are untouched.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.obs.registry import REGISTRY

#: column indices of the device matrix (mirrors ops/engine.TL_* — kept
#: literal here so this module stays importable without torch)
TL_RID = 0
TL_PASS = 1
TL_BLOCK = 2
TL_SUCCESS = 3
TL_EXCEPTION = 4
TL_RT_SUM = 5
TL_RT_MIN = 6
TL_CONC = 7

#: ops/window.RT_MIN_INIT — the "no completions in bucket" sentinel;
#: masked to 0.0 in records (a phantom 5 s minimum helps nobody)
_RT_MIN_INIT = 5000.0

_C_ROWS = REGISTRY.counter(
    "sentinel_timeline_rows_total",
    "per-second per-resource rows flushed by the timeline recorder",
)
_C_WRITE_FAIL = REGISTRY.counter(
    "sentinel_timeline_write_failures_total",
    "timeline metric-log writes that failed (rows dropped from disk, "
    "decisions unaffected — the timeline fails OPEN)",
)
_G_SEGMENTS = REGISTRY.gauge(
    "sentinel_timeline_segments",
    "live metric-log segment files after rotation/retention",
)
_WIRE_HELP = "bytes moved, by path (device|cluster|timeline) and direction (tx|rx)"
_C_WIRE = {
    d: REGISTRY.counter(
        "sentinel_wire_bytes_total", _WIRE_HELP,
        labels={"path": "timeline", "direction": d},
    )
    for d in ("tx", "rx")
}

#: chaos injection site on the log-write path (hit once per non-empty
#: disk flush); a raise exercises the fail-OPEN contract end to end
_FP_WRITE = FP.register(
    "datasource.metriclog.write",
    "timeline metric-log disk append (a raise drops the rows from disk; "
    "decisions unaffected — fail OPEN)",
    FP.HIT_ACTIONS,
)


@dataclass
class MetricRow:
    """One (second, resource) timeline record — the binary analog of the
    reference's MetricNode line."""

    sec_ms: int  # wall-clock ms, second-aligned
    resource: str
    pass_count: int = 0
    block_count: int = 0
    success_count: int = 0
    exception_count: int = 0
    rt_sum: float = 0.0
    rt_min: float = 0.0  # 0 = no completions that second
    concurrency: int = 0

    def to_dict(self) -> dict:
        return {
            "ts": self.sec_ms,
            "resource": self.resource,
            "pass": self.pass_count,
            "block": self.block_count,
            "success": self.success_count,
            "exception": self.exception_count,
            "rt_sum": round(float(self.rt_sum), 3),
            "rt_min": round(float(self.rt_min), 3),
            "concurrency": self.concurrency,
        }


# -- binary codec ------------------------------------------------------------
#
# record := FIXED | name(utf-8) | crc32(FIXED | name)  — little-endian.
# The format is the JAX package's, byte for byte (tests/test_torch_obs.py
# holds the two codecs to each other): any layout change must bump
# RECORD_MAGIC so old files are rejected, not misread.

RECORD_MAGIC = 0x544C  # "TL"
_FIXED = struct.Struct("<HHQIIIIffIH")  # magic, len, sec, p, b, s, e, rts, rtm, conc, nlen
_CRC = struct.Struct("<I")
_IDX = struct.Struct("<QQ")  # (sec_ms, byte offset of its first record)
MAX_RECORD_LEN = _FIXED.size + 1024 + _CRC.size  # resource names cap at 1 KiB


def pack_record(row: MetricRow) -> bytes:
    name = row.resource.encode("utf-8")[:1024]
    body = _FIXED.pack(
        RECORD_MAGIC,
        _FIXED.size + len(name) + _CRC.size,
        int(row.sec_ms),
        int(row.pass_count) & 0xFFFFFFFF,
        int(row.block_count) & 0xFFFFFFFF,
        int(row.success_count) & 0xFFFFFFFF,
        int(row.exception_count) & 0xFFFFFFFF,
        float(row.rt_sum),
        float(row.rt_min),
        int(row.concurrency) & 0xFFFFFFFF,
        len(name),
    ) + name
    return body + _CRC.pack(zlib.crc32(body))


def unpack_record(buf: bytes, offset: int = 0):
    """(MetricRow, next_offset) or None when the bytes at ``offset`` are
    not a whole valid record (torn tail, corruption, index drift)."""
    end = len(buf)
    if offset + _FIXED.size > end:
        return None
    magic, rec_len, sec, p, b, s, e, rts, rtm, conc, nlen = _FIXED.unpack_from(
        buf, offset
    )
    if (
        magic != RECORD_MAGIC
        or rec_len != _FIXED.size + nlen + _CRC.size
        or rec_len > MAX_RECORD_LEN
        or offset + rec_len > end
    ):
        return None
    body_end = offset + _FIXED.size + nlen
    (crc,) = _CRC.unpack_from(buf, body_end)
    if zlib.crc32(buf[offset:body_end]) != crc:
        return None
    name = buf[offset + _FIXED.size : body_end].decode("utf-8", "replace")
    return (
        MetricRow(sec, name, p, b, s, e, rts, rtm, conc),
        offset + rec_len,
    )


# -- the on-disk log ---------------------------------------------------------


def _seg_paths(base_dir: str, seq: int):
    return (
        os.path.join(base_dir, f"timeline_{seq:06d}.mlog"),
        os.path.join(base_dir, f"timeline_{seq:06d}.idx"),
    )


def _read_idx(idx_path: str) -> List[tuple]:
    """[(sec_ms, offset)] — a torn trailing entry (size not a multiple of
    the entry width) is ignored."""
    try:
        with open(idx_path, "rb") as f:
            raw = f.read()
    except OSError:
        return []
    n = len(raw) // _IDX.size
    return [_IDX.unpack_from(raw, i * _IDX.size) for i in range(n)]


class MetricLog:
    """Append-only binary per-second metric log with a per-segment
    second→offset index, size-based rotation, retention pruning, and
    crash-safe reopen (see the module docstring).  Thread-safe."""

    def __init__(
        self,
        base_dir: str,
        max_segment_bytes: int = 8 << 20,
        max_segments: int = 8,
    ):
        self.base_dir = base_dir
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_segments = max(1, int(max_segments))
        self._lock = threading.Lock()
        self._fh = None
        self._idx_fh = None
        self._size = 0
        self._last_idx_sec = -1
        os.makedirs(base_dir, exist_ok=True)
        seqs = self._segment_seqs()
        self._seq = seqs[-1] if seqs else 1
        if seqs:
            self._recover(self._seq)
        self._open_segment(self._seq, recovered=bool(seqs))
        _G_SEGMENTS.set(len(self._segment_seqs()))

    # -- write side ----------------------------------------------------------

    def append(self, rows: List[MetricRow]) -> int:
        """Append records (callers pass nondecreasing sec_ms); returns the
        bytes written.  Raises on I/O failure — the RECORDER owns the
        fail-open policy, the log itself stays honest."""
        written = 0
        with self._lock:
            for row in rows:
                if self._size >= self.max_segment_bytes:
                    self._rotate()
                rec = pack_record(row)
                if int(row.sec_ms) != self._last_idx_sec:
                    self._last_idx_sec = int(row.sec_ms)
                    self._idx_fh.write(_IDX.pack(int(row.sec_ms), self._size))
                    written += _IDX.size
                self._fh.write(rec)
                self._size += len(rec)
                written += len(rec)
            self._fh.flush()
            self._idx_fh.flush()
        return written

    def close(self) -> None:
        with self._lock:
            for fh in (self._fh, self._idx_fh):
                if fh is not None:
                    fh.close()
            self._fh = self._idx_fh = None

    # -- read side -----------------------------------------------------------

    def find(
        self,
        resource: Optional[str],
        start_ms: int,
        end_ms: int,
    ) -> List[MetricRow]:
        """Rows with start_ms <= sec_ms <= end_ms (all resources when
        ``resource`` is None), oldest first.  Seeks via the index — a
        query never scans records before its range."""
        out: List[MetricRow] = []
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._idx_fh.flush()
            seqs = self._segment_seqs()
        for seq in seqs:
            path, idx_path = _seg_paths(self.base_dir, seq)
            idx = _read_idx(idx_path)
            if idx and idx[-1][0] < start_ms:
                continue  # whole segment before the range
            if idx and idx[0][0] > end_ms:
                continue  # whole segment after the range
            offset = _seek_offset(idx, start_ms)
            # read only up to the first indexed second PAST the range —
            # a narrow query over a large segment stays proportional to
            # the range, not the file
            stop = next((off for sec, off in idx if sec > end_ms), None)
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    buf = (
                        f.read()
                        if stop is None
                        else f.read(max(0, stop - offset))
                    )
            except OSError:
                continue
            pos = 0
            while True:
                rec = unpack_record(buf, pos)
                if rec is None:
                    break
                row, pos = rec
                if row.sec_ms > end_ms:
                    break  # records are nondecreasing in sec within a segment
                if row.sec_ms >= start_ms and (
                    resource is None or row.resource == resource
                ):
                    out.append(row)
        return out

    def segments(self) -> List[str]:
        return [
            _seg_paths(self.base_dir, s)[0] for s in self._segment_seqs()
        ]

    # -- internals -----------------------------------------------------------

    def _segment_seqs(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.base_dir)
        except OSError:
            return out
        for fn in names:
            if fn.startswith("timeline_") and fn.endswith(".mlog"):
                try:
                    out.append(int(fn[len("timeline_") : -len(".mlog")]))
                except ValueError:
                    continue
        return sorted(out)

    def _open_segment(self, seq: int, recovered: bool = False) -> None:
        path, idx_path = _seg_paths(self.base_dir, seq)
        self._fh = open(path, "ab")
        self._idx_fh = open(idx_path, "ab")
        self._size = self._fh.tell()
        idx = _read_idx(idx_path) if recovered else []
        self._last_idx_sec = idx[-1][0] if idx else -1

    def _rotate(self) -> None:
        self._fh.close()
        self._idx_fh.close()
        self._seq += 1
        self._open_segment(self._seq)
        # retention: drop oldest segments beyond the cap
        seqs = self._segment_seqs()
        for old in seqs[: max(0, len(seqs) - self.max_segments)]:
            for p in _seg_paths(self.base_dir, old):
                try:
                    os.remove(p)
                except OSError:
                    pass
        _G_SEGMENTS.set(len(self._segment_seqs()))

    def _recover(self, seq: int) -> None:
        """Crash-safe reopen of the newest segment: walk its records,
        truncate a torn tail, and rewrite the index if any entry
        disagrees with the records it claims to point at."""
        path, idx_path = _seg_paths(self.base_dir, seq)
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except OSError:
            return
        good: List[tuple] = []  # rebuilt index
        pos = 0
        last_sec = -1
        while True:
            rec = unpack_record(buf, pos)
            if rec is None:
                break
            row, nxt = rec
            if row.sec_ms != last_sec:
                good.append((row.sec_ms, pos))
                last_sec = row.sec_ms
            pos = nxt
        if pos < len(buf):  # torn tail → truncate to the last whole record
            with open(path, "r+b") as f:
                f.truncate(pos)
        if _read_idx(idx_path) != good:  # drift → rebuild from records
            with open(idx_path, "wb") as f:
                for sec, off in good:
                    f.write(_IDX.pack(sec, off))


def _seek_offset(idx: List[tuple], start_ms: int) -> int:
    """Greatest indexed offset whose second <= start_ms (binary search)."""
    lo, hi, best = 0, len(idx) - 1, 0
    while lo <= hi:
        mid = (lo + hi) // 2
        if idx[mid][0] <= start_ms:
            best = idx[mid][1]
            lo = mid + 1
        else:
            hi = mid - 1
    return best


# -- the write-behind recorder -----------------------------------------------

#: live recorders by id — the local sources a fleet timeline merge reads
#: (obs/fleet.fleet_timeline)
_LIVE: Dict[int, "TimelineRecorder"] = {}
_LIVE_LOCK = threading.Lock()


def live_recorders() -> List["TimelineRecorder"]:
    with _LIVE_LOCK:
        return list(_LIVE.values())


class TimelineRecorder:
    """Folds per-tick device top-K matrices into exact per-second rows.

    The device emits the CURRENT window bucket's cumulative counts per
    hot resource; ``note_tick`` keeps the last read per (resource,
    bucket) and, once the engine clock leaves a second, combines that
    second's buckets into one ``MetricRow`` per resource — written
    behind the tick to the ``MetricLog`` (fail OPEN) and to a bounded
    in-memory ring that serves queries even without a disk log."""

    def __init__(
        self,
        resolve_name: Callable[[int], Optional[str]],
        window_ms: int,
        sample_count: int,
        log: Optional[MetricLog] = None,
        memory_s: int = 180,
        name: str = "",
    ):
        self._resolve_name = resolve_name
        self.window_ms = int(window_ms)
        self.sample_count = int(sample_count)
        self.log = log
        self.memory_s = int(memory_s)
        self.name = name
        self._lock = threading.Lock()
        #: wid -> {rid -> latest cumulative device row (np array copy)}
        self._buckets: Dict[int, Dict[int, object]] = {}
        #: flushed rows ring: sec_ms -> {resource -> MetricRow}
        self._mem: Dict[int, Dict[str, MetricRow]] = {}
        self._wall_off = 0
        with _LIVE_LOCK:
            _LIVE[id(self)] = self

    # -- hot path (resolver thread, once per tick) ---------------------------

    def note_tick(self, rs, now_ms: int, wall_offset_ms: int) -> None:
        """Fold one device matrix (float32 [K, TL_COLS], host-resident).

        ``wall_offset_ms`` maps engine ms to wall ms (TimeSource.wall_ms
        is engine + constant offset) so records carry queryable
        wall-clock second stamps."""
        wid = int(now_ms) // self.window_ms
        # active rows only: zero rows are padding or idle top-K slots
        act = rs[(rs[:, TL_PASS:TL_EXCEPTION + 1].sum(axis=1) > 0) | (rs[:, TL_CONC] > 0)]
        with self._lock:
            self._wall_off = int(wall_offset_ms)
            if len(act):
                b = self._buckets.setdefault(wid, {})
                for row in act:
                    b[int(row[TL_RID])] = row.copy()
            self._flush_locked(cur_wid=wid)

    # -- flush ---------------------------------------------------------------

    def _sec_of(self, wid: int) -> int:
        return ((wid * self.window_ms + self._wall_off) // 1000) * 1000

    def flush(self, force: bool = False) -> None:
        """Flush completed seconds; ``force`` also flushes the still-open
        current second (shutdown / test drains)."""
        with self._lock:
            self._flush_locked(cur_wid=None if force else max(self._buckets, default=None))

    def _combine(self, sec_ms: int, per_rid: Dict[int, dict]) -> List[MetricRow]:
        """One second's buckets → MetricRows: counts/rt_sum sum across the
        second's buckets, rt_min mins (sentinel-masked), concurrency is
        the latest bucket's gauge value."""
        rows: List[MetricRow] = []
        for rid, by_wid in per_rid.items():
            name = self._resolve_name(rid)
            if name is None:
                continue  # stale row beyond the registry (never for live traffic)
            p = b = s = e = conc = 0
            rts, rtm = 0.0, _RT_MIN_INIT
            for w in sorted(by_wid):
                r = by_wid[w]
                p += int(r[TL_PASS])
                b += int(r[TL_BLOCK])
                s += int(r[TL_SUCCESS])
                e += int(r[TL_EXCEPTION])
                rts += float(r[TL_RT_SUM])
                rtm = min(rtm, float(r[TL_RT_MIN]))
                conc = int(r[TL_CONC])  # gauge: latest bucket wins
            rows.append(
                MetricRow(
                    sec_ms, name, p, b, s, e, rts,
                    0.0 if rtm >= _RT_MIN_INIT else rtm, conc,
                )
            )
        rows.sort(key=lambda r: r.resource)
        return rows

    def _flush_locked(self, cur_wid: Optional[int]) -> None:
        cur_sec = None if cur_wid is None else self._sec_of(cur_wid)
        by_sec: Dict[int, Dict[int, dict]] = {}
        for w in sorted(self._buckets):
            s = self._sec_of(w)
            if cur_sec is not None and s >= cur_sec:
                continue  # the current second is still being written
            per_rid = by_sec.setdefault(s, {})
            for rid, row in self._buckets.pop(w).items():
                per_rid.setdefault(rid, {})[w] = row
        for s in sorted(by_sec):
            self._land(s, self._combine(s, by_sec[s]))

    def _land(self, sec_ms: int, rows: List[MetricRow]) -> None:
        if not rows:
            return
        _C_ROWS.inc(len(rows))
        mem = self._mem.setdefault(sec_ms, {})
        for r in rows:
            mem[r.resource] = r
        cutoff = sec_ms - self.memory_s * 1000
        for old in [t for t in self._mem if t < cutoff]:
            del self._mem[old]
        if self.log is not None:
            try:
                FP.hit(_FP_WRITE)  # chaos: a raise exercises fail OPEN
                _C_WIRE["tx"].inc(self.log.append(rows))
            except Exception:  # fail OPEN: rows drop from disk (kept in memory); decisions never ride on disk health
                _C_WRITE_FAIL.inc()

    # -- read side -----------------------------------------------------------

    def find(
        self,
        resource: Optional[str],
        start_ms: int,
        end_ms: int,
    ) -> List[MetricRow]:
        """Read-through query: disk rows (when a log is attached), memory
        ring fallback (disk-write failures / no log), plus a live
        snapshot of still-open buckets — so a query never waits for the
        next flush.  Keyed (sec, resource); disk wins over memory, open
        buckets cover seconds neither has."""
        merged: Dict[tuple, MetricRow] = {}
        with self._lock:
            for sec, by_res in self._mem.items():
                if start_ms <= sec <= end_ms:
                    for name, row in by_res.items():
                        if resource is None or name == resource:
                            merged[(sec, name)] = row
            pending = self._pending_snapshot_locked()
        if self.log is not None:
            for row in self.log.find(resource, start_ms, end_ms):
                merged[(row.sec_ms, row.resource)] = row
        for row in pending:
            if start_ms <= row.sec_ms <= end_ms and (
                resource is None or row.resource == resource
            ):
                key = (row.sec_ms, row.resource)
                if key not in merged:
                    merged[key] = row
        return [merged[k] for k in sorted(merged)]

    def _pending_snapshot_locked(self) -> List[MetricRow]:
        by_sec: Dict[int, Dict[int, dict]] = {}
        for w, per_rid in self._buckets.items():
            s = self._sec_of(w)
            slot = by_sec.setdefault(s, {})
            for rid, row in per_rid.items():
                slot.setdefault(rid, {})[w] = row
        out: List[MetricRow] = []
        for s in sorted(by_sec):
            out.extend(self._combine(s, by_sec[s]))
        return out

    # -- flight-recorder provider --------------------------------------------

    def flight_section(self, seconds: int = 30, max_resources: int = 16) -> dict:
        """The last ~``seconds`` of rows for the hottest resources — the
        ``timeline`` section of a flight bundle (obs/flight.py)."""
        with self._lock:
            secs = sorted(self._mem)
            pending = self._pending_snapshot_locked()
            recent: List[MetricRow] = []
            for sec in secs[-seconds:]:
                recent.extend(self._mem[sec].values())
        recent.extend(pending[-seconds * max_resources :])
        volume: Dict[str, float] = {}
        for r in recent:
            volume[r.resource] = volume.get(r.resource, 0.0) + r.pass_count + r.block_count
        keep = set(sorted(volume, key=lambda n: (-volume[n], n))[:max_resources])
        rows = [r.to_dict() for r in recent if r.resource in keep]
        rows.sort(key=lambda d: (d["ts"], d["resource"]))
        return {"window_s": seconds, "resources": sorted(keep), "rows": rows}

    def close(self) -> None:
        self.flush(force=True)
        with _LIVE_LOCK:
            _LIVE.pop(id(self), None)
        if self.log is not None:
            self.log.close()
