"""Verdict provenance plane: decode + serve the wire's "explain" records.

The port's copy of ``sentinel_tpu/obs/explain.py``.  The packed readback
carries one 3-bit verdict code per row; for up to ``explain_k`` BLOCKED
rows of a tick the engine also packs a 4-word fixed-point record — rule
slot + verdict kind + sketch-tier flag, observed value vs threshold —
into a trailing, separately checksummed section of the same readback
(``ops/engine._device_explain`` encodes, ``ops/wire.py`` carries).  Here
we:

* validate + decode that section (``decode_section`` /
  ``decode_record``) behind the ``obs.explain.decode`` chaos failpoint —
  corruption drops the tick's explanations and bumps
  ``sentinel_explain_decode_failures_total``, but NEVER touches a
  verdict: fail-OPEN for the explanation only (the main wire section
  keeps its own checksum and still fails verdicts CLOSED);
* fold records into an :class:`ExplainPlane` — a bounded global ring
  plus per-resource rings — annotating sketch-tier records with an eps
  budget when one is supplied (a tail block whose margin is within eps
  is flagged ``possibly_false``: a CMS only ever OVERestimates);
* fold a cluster deny's provenance (``fold_remote``; a deny with none,
  from a pre-v3 peer, is ``count_unexplained``) — the client's cluster
  check lands remote blocks here like local ones;
* serve ``SentinelClient.explain(resource)``, ``explain_top_causes()``
  and ``explain_coverage()``.

It also keys the block log (``latest_rule``: the blamed rule slot of a
resource's newest record of one kind, metrics/block_log.py) and feeds the
flight recorder (``flight_section``, obs/flight.py).

Metrics (the port's own registry): ``sentinel_explain_records_total``,
``sentinel_explain_unexplained_total`` (blocked rows beyond the wire
section's explain_k capacity), ``sentinel_explain_decode_failures_total``
and ``sentinel_explain_possibly_false_total``.
"""

from __future__ import annotations

import threading
from collections import Counter, deque
from dataclasses import dataclass, replace
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.core.errors import (
    BLOCK_AUTHORITY,
    BLOCK_DEGRADE,
    BLOCK_FLOW,
    BLOCK_PARAM,
    BLOCK_SYSTEM,
)
from sentinel_tpu_torch.obs.registry import REGISTRY

#: verdict code -> short cause name (stable API: the block log, the CLI
#: and the dashboard all print these)
KIND_NAMES = {
    BLOCK_FLOW: "flow",
    BLOCK_DEGRADE: "degrade",
    BLOCK_PARAM: "param",
    BLOCK_SYSTEM: "system",
    BLOCK_AUTHORITY: "authority",
}

#: chaos site on the decode path — armed ``drop``/``corrupt``/
#: ``short_read`` prove explanation loss never alters a verdict
SITE_DECODE = FP.register(
    "obs.explain.decode",
    "explain-section decode of the fused readback (fail-open: "
    "provenance dropped, verdicts untouched)",
    kinds=FP.PIPE_ACTIONS,
)


class ExplainDecodeError(Exception):
    """The explain section failed validation (length or sec_sum).  The
    caller drops the tick's provenance and counts it — never the tick."""


#: fixed-point scale for observed/threshold words — canonical here and
#: shared with the device records (ops/engine._explain_fx): value x256,
#: 1/256 resolution
FX = 256.0
#: "unknown" sentinel word
FX_UNKNOWN = 0xFFFFFFFF
#: clamp ceiling — largest float32 below 2**32 (uint32-cast-safe on device)
FX_MAX = 4294967040.0


def fx_encode(v: Optional[float]) -> int:
    """Host-side value -> fixed-point word (None -> FX_UNKNOWN)."""
    if v is None:
        return FX_UNKNOWN
    x = float(v) * FX
    if x < 0.0:
        x = 0.0
    elif x > FX_MAX:
        x = FX_MAX
    return int(x)


def fx_decode(w: int) -> Optional[float]:
    """Fixed-point word -> value (FX_UNKNOWN -> None)."""
    w = int(w) & 0xFFFFFFFF
    return None if w == FX_UNKNOWN else w / FX


def _wire_consts():
    # lazy: keeps this module importable without torch until a wire
    # section is actually decoded
    from sentinel_tpu_torch.ops import wire as W

    return W.EXPLAIN_MAGIC, W.EXPLAIN_WORDS


@dataclass(frozen=True)
class ExplainRecord:
    """One decoded block explanation (host form of the 4-word record)."""

    resource: int  # device resource id (exact row or sketch id)
    kind: int  # verdict code (core/errors: 1..5)
    kind_name: str
    rule: Optional[int]  # blamed rule slot; None = not attributable
    sketch_tier: bool  # True = enforced from the SALSA estimate
    forced: bool  # host pre_verdict (e.g. a cluster token denial)
    observed: Optional[float]  # value the check read (1/256 resolution)
    threshold: Optional[float]  # limit it was checked against
    ts_ms: int = 0
    origin: str = "local"  # "local" | "cluster"
    name: str = ""  # resolved resource name ("" = unresolved)
    eps: Optional[float] = None  # audit eps budget at fold time
    possibly_false: bool = False  # sketch-tier margin within eps

    @property
    def margin(self) -> Optional[float]:
        """observed - threshold (how far past the limit), when known."""
        if self.observed is None or self.threshold is None:
            return None
        return self.observed - self.threshold

    def to_dict(self) -> dict:
        return {
            "resource": self.resource,
            "name": self.name,
            "kind": self.kind_name,
            "rule": self.rule,
            "sketch_tier": self.sketch_tier,
            "forced": self.forced,
            "observed": self.observed,
            "threshold": self.threshold,
            "margin": self.margin,
            "eps": self.eps,
            "possibly_false": self.possibly_false,
            "origin": self.origin,
            "ts_ms": self.ts_ms,
        }


def decode_section(words: np.ndarray) -> Tuple[int, np.ndarray]:
    """Validate the raw explain words ``[n_blocked, sec_sum, K*4 ...]``.

    The section bytes pass through the ``obs.explain.decode`` failpoint
    first, so the chaos matrix exercises exactly the real fault surface.
    Returns ``(n_blocked, records uint32 [K, 4])``; raises
    :class:`ExplainDecodeError` on any integrity failure."""
    magic, words_per = _wire_consts()
    raw = np.ascontiguousarray(words, dtype=np.uint32)
    data = FP.pipe(SITE_DECODE, raw.tobytes())
    if len(data) != raw.nbytes or len(data) < 8:
        raise ExplainDecodeError(
            f"explain section {len(data)} B != layout {raw.nbytes} B"
        )
    buf = np.frombuffer(data, dtype=np.uint32)
    n_blocked = int(buf[0])
    recs = buf[2:]
    expect = (
        magic + n_blocked + int(np.sum(recs, dtype=np.uint64))
    ) & 0xFFFFFFFF
    if int(buf[1]) != expect:
        raise ExplainDecodeError(
            f"explain sec_sum mismatch ({int(buf[1]):#x} != {expect:#x})"
        )
    return n_blocked, recs.reshape(-1, words_per)


def decode_record(row, ts_ms: int = 0, origin: str = "local") -> Optional[ExplainRecord]:
    """One wire record -> :class:`ExplainRecord`; None for a padding row
    or an undecodable kind (never raises — fail-open per record)."""
    w0, w1, w2, w3 = (int(x) for x in row)
    kind = w1 & 0x7
    if kind not in KIND_NAMES:
        return None
    slot_w = (w1 >> 16) & 0xFFFF
    return ExplainRecord(
        resource=w0,
        kind=kind,
        kind_name=KIND_NAMES[kind],
        rule=slot_w - 1 if slot_w else None,
        sketch_tier=bool(w1 & 0x8),
        forced=bool(w1 & 0x10),
        observed=fx_decode(w2),
        threshold=fx_decode(w3),
        ts_ms=int(ts_ms),
        origin=origin,
    )


#: cap on distinct (resource, kind, rule, origin) cause keys held for the
#: top-causes aggregation; pruned to the top half when exceeded
_CAUSE_CAP = 8192


class ExplainPlane:
    """Per-client provenance store: bounded rings + cause aggregation.

    Thread-safe (resolver thread folds, command/CLI threads read).  All
    annotation inputs are injected callables so the plane carries no
    client reference: ``eps_source`` returns the current audit eps budget
    (or None), ``name_source`` resolves a resource id to its name."""

    def __init__(
        self,
        registry=REGISTRY,
        ring: int = 512,
        per_resource: int = 16,
        eps_source: Optional[Callable[[], Optional[float]]] = None,
        name_source: Optional[Callable[[int], Optional[str]]] = None,
    ):
        self._lock = threading.Lock()
        self._ring: Deque[ExplainRecord] = deque(maxlen=ring)
        self._per_res: Dict[int, Deque[ExplainRecord]] = {}
        self._per_res_cap = per_resource
        self._causes: Counter = Counter()
        self._blocked_total = 0
        self._explained_total = 0
        self.eps_source = eps_source
        self.name_source = name_source
        self._c_records = registry.counter(
            "sentinel_explain_records_total",
            "block-provenance records folded into the explain plane",
        )
        self._c_unexplained = registry.counter(
            "sentinel_explain_unexplained_total",
            "blocked decisions with no provenance record (beyond the "
            "wire section's explain_k capacity, or decode-dropped)",
        )
        self._c_decode_fail = registry.counter(
            "sentinel_explain_decode_failures_total",
            "explain sections dropped on integrity failure (fail-open: "
            "verdicts unaffected)",
        )
        self._c_possibly_false = registry.counter(
            "sentinel_explain_possibly_false_total",
            "sketch-tier blocks whose margin is within the audit eps "
            "budget (candidate false blocks — CMS overestimate)",
        )

    # -- fold paths ----------------------------------------------------------

    def ingest_section(self, words, ts_ms: int = 0) -> int:
        """Fold one tick's raw explain words.  Returns records folded.
        NEVER raises: any decode failure drops the tick's provenance
        (counted) — the verdict path is not in this call's blast radius."""
        try:
            n_blocked, rows = decode_section(words)
        except ExplainDecodeError:
            self._c_decode_fail.inc()
            return 0
        except Exception:
            # an armed `raise` on the decode site lands here — same
            # fail-open contract as a mangled payload
            self._c_decode_fail.inc()
            return 0
        folded = 0
        for row in rows[: max(0, n_blocked)]:
            rec = decode_record(row, ts_ms=ts_ms)
            if rec is None:
                continue
            self.fold(rec)
            folded += 1
        with self._lock:
            self._blocked_total += max(n_blocked, folded)
            self._explained_total += folded
        if n_blocked > folded:
            self._c_unexplained.inc(n_blocked - folded)
        return folded

    def fold(self, rec: ExplainRecord) -> ExplainRecord:
        """Annotate (name, eps, possibly_false) and store one record."""
        if self.name_source is not None and not rec.name:
            try:
                nm = self.name_source(rec.resource)
            except Exception:
                nm = None
            if nm:
                rec = replace(rec, name=str(nm))
        if rec.sketch_tier and self.eps_source is not None:
            try:
                eps = self.eps_source()
            except Exception:
                eps = None
            if eps is not None:
                m = rec.margin
                rec = replace(
                    rec,
                    eps=float(eps),
                    possibly_false=(m is not None and m <= float(eps)),
                )
                if rec.possibly_false:
                    self._c_possibly_false.inc()
        self._c_records.inc()
        with self._lock:
            self._ring.append(rec)
            ring = self._per_res.get(rec.resource)
            if ring is None:
                ring = self._per_res[rec.resource] = deque(
                    maxlen=self._per_res_cap
                )
            ring.append(rec)
            self._causes[
                (rec.resource, rec.kind_name, rec.rule, rec.origin)
            ] += 1
            if len(self._causes) > _CAUSE_CAP:
                self._causes = Counter(
                    dict(self._causes.most_common(_CAUSE_CAP // 2))
                )
        return rec

    def fold_remote(
        self,
        resource: int,
        kind: int,
        rule: Optional[int],
        observed: Optional[float],
        threshold: Optional[float],
        origin: str = "cluster",
        ts_ms: int = 0,
    ) -> Optional[ExplainRecord]:
        """Fold a provenance tuple from a cluster deny frame (protocol v3
        _T_PROV block) — remote blocks explain themselves too."""
        if kind not in KIND_NAMES:
            return None
        rec = ExplainRecord(
            resource=int(resource),
            kind=int(kind),
            kind_name=KIND_NAMES[int(kind)],
            rule=rule,
            sketch_tier=False,
            forced=False,
            observed=observed,
            threshold=threshold,
            ts_ms=int(ts_ms),
            origin=origin,
        )
        rec = self.fold(rec)
        with self._lock:
            self._blocked_total += 1
            self._explained_total += 1
        return rec

    def count_unexplained(self, n: int = 1) -> None:
        """A blocked decision the plane has no record for (e.g. a remote
        deny from a pre-v3 peer)."""
        if n <= 0:
            return
        with self._lock:
            self._blocked_total += n
        self._c_unexplained.inc(n)

    # -- read paths ----------------------------------------------------------

    def explain(self, resource: int, limit: int = 0) -> List[ExplainRecord]:
        """Newest-first provenance ring for one resource id."""
        with self._lock:
            ring = self._per_res.get(int(resource))
            out = list(ring) if ring else []
        out.reverse()
        return out[:limit] if limit else out

    def latest_rule(self, resource: int, kind: int) -> Optional[int]:
        """Blamed rule slot of the newest record matching (resource, kind)
        — the block log's provenance key lookup."""
        with self._lock:
            ring = self._per_res.get(int(resource))
            recs = list(ring) if ring else []
        for rec in reversed(recs):
            if rec.kind == int(kind):
                return rec.rule
        return None

    def recent(self, limit: int = 0) -> List[ExplainRecord]:
        """Newest-first global ring."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        return out[:limit] if limit else out

    def top_causes(self, n: int = 10) -> List[dict]:
        """Most frequent (resource, kind, rule, origin) block causes."""
        with self._lock:
            items = self._causes.most_common(n)
        out = []
        for (res, kind_name, rule, origin), cnt in items:
            name = ""
            if self.name_source is not None:
                try:
                    name = str(self.name_source(res) or "")
                except Exception:
                    name = ""
            out.append(
                {
                    "resource": res,
                    "name": name,
                    "kind": kind_name,
                    "rule": rule,
                    "origin": origin,
                    "count": cnt,
                }
            )
        return out

    def coverage(self) -> dict:
        """How many blocked decisions the plane can explain."""
        with self._lock:
            b, e = self._blocked_total, self._explained_total
        return {
            "blocked": b,
            "explained": e,
            "frac": (e / b) if b else 1.0,
        }

    def flight_section(self) -> dict:
        """Flight-recorder provider payload: the last explanations and the
        cause leaderboard ride every black-box bundle."""
        return {
            "coverage": self.coverage(),
            "top_causes": self.top_causes(10),
            "recent": [r.to_dict() for r in self.recent(64)],
        }
