"""Metrics registry: counters, gauges, power-of-two latency histograms.

The port's copy of ``sentinel_tpu/obs/registry.py``: the port keeps its
own process-global ``REGISTRY``, so its counters never mix with the JAX
package's.  The build-info gauge labels the port's version, torch's
version and the CUDA toolkit torch was built for, where the reference's
labels jax's.

The always-on quantitative side of the observability plane (the span
tracer in ``obs/trace.py`` is the qualitative side): SALSA's argument
(arxiv 2102.12531) applied host-side — self-adjusting-resolution
measurement must be cheap enough to leave on, so the histogram is a
fixed bucket array indexed by ``math.frexp`` (one C call, no log, no
per-sample allocation) and every metric is a tiny object with one lock.

Power-of-two buckets: bucket ``i`` counts samples in
``(start * 2**(i-1), start * 2**i]``; the default ``start_ms = 1/16``
spans 62.5 µs → ~4.4 min (top finite bound ``2**22/16`` ms ≈ 262 s,
then +Inf) in 23 buckets, ~2x relative error — the same log-bucket
resolution story as ``ops/rtq.py`` device-side.

Prometheus exposition follows the text format 0.0.4: cumulative
``_bucket{le=...}`` lines with a ``+Inf`` terminal, ``_sum``/``_count``,
``# HELP``/``# TYPE`` headers.  ``MetricRegistry.exposition()`` is what
the command center serves at ``GET /metrics``.
"""

from __future__ import annotations

import math
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

# -- value formatting --------------------------------------------------------


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as integers."""
    f = float(v)
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping (text format 0.0.4): backslash,
    double-quote, and newline — one bad value must not invalidate the
    whole exposition."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    """Common shell: name + frozen labels + a per-instance lock."""

    kind = "untyped"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    def samples(self) -> List[Tuple[str, str, float]]:
        """[(suffix, label-string, value)] — exposition building blocks."""
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic counter.  Name your counters ``*_total`` (convention)."""

    kind = "counter"

    def __init__(self, name: str, labels=()):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def samples(self):
        return [("", _fmt_labels(self.labels), self._value)]


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, labels=()):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)  # single store; atomic under the GIL

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def samples(self):
        return [("", _fmt_labels(self.labels), self._value)]


#: default latency grid: 62.5 µs .. ~4.4 min in 23 powers of two
DEFAULT_START_MS = 1.0 / 16.0
DEFAULT_BUCKETS = 23


class Histogram(_Metric):
    """Power-of-two-bucket histogram (numpy counts, no per-sample alloc).

    ``observe(v)`` indexes bucket ``ceil(log2(v / start))`` via
    ``math.frexp`` — one C call — and bumps an int64 slot under the
    instance lock.  The terminal slot is the ``+Inf`` overflow bucket.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels=(),
        start: float = DEFAULT_START_MS,
        buckets: int = DEFAULT_BUCKETS,
    ):
        super().__init__(name, labels)
        if start <= 0 or buckets < 1:
            raise ValueError("histogram needs start > 0 and buckets >= 1")
        self.start = float(start)
        self.n_buckets = int(buckets)
        # bounds[i] = start * 2**i; counts has one extra +Inf slot
        self.bounds = self.start * np.exp2(np.arange(self.n_buckets))
        self._counts = np.zeros(self.n_buckets + 1, np.int64)
        self._sum = 0.0
        self._count = 0
        # per-bucket last exemplar: bucket index -> (value, trace_id str).
        # Populated only when observe() is handed an exemplar (the obs
        # stage helpers pass the active tick trace id), so a bad quantile
        # links straight to its Perfetto span.
        self._exemplars: Dict[int, Tuple[float, str]] = {}

    def _index(self, v: float) -> int:
        if v <= self.start:
            return 0
        m, e = math.frexp(v / self.start)  # v/start = m * 2**e, m in [0.5, 1)
        i = e - 1 if m == 0.5 else e  # smallest i with v <= start * 2**i
        return i if i < self.n_buckets else self.n_buckets

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                self._exemplars[i] = (float(v), str(exemplar))

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's samples in (bench aggregation)."""
        if (other.start, other.n_buckets) != (self.start, self.n_buckets):
            raise ValueError("histogram grids differ; cannot merge")
        with self._lock:
            self._counts += other._counts
            self._sum += other._sum
            self._count += other._count

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def count_over(self, threshold: float) -> int:
        """Samples above ``threshold`` at bucket resolution: everything in
        buckets whose full range lies above the bucket holding the
        threshold (a slight undercount within one bucket, never an
        overcount) — the latency-SLO "bad events" read (obs/slo.py)."""
        i = self._index(threshold)
        with self._lock:
            return int(self._counts[i + 1 :].sum())

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th sample); 0.0 when empty, last finite bound for
        overflow samples."""
        with self._lock:
            counts = self._counts.copy()
            total = self._count
        if total == 0:
            return 0.0
        rank = max(1, math.ceil(q * total))
        cum = 0
        for i in range(self.n_buckets + 1):
            cum += int(counts[i])
            if cum >= rank:
                return float(self.bounds[min(i, self.n_buckets - 1)])
        return float(self.bounds[-1])

    def p99_exemplar(self) -> Optional[dict]:
        """The exemplar linking the p99 to its trace: the record stored in
        the bucket holding the 99th-percentile sample, else the highest
        recorded bucket below it, else the closest recorded bucket above
        it (exemplars are only stored for traced observations, so the
        exact bucket may have none).  None when no exemplar was ever
        recorded."""
        with self._lock:
            if not self._exemplars:
                return None
            counts = self._counts.copy()
            total = self._count
            ex = dict(self._exemplars)
        rank = max(1, math.ceil(0.99 * total))
        cum = 0
        p99_i = self.n_buckets
        for i in range(self.n_buckets + 1):
            cum += int(counts[i])
            if cum >= rank:
                p99_i = i
                break
        below = [i for i in ex if i <= p99_i]
        i = max(below) if below else min(ex)  # else: closest bucket above
        v, trace_id = ex[i]
        le = _fmt(self.bounds[i]) if i < self.n_buckets else "+Inf"
        return {"le": le, "value": v, "trace_id": trace_id}

    def samples(self):
        # snapshot under the lock so bucket/sum/count agree
        with self._lock:
            counts = self._counts.copy()
            s, c = self._sum, self._count
        out = []
        cum = 0
        for i in range(self.n_buckets):
            cum += int(counts[i])
            lab = self.labels + (("le", _fmt(self.bounds[i])),)
            out.append(("_bucket", _fmt_labels(lab), cum))
        lab = self.labels + (("le", "+Inf"),)
        out.append(("_bucket", _fmt_labels(lab), c))
        out.append(("_sum", _fmt_labels(self.labels), s))
        out.append(("_count", _fmt_labels(self.labels), c))
        return out


class MetricRegistry:
    """Name → metric map with get-or-create and Prometheus exposition.

    One metric NAME maps to one type and one help string; distinct label
    sets under a name are distinct series (the Prometheus model).  All
    registry mutations serialize on one lock; the metric objects
    themselves are handed out once and then mutated lock-free-read /
    per-instance-locked-write by the hot paths.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], _Metric] = {}
        self._help: Dict[str, str] = {}
        self._kind: Dict[str, str] = {}

    def _get_or_create(self, cls, name: str, help_: str, labels: dict, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                if name in self._kind and self._kind[name] != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{self._kind[name]}, not {cls.kind}"
                    )
                m = cls(name, key[1], **kw)
                self._metrics[key] = m
                self._kind.setdefault(name, cls.kind)
                if help_:
                    self._help.setdefault(name, help_)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} is a {m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "", labels: Optional[dict] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels or {})

    def gauge(self, name: str, help: str = "", labels: Optional[dict] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels or {})

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Optional[dict] = None,
        start: float = DEFAULT_START_MS,
        buckets: int = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels or {}, start=start, buckets=buckets
        )

    def get(self, name: str, labels: Optional[dict] = None) -> Optional[_Metric]:
        key = (name, tuple(sorted((labels or {}).items())))
        return self._metrics.get(key)

    def series(self, name: str) -> List[_Metric]:
        """Every live series (label set) under one metric name — the SLO
        engine's read surface (obs/slo.py sums label sets per family)."""
        with self._lock:
            return [m for (n, _), m in self._metrics.items() if n == name]

    def exposition(self) -> str:
        """Prometheus text format 0.0.4 over every registered metric."""
        with self._lock:
            items = sorted(self._metrics.items())
            helps = dict(self._help)
            kinds = dict(self._kind)
        lines: List[str] = []
        seen_header = set()
        for (name, _labels), m in items:
            if name not in seen_header:
                seen_header.add(name)
                h = helps.get(name, "")
                if h:
                    lines.append(f"# HELP {name} {h}")
                lines.append(f"# TYPE {name} {kinds.get(name, m.kind)}")
            for suffix, labstr, value in m.samples():
                lines.append(f"{name}{suffix}{labstr} {_fmt(value)}")
            if isinstance(m, Histogram):
                # exemplar comment (the 0.0.4 text format has no exemplar
                # syntax; OpenMetrics-style data rides a comment so plain
                # scrapers stay compatible): the p99 bucket's trace id,
                # the --postmortem / Perfetto jump-off point
                e = m.p99_exemplar()
                if e is not None:
                    lab = m.labels + (("le", e["le"]),)
                    lines.append(
                        f"# EXEMPLAR {name}_bucket{_fmt_labels(lab)} "
                        f"trace_id={e['trace_id']} value={_fmt(e['value'])}"
                    )
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> dict:
        """JSON-friendly dump (dashboard / tests): scalars by series."""
        out: dict = {}
        with self._lock:
            items = sorted(self._metrics.items())
        for (name, labels), m in items:
            key = name + _fmt_labels(labels)
            if isinstance(m, Histogram):
                out[key] = {
                    "count": m.count,
                    "sum": m.sum,
                    "p50": m.quantile(0.5),
                    "p99": m.quantile(0.99),
                }
                e = m.p99_exemplar()
                if e is not None:
                    out[key]["p99_exemplar"] = e
            else:
                out[key] = m.value
        return out


#: process-global default registry — the one ``GET /metrics`` serves
REGISTRY = MetricRegistry()


#: the one registered build-info series (module cache: labels freeze at
#: first registration, so a later call can never fork a second series)
_BUILD_INFO: Optional[Gauge] = None


def register_build_info(registry: Optional[MetricRegistry] = None) -> Gauge:
    """``sentinel_build_info`` — the Prometheus info-gauge idiom (value
    1, identity in the labels) so every scrape says WHAT it scraped: the
    port's version, torch's version, the CUDA toolkit torch was built for
    and python.  Versions come from ``sys.modules`` only (no import
    here); the default-registry labels freeze at the first call."""
    global _BUILD_INFO
    if registry is None and _BUILD_INFO is not None:
        return _BUILD_INFO
    st = sys.modules.get("sentinel_tpu_torch")
    th = sys.modules.get("torch")
    g = (registry or REGISTRY).gauge(
        "sentinel_build_info",
        "build/runtime identity (value is always 1; the labels carry it)",
        labels={
            "sentinel_version": getattr(st, "__version__", "unknown"),
            "torch_version": str(getattr(th, "__version__", "unloaded")),
            "cuda_version": str(getattr(getattr(th, "version", None), "cuda", None) or "none"),
            "python": ".".join(str(x) for x in sys.version_info[:3]),
        },
    )
    g.set(1)
    if registry is None:
        _BUILD_INFO = g
    return g


#: process-unique scrape identity (fleet aggregation dedupe): random so a
#: forked/restarted process never collides with its predecessor's id
_SCRAPE_ID_VALUE = os.urandom(8).hex()
_SCRAPE_ID: Optional[Gauge] = None


def register_scrape_id(registry: Optional[MetricRegistry] = None) -> Gauge:
    """``sentinel_scrape_id{id="<hex>"} 1`` — the info-gauge a fleet
    aggregator uses to recognize that two scrape targets answered from
    the SAME process and merge it exactly once."""
    global _SCRAPE_ID
    if registry is None and _SCRAPE_ID is not None:
        return _SCRAPE_ID
    g = (registry or REGISTRY).gauge(
        "sentinel_scrape_id",
        "process-unique scrape identity (value 1; the id label carries it)",
        labels={"id": _SCRAPE_ID_VALUE},
    )
    g.set(1)
    if registry is None:
        _SCRAPE_ID = g
    return g
