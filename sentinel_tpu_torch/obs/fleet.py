"""Fleet-scale metric aggregation: scrape every fleet member's
``/metrics`` and merge them into ONE Prometheus exposition.

The token fleet (N token-server shards + the Envoy RLS front door + any
number of engine hosts) is observable only one process at a time: each
command center serves its own registry.  This module closes that gap
host-side, with zero new wire cost for the members — they keep serving
the exposition they already serve:

* ``parse_exposition`` reads Prometheus text format 0.0.4 back into a
  structured scrape (families, counter/gauge samples, histograms with
  their cumulative buckets, and the ``sentinel_scrape_id`` identity);
* ``merge_scrapes`` folds scrapes together: counters SUM, histograms
  merge bucket-wise (every sentinel histogram shares the power-of-two
  grid, so cumulative buckets add per ``le``), gauges take the MAX (the
  conservative fleet view for occupancy/utilization-style values), and
  scrapes carrying an already-seen ``sentinel_scrape_id`` are dropped —
  the scraping process's own command center listed as a fleet member
  must not double-count;
* ``fleet_exposition`` = local registry + every configured target
  (``add_fleet_target`` / ``SENTINEL_FLEET_TARGETS``), plus fleet meta
  series (member/error/duplicate counts) and the live ``/api/shards``
  topology (``cluster.shard.describe_fleets``) rendered as
  ``sentinel_fleet_shard_info`` info-gauges.

The port's copy of ``sentinel_tpu/obs/fleet.py`` over the port's own
``REGISTRY``.  The shard topology lines wait for the sharded token client
(``cluster/shard.py``, ROADMAP.md Queue A item A7b): until it is ported,
``_shard_topology_lines`` returns none.

Surface: ``GET /metrics?fleet=1`` on any command center
(transport/handlers.py); the one-shot CLI scrape comes with the port's
``obs/__main__.py`` (ROADMAP.md item A10).  Per-shard label sets
(``sentinel_shard_*{shard=...}``) survive the merge untouched — merging
is by full (name, labels) series key.
"""

from __future__ import annotations

import os
import re
import threading
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from sentinel_tpu_torch.obs.registry import (
    REGISTRY,
    _fmt,
    _fmt_labels,
    register_scrape_id,
)

#: series key: (metric name, sorted ((label, value), ...) WITHOUT ``le``)
SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    """Single-pass label-value unescape (\\n, \\", \\\\).  Sequential
    str.replace would corrupt a literal backslash followed by 'n'
    ('a\\\\nb' on the wire means backslash+n, not newline)."""
    out = []
    i = 0
    n = len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n:
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


@dataclass
class Scrape:
    """One parsed exposition."""

    kinds: Dict[str, str] = field(default_factory=dict)  # family -> kind
    helps: Dict[str, str] = field(default_factory=dict)
    scalars: Dict[SeriesKey, float] = field(default_factory=dict)
    #: histogram series -> {"buckets": {le_str: cum}, "sum": x, "count": n}
    hists: Dict[SeriesKey, dict] = field(default_factory=dict)
    scrape_id: Optional[str] = None


def _hist_base(sample_name: str, hist_families) -> Optional[Tuple[str, str]]:
    """(family, part) when this sample belongs to a histogram family."""
    for suffix, part in (("_bucket", "bucket"), ("_sum", "sum"), ("_count", "count")):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in hist_families:
                return base, part
    return None


def parse_exposition(text: str) -> Scrape:
    """Prometheus text format 0.0.4 -> ``Scrape``.  Tolerant: comment
    lines other than HELP/TYPE (e.g. ``# EXEMPLAR``) and malformed lines
    are skipped, never fatal — one odd member must not break the fleet
    view."""
    s = Scrape()
    lines = text.splitlines()
    for line in lines:  # pass 1: family headers
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) >= 4:
                s.kinds[parts[2]] = parts[3].strip()
        elif line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 4:
                s.helps[parts[2]] = parts[3]
    hist_families = {n for n, k in s.kinds.items() if k == "histogram"}
    for line in lines:  # pass 2: samples
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line.strip())
        if not m:
            continue
        name, _, labstr, val = m.groups()
        try:
            value = float(val)
        except ValueError:
            continue
        labels = tuple(
            sorted(
                (k, _unescape(v)) for k, v in _LABEL_RE.findall(labstr or "")
            )
        )
        hb = _hist_base(name, hist_families)
        if hb is not None:
            base, part = hb
            le = dict(labels).get("le")
            key = (base, tuple(kv for kv in labels if kv[0] != "le"))
            h = s.hists.setdefault(
                key, {"buckets": {}, "sum": 0.0, "count": 0.0}
            )
            if part == "bucket" and le is not None:
                h["buckets"][le] = value
            elif part in ("sum", "count"):
                h[part] = value
            continue
        if name == "sentinel_scrape_id":
            s.scrape_id = dict(labels).get("id")
        s.scalars[(name, labels)] = value
    return s


@dataclass
class Merged:
    """Fold of N deduplicated scrapes (see ``merge_scrapes``)."""

    scrape: Scrape = field(default_factory=Scrape)
    members: int = 0  # distinct processes merged
    duplicates: int = 0  # scrapes dropped by scrape-id dedupe
    skipped_series: int = 0  # histogram series with incompatible grids


def merge_scrapes(scrapes: List[Scrape]) -> Merged:
    """Merge with scrape-id dedupe.  Counter series sum, gauges take the
    max, histogram buckets/sum/count add per ``le`` (identical bucket
    grids required — all sentinel histograms share the default
    power-of-two grid; a mismatched series is kept from the first scrape
    and counted in ``skipped_series``).  The per-process identity series
    (``sentinel_scrape_id``) is consumed by the dedupe and dropped from
    the merged output."""
    out = Merged()
    seen_ids = set()
    for s in scrapes:
        if s.scrape_id is not None:
            if s.scrape_id in seen_ids:
                out.duplicates += 1
                continue
            seen_ids.add(s.scrape_id)
        out.members += 1
        m = out.scrape
        for name, kind in s.kinds.items():
            m.kinds.setdefault(name, kind)
        for name, h in s.helps.items():
            m.helps.setdefault(name, h)
        for key, value in s.scalars.items():
            name = key[0]
            if name == "sentinel_scrape_id":
                continue
            if key not in m.scalars:
                m.scalars[key] = value
            elif m.kinds.get(name) == "counter":
                m.scalars[key] += value
            else:  # gauge / untyped: conservative fleet view
                m.scalars[key] = max(m.scalars[key], value)
        for key, h in s.hists.items():
            cur = m.hists.get(key)
            if cur is None:
                m.hists[key] = {
                    "buckets": dict(h["buckets"]),
                    "sum": h["sum"],
                    "count": h["count"],
                }
            elif set(cur["buckets"]) == set(h["buckets"]):
                for le, v in h["buckets"].items():
                    cur["buckets"][le] += v
                cur["sum"] += h["sum"]
                cur["count"] += h["count"]
            else:
                out.skipped_series += 1
    return out


def _le_sort_key(le: str):
    return (1, 0.0) if le == "+Inf" else (0, float(le))


def render_exposition(merged: Merged) -> str:
    """Merged scrape -> Prometheus text format 0.0.4 (passes the same
    line grammar the per-process exposition is tested against)."""
    s = merged.scrape
    # only families with samples: the scrape-id family (consumed by the
    # dedupe) and any header-only stragglers would render dangling
    # HELP/TYPE lines
    names = sorted({k[0] for k in s.scalars} | {k[0] for k in s.hists})
    lines: List[str] = []
    for name in names:
        h = s.helps.get(name, "")
        if h:
            lines.append(f"# HELP {name} {h}")
        lines.append(f"# TYPE {name} {s.kinds.get(name, 'untyped')}")
        for (n, labels), value in sorted(s.scalars.items()):
            if n == name:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt(value)}")
        for (n, labels), hist in sorted(s.hists.items()):
            if n != name:
                continue
            for le in sorted(hist["buckets"], key=_le_sort_key):
                lab = labels + (("le", le),)
                lines.append(
                    f"{name}_bucket{_fmt_labels(lab)} "
                    f"{_fmt(hist['buckets'][le])}"
                )
            lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt(hist['sum'])}")
            lines.append(
                f"{name}_count{_fmt_labels(labels)} {_fmt(hist['count'])}"
            )
    return "\n".join(lines) + "\n" if lines else ""


# -- per-resource timeline merge (obs/timeline.py rows) ----------------------

#: timeline row keys that SUM across sources (counts + RT total)
_TL_SUM_KEYS = ("pass", "block", "success", "exception", "rt_sum", "concurrency")


def merge_timelines(per_source: Dict[str, List[dict]]) -> List[dict]:
    """Fold per-source ``/api/metric`` rows into ONE fleet timeline.

    Sources (shards / machines) are aligned on second boundaries and
    summed per (resource, second): counts, rt_sum and concurrency add,
    ``rt_min`` takes the smallest nonzero minimum (0 = that source saw no
    completions).  Every merged row keeps per-source provenance:
    ``row["sources"]`` maps source name → that source's pass+block volume
    for the second, so a fleet spike attributes to the shard that served
    it."""
    merged: Dict[tuple, dict] = {}
    for source, rows in sorted(per_source.items()):
        for r in rows:
            key = (int(r.get("ts", 0)), str(r.get("resource", "")))
            vol = float(r.get("pass", 0)) + float(r.get("block", 0))
            cur = merged.get(key)
            if cur is None:
                cur = merged[key] = {
                    "ts": key[0],
                    "resource": key[1],
                    **{k: r.get(k, 0) for k in _TL_SUM_KEYS},
                    "rt_min": r.get("rt_min", 0.0),
                    "sources": {},
                }
            else:
                for k in _TL_SUM_KEYS:
                    cur[k] += r.get(k, 0)
                a, b = cur["rt_min"], r.get("rt_min", 0.0)
                cur["rt_min"] = min(a or b, b or a)
            cur["sources"][source] = round(
                cur["sources"].get(source, 0.0) + vol, 3
            )
    return [merged[k] for k in sorted(merged)]


def _timeline_url(target: str, resource, start_ms: int, end_ms: int) -> str:
    base = target if target.startswith(("http://", "https://")) else f"http://{target}"
    base = base.rstrip("/")
    if base.endswith("/metrics"):
        base = base[: -len("/metrics")]
    qs = f"start={start_ms}&end={end_ms}"
    if resource:
        import urllib.parse as _up

        qs += f"&resource={_up.quote(str(resource), safe='')}"
    return f"{base}/api/metric?{qs}"


def fleet_timeline(
    resource: Optional[str] = None,
    start_ms: int = 0,
    end_ms: int = 2**62,
    targets: Optional[List[str]] = None,
    fetch: Optional[Callable[[str], str]] = None,
    include_local: bool = True,
) -> List[dict]:
    """One merged per-resource timeline for the whole fleet: every live
    local recorder (``obs.timeline.live_recorders``) plus each target's
    ``GET /api/metric``.  Scrape failures degrade to a counted gap
    (source absent from provenance), like ``fleet_exposition``."""
    import json as _json

    per_source: Dict[str, List[dict]] = {}
    if include_local:
        from sentinel_tpu_torch.obs.timeline import live_recorders

        for i, rec in enumerate(live_recorders()):
            rows = rec.find(resource, start_ms, end_ms)
            if rows:
                # recorders may share an app name (one process, several
                # clients): suffix collisions so no source's rows are
                # silently replaced instead of merged
                name = base = f"local/{rec.name or i}"
                n = 1
                while name in per_source:
                    n += 1
                    name = f"{base}#{n}"
                per_source[name] = [r.to_dict() for r in rows]
    local_keys = list(per_source)
    for t in targets if targets is not None else fleet_targets():
        url = _timeline_url(t, resource, start_ms, end_ms)
        try:
            raw = (fetch or _http_fetch)(url)
            rows = _json.loads(raw)
        except Exception:  # stlint: disable=fail-open — a dead member leaves a counted gap in the fleet timeline, never an error page
            continue
        if isinstance(rows, list) and rows:
            # self-scrape dedupe (the fleet_exposition scrape-id analog —
            # timeline rows carry no process identity, so compare the
            # rows themselves): a target whose row list is identical to a
            # LOCAL source's is this process listed as its own member and
            # must not double-count.  Target-vs-target is never deduped.
            if any(rows == per_source[k] for k in local_keys):
                continue
            per_source[t] = rows
    return merge_timelines(per_source)


# -- fleet targets -----------------------------------------------------------

_TARGETS: List[str] = []
_TARGETS_LOCK = threading.Lock()


def add_fleet_target(target: str) -> None:
    """Register a peer command center (``host:port`` or full URL) for
    fleet scrapes; idempotent."""
    with _TARGETS_LOCK:
        if target not in _TARGETS:
            _TARGETS.append(target)


def set_fleet_targets(targets: List[str]) -> None:
    with _TARGETS_LOCK:
        _TARGETS[:] = list(targets)


def fleet_targets() -> List[str]:
    """Configured targets: explicit registrations plus the
    ``SENTINEL_FLEET_TARGETS`` comma-separated env list."""
    with _TARGETS_LOCK:
        out = list(_TARGETS)
    env = os.environ.get("SENTINEL_FLEET_TARGETS", "")
    for t in env.split(","):
        t = t.strip()
        if t and t not in out:
            out.append(t)
    return out


def _normalize_url(target: str) -> str:
    if target.startswith(("http://", "https://")):
        url = target
    else:
        url = f"http://{target}"
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    return url


def _http_fetch(url: str, timeout_s: float = 2.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as r:  # noqa: S310 — operator-configured peer scrape
        return r.read().decode("utf-8", "replace")


def _shard_topology_lines() -> List[str]:
    """The live ``/api/shards`` view as ``sentinel_fleet_shard_info``
    info-gauge series.  The port has no sharded token client yet
    (``cluster/shard.describe_fleets``, ROADMAP.md item A7b, wires it), so
    there is no fleet to describe and no line to render."""
    return []


def fleet_exposition(
    targets: Optional[List[str]] = None,
    fetch: Optional[Callable[[str], str]] = None,
    include_local: bool = True,
    registry=None,
) -> str:
    """One merged exposition for the whole fleet: the local registry plus
    every target's ``/metrics`` (see module docstring for the merge
    semantics).  Scrape failures degrade to a counted gap — the local
    view always renders."""
    texts: List[str] = []
    errors = 0
    if include_local:
        register_scrape_id()  # identity present even on bare registries
        texts.append((registry or REGISTRY).exposition())
    for t in targets if targets is not None else fleet_targets():
        try:
            texts.append((fetch or _http_fetch)(_normalize_url(t)))
        except Exception:  # stlint: disable=fail-open — a dead member leaves a counted gap in the fleet view, never an error page
            errors += 1
    merged = merge_scrapes([parse_exposition(t) for t in texts])
    lines = [render_exposition(merged).rstrip("\n")] if texts else []
    lines.append("# HELP sentinel_fleet_members processes merged into this exposition")
    lines.append("# TYPE sentinel_fleet_members gauge")
    lines.append(f"sentinel_fleet_members {merged.members}")
    lines.append("# HELP sentinel_fleet_scrape_errors fleet targets that failed to scrape")
    lines.append("# TYPE sentinel_fleet_scrape_errors gauge")
    lines.append(f"sentinel_fleet_scrape_errors {errors}")
    lines.append(
        "# HELP sentinel_fleet_scrape_duplicates scrapes dropped as same-process duplicates"
    )
    lines.append("# TYPE sentinel_fleet_scrape_duplicates gauge")
    lines.append(f"sentinel_fleet_scrape_duplicates {merged.duplicates}")
    lines.extend(_shard_topology_lines())
    return "\n".join(l for l in lines if l) + "\n"
