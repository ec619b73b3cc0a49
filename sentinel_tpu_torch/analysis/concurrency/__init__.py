"""sentinel_tpu_torch.analysis.concurrency — the tier-3 concurrency analyzer.

The port's copy of ``sentinel_tpu/analysis/concurrency``, pointed at
``sentinel_tpu_torch/``.  Tier 3 reasons about the package's threading
sites as ONE program: per-function lock summaries propagated
interprocedurally (``summaries.py``) feed four passes (``passes.py``):

* ``lock-order-cycle``    — the global held→acquired graph must be
  acyclic (a cycle is a deadlock between two threads taking the locks in
  opposite orders);
* ``lock-order-new-edge`` — the blessed acyclic graph is pinned as a
  golden (the port's own ``lock_order.json``); any NEW edge fails until
  reviewed and re-blessed with :func:`update_lock_order`;
* ``blocking-under-lock`` — no socket/RPC/Future.result/join/sleep/
  device-sync/unbounded-get while a lock is held, severity-ranked by
  admission/tick-path reachability (the port's device syncs:
  ``torch.cuda.synchronize``, a stream's or an event's ``synchronize``,
  a tensor's ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()``);
* ``thread-lifecycle``    — threads are daemon or provably joined;
  waits under a lock carry timeouts.

Lock names are package-relative, as the reference's are, so where the
port mirrors the reference's structure its lock names equal the
reference's (``cluster.client.ClusterTokenClient._lock``).

``witness.py`` is the empirical check on all of the above: opt-in
instrumented lock wrappers record the REAL acquisition order and fail on
any dynamic edge the static graph missed.

Programmatic surface::

    from sentinel_tpu_torch.analysis.concurrency import run_concurrency_analysis
    findings = run_concurrency_analysis()
    update_lock_order()          # re-bless lock_order.json after review
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Set

from sentinel_tpu_torch.analysis.framework import _SEV_ORDER, Finding
from sentinel_tpu_torch.analysis.concurrency.passes import (  # noqa: F401
    ALL_CONCURRENCY_PASSES,
    ConcurrencyPass,
    GRAPH_PATH,
    edge_str,
)
from sentinel_tpu_torch.analysis.concurrency.summaries import (  # noqa: F401
    SummaryDB,
    build_db,
    invalidate_cache,
    module_entry_locks,
)

LOCK_ORDER_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "lock_order.json"
)


def load_lock_order(path: str = LOCK_ORDER_PATH) -> Optional[Set[str]]:
    """The blessed edge set, or None when the golden file is absent
    (fixture runs pass golden_path=None instead; a MISSING repo golden is
    surfaced by the repo gate test, not silently ignored here)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return None
    return {str(e) for e in data.get("edges", [])}


def save_lock_order(edges: Sequence[str], path: str = LOCK_ORDER_PATH) -> None:
    data = {
        "comment": (
            "Blessed held->acquired lock-order edges (the acyclic global "
            "lock graph) of sentinel_tpu_torch.  Regenerate with "
            "sentinel_tpu_torch.analysis.concurrency.update_lock_order() and commit the diff ONLY after reviewing "
            "each new edge for ordering consistency — a new edge is a new "
            "ordering constraint every future acquisition must respect."
        ),
        "edges": sorted(set(edges)),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


def _default_roots() -> List[str]:
    from sentinel_tpu_torch.analysis import PACKAGE, REPO_ROOT

    return [os.path.join(REPO_ROOT, PACKAGE)]


def run_concurrency_analysis(
    roots: Optional[Sequence[str]] = None,
    passes: Optional[Sequence[ConcurrencyPass]] = None,
    golden_path: Optional[str] = LOCK_ORDER_PATH,
) -> List[Finding]:
    """Build (or reuse, per-process cache) the summary DB over ``roots``
    and run the tier-3 passes.  ``# stlint:`` suppressions on
    file-anchored findings are honored; graph-level findings on the
    ``concurrency://`` pseudo-path are managed through the golden, not
    comments."""
    from sentinel_tpu_torch.analysis import REPO_ROOT

    db = build_db(roots or _default_roots(), REPO_ROOT)
    golden = load_lock_order(golden_path) if golden_path else None
    findings: List[Finding] = []
    for p in passes if passes is not None else ALL_CONCURRENCY_PASSES:
        for f in p.run(db, golden):
            mod = db.modules.get(f.path)
            if mod is not None and mod.suppressed(f.rule, *f.span()):
                continue
            findings.append(f)
    findings.sort(
        key=lambda f: (_SEV_ORDER.get(f.severity, 9), f.path, f.line, f.rule)
    )
    return findings


def current_edges(roots: Optional[Sequence[str]] = None) -> List[str]:
    """The observed edge strings for the current tree (golden format)."""
    from sentinel_tpu_torch.analysis import REPO_ROOT

    db = build_db(roots or _default_roots(), REPO_ROOT)
    return sorted(edge_str(s, d) for (s, d) in db.lock_edges())


def update_lock_order(
    path: str = LOCK_ORDER_PATH, roots: Optional[Sequence[str]] = None
) -> int:
    """Regenerate the blessed graph from the current tree; returns the
    edge count.  Refuses nothing — cycle detection still runs on every
    analysis, so blessing a cyclic graph does not silence the cycle
    finding."""
    edges = current_edges(roots)
    save_lock_order(edges, path)
    return len(edges)
