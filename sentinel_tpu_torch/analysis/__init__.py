"""sentinel_tpu_torch.analysis — the port's four-tier hazard analyzer.

The port of ``sentinel_tpu/analysis``, pointed at ``sentinel_tpu_torch/``
and with its own goldens and baseline:

* tier 1 (``passes/``): five AST passes over source files — fail-open,
  time-source and unguarded-global as the reference's (the hazards are
  language-neutral), host-sync (device syncs on the client's dispatch
  path) and jit-recompile (what makes ``ops/engine.make_tick``'s cache
  miss) by intent; ``metrics_catalog.py`` lints the registered metric
  names against the README's catalog;
* tier 2 (``jaxpr/``): five passes over the dispatched ATen stream of
  the 13 canonical entry points, each run eagerly under a
  ``TorchDispatchMode`` (transfer-guard, dtype-overflow, const-hoist,
  recompile-fingerprint, flops-bytes-budget) — the reference's tier name
  and rule ids, reading ATen where the reference reads a jaxpr;
* tier 3 (``concurrency/``): interprocedural lock summaries feeding four
  passes (lock-order-cycle, lock-order-new-edge, blocking-under-lock,
  thread-lifecycle) against the blessed graph
  (``concurrency/lock_order.json``), and the runtime lock witness
  (``concurrency/witness.py``) that the chaos plane reads;
* tier 4 (``spmd/``): the sharded entry points run on the blessed mesh in
  child processes, five passes (collective-ledger, implicit-reshard,
  replication-hazard, shard-divisibility, shard-hbm-budget) over the
  collectives they recorded and the declared placements, against
  ``spmd/collectives.json``.

Findings, ``# stlint:`` suppressions, the baseline and the report formats
are ``framework.py``'s.

Programmatic surface::

    from sentinel_tpu_torch.analysis import run_repo_analysis
    findings, new = run_repo_analysis()          # AST tier
    from sentinel_tpu_torch.analysis.jaxpr import run_jaxpr_analysis
    findings = run_jaxpr_analysis(device="cpu")  # jaxpr tier (default: cuda)
    from sentinel_tpu_torch.analysis.concurrency import run_concurrency_analysis
    findings = run_concurrency_analysis()        # concurrency tier
    from sentinel_tpu_torch.analysis.spmd import run_spmd_analysis
    findings = run_spmd_analysis(device="cpu")   # spmd tier (default: cuda)

CLI::

    python -m sentinel_tpu_torch.analysis --device cpu   # ALL tiers, exit 1 on new findings
    python -m sentinel_tpu_torch.analysis --tier ast --json
    python -m sentinel_tpu_torch.analysis --sarif --device cpu
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from sentinel_tpu_torch.analysis.framework import (  # noqa: F401
    ERROR,
    WARNING,
    Finding,
    ParsedModule,
    Pass,
    load_baseline,
    new_findings,
    run_passes,
    save_baseline,
)
from sentinel_tpu_torch.analysis.passes import ALL_PASSES  # noqa: F401

#: repo root (the directory containing the sentinel_tpu_torch package)
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: the package the analyzers read by default
PACKAGE = "sentinel_tpu_torch"

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json"
)


def rule_catalog() -> dict:
    """rule id -> one-line description, across ALL four tiers (importing
    the pass classes is cheap; recording, summary building and the ranks
    only happen when a tier runs)."""
    from sentinel_tpu_torch.analysis.concurrency.passes import ALL_CONCURRENCY_PASSES
    from sentinel_tpu_torch.analysis.jaxpr.passes import ALL_JAXPR_PASSES
    from sentinel_tpu_torch.analysis.spmd.passes import ALL_SPMD_PASSES

    return {
        p.name: p.description
        for p in tuple(ALL_PASSES)
        + tuple(ALL_JAXPR_PASSES)
        + tuple(ALL_CONCURRENCY_PASSES)
        + tuple(ALL_SPMD_PASSES)
    }


def run_repo_analysis(
    roots: Optional[Sequence[str]] = None,
    passes: Sequence[Pass] = ALL_PASSES,
    baseline_path: str = DEFAULT_BASELINE,
) -> Tuple[List[Finding], List[Finding]]:
    """(all findings, findings new vs the checked-in baseline)."""
    if roots is None:
        roots = [os.path.join(REPO_ROOT, PACKAGE)]
    findings = run_passes(roots, passes, rel_to=REPO_ROOT)
    base = load_baseline(baseline_path)
    return findings, new_findings(findings, base)
