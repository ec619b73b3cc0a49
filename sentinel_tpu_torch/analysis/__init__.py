"""sentinel_tpu_torch.analysis — the port's static analyzers.

The port's copy of the parts of ``sentinel_tpu/analysis`` that read
Python source and so can be pointed at the port:

* ``framework`` and ``astutil`` — findings, parsed modules with their
  ``# stlint:`` suppressions, baselines, the report formats;
* ``concurrency/`` — the tier-3 concurrency analyzer: interprocedural
  lock summaries over ``sentinel_tpu_torch/`` feeding four passes
  (lock-order-cycle, lock-order-new-edge, blocking-under-lock,
  thread-lifecycle) against the port's own blessed graph
  (``concurrency/lock_order.json``), and the runtime lock witness
  (``concurrency/witness.py``) that the chaos plane's
  ``no-order-violations`` invariant reads;
* ``spmd/`` — the tier-4 SPMD analyzer: the sharded entry points
  (``parallel/spmd.py``) run on the blessed mesh in child processes,
  five passes (collective-ledger, implicit-reshard, replication-hazard,
  shard-divisibility, shard-hbm-budget) over the collectives they
  recorded (``parallel/collectives.py``) and the declared placements,
  against the port's own golden (``spmd/collectives.json``).

Still to come: the tier-1 AST passes with ``ALL_PASSES``,
``rule_catalog``, ``run_repo_analysis``, ``metrics_catalog.py``,
``baseline.json`` and the CLI (``python -m sentinel_tpu.analysis`` in the
reference); then the intent of the reference's jaxpr tier, which
analyzes JAX programs, so the port will carry its intent, not its code.

Programmatic surface::

    from sentinel_tpu_torch.analysis.concurrency import run_concurrency_analysis
    findings = run_concurrency_analysis()        # over sentinel_tpu_torch/
    from sentinel_tpu_torch.analysis.spmd import run_spmd_analysis
    findings = run_spmd_analysis()               # ranks on the card
"""

from __future__ import annotations

import os

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

#: repo root (the directory containing the sentinel_tpu_torch package)
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: the package the analyzers read by default
PACKAGE = "sentinel_tpu_torch"
