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
  ``no-order-violations`` invariant reads.

This slice carries only what the concurrency tier and the witness need:
``REPO_ROOT`` and the framework's exports.  The tier-1 AST passes with
``ALL_PASSES``, ``rule_catalog``, ``run_repo_analysis`` and the CLI
(``python -m sentinel_tpu.analysis`` in the reference) come in a later
slice; the reference's jaxpr and spmd tiers analyze JAX programs, so
the port will carry their intent, not their code.

Programmatic surface::

    from sentinel_tpu_torch.analysis.concurrency import run_concurrency_analysis
    findings = run_concurrency_analysis()        # over sentinel_tpu_torch/
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
