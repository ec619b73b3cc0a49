"""sentinel_tpu_torch.analysis.jaxpr — the port's tier-2 analyzer.

It keeps the reference's path, its tier name (``jaxpr``) and its five
rule ids, but it reads the dispatched ATen stream, not a jaxpr: the
port's entry points run eagerly, each under a ``TorchDispatchMode`` that
records every ATen overload with its dtypes, shapes, devices and bytes
(``framework.py``), beside the port's kernel launch counters.  Five
passes read the recording:

* ``transfer-guard``        — no ``_local_scalar_dense``, device→host
  copy, or upload of host data the tick was not given, inside a tick;
* ``dtype-overflow``        — int32 clock lineage (seeded by a shadow run
  with the clock moved) must not be scaled or accumulated past wrap;
* ``const-hoist``           — no tensor read from outside the entry's call;
  no host constant of 256 KiB or more uploaded every call;
* ``recompile-fingerprint`` — golden hashes of each entry's op stream;
  silent program drift fails CI;
* ``flops-bytes-budget``    — ceilings on each entry's launches (ATen
  ops that launch work plus kernel launches) and bytes.

Programmatic surface::

    from sentinel_tpu_torch.analysis.jaxpr import run_jaxpr_analysis
    findings = run_jaxpr_analysis(device="cpu")    # default: cuda

Importing this package is cheap; entries are recorded on first use and
cached per process and device.  Each golden file holds two blocks: the
CPU's, which the tests and CI check, and the card's under ``"card"``,
which a run on the card checks (the kernel-bearing entries dispatch
another stream there).  ``update_fingerprints()`` and ``update_budgets()``
rewrite the CPU block, recorded on the CPU; with ``card=True`` the card's
block, recorded on cuda (``--update-fingerprints`` / ``--update-budgets``
on the CLI, with ``--device cpu`` for the first).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from sentinel_tpu_torch.analysis.framework import Finding
from sentinel_tpu_torch.analysis.jaxpr.framework import (  # noqa: F401
    BUDGETS_PATH,
    CARD_DEVICE,
    FINGERPRINTS_PATH,
    JaxprPass,
    TracedEntry,
    entry_signature,
    load_golden,
    run_jaxpr_passes,
    save_golden,
)


def jaxpr_passes():
    from sentinel_tpu_torch.analysis.jaxpr.passes import ALL_JAXPR_PASSES

    return ALL_JAXPR_PASSES


def run_jaxpr_analysis(
    passes: Optional[Sequence[JaxprPass]] = None,
    entries: Optional[Sequence[TracedEntry]] = None,
    device: str = "cuda",
) -> List[Finding]:
    """Record the canonical entry points on ``device`` (cached per process)
    and run the passes; returns findings (tier-1 ``# stlint:``
    suppressions on source-anchored findings already honored)."""
    from sentinel_tpu_torch.analysis import REPO_ROOT
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import trace_entries

    if entries is None:
        entries = trace_entries(device)
    if passes is None:
        passes = jaxpr_passes()
    return run_jaxpr_passes(entries, passes, REPO_ROOT)


def _write_block(path: str, card: bool, comment: str, block_entries: dict, **extra) -> None:
    """Write one block of a golden file and keep the other: the CPU block
    at the top level, the card's under ``"card"``."""
    import torch

    data = load_golden(path)
    block = dict(device=CARD_DEVICE if card else "cpu", torch_version=torch.__version__, entries=block_entries, **extra)
    if card:
        data["card"] = block
    else:
        data = dict(block, comment=comment, **({"card": data["card"]} if "card" in data else {}))
    save_golden(path, data)


def _recorded(card: bool):
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import trace_entries

    return trace_entries(CARD_DEVICE if card else "cpu")


def update_fingerprints(path: str = FINGERPRINTS_PATH, card: bool = False) -> int:
    """Regenerate the golden op-stream signatures: the CPU block, recorded
    on the CPU, or (``card``) the card's block, recorded on cuda.  The
    other block is kept.  Returns the entry count."""
    entries = _recorded(card)
    _write_block(
        path,
        card,
        "Golden op-stream signatures per entry point: the top level "
        "recorded on the CPU by `python -m sentinel_tpu_torch.analysis "
        "--update-fingerprints --device cpu`, 'card' on the card by the same "
        "verb without --device.  Commit ONLY when the dispatched-program "
        "change is the point of the change.",
        {e.name: entry_signature(e) for e in entries},
    )
    return len(entries)


def update_budgets(path: str = BUDGETS_PATH, card: bool = False) -> int:
    """Re-baseline the launch and byte ceilings at measured*(1+HEADROOM):
    the CPU block, recorded on the CPU, or (``card``) the card's block,
    recorded on cuda.  The other block is kept.  Returns the number of
    budgeted entries."""
    from sentinel_tpu_torch.analysis.jaxpr.passes.cost_budget import HEADROOM

    entries = _recorded(card)
    _write_block(
        path,
        card,
        "Launch and byte ceilings per entry point at measured*"
        f"{1 + HEADROOM:g}: the top level recorded on the CPU by "
        "`python -m sentinel_tpu_torch.analysis --update-budgets --device "
        "cpu`, 'card' on the card by the same verb without --device.  A "
        "change that breaches a ceiling either optimizes or re-baselines "
        "WITH a justification.",
        {
            e.name: {
                "launches": round(e.launches * (1 + HEADROOM)),
                "bytes": round(e.bytes * (1 + HEADROOM)),
                "measured_launches": e.launches,
                "measured_bytes": e.bytes,
            }
            for e in entries
        },
        headroom=HEADROOM,
    )
    return len(entries)
