"""flops-bytes-budget: an entry's launches and bytes gated against goldens.

The port of ``sentinel_tpu/analysis/jaxpr/passes/cost_budget.py``, by
intent.  The reference gates XLA's ``cost_analysis`` flops and bytes.
The port's eager tick has no compiled cost model, and its main cost on
the card is its launch count (1,618–2,209 a tick at the serving widths,
PERF.md §5): so the budget is

* ``launches`` — the ATen ops that launch work (views and allocations
  excluded) plus the port's kernel launches (B1–B4);
* ``bytes`` — the tensor bytes those ATen ops read and write.

Ceilings live in ``sentinel_tpu_torch/analysis/jaxpr/budgets.json`` at
measured × (1 + ``HEADROOM``), in two blocks measured at the canonical
configs: the top level on the CPU, the ``"card"`` block on the card, by

    python -m sentinel_tpu_torch.analysis --update-budgets --device cpu
    python -m sentinel_tpu_torch.analysis --update-budgets   # on the card

Every entry is budgeted, the kernel-bearing ones too.  A run on the CPU
holds each entry to the CPU's ceilings.  A run on the card holds it to
both: a kernel replaces plain ops, so the CPU's count (plain versions)
bounds the card's, and the card's own ceilings pin the kernel path,
whose launches sit far under the CPU's (the kernels' own bytes are not
visible to the dispatcher).  A change that breaches a ceiling optimizes,
or re-baselines with the diff justified.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from sentinel_tpu_torch.analysis.framework import ERROR, Finding
from sentinel_tpu_torch.analysis.jaxpr.framework import (
    BUDGETS_PATH,
    JaxprPass,
    TracedEntry,
    golden_block,
    load_golden,
)

#: --update-budgets writes ceiling = measured * (1 + HEADROOM), the reference's
HEADROOM = 0.25

_METRICS = ("launches", "bytes")


class CostBudgetPass(JaxprPass):
    name = "flops-bytes-budget"
    description = "entry-point launches and bytes must stay under checked-in ceilings"
    severity = ERROR

    def __init__(self, budget_path: str = BUDGETS_PATH):
        self.budget_path = budget_path
        self._golden: Optional[Dict[str, Any]] = None

    def _load(self) -> Dict[str, Any]:
        if self._golden is None:
            self._golden = load_golden(self.budget_path)
        return self._golden

    def run(self, entry: TracedEntry) -> Iterable[Finding]:
        golden = self._load()
        blocks = [("the CPU", golden)]
        if entry.device != "cpu":
            blocks.append((f"the card ({entry.device})", golden_block(golden, entry.device)))
        cost = entry.cost
        for where, block in blocks:
            want = block.get("entries", {}).get(entry.name)
            if want is None:
                verb = "--update-budgets --device cpu" if block is golden else "--update-budgets on the card"
                yield self.finding(
                    entry,
                    f"no cost budget recorded on {where} checked in for this "
                    f"entry point — run `python -m sentinel_tpu_torch.analysis "
                    f"{verb}` and commit budgets.json",
                )
                continue
            for metric in _METRICS:
                ceiling = want.get(metric)
                got = cost[metric]
                if ceiling is not None and got > ceiling:
                    yield self.finding(
                        entry,
                        f"{metric} {got:,} on {entry.device} exceed the "
                        f"checked-in ceiling {ceiling:,} (recorded on {where} "
                        f"at measured+{HEADROOM:.0%} headroom) — this change "
                        "grows the entry's device work; optimize, or "
                        "re-baseline with --update-budgets and justify the diff",
                    )
