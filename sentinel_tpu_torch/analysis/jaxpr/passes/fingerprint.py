"""recompile-fingerprint: an entry's dispatched program must not change
silently.

The port of ``sentinel_tpu/analysis/jaxpr/passes/fingerprint.py``.
Golden signatures of each entry's recorded op stream
(``framework.entry_signature``: a hash of the ordered ATen overload names
with their operands' and results' dtypes and ranks, the op count, the
argument and output counts) are checked in at
``sentinel_tpu_torch/analysis/jaxpr/fingerprints.json``.  A change that
adds ops to the tick, flips a dtype, or reorders its work fails here,
at review time, instead of surfacing as a launch-count regression on the
card (the eager tick's launches are its main cost there).

The file holds two blocks.  The top level is recorded on the CPU, where
the plain versions of the kernels run, so its stream is the same on any
machine with the same torch: the tests and CI check it.  The ``"card"``
block is recorded on the card, where the kernel-bearing entries dispatch
another stream (the kernels replace plain ops): a run on the card checks
every entry against it.  When the program change is the point of the
change, regenerate with

    python -m sentinel_tpu_torch.analysis --update-fingerprints --device cpu
    python -m sentinel_tpu_torch.analysis --update-fingerprints   # on the card

and commit the diff.  Streams depend on torch's decompositions, so each
block records the ``torch.__version__`` it was made under, and a finding
names both versions when they differ.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from sentinel_tpu_torch.analysis.framework import ERROR, Finding
from sentinel_tpu_torch.analysis.jaxpr.framework import (
    FINGERPRINTS_PATH,
    JaxprPass,
    TracedEntry,
    entry_signature,
    golden_block,
    load_golden,
)


class FingerprintPass(JaxprPass):
    name = "recompile-fingerprint"
    description = "recorded op-stream signatures must match the checked-in goldens"
    severity = ERROR

    def __init__(self, golden_path: str = FINGERPRINTS_PATH):
        self.golden_path = golden_path
        self._golden: Optional[Dict[str, Any]] = None

    def _load(self) -> Dict[str, Any]:
        if self._golden is None:
            self._golden = load_golden(self.golden_path)
        return self._golden

    def run(self, entry: TracedEntry) -> Iterable[Finding]:
        import torch

        golden = golden_block(self._load(), entry.device)
        want = golden.get("entries", {}).get(entry.name)
        got = entry_signature(entry)
        if want is None:
            verb = "--update-fingerprints --device cpu" if entry.device == "cpu" else "--update-fingerprints on the card"
            yield self.finding(
                entry,
                f"no golden fingerprint checked in for this entry point on "
                f"{entry.device} — run `python -m sentinel_tpu_torch.analysis "
                f"{verb}` and commit fingerprints.json",
            )
            return
        if want.get("hash") == got["hash"]:
            return
        ver_note = ""
        golden_ver = golden.get("torch_version")
        if golden_ver and golden_ver != torch.__version__:
            ver_note = (
                f" (NOTE: the goldens were recorded under torch {golden_ver}, "
                f"this is torch {torch.__version__} — its decompositions may "
                "have moved; regenerate and review)"
            )
        yield self.finding(
            entry,
            f"dispatched program changed on {entry.device}: signature {want.get('hash')} -> "
            f"{got['hash']} ({want.get('ops')} -> {got['ops']} ops, "
            f"{want.get('args')} -> {got['args']} args){ver_note}.  If the "
            "change is intended, regenerate with --update-fingerprints and "
            "commit the diff; otherwise the change re-shapes the admission "
            "path unintentionally",
        )
