"""host-sync: a device→host synchronization on the tick's dispatch path.

The port of ``sentinel_tpu/analysis/passes/host_sync.py``, by intent.
The reference flags ``jax.device_get``, ``np.asarray`` and
``block_until_ready`` inside ``jax.jit`` zones and the client's dispatch
roots.  The port has no jit zone: its tick runs eagerly, and every
launch it queues is asynchronous until something on the host waits for
the card.  So the hazard lives where the host dispatches: one stray
``.item()`` on the client's tick path turns the queued tick into a
blocking round trip per call and caps the tick rate at the card's
latency.

Zone: the client's dispatch roots (``_tick_loop``, ``tick_once``,
``_tick_once_locked``, ``_run_tick``) and the token service's
(``_tick_loop``, ``_drain``), with their same-module callees.

Flagged there — the device syncs the tier-3 analyzer classifies
(``concurrency/summaries._device_sync``): ``.synchronize()`` and the
readbacks ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()``
called without a positional argument; plus, as in the reference,
``np.asarray`` / ``np.array`` of an attribute chain (a tick output or
engine state read back).  Plain host numpy over a bare local — batch
assembly — is the design and stays legal.

``_resolve_tick`` (with ``_resolve_tick_inner``) is the single readback
point, as in the reference: the zone stops there.  A new readback
elsewhere moves into it or carries a ``# stlint: disable=host-sync``
rationale.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Set

from sentinel_tpu_torch.analysis import astutil as A
from sentinel_tpu_torch.analysis.concurrency.summaries import _device_sync
from sentinel_tpu_torch.analysis.framework import ERROR, Finding, ParsedModule, Pass

#: file-glob -> host-side dispatch roots (same-module closure)
HOST_ROOTS = {
    "*sentinel_tpu_torch/runtime/client.py": (
        "_tick_loop",
        "tick_once",
        "_tick_once_locked",
        "_run_tick",
    ),
    "*sentinel_tpu_torch/cluster/token_service.py": ("_tick_loop", "_drain"),
}

#: the designed readback point: never in the zone, and the closure stops there
READBACK_POINTS = frozenset({"_resolve_tick", "_resolve_tick_inner"})

_MATERIALIZE = {"numpy.asarray", "numpy.array"}


def _zone(tree: ast.Module, roots: Set[str]) -> Dict[str, ast.AST]:
    """Same-module closure from ``roots`` that does not enter the
    readback points."""
    defs = A.func_defs(tree)
    seen: Set[str] = set()
    frontier = [r for r in roots if r in defs]
    while frontier:
        name = frontier.pop()
        if name in seen or name in READBACK_POINTS:
            continue
        seen.add(name)
        frontier.extend(c for c in A.called_names(defs[name]) if c in defs and c not in seen)
    return {n: defs[n] for n in seen}


class HostSyncPass(Pass):
    name = "host-sync"
    description = "no device→host sync on the tick's dispatch path"
    severity = ERROR

    def run(self, mod: ParsedModule) -> Iterable[Finding]:
        roots: Set[str] = set()
        for glob, names in HOST_ROOTS.items():
            if A.path_matches(mod.path, (glob,)):
                roots |= set(names)
        if not roots:
            return
        aliases = A.import_aliases(mod.tree)
        emitted: Set[tuple] = set()
        for fname, fn in sorted(_zone(mod.tree, roots).items()):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or (node.lineno, node.col_offset) in emitted:
                    continue
                what = _device_sync(node, A.dotted_name(node.func) or "")
                if what is None:
                    name = A.resolve_call(node, aliases)
                    if name in _MATERIALIZE and node.args and isinstance(node.args[0], ast.Attribute):
                        what = name
                if what is None:
                    continue
                emitted.add((node.lineno, node.col_offset))
                yield self.finding(
                    mod,
                    node,
                    f"{what}() on the tick's dispatch path '{fname}' waits "
                    "for the card — every launch queued before it must "
                    "finish; move it to the readback point (_resolve_tick) "
                    "or suppress with a rationale",
                )
