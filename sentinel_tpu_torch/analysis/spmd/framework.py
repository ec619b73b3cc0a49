"""SPMD-tier (tier-4) analysis framework — the port's copy.

The port of ``sentinel_tpu/analysis/spmd/framework.py``.  Tier 3 pins the
lock graph; this tier pins the SHARDED program: each real entry point run
on the blessed mesh (``parallel/meshspec.py``: ``n_devices`` gloo ranks)
with the shardings ``parallel/spmd.py`` declares.  The objects of study
are what sharding ADDS: the collectives the sharded path sends (all-reduce
/ all-gather, each with its per-tick bytes between ranks), the
implicit reshards (an all-gather that rebuilds a sharded array at full
size), and the per-shard byte footprint the declared specs imply.

Where the reference reads XLA's optimized HLO text (``parse_hlo_collectives``:
the partitioner placed the collectives), the port reads the ledger that
``parallel/collectives.py`` records while the entry points run — the port
places its collectives by hand, and every one of them goes through that
module, so the ledger is the whole inventory.  ``collectives_from_ledger``
takes the place of the HLO parser; it has no other counterpart.

Findings reuse the tier-1 :class:`Finding`/baseline machinery.  A recorded
collective carries its caller's ``file:line``, so its findings land on
the real source line (``# stlint: disable=`` comments apply);
program-level findings anchor on the entry's pseudo-path
``spmd://<entry-name>`` and config-level ones on
``spmd://config/<config-name>``.

Everything in this module is mesh-free and torch-free: the passes run in
the PARENT process over a plain-data report the ranks produce (worker.py
via runner.py), which keeps them unit-testable on synthetic fixtures and
leaves the parent with no process group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from sentinel_tpu_torch.analysis.framework import ERROR, Finding

#: directory of the golden file (collectives.json)
SPMD_DIR = os.path.dirname(os.path.abspath(__file__))
COLLECTIVES_PATH = os.path.join(SPMD_DIR, "collectives.json")

#: HLO-style dtype byte widths (the ledger spells dtypes as the
#: reference's HLO does: parallel/collectives.DTYPE_NAMES)
DTYPE_BYTES = {
    "pred": 1,
    "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

#: collective kinds the ledger records (parallel/collectives.py sends
#: only these; gloo takes them on CUDA tensors)
COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
)


@dataclass(frozen=True)
class Collective:
    """One collective the sharded path sent (a ledger record)."""

    kind: str  # e.g. "all-gather"
    dtype: str  # HLO-style dtype, e.g. "s32"
    shape: Tuple[int, ...]  # per-rank RESULT shape
    source: Optional[str] = None  # repo-relative path of the caller
    line: int = 0

    @property
    def nbytes(self) -> int:
        n = DTYPE_BYTES.get(self.dtype, 4)
        for d in self.shape:
            n *= d
        return n


@dataclass(frozen=True)
class ConstInfo:
    """One constant an entry carries on every rank (replicated by
    construction).  Eager PyTorch closes over no jaxpr consts; the port's
    are the tensors a call makes from host data (an upload each call, on
    the card), which the ranks record with the jaxpr tier's op recorder
    (``worker.rank_main``)."""

    dtype: str
    shape: Tuple[int, ...]
    nbytes: int


@dataclass(frozen=True)
class LeafPlacement:
    """One state leaf folded with its declared PartitionSpec
    (parallel/spmd.PartitionSpec)."""

    name: str  # pytree key path, e.g. ".win_sec.counts"
    dtype: str
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]  # mesh axis (or None) per dimension
    global_bytes: int
    shard_bytes: int  # projected per-device bytes under the spec

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.spec)


@dataclass
class ShardedEntry:
    """One sharded entry point as the ranks ran it: the unit the ledger
    passes run over."""

    name: str  # e.g. "tick/sketch-salsa"
    collectives: List[Collective] = field(default_factory=list)
    consts: List[ConstInfo] = field(default_factory=list)
    placements: List[LeafPlacement] = field(default_factory=list)

    @property
    def pseudo_path(self) -> str:
        return f"spmd://{self.name}"


@dataclass
class ConfigCase:
    """One blessed config's state leaves folded with the declared specs —
    enough for divisibility and byte math WITHOUT running anything."""

    name: str  # e.g. "bench/sketch-1m"
    placements: List[LeafPlacement] = field(default_factory=list)

    @property
    def pseudo_path(self) -> str:
        return f"spmd://config/{self.name}"

    @property
    def shard_bytes(self) -> int:
        return sum(p.shard_bytes for p in self.placements)


@dataclass
class SpmdProgram:
    """Everything the tier-4 passes consume, as plain data."""

    n_devices: int
    axis: str
    entries: List[ShardedEntry] = field(default_factory=list)
    configs: List[ConfigCase] = field(default_factory=list)
    #: name of the ConfigCase the HBM budgeter projects (the 1M-resource
    #: sketch tier); None disables the budget pass
    budget_config: Optional[str] = None
    capacity_bytes: int = 0
    golden: Optional[Dict[str, Any]] = None
    torch_version: str = ""
    #: non-None when the ranks failed — the ledger pass surfaces it
    #: loudly instead of reporting a silently-empty tier
    worker_error: Optional[str] = None

    def budget_case(self) -> Optional[ConfigCase]:
        for c in self.configs:
            if c.name == self.budget_config:
                return c
        return None


class SpmdPass:
    """One pass over the sharded program."""

    name: str = ""
    description: str = ""
    severity: str = ERROR

    def run(self, program: SpmdProgram) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(
        self,
        path: str,
        message: str,
        severity: Optional[str] = None,
        line: int = 1,
    ) -> Finding:
        return Finding(
            rule=self.name,
            path=path,
            line=line,
            col=0,
            message=message,
            severity=severity or self.severity,
        )


# -- the recorded ledger -----------------------------------------------------


def collectives_from_ledger(records: Iterable[Dict[str, Any]]) -> List[Collective]:
    """The report's ledger records (``parallel/collectives.Record`` as
    plain dicts) as :class:`Collective`s — what the reference's
    ``parse_hlo_collectives`` reads out of the optimized HLO."""
    return [
        Collective(
            kind=r["kind"],
            dtype=r["dtype"],
            shape=tuple(int(d) for d in r["shape"]),
            source=r.get("source"),
            line=int(r.get("line") or 0),
        )
        for r in records
    ]


def group_collectives(colls: Iterable[Collective]) -> List[Dict[str, Any]]:
    """Collectives grouped by (kind, dtype, shape) — the golden's unit.

    Source lines are deliberately NOT part of the key: they drift with
    every unrelated edit, while the (kind, shape, count) inventory only
    moves when the partitioned program really changes.
    """
    acc: Dict[Tuple[str, str, Tuple[int, ...]], Dict[str, Any]] = {}
    for c in colls:
        key = (c.kind, c.dtype, c.shape)
        g = acc.get(key)
        if g is None:
            acc[key] = {
                "kind": c.kind,
                "dtype": c.dtype,
                "shape": list(c.shape),
                "count": 1,
                "bytes_each": c.nbytes,
            }
        else:
            g["count"] += 1
    return sorted(
        acc.values(),
        key=lambda g: (g["kind"], g["dtype"], tuple(g["shape"])),
    )


def ledger_bytes(groups: Iterable[Dict[str, Any]]) -> int:
    """Per-tick bytes between ranks for a grouped inventory."""
    return sum(int(g["count"]) * int(g["bytes_each"]) for g in groups)
