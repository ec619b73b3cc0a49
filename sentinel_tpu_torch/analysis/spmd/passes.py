"""The five tier-4 SPMD passes — the port's copy.

The port of ``sentinel_tpu/analysis/spmd/passes.py``.  All run in the
PARENT over plain data (framework.SpmdProgram): the ledger the ranks
recorded (worker.py) plus the placements folded from leaf shapes on the
meta device — no pass touches a device, so fixtures in tests can
synthesize programs freely.
"""

from __future__ import annotations

from typing import Iterable, List

from sentinel_tpu_torch.analysis.framework import ERROR, Finding
from sentinel_tpu_torch.analysis.spmd.framework import (
    SpmdPass,
    SpmdProgram,
    group_collectives,
    ledger_bytes,
)

#: collective-ledger headroom: current bytes/tick may exceed the golden's
#: pinned total by this fraction before the regression is an ERROR
#: (counts and kinds are exact — only byte totals get slack)
LEDGER_TOLERANCE = 0.25

#: implicit-reshard: an all-gather whose result equals a sharded leaf's
#: GLOBAL size is a full re-materialization; ignore matches below this
#: (tiny tables can collide with batch-sized gathers by accident)
RESHARD_MATCH_MIN_BYTES = 1 << 10
#: ...and any all-gather at least this large is flagged even unmatched
RESHARD_BIG_BYTES = 1 << 16

#: replication-hazard thresholds: closed-over consts ride every rank
#: replicated (checked at analyzer scale; the port records none, see
#: ReplicationHazardPass), state leaves are checked at the blessed
#: configs' REAL scale (the 1M sketch tier), where a mis-replicated SALSA
#: plane or window table is tens of MiB per device
REPLICATION_CONST_MAX_BYTES = 1 << 18
REPLICATION_LEAF_MAX_BYTES = 1 << 23


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 30:
        return f"{n / (1 << 30):.2f} GiB"
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f} MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f} KiB"
    return f"{n} B"


class CollectiveLedgerPass(SpmdPass):
    """Golden-pinned inventory of the collectives the sharded path sends
    per tick (the recorded ledger; the reference pins what XLA placed)."""

    name = "collective-ledger"
    description = (
        "recorded collectives of the sharded entry points (kind/dtype/"
        "shape/count and bytes between ranks per tick) must match the "
        "golden pinned in analysis/spmd/collectives.json — a NEW collective "
        "or a bytes regression past tolerance fails; re-pin with "
        "update_collectives()"
    )
    severity = ERROR

    def run(self, program: SpmdProgram) -> Iterable[Finding]:
        if program.worker_error is not None:
            # the one loud surface for dead ranks (the other ledger
            # passes stay quiet: one failure, one finding)
            yield self.finding(
                "spmd://analyzer",
                "the analyzer's ranks failed — the SPMD tier has no "
                f"ledger to analyze: {program.worker_error}",
            )
            return
        golden = program.golden
        if not golden or "entries" not in golden:
            yield self.finding(
                "spmd://analyzer",
                "no golden collective ledger "
                "(analysis/spmd/collectives.json) — run "
                "sentinel_tpu_torch.analysis.spmd.update_collectives() "
                "(--update-collectives) and commit it",
            )
            return
        gentries = golden["entries"]
        seen = set()
        for e in program.entries:
            seen.add(e.name)
            g = gentries.get(e.name)
            if g is None:
                yield self.finding(
                    e.pseudo_path,
                    "entry has no pinned collective ledger — run "
                    "--update-collectives and review the new inventory",
                )
                continue
            gold = {
                (c["kind"], c["dtype"], tuple(c["shape"])): int(c["count"])
                for c in g.get("collectives", [])
            }
            cur = group_collectives(e.collectives)
            for grp in cur:
                key = (grp["kind"], grp["dtype"], tuple(grp["shape"]))
                pinned = gold.get(key)
                shape = "x".join(map(str, grp["shape"])) or "scalar"
                if pinned is None:
                    yield self.finding(
                        e.pseudo_path,
                        f"NEW collective {grp['kind']} {grp['dtype']}"
                        f"[{shape}] x{grp['count']} "
                        f"({_fmt_bytes(grp['count'] * grp['bytes_each'])}"
                        "/tick) not in the pinned ledger — an added "
                        "interconnect transfer; optimize it away or "
                        "re-pin with --update-collectives",
                    )
                elif grp["count"] > pinned:
                    yield self.finding(
                        e.pseudo_path,
                        f"collective {grp['kind']} {grp['dtype']}[{shape}] "
                        f"count grew {pinned} -> {grp['count']} — "
                        "optimize or re-pin with --update-collectives",
                    )
            cur_bytes = ledger_bytes(cur)
            pinned_bytes = int(g.get("bytes_per_tick", 0))
            ceiling = round(pinned_bytes * (1 + LEDGER_TOLERANCE))
            if cur_bytes > ceiling:
                yield self.finding(
                    e.pseudo_path,
                    f"interconnect bytes/tick {cur_bytes} exceed the "
                    f"pinned {pinned_bytes} by more than "
                    f"{LEDGER_TOLERANCE:.0%} (ceiling {ceiling}) — "
                    "optimize or re-pin with --update-collectives",
                )
        for name in sorted(set(gentries) - seen):
            yield self.finding(
                f"spmd://{name}",
                "golden ledger names an entry the analyzer no longer "
                "runs — stale pin; re-pin with --update-collectives",
            )


class ImplicitReshardPass(SpmdPass):
    """The silent all-gather class: a sharded array re-materialized on
    every rank (in the reference, XLA resolving a sharding mismatch; in
    the port, a hand-placed gather that should have been shard-local)."""

    name = "implicit-reshard"
    description = (
        "recorded all-gather that rebuilds a sharded state leaf — or a "
        "slice spanning a leaf's full sharded dimension — at global size "
        "(or moves >=64 KiB): make the consuming op shard-local (partial "
        "gather + all-reduce) instead of paying the transfer every tick"
    )
    severity = ERROR

    def run(self, program: SpmdProgram) -> Iterable[Finding]:
        if program.worker_error is not None:
            return
        for e in program.entries:
            by_global = {}
            # a gather result that carries a sharded dim at its GLOBAL
            # size is a slice of that leaf rebuilt whole (e.g. one salsa
            # plane of the width-sharded running sums): index the
            # sharded dim sizes so slice-shaped gathers still attribute
            dim_owners = {}
            for p in e.placements:
                if not p.sharded:
                    continue
                by_global.setdefault(p.global_bytes, []).append(p.name)
                for i, axis in enumerate(p.spec):
                    if axis is not None:
                        dim_owners.setdefault(p.shape[i], set()).add(p.name)
            for c in e.collectives:
                if c.kind != "all-gather":
                    continue
                path, line = (
                    (c.source, c.line) if c.source else (e.pseudo_path, 1)
                )
                shape = "x".join(map(str, c.shape)) or "scalar"
                if c.nbytes < RESHARD_MATCH_MIN_BYTES:
                    continue
                matches = by_global.get(c.nbytes, [])
                slice_of = sorted(
                    set().union(
                        *(dim_owners.get(d, set()) for d in c.shape)
                    )
                )
                if matches:
                    yield self.finding(
                        path,
                        f"[{e.name}] all-gather {c.dtype}[{shape}] "
                        f"({_fmt_bytes(c.nbytes)}) re-materializes the "
                        f"full sharded leaf {' / '.join(matches)} on "
                        "every device each tick — the consuming op "
                        "defeats the declared sharding (implicit "
                        "reshard); make the op shard-local or replicate "
                        "the leaf deliberately in parallel/spmd.py",
                        line=line,
                    )
                elif slice_of:
                    yield self.finding(
                        path,
                        f"[{e.name}] all-gather {c.dtype}[{shape}] "
                        f"({_fmt_bytes(c.nbytes)}/tick) rebuilds the "
                        "full sharded dimension of "
                        f"{' / '.join(slice_of)} — a slice of the leaf "
                        "is gathered whole on every device (implicit "
                        "reshard); make the consuming op shard-local "
                        "(partial gather + all-reduce) or suppress with "
                        "a rationale and pin it in the ledger",
                        line=line,
                    )
                elif c.nbytes >= RESHARD_BIG_BYTES:
                    yield self.finding(
                        path,
                        f"[{e.name}] large all-gather {c.dtype}[{shape}] "
                        f"({_fmt_bytes(c.nbytes)}/tick) — likely an "
                        "implicit reshard of intermediate data; check "
                        "the producer/consumer sharding mismatch",
                        line=line,
                    )


class ReplicationHazardPass(SpmdPass):
    """Big arrays silently riding every rank instead of sharding.

    Both halves: the state-leaf half (replicated leaves past 8 MiB at a
    blessed config's real scale), and the const half.  The reference's
    consts are jaxpr consts closed over an executable; eager PyTorch
    closes over none, so the port's are what the jaxpr tier's
    ``const-hoist`` sees: tensors a call makes from host data, uploaded
    on every call and so carried by every rank.  The ranks record them
    with that tier's op recorder (``worker.rank_main``); one of 256 KiB or
    more is a finding."""

    name = "replication-hazard"
    description = (
        "state leaves declared replicated that exceed 8 MiB at a blessed "
        "config's real scale, and host constants >=256 KiB every call "
        "uploads on every rank — the SALSA planes and window tables must "
        "stay sharded for capacity to scale with ranks"
    )
    severity = ERROR

    def run(self, program: SpmdProgram) -> Iterable[Finding]:
        if program.worker_error is None:
            for e in program.entries:
                for c in e.consts:
                    if c.nbytes < REPLICATION_CONST_MAX_BYTES:
                        continue
                    shape = "x".join(map(str, c.shape)) or "scalar"
                    yield self.finding(
                        e.pseudo_path,
                        f"jaxpr const {c.dtype}[{shape}] "
                        f"({_fmt_bytes(c.nbytes)}): host data the entry "
                        "makes into a tensor on every call, replicated on "
                        "every rank — shard it as an input or shrink it "
                        "(a constant made per call is never sharded)",
                    )
        for case in program.configs:
            for p in case.placements:
                if p.sharded or p.global_bytes < REPLICATION_LEAF_MAX_BYTES:
                    continue
                shape = "x".join(map(str, p.shape)) or "scalar"
                yield self.finding(
                    case.pseudo_path,
                    f"state leaf {p.name} {p.dtype}[{shape}] "
                    f"({_fmt_bytes(p.global_bytes)}) is declared "
                    "replicated — at this config's scale every rank "
                    "carries the full copy; shard it in "
                    "parallel/spmd.py or justify the replication",
                )


class ShardDivisibilityPass(SpmdPass):
    """Mesh-divisibility of every sharded dim, checked without tracing."""

    name = "shard-divisibility"
    description = (
        "every dimension a PartitionSpec shards must divide the mesh "
        "axis size for every blessed config (max_resources / sketch "
        "width / token columns) — an indivisible dim makes the sharded "
        "tick raise (the port never pads a shard)"
    )
    severity = ERROR

    def run(self, program: SpmdProgram) -> Iterable[Finding]:
        n = program.n_devices
        for case in program.configs:
            for p in case.placements:
                for i, axis in enumerate(p.spec):
                    if axis is None:
                        continue
                    if p.shape[i] % n != 0:
                        yield self.finding(
                            case.pseudo_path,
                            f"leaf {p.name} dim {i} ({p.shape[i]}) is "
                            f"sharded on '{axis}' but does not divide "
                            f"the {n}-device mesh — pick a config whose "
                            f"{p.name} dim is a multiple of {n}",
                        )


class ShardHbmBudgetPass(SpmdPass):
    """Projected per-shard device bytes for the 1M-resource tier vs the
    capacity SLO."""

    name = "shard-hbm-budget"
    description = (
        "per-device state bytes projected from the declared shardings "
        "for the 1M-resource sketch config must stay under the device "
        "memory capacity SLO (SENTINEL_HBM_CAPACITY_BYTES, default the "
        "H100's total_memory per rank)"
    )
    severity = ERROR

    def run(self, program: SpmdProgram) -> Iterable[Finding]:
        case = program.budget_case()
        if case is None:
            if program.budget_config is not None:
                yield self.finding(
                    "spmd://analyzer",
                    f"budget config {program.budget_config!r} has no "
                    "placement case — analyzer wiring bug",
                )
            return
        total = case.shard_bytes
        cap = program.capacity_bytes
        if cap and total > cap:
            top = sorted(
                case.placements, key=lambda p: -p.shard_bytes
            )[:3]
            tops = ", ".join(
                f"{p.name}={_fmt_bytes(p.shard_bytes)}" for p in top
            )
            yield self.finding(
                case.pseudo_path,
                f"projected per-shard HBM {_fmt_bytes(total)} exceeds "
                f"the capacity SLO {_fmt_bytes(cap)} (largest: {tops}) "
                "— shard more state, shrink the config, or raise "
                "SENTINEL_HBM_CAPACITY_BYTES deliberately",
            )


ALL_SPMD_PASSES: List[SpmdPass] = [
    CollectiveLedgerPass(),
    ImplicitReshardPass(),
    ReplicationHazardPass(),
    ShardDivisibilityPass(),
    ShardHbmBudgetPass(),
]
