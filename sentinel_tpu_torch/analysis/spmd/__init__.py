"""sentinel_tpu_torch.analysis.spmd — the tier-4 SPMD/sharding analyzer.

The port of ``sentinel_tpu/analysis/spmd/``.  Tier 3 pins the lock graph;
this tier pins the SHARDED program: the real entry points (the engine
tick with the salsa sketch tier, ``ops/window.add_batch``,
``ops/token_col.decide_batch``) run on the blessed mesh
(``parallel/meshspec.py``: ``n_devices`` ranks) with the shardings
``parallel/spmd.py`` declares, then five passes over the collectives the
ranks recorded and the declared placements:

* ``collective-ledger``   — the all-reduce / all-gather inventory with bytes between ranks per tick, golden-pinned in
  ``collectives.json`` (``update_collectives()``);
* ``implicit-reshard``    — the silent all-gather class: a supposedly
  sharded array rebuilt at full size on every rank;
* ``replication-hazard``  — replicated state leaves beyond a size
  threshold (the SALSA planes must stay sharded); its const half has no
  torch counterpart (passes.py);
* ``shard-divisibility``  — every sharded dim divides the mesh width
  for every blessed config, nothing run;
* ``shard-hbm-budget``    — per-shard bytes projected from the specs for
  the 1M-resource sketch tier against the device memory SLO (the H100's
  ``total_memory`` unless ``SENTINEL_HBM_CAPACITY_BYTES`` says otherwise).

Where the reference reads the HLO that XLA's partitioner produced, the
port reads the ledger ``parallel/collectives.py`` records: the port
places its collectives by hand, each through that module.  The ranks run
in child processes (runner.py), so running this tier leaves the calling
process with no process group — it is safe inside tier-1 pytest.

Programmatic surface::

    from sentinel_tpu_torch.analysis.spmd import run_spmd_analysis
    findings = run_spmd_analysis()               # ranks on the card
    findings = run_spmd_analysis(device="cpu")   # gloo ranks on the CPU

The CLI (``python -m sentinel_tpu.analysis --tier spmd`` in the
reference) comes with the port's tier-1 slice.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

from sentinel_tpu_torch.analysis.framework import Finding, parse_suppressions
from sentinel_tpu_torch.analysis.spmd.framework import (  # noqa: F401
    COLLECTIVES_PATH,
    Collective,
    ConfigCase,
    ConstInfo,
    LeafPlacement,
    ShardedEntry,
    SpmdPass,
    SpmdProgram,
    collectives_from_ledger,
    group_collectives,
    ledger_bytes,
)

#: default per-device memory capacity SLO when SENTINEL_HBM_CAPACITY_BYTES
#: is unset: ``torch.cuda.get_device_properties(0).total_memory`` of the
#: NVIDIA H100 80GB HBM3 (700 W) the port runs on, as chip_smoke.py's
#: phase 16c reads and prints it (PERF.md) — the reference's default is a
#: v5e chip's 16 GiB
DEFAULT_CAPACITY_BYTES = 85_017_493_504


def spmd_passes():
    from sentinel_tpu_torch.analysis.spmd.passes import ALL_SPMD_PASSES

    return ALL_SPMD_PASSES


def capacity_slo_bytes() -> int:
    """The capacity SLO: the env knob, else the H100's total_memory."""
    try:
        env = int(os.environ.get("SENTINEL_HBM_CAPACITY_BYTES", "0") or 0)
    except ValueError:
        env = 0
    return env if env > 0 else DEFAULT_CAPACITY_BYTES


def _report_entries(report: dict, placements_by_name: dict) -> List[ShardedEntry]:
    entries = []
    for e in report.get("entries", []):
        entries.append(
            ShardedEntry(
                name=e["name"],
                collectives=collectives_from_ledger(e.get("collectives", [])),
                consts=[
                    ConstInfo(dtype=c["dtype"], shape=tuple(c["shape"]), nbytes=int(c["nbytes"]))
                    for c in e.get("consts", [])
                ],
                placements=placements_by_name.get(e["name"], []),
            )
        )
    return entries


def _load_golden(path: str) -> Optional[dict]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def build_program(
    golden_path: str = COLLECTIVES_PATH, refresh: bool = False, device: str = "cuda"
) -> SpmdProgram:
    """Assemble the pass input: the ranks' report (child processes,
    cached per process) + declared placements + blessed config cases."""
    from sentinel_tpu_torch.analysis.spmd import entrypoints as EP
    from sentinel_tpu_torch.analysis.spmd.runner import SpmdWorkerError, worker_report
    from sentinel_tpu_torch.parallel.meshspec import mesh_spec

    spec = mesh_spec()
    placements = EP.entry_placements()
    worker_error = None
    report = {}
    try:
        report = worker_report(spec.n_devices, refresh=refresh, device=device)
    except SpmdWorkerError as e:
        worker_error = str(e)
    program = SpmdProgram(
        n_devices=spec.n_devices,
        axis=spec.axis,
        entries=_report_entries(report, placements),
        configs=[ConfigCase(name=n, placements=p) for n, p in EP.config_cases()],
        budget_config=EP.BUDGET_CONFIG,
        capacity_bytes=capacity_slo_bytes(),
        golden=_load_golden(golden_path) if golden_path else None,
        torch_version=report.get("torch_version", ""),
        worker_error=worker_error,
    )
    _export_gauges(program)
    return program


def _export_gauges(program: SpmdProgram) -> None:
    """Publish the analyzer's measurements on the port's obs registry:
    bytes between ranks per tick per entry, and the projected per-shard
    bytes of the budgeted config."""
    from sentinel_tpu_torch.obs.registry import REGISTRY

    for e in program.entries:
        REGISTRY.gauge(
            "sentinel_spmd_collective_bytes_per_tick",
            "per-tick bytes between ranks that the sharded path sends for "
            "one entry point (tier-4 analyzer, recorded ledger)",
            labels={"entry": e.name},
        ).set(ledger_bytes(group_collectives(e.collectives)))
    case = program.budget_case()
    if case is not None:
        REGISTRY.gauge(
            "sentinel_spmd_shard_hbm_projected_bytes",
            "per-rank state bytes projected from the declared shardings "
            "for the budgeted 1M-resource config (tier-4 analyzer)",
        ).set(case.shard_bytes)


def _source_suppressed(repo_root: str, cache: dict, f: Finding) -> bool:
    """Honor ``# stlint: disable=`` comments for findings that landed on a
    real source line (pseudo-path findings are managed through the golden,
    not comments)."""
    if f.path.startswith("spmd://"):
        return False
    table = cache.get(f.path)
    if table is None:
        try:
            with open(os.path.join(repo_root, f.path), "r", encoding="utf-8") as fh:
                table = parse_suppressions(fh.read())
        except OSError:
            table = ({}, set())
        cache[f.path] = table
    line_disables, file_disables = table
    if "*" in file_disables or f.rule in file_disables:
        return True
    at = line_disables.get(f.line, ())
    return "*" in at or f.rule in at


def run_spmd_analysis(
    passes: Optional[Sequence[SpmdPass]] = None,
    program: Optional[SpmdProgram] = None,
    device: str = "cuda",
) -> List[Finding]:
    """Run the tier-4 passes; ``# stlint:`` suppressions on findings
    anchored at real source lines are honored."""
    from sentinel_tpu_torch.analysis import REPO_ROOT
    from sentinel_tpu_torch.analysis.framework import _SEV_ORDER

    if program is None:
        program = build_program(device=device)
    if passes is None:
        passes = spmd_passes()
    findings: List[Finding] = []
    sup_cache: dict = {}
    for p in passes:
        for f in p.run(program):
            if not _source_suppressed(REPO_ROOT, sup_cache, f):
                findings.append(f)
    findings.sort(key=lambda f: (_SEV_ORDER.get(f.severity, 9), f.path, f.line, f.rule))
    return findings


#: for each entry, the reference's golden entry it stands for and why the
#: two inventories differ (written into collectives.json's comment)
REFERENCE_COUNTERPARTS = {
    "tick/sketch-salsa": (
        "sentinel_tpu/analysis/spmd/collectives.json entries['tick/sketch-salsa']: XLA "
        "placed all-gathers of the salsa running sums (s32[2,512] x2, the flattened "
        "read's implicit reshard) and many small partial-result all-reduces; the port's "
        "hand-placed collectives are one all-reduce per sharded read (the ENTRY row, "
        "the flow check's triple, the sketch's [depth, N] cells, the explain records' "
        "pass runs) and one all-gather of each rank's top-K timeline rows"
    ),
    "window/add-batch": (
        "sentinel_tpu/analysis/spmd/collectives.json entries['window/add-batch']: the "
        "port's scatter lands only the rank's own rows, so it sends nothing"
    ),
    "cluster/token-col": (
        "sentinel_tpu/analysis/spmd/collectives.json entries['cluster/token-col'] (an "
        "f32[32] and an s32[32] all-reduce): the port reads the slot's windowed pass "
        "count and its limit in ONE f32[2,32] all-reduce"
    ),
}


def update_collectives(path: str = COLLECTIVES_PATH, device: str = "cuda", refresh: bool = True) -> int:
    """Re-pin the golden collective ledger from a fresh run of the ranks
    (``refresh=False``: this process's cached run); returns the entry
    count.  Commit the diff ONLY after reviewing each
    new collective — every pinned transfer is paid every tick."""
    from sentinel_tpu_torch.analysis.spmd.runner import worker_report
    from sentinel_tpu_torch.parallel.meshspec import mesh_spec

    spec = mesh_spec()
    report = worker_report(spec.n_devices, refresh=refresh, device=device)
    entries = {}
    for e in report.get("entries", []):
        groups = group_collectives(
            Collective(kind=c.kind, dtype=c.dtype, shape=c.shape)
            for c in collectives_from_ledger(e.get("collectives", []))
        )
        entries[e["name"]] = {
            "collectives": groups,
            "bytes_per_tick": ledger_bytes(groups),
            "reference": REFERENCE_COUNTERPARTS.get(e["name"], ""),
        }
    data = {
        "comment": (
            "Golden collective ledger per sharded entry point on the blessed mesh "
            "(parallel/meshspec.py), recorded by parallel/collectives.py while the "
            "ranks ran them.  Shapes are per-rank result shapes; bytes_per_tick is "
            "the summed transfer size.  Each entry's 'reference' names its "
            "counterpart in the JAX package's golden and why they differ: the "
            "port's collectives are placed by hand, the reference's by XLA's "
            "partitioner.  Regenerate with "
            "sentinel_tpu_torch.analysis.spmd.update_collectives(device='cpu') "
            "(--update-collectives) and commit ONLY when the new traffic is the "
            "point of the change."
        ),
        "torch_version": report.get("torch_version", ""),
        "mesh": {
            "axis": report.get("axis", spec.axis),
            "n_devices": report.get("n_devices", spec.n_devices),
        },
        "entries": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(entries)
