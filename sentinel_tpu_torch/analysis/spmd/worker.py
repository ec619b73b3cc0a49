"""The rank side of the tier-4 analyzer: run the entry points, record
the collectives.

The port of ``sentinel_tpu/analysis/spmd/worker.py``.  The reference
lowers its entry points in a child process whose XLA platform was forced
to n CPU devices, and reads the optimized HLO.  Here each of the
``mesh_spec().n_devices`` ranks that runner.py starts (``parallel/
launch.run_ranks``) joins the mesh, runs every sharded job once while
``parallel/collectives.recording()`` is on, and returns its ledger; rank
0's report is the analyzer's input (the ranks send the same collectives,
and ``build_report`` checks that they did).  Each job runs under the
jaxpr tier's op recorder too (``analysis/jaxpr/framework.record_call``):
the tensors a call makes from host data are its ``consts`` — one copy on
every rank, the const half of ``replication-hazard``.

Protocol: the report is plain JSON-able data (``rank_main``'s return
value, pickled back by the launcher); a rank that fails surfaces in the
runner as ``SpmdWorkerError``, never as a silently-empty tier.
"""

from __future__ import annotations

from sentinel_tpu_torch.parallel.meshspec import mesh_spec


def rank_main(rank: int, n: int, device: str) -> dict:
    """One rank: join the mesh, run every sharded job once while the
    ledger records; the report (every rank builds it)."""
    import torch

    from sentinel_tpu_torch.analysis.jaxpr.framework import HOST_MADE, record_call
    from sentinel_tpu_torch.analysis.spmd.entrypoints import sharded_jobs
    from sentinel_tpu_torch.parallel import collectives as CL
    from sentinel_tpu_torch.parallel import spmd

    mesh = spmd.make_mesh(n, device=device)
    entries = []
    for name, fn, args in sharded_jobs(mesh, mesh.device):
        with CL.recording() as ledger:
            ops = record_call(fn, args, mesh.device.type)[0]
        made = [op.outputs[0] for op in ops if op.base in HOST_MADE and op.outputs and op.outputs[0].shape != ()]
        entries.append({
            "name": name,
            "consts": [{"dtype": t.dtype, "shape": list(t.shape), "nbytes": t.nbytes} for t in made],
            "collectives": [
                {"kind": r.kind, "dtype": r.dtype, "shape": list(r.shape), "source": r.source, "line": r.line}
                for r in ledger
            ],
        })
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    return {
        "torch_version": torch.__version__,
        "n_devices": n,
        "axis": mesh_spec().axis,
        "device": str(mesh.device.type),
        "backend": mesh.backend,
        "entries": entries,
    }


def build_report(reports: list) -> dict:
    """Rank 0's report, after checking that every rank recorded the same
    collectives (kinds, dtypes, shapes, in order)."""
    def shapes(r):
        return [[(c["kind"], c["dtype"], tuple(c["shape"])) for c in e["collectives"]] for e in r["entries"]]

    first = shapes(reports[0])
    for i, r in enumerate(reports[1:], 1):
        if shapes(r) != first:
            raise RuntimeError(f"rank {i} sent other collectives than rank 0")
    return reports[0]
