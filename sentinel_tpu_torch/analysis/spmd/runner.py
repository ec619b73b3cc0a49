"""Parent-side runner for the tier-4 analyzer's ranks.

The port of ``sentinel_tpu/analysis/spmd/runner.py``.  The analyzer needs
an n-rank mesh, but it runs INSIDE tier-1 pytest — a process that must be
left as it was: no process group, no device state.  So the entry points
run in ``mesh_spec().n_devices`` child processes started from the shared
``meshspec.force_cpu_mesh_env`` recipe (``parallel/launch.run_ranks``:
``spawn``, a deadline, every rank killed on a failure or a timeout), and
the parent consumes a plain report.  The report is cached per process and
device: every pass and test in one process shares one run.

``device``: ``cuda`` by default (every rank on the card; it raises where
there is none); ``cpu`` for gloo ranks on the CPU, as the tests run it.

    python -m sentinel_tpu_torch.analysis.spmd.runner [--device cuda|cpu] [--ranks N]

prints the report as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import Dict, Optional, Tuple

from sentinel_tpu_torch.parallel.meshspec import mesh_spec

#: the ranks' deadline: spawning and importing dominates on the CPU
WORKER_TIMEOUT_S = 300

_CACHE: Dict[Tuple[int, str], dict] = {}
_CACHE_LOCK = threading.Lock()


class SpmdWorkerError(RuntimeError):
    """The ranks failed; str() carries the failing rank's traceback tail."""


def _run_worker(n_devices: int, device: str) -> dict:
    import torch

    from sentinel_tpu_torch.analysis.spmd import worker
    from sentinel_tpu_torch.parallel import launch

    if device == "cuda" and not torch.cuda.is_available():
        raise SpmdWorkerError("no CUDA device for the analyzer's ranks (pass device='cpu' to run on the CPU)")
    try:
        # on the card the backend follows the world size (spmd.make_mesh)
        backend = "gloo" if device == "cpu" else None
        reports = launch.run_ranks(worker.rank_main, n_devices, (device,), timeout_s=WORKER_TIMEOUT_S, backend=backend)
        return worker.build_report(reports)
    except (launch.RanksError, RuntimeError) as e:
        tail = "\n".join(str(e).strip().splitlines()[-8:])
        raise SpmdWorkerError(f"spmd ranks failed: {tail}") from e


def worker_report(n_devices: Optional[int] = None, refresh: bool = False, device: str = "cuda") -> dict:
    """The ranks' report for the blessed mesh, cached per process (the
    ranks run outside the cache's lock: two first callers may both run
    them, and the later report wins)."""
    n = n_devices if n_devices is not None else mesh_spec().n_devices
    with _CACHE_LOCK:
        hit = None if refresh else _CACHE.get((n, device))
    if hit is not None:
        return hit
    report = _run_worker(n, device)
    with _CACHE_LOCK:
        _CACHE[(n, device)] = report
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=mesh_spec().n_devices)
    a = ap.parse_args(argv)
    print(json.dumps(worker_report(a.ranks, refresh=True, device=a.device), sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
