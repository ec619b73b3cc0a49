"""Start the ranks of a mesh, with a deadline — the one launcher the tests,
the tier-4 analyzer's runner and ``chip_smoke.py`` share.

``run_ranks(target, n, args)`` starts ``n`` processes (the ``spawn``
start method: CUDA ranks need it), gives each the mesh recipe of
``meshspec.force_cpu_mesh_env`` plus its ``RANK``, and calls
``target(rank, n, *args)`` there.  Each rank's return value comes back
(pickled); the list is in rank order.

``start_ranks`` is the same launch split in two, for callers that set
several groups up at once and then run them one at a time: a rank calls
``gate()`` when its set-up is done and blocks there until the parent
calls ``Ranks.go()``; ``Ranks.ready()`` waits for every rank to reach its
gate and ``Ranks.wait()`` for the results.

A ``gloo`` rank that raises leaves its peers blocked in a collective, so
nothing here waits without a bound:

* every child asks the kernel to kill it when its parent ends
  (``die_with_parent``: ``PR_SET_PDEATHSIG``), however the parent ends;
* the groups the ranks open time out (``spmd.GROUP_TIMEOUT_S``);
* the parent waits at most ``timeout_s`` from the start: a rank that
  fails, dies or misses the deadline has every rank killed and raises
  ``RanksError`` with the failing rank's traceback.

The ``spawn`` start method also starts multiprocessing's resource
tracker, a process that lives as long as the process that started the
ranks; the launcher leaves it alone.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from sentinel_tpu_torch.parallel import meshspec as MS


class RanksError(RuntimeError):
    """A rank failed, died or missed the deadline (every rank was killed)."""


def die_with_parent(parent_pid: int) -> None:
    """In a child process: have the kernel send it SIGKILL when its parent
    ends (``PR_SET_PDEATHSIG``), a crash by a fatal signal included, where
    no ``finally`` of the parent's runs; a parent already gone (not
    ``parent_pid`` any more) ends it now."""
    import ctypes
    import signal

    pr_set_pdeathsig = 1
    if ctypes.CDLL(None, use_errno=True).prctl(pr_set_pdeathsig, signal.SIGKILL) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != parent_pid:
        os._exit(3)


#: in a rank: its connection to the parent (``gate`` reads it)
_PARENT_CONN = None


def gate() -> None:
    """In a rank: tell the parent that this rank's set-up is done and block
    until the parent lets its group run (``Ranks.go``; ``run_ranks`` lets
    it run at once).  Outside a rank it does nothing."""
    conn = _PARENT_CONN
    if conn is None:
        return
    conn.send(("ready", None))
    if conn.recv() != "go":
        raise RanksError("the parent did not let the group run")


def _child(rank: int, n: int, recipe: dict, parent: int, target, args, conn) -> None:
    global _PARENT_CONN
    die_with_parent(parent)
    os.environ.update(recipe)
    os.environ["RANK"] = str(rank)
    os.environ["LOCAL_RANK"] = str(rank)
    _PARENT_CONN = conn
    try:
        res = target(rank, n, *args)
        conn.send(("ok", res))
    except BaseException:  # noqa: BLE001 — every failure goes back to the parent
        conn.send(("err", traceback.format_exc()))
    finally:
        conn.close()
        try:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — teardown after the result went back
            pass


class Ranks:
    """A started rank group (``start_ranks``).  Use it as a context
    manager, or call ``kill()``: no process it started outlives it."""

    def __init__(self, target: Callable, n: int, args: Sequence[Any], timeout_s: float, backend: Optional[str]):
        import multiprocessing as mp

        self.n, self.timeout_s = n, timeout_s
        recipe: dict = {}
        MS.force_cpu_mesh_env(recipe, n)
        if backend is None:
            del recipe[MS.BACKEND_ENV]  # make_mesh picks by the device and the world size
        else:
            recipe[MS.BACKEND_ENV] = backend
        ctx = mp.get_context("spawn")
        pipes = [ctx.Pipe(duplex=True) for _ in range(n)]
        self._conns = [mine for mine, _theirs in pipes]
        self._procs = [
            ctx.Process(target=_child, args=(r, n, recipe, os.getpid(), target, tuple(args), pipes[r][1]), daemon=True)
            for r in range(n)
        ]
        self._deadline = time.monotonic() + timeout_s
        self._ready: set = set()
        self._results: dict = {}
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.kill()
            raise
        finally:
            for _mine, theirs in pipes:
                theirs.close()  # the parent's copy: a rank's end closes when it exits

    def _pump(self, until_done: bool) -> None:
        from multiprocessing.connection import wait

        try:
            while True:
                pending = {
                    self._conns[r]: r for r in range(self.n)
                    if r not in self._results and (until_done or r not in self._ready)
                }
                if not pending:
                    return
                left = self._deadline - time.monotonic()
                if left <= 0:
                    raise RanksError(f"{len(pending)} of {self.n} ranks missed the {self.timeout_s:.0f} s deadline")
                for conn in wait(list(pending), timeout=left):
                    r = pending[conn]
                    try:
                        kind, payload = conn.recv()
                    except EOFError:
                        self._procs[r].join(timeout=5.0)
                        raise RanksError(
                            f"rank {r} died (exit code {self._procs[r].exitcode}) without a result"
                        ) from None
                    if kind == "err":
                        raise RanksError(f"rank {r} failed:\n{payload}")
                    self._ready.add(r)
                    if kind == "ok":
                        self._results[r] = payload
        except BaseException:
            self.kill()
            raise

    def ready(self) -> None:
        """Wait until every rank has reached its ``gate()`` (or ended)."""
        self._pump(until_done=False)

    def go(self) -> None:
        """Let every rank past its ``gate()`` (sent ahead: a rank that has
        not reached it yet passes it at once)."""
        for r, conn in enumerate(self._conns):
            if r not in self._results:
                try:
                    conn.send("go")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the rank is gone: wait() reports it

    def wait(self) -> List[Any]:
        """Every rank's result, in rank order."""
        self._pump(until_done=True)
        for p in self._procs:
            p.join(timeout=max(1.0, self._deadline - time.monotonic()))
        self.kill()
        return [self._results[r] for r in range(self.n)]

    def kill(self) -> None:
        """Kill every rank still alive and close the pipes (idempotent)."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=5.0)
        for conn in self._conns:
            conn.close()

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.kill()


def start_ranks(
    target: Callable,
    n: int,
    args: Sequence[Any] = (),
    timeout_s: float = 120.0,
    backend: Optional[str] = "gloo",
) -> Ranks:
    """Start ``target(rank, n, *args)`` in each of ``n`` processes of an
    ``n``-rank mesh; the deadline counts from now.  ``backend`` goes into
    the recipe (``gloo``, the CPU recipe's, by default; ``None`` lets
    ``spmd.make_mesh`` pick it from the device and the world size)."""
    return Ranks(target, n, args, timeout_s, backend)


def run_ranks(
    target: Callable,
    n: int,
    args: Sequence[Any] = (),
    timeout_s: float = 120.0,
    backend: Optional[str] = "gloo",
) -> List[Any]:
    """``[target(rank, n, *args) for rank in range(n)]``, each in its own
    process of an ``n``-rank mesh; raises ``RanksError`` (every rank
    killed) when one fails, dies, or the deadline passes.  No process it
    started outlives it."""
    with start_ranks(target, n, args, timeout_s, backend) as ranks:
        ranks.go()
        return ranks.wait()
