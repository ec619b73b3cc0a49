"""Runtime lock witness: the dynamic half of the tier-3 lock-order pass.

The static pass (``summaries.py`` + ``passes.py``) proves an acyclic
held→acquired graph from source; this module checks the claim against
REALITY.  ``install()`` monkeypatches the ``threading.Lock``/``RLock``
factories so that every lock created at a source line the summary DB
knows about (``SummaryDB.creation_sites``) comes back wrapped in a
:class:`WitnessLock` carrying its canonical tier-3 identity (e.g.
``cluster.client.ClusterTokenClient._lock``).  Locks created anywhere
else — stdlib internals, test scaffolding, third-party code — come back
as plain locks and cost nothing.

Each witnessed acquisition then records, per thread, the REAL
held→acquired edges as they happen and checks two things on the spot:

* **order inversion** — acquiring B while holding A when the blessed
  static graph (``lock_order.json``) or the dynamically observed edge
  set already contains B→A.  This is the two-thread deadlock recipe the
  static ``lock-order-cycle`` pass looks for, caught in the act; each
  one increments ``sentinel_lock_order_violations_total``.
* **same-instance re-acquire** — a blocking ``acquire()`` of a
  non-reentrant lock the calling thread already holds.  That is a
  guaranteed self-deadlock, so the witness raises ``RuntimeError``
  immediately instead of hanging the test run.

``verdict()`` closes the loop after a run: zero violations AND no
dynamic edge between two statically-known locks that the static pass
missed (an edge the analyzer cannot see — e.g. one routed through a
callback — is exactly the blind spot the witness exists to surface).
The chaos plane evaluates this as the ``no-order-violations`` invariant
(``chaos/invariants.py``), and ``runtime.lock.contend`` is a delay
failpoint at every witnessed acquisition, so chaos scenarios can widen
race windows at the exact moment two threads contend.

Observability: ``sentinel_lock_wait_ms`` (histogram) is the time each
witnessed ``acquire()`` spent waiting — the contention profile of the
whole lock plane; ``sentinel_lock_order_violations_total`` (counter)
stays at zero or the run is wrong.

Opt-in only: nothing in this module runs unless a test or chaos harness
calls ``install()`` BEFORE the modules under test create their locks.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.time_source import mono_s

_FP_CONTEND = FP.register(
    "runtime.lock.contend",
    "witnessed lock acquisition (delay here widens race windows)",
    ("delay",),
)

_H_WAIT = _OBS.histogram(
    "sentinel_lock_wait_ms",
    "time witnessed lock acquisitions spent waiting (witness installed "
    "runs only; the contention profile of the instrumented lock plane)",
)
_C_VIOLATIONS = _OBS.counter(
    "sentinel_lock_order_violations_total",
    "lock acquisitions that inverted a blessed or dynamically observed "
    "lock-order edge (witness installed runs only; any nonzero value is "
    "a latent deadlock)",
)

#: the REAL factories, captured at import so witness internals and the
#: uninstalled path never recurse through the patch
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_tls = threading.local()


def _held_stack() -> List["WitnessLock"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _WitnessState:
    """Process-global edge ledger shared by every witnessed lock."""

    def __init__(self):
        self.lock = _REAL_LOCK()
        #: dynamic held→acquired edges, name-level: edge -> first-seen detail
        self.edges: Dict[Tuple[str, str], str] = {}
        self.violations: List[str] = []
        #: blessed static edges ("A -> B" strings parsed into pairs)
        self.static_edges: Set[Tuple[str, str]] = set()
        #: every lock id the static graph knows (edge endpoints)
        self.static_nodes: Set[str] = set()

    def record(self, held: str, acquired: str, where: str) -> None:
        edge = (held, acquired)
        rev = (acquired, held)
        with self.lock:
            inverted = rev in self.static_edges or rev in self.edges
            if edge not in self.edges:
                self.edges[edge] = where
            if inverted:
                self.violations.append(
                    f"order inversion: {held} -> {acquired} at {where} "
                    f"reverses the established {acquired} -> {held}"
                )
        if inverted:
            _C_VIOLATIONS.inc()


_STATE = _WitnessState()


class WitnessLock:
    """A ``threading.Lock``/``RLock`` wrapper that narrates acquisitions.

    Deliberately NOT a ``__getattr__`` delegator: ``threading.Condition``
    probes its lock for ``_release_save``/``_acquire_restore``/
    ``_is_owned`` and uses them to drop the lock around ``wait()`` — if
    those resolved to the INNER lock the witness's held-stack would
    desync.  The reentrant wrapper implements all three so a Condition
    built on a witnessed RLock keeps the ledger exact; the plain-Lock
    wrapper omits them so Condition takes its acquire/release fallback,
    which already routes through the witness.
    """

    __slots__ = ("_inner", "name", "_reentrant")

    def __init__(self, inner, name: str, reentrant: bool):
        self._inner = inner
        self.name = name
        self._reentrant = reentrant

    # -- core protocol ------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # reentrancy guard: the instrumentation below itself acquires
        # witnessed locks (the chaos failpoint state lock, the metric
        # registry's) — while this thread is inside the witness, nested
        # witnessed acquisitions pass straight through or the first
        # armed `runtime.lock.contend` delay would recurse forever
        if getattr(_tls, "busy", False):
            return self._inner.acquire(blocking, timeout)
        stack = _held_stack()
        _tls.busy = True
        try:
            if blocking and not self._reentrant and any(
                w is self for w in stack
            ):
                msg = (
                    f"same-instance re-acquire of non-reentrant "
                    f"{self.name}: guaranteed self-deadlock"
                )
                with _STATE.lock:
                    _STATE.violations.append(msg)
                _C_VIOLATIONS.inc()
                raise RuntimeError(msg)
            FP.hit(_FP_CONTEND)
            t0 = mono_s()
            got = self._inner.acquire(blocking, timeout)
            _H_WAIT.observe((mono_s() - t0) * 1e3)
            if got:
                self._on_acquired(stack)
        finally:
            _tls.busy = False
        return got

    def _on_acquired(self, stack: List["WitnessLock"]) -> None:
        where = threading.current_thread().name
        for w in stack:
            # self-edges (RLock reentry) carry no ordering information —
            # the static graph excludes them too
            if w.name != self.name:
                _STATE.record(w.name, self.name, where)
        stack.append(self)

    def release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name} wrapping {self._inner!r}>"


class WitnessRLock(WitnessLock):
    """Reentrant variant, Condition-compatible (see WitnessLock doc)."""

    __slots__ = ()

    def __init__(self, inner, name: str):
        super().__init__(inner, name, reentrant=True)

    # threading.Condition protocol: these keep the held-stack exact when
    # a Condition drops/retakes the lock around wait()
    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        return self._inner._release_save()

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        _held_stack().append(self)


# -- install / uninstall -----------------------------------------------------

_installed = False
_names_by_site: Dict[Tuple[str, int], str] = {}


def _repo_root() -> str:
    from sentinel_tpu_torch.analysis import REPO_ROOT

    return REPO_ROOT


def _creation_name() -> Optional[str]:
    """Canonical id for the lock being created, from the caller's frame —
    None when the creating line is not a creation site the summary DB
    canonicalized (stdlib, tests, dynamic code)."""
    import sys

    f = sys._getframe(2)
    path = f.f_code.co_filename
    root = _repo_root()
    if not path.startswith(root + os.sep):
        return None
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with _STATE.lock:
        return _names_by_site.get((rel, f.f_lineno))


def _witness_lock_factory():
    name = _creation_name()
    inner = _REAL_LOCK()
    if name is None:
        return inner
    return WitnessLock(inner, name, reentrant=False)


def _witness_rlock_factory():
    name = _creation_name()
    inner = _REAL_RLOCK()
    if name is None:
        return inner
    return WitnessRLock(inner, name)


def install(golden_path: Optional[str] = None) -> int:
    """Patch the lock factories; returns the number of known creation
    sites.  Must run BEFORE the modules under test construct their locks
    (module-level locks need a fresh import or an explicit re-create).

    ``golden_path``: the blessed ``lock_order.json`` to check inversions
    against (default: the committed one; pass a missing path to witness
    with dynamic-edge inversion checking only).
    """
    global _installed
    from sentinel_tpu_torch.analysis import PACKAGE, REPO_ROOT
    from sentinel_tpu_torch.analysis.concurrency import LOCK_ORDER_PATH, load_lock_order
    from sentinel_tpu_torch.analysis.concurrency.summaries import build_db

    db = build_db([os.path.join(REPO_ROOT, PACKAGE)], REPO_ROOT)
    edges = load_lock_order(golden_path or LOCK_ORDER_PATH) or set()
    with _STATE.lock:
        _names_by_site.clear()
        _names_by_site.update(db.creation_sites)
        _STATE.static_edges = {
            tuple(e.split(" -> ", 1)) for e in edges if " -> " in e
        }
        _STATE.static_nodes = {n for pair in _STATE.static_edges for n in pair}

    threading.Lock = _witness_lock_factory
    threading.RLock = _witness_rlock_factory
    _installed = True
    return len(_names_by_site)


def uninstall() -> None:
    """Restore the real factories.  Already-wrapped locks keep working
    (they hold real inner locks); they just stop being created."""
    global _installed
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _installed = False


def is_installed() -> bool:
    return _installed


def reset() -> None:
    """Clear the edge ledger and violation list (between scenarios)."""
    with _STATE.lock:
        _STATE.edges.clear()
        _STATE.violations.clear()


def violations() -> List[str]:
    with _STATE.lock:
        return list(_STATE.violations)


def dynamic_edges() -> Dict[Tuple[str, str], str]:
    with _STATE.lock:
        return dict(_STATE.edges)


def edges_unknown_to_static() -> List[str]:
    """Dynamic edges between two statically-known locks that the static
    pass did NOT derive — its blind spots (callback-routed acquisitions,
    dynamic dispatch).  Edges touching a lock outside the static graph's
    node set are not reported here: the witness cannot distinguish "the
    analyzer missed this edge" from "the analyzer names this lock
    differently" for locks it never placed in the graph."""
    out = []
    with _STATE.lock:
        for (a, b), where in sorted(_STATE.edges.items()):
            if (
                a in _STATE.static_nodes
                and b in _STATE.static_nodes
                and (a, b) not in _STATE.static_edges
            ):
                out.append(f"{a} -> {b} (seen on thread {where})")
    return out


def verdict() -> Tuple[bool, str]:
    """(ok, detail) for the ``no-order-violations`` chaos invariant:
    zero recorded violations AND zero dynamic edges the static graph
    missed.  Trivially ok when the witness was never installed."""
    if not _installed and not _STATE.edges and not _STATE.violations:
        return True, "witness inactive"
    v = violations()
    missing = edges_unknown_to_static()
    ok = not v and not missing
    bits = []
    if v:
        bits.append(f"{len(v)} violation(s): " + "; ".join(v[:3]))
    if missing:
        bits.append(
            f"{len(missing)} dynamic edge(s) absent from the static "
            "graph: " + "; ".join(missing[:3])
        )
    n = len(dynamic_edges())
    return ok, "; ".join(bits) or f"{n} dynamic edge(s), all consistent"
