"""Tier-3 concurrency passes over the interprocedural summary DB.

Unlike tier 1 these are whole-program: one :class:`SummaryDB` spanning
the package feeds every pass, so a pass can say "``_call`` holds
``probe_lock`` and the callee three frames down blocks on a socket".
Graph-level findings (cycles, stale golden edges) anchor on the
``concurrency://lock-order`` pseudo-path (the tier-2 convention for
findings with no single source line); everything else anchors at a real
file:line and honors ``# stlint:`` suppressions like any tier-1 finding.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from sentinel_tpu_torch.analysis.framework import ERROR, WARNING, Finding
from sentinel_tpu_torch.analysis.concurrency.summaries import (
    EdgeSite,
    SummaryDB,
)

#: pseudo-path for graph-level findings (no single source anchor)
GRAPH_PATH = "concurrency://lock-order"


class ConcurrencyPass:
    """Base: subclasses implement :meth:`run` over the shared DB."""

    name: str = ""
    description: str = ""
    severity: str = ERROR

    def run(
        self, db: SummaryDB, golden: Optional[Set[str]]
    ) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(
        self,
        path: str,
        line: int,
        message: str,
        severity: Optional[str] = None,
    ) -> Finding:
        return Finding(
            rule=self.name,
            path=path,
            line=line,
            col=0,
            message=message,
            severity=severity or self.severity,
        )


def edge_str(src: str, dst: str) -> str:
    return f"{src} -> {dst}"


def _sccs(nodes: Set[str], succ: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan SCCs (iterative); only components of size > 1 are returned
    — self-loops were already excluded at edge-construction time."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in sorted(nodes):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            v, pi = work.pop()
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack.add(v)
            recursed = False
            children = sorted(succ.get(v, ()))
            for i in range(pi, len(children)):
                w = children[i]
                if w not in index:
                    work.append((v, i + 1))
                    work.append((w, 0))
                    recursed = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if recursed:
                continue
            if low[v] == index[v]:
                comp: List[str] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return out


class LockOrderCyclePass(ConcurrencyPass):
    name = "lock-order-cycle"
    description = (
        "the interprocedural held->acquired lock graph must be acyclic "
        "(a cycle is a potential deadlock between two threads taking the "
        "locks in opposite orders)"
    )

    def run(self, db: SummaryDB, golden: Optional[Set[str]]) -> Iterable[Finding]:
        edges = db.lock_edges()
        nodes: Set[str] = set()
        succ: Dict[str, Set[str]] = {}
        for (src, dst) in edges:
            nodes.add(src)
            nodes.add(dst)
            succ.setdefault(src, set()).add(dst)
        for comp in _sccs(nodes, succ):
            comp_set = set(comp)
            lines: List[str] = []
            for (src, dst), sites in sorted(edges.items()):
                if src in comp_set and dst in comp_set:
                    lines.append(f"{edge_str(src, dst)} [{sites[0].chain}]")
            yield self.finding(
                GRAPH_PATH,
                1,
                "lock-order cycle among {%s}: %s"
                % (", ".join(comp), "; ".join(lines)),
            )


class LockOrderNewEdgePass(ConcurrencyPass):
    name = "lock-order-new-edge"
    description = (
        "every held->acquired lock-order edge must appear in the blessed "
        "acyclic graph (analysis/concurrency/lock_order.json); bless new "
        "edges with --update-lock-order after reviewing the ordering"
    )

    def run(self, db: SummaryDB, golden: Optional[Set[str]]) -> Iterable[Finding]:
        if golden is None:
            return
        edges = db.lock_edges()
        observed: Set[str] = set()
        for (src, dst), sites in sorted(edges.items()):
            e = edge_str(src, dst)
            observed.add(e)
            if e not in golden:
                s = sites[0]
                yield self.finding(
                    s.module,
                    s.line,
                    f"new lock-order edge '{e}' not in the blessed graph: "
                    f"{s.chain}.  Review the ordering against "
                    "lock_order.json, then run "
                    "`update_lock_order()`",
                )
        for e in sorted(golden - observed):
            yield self.finding(
                GRAPH_PATH,
                1,
                f"golden lock-order edge '{e}' is no longer observed; run "
                "--update-lock-order to prune it",
                severity=WARNING,
            )


class BlockingUnderLockPass(ConcurrencyPass):
    name = "blocking-under-lock"
    description = (
        "no blocking operation (socket I/O, RPC roundtrip, Future.result, "
        "thread join, sleep, device sync, unbounded queue get) may run "
        "while a lock is held; ERROR when the holding code is reachable "
        "from an admission/tick root, WARNING elsewhere"
    )

    def run(self, db: SummaryDB, golden: Optional[Set[str]]) -> Iterable[Finding]:
        blk = db.blocking_closure()
        admission = db.admission_reachable()
        seen: Set[Tuple[str, int, str]] = set()
        for key, fs in sorted(db.funcs.items()):
            sev = ERROR if key in admission else WARNING
            tag = " [admission-path]" if sev == ERROR else ""
            for b in fs.blocking:
                if not b.held:
                    continue
                dk = (fs.module, b.line, b.kind)
                if dk in seen:
                    continue
                seen.add(dk)
                yield self.finding(
                    fs.module,
                    b.line,
                    f"{fs.qualname} performs a blocking {b.kind} "
                    f"({b.detail}) while holding {', '.join(b.held)}{tag}",
                    severity=sev,
                )
            for cs in fs.calls:
                if not cs.held:
                    continue
                g = db.resolve_call(fs, cs.ref)
                if g is None or g == key:
                    continue
                for kind, via in sorted(blk[g].items()):
                    dk = (fs.module, cs.line, kind)
                    if dk in seen:
                        continue
                    seen.add(dk)
                    yield self.finding(
                        fs.module,
                        cs.line,
                        f"{fs.qualname} calls {cs.ref} while holding "
                        f"{', '.join(cs.held)}, and the callee reaches a "
                        f"blocking {kind} ({_blk_chain(db, g, kind)}){tag}",
                        severity=sev,
                    )


def _blk_chain(db: SummaryDB, key: str, kind: str, depth: int = 8) -> str:
    blk = db.blocking_closure()
    parts: List[str] = []
    k = key
    for _ in range(depth):
        via = blk.get(k, {}).get(kind)
        if via is None:
            break
        fs = db.funcs[k]
        if via[0] == "direct":
            parts.append(f"{fs.qualname} ({fs.module}:{via[1]} {via[2]})")
            return " -> ".join(parts)
        parts.append(f"{fs.qualname} ({fs.module}:{via[2]})")
        k = via[1]
    parts.append("...")
    return " -> ".join(parts)


class ThreadLifecyclePass(ConcurrencyPass):
    name = "thread-lifecycle"
    description = (
        "every Thread must be daemon=True or provably joined by its "
        "owning class/function; every Event/Condition wait under a lock "
        "must carry a timeout (a stuck peer must not wedge teardown)"
    )

    def run(self, db: SummaryDB, golden: Optional[Set[str]]) -> Iterable[Finding]:
        # class-wide join/daemon-set inventory: self._t joined in close()
        # clears the ctor finding in __init__
        cls_joins: Dict[Tuple[str, str], Set[str]] = {}
        cls_daemon: Dict[Tuple[str, str], Set[str]] = {}
        for fs in db.funcs.values():
            if fs.cls is None:
                continue
            ck = (fs.modstem, fs.cls)
            cls_joins.setdefault(ck, set()).update(fs.joins)
            cls_daemon.setdefault(ck, set()).update(fs.daemon_sets)
        for key, fs in sorted(db.funcs.items()):
            ck = (fs.modstem, fs.cls or "")
            for t in fs.threads:
                if t.daemon is True:
                    continue
                bind = t.bind
                if bind is not None:
                    joined = bind in fs.joins or bind in cls_joins.get(ck, ())
                    daemonized = bind in fs.daemon_sets or bind in cls_daemon.get(
                        ck, ()
                    )
                    if joined or daemonized:
                        continue
                yield self.finding(
                    fs.module,
                    t.line,
                    f"{fs.qualname} starts a thread that is neither "
                    "daemon=True nor joined on any path of its owning "
                    f"{'class' if fs.cls else 'function'} — a non-daemon "
                    "thread with no join blocks interpreter exit",
                )
            for w in fs.waits:
                if not w.held:
                    continue
                yield self.finding(
                    fs.module,
                    w.line,
                    f"{fs.qualname} calls {w.recv}.wait() with no timeout "
                    f"while holding {', '.join(w.held)} — a missed notify "
                    "wedges this thread (and teardown) forever; use "
                    "wait(timeout=...) in a predicate loop",
                )


ALL_CONCURRENCY_PASSES: Tuple[ConcurrencyPass, ...] = (
    LockOrderCyclePass(),
    LockOrderNewEdgePass(),
    BlockingUnderLockPass(),
    ThreadLifecyclePass(),
)
