"""unguarded-global: module-level mutable state written without a lock,
or written under INCONSISTENT locks at different sites.

The port's copy of ``sentinel_tpu/analysis/passes/unguarded_global.py``:
the hazard is language-neutral, so the pass is the reference's; its
interprocedural upgrade reads the port's tier-3 summaries.

Registries (rule managers, tick caches, extension lists) live as
module-level dicts/lists and get written from rule-reload threads,
background resize threads, and the serving loop at once.  CPython's GIL
makes a single ``d[k] = v`` atomic, but every real registry write is a
check-then-act (``get`` → compile → ``set``), and unserialized
check-then-act on the tick cache means two threads compiling the same
executable — seconds of duplicated XLA work on the serving path — or a
torn copy-on-write swap.

Two hazard shapes:

1. **lock presence** — any mutation of a module-level mutable container
   (subscript assign/del, ``global X`` rebind, or a mutating method call
   — append / update / pop / setdefault / ...) from inside a function,
   unless the statement sits under a ``with`` whose context expression
   mentions a lock-ish name (lock / mutex / guard / cond / sem).

2. **lockset consistency** — a global whose guarded write sites do NOT
   share at least one common lock.  ``with _LOCK_A: D[k] = v`` in one
   function and ``with _LOCK_B: D.pop(k)`` in another both "hold a
   lock", but they serialize against nothing — the two writes still
   race.  Every guarded site of the disjoint lockset is reported, each
   naming the other sites (the fix is picking ONE owning lock).

Module-level initialization code is exempt (import is single-threaded
per the import lock).  Lock identity is the dotted source name of the
lock expression (``_LOCK``, ``self._lock``) — syntactic, so two names
aliasing one lock object are conservatively treated as different locks.

Interprocedural upgrade (tier 3): a write site's effective lockset is
the locks held AT the site plus the locks provably held at entry to the
enclosing function — the intersection over every known call site, from
``analysis.concurrency.summaries.module_entry_locks``.  A private helper
whose callers all wrap it in ``with _LOCK:`` no longer reports its
writes as unguarded, and those writes join the callers' lockset for the
consistency check instead of being invisible to it.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterable, List, NamedTuple, Set, Tuple

from sentinel_tpu_torch.analysis import astutil as A
from sentinel_tpu_torch.analysis.framework import ERROR, Finding, ParsedModule, Pass

_MUTATORS = {
    "append",
    "extend",
    "insert",
    "remove",
    "pop",
    "popitem",
    "clear",
    "update",
    "setdefault",
    "add",
    "discard",
    "appendleft",
    "__setitem__",
}

_LOCKISH = ("lock", "mutex", "guard", "cond", "sem")


def _lock_name(expr: ast.AST) -> str:
    """Identity of the first lock-ish (sub)expression, or '' if none.

    ``with self._lock:`` -> 'self._lock'; ``with _LOCK.writer():`` ->
    '_LOCK'; a lock reached through a call — ``with registry().lock:`` —
    has no stable dotted name, so its identity degrades to '<expr>.lock'
    (it still COUNTS as a lock, matching the pre-lockset behavior; two
    call-rooted sites with the same attribute name are conservatively
    treated as the same lock rather than flagged).
    """
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            if any(tok in node.id.lower() for tok in _LOCKISH):
                return node.id
        elif isinstance(node, ast.Attribute):
            if any(tok in node.attr.lower() for tok in _LOCKISH):
                return A.dotted_name(node) or f"<expr>.{node.attr}"
    return ""


class _Write(NamedTuple):
    node: ast.AST
    gname: str
    verb: str
    fname: str
    locks: FrozenSet[str]  # dotted names of locks held at the write


class _FuncScanner(ast.NodeVisitor):
    """Walk one function body tracking the enclosing with-lock stack."""

    def __init__(self, mutables, fname, entry_locks: FrozenSet[str] = frozenset()):
        self.mutables = mutables
        self.fname = fname
        self.entry_locks = entry_locks
        self.lock_stack: List[str] = []
        self.writes: List[_Write] = []

    # nested defs get their own scan via the pass driver; don't descend
    def visit_FunctionDef(self, node):  # noqa: N802
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_With(self, node):  # noqa: N802
        names = [n for n in (_lock_name(i.context_expr) for i in node.items) if n]
        self.lock_stack.extend(names)
        self.generic_visit(node)
        if names:
            del self.lock_stack[-len(names):]

    visit_AsyncWith = visit_With

    def _record(self, node, gname: str, verb: str) -> None:
        self.writes.append(
            _Write(
                node,
                gname,
                verb,
                self.fname,
                frozenset(self.lock_stack) | self.entry_locks,
            )
        )

    def visit_Assign(self, node):  # noqa: N802
        for t in node.targets:
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id in self.mutables
            ):
                self._record(node, t.value.id, "written")
        self.generic_visit(node)

    def visit_Delete(self, node):  # noqa: N802
        for t in node.targets:
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id in self.mutables
            ):
                self._record(node, t.value.id, "deleted from")
        self.generic_visit(node)

    def visit_Call(self, node):  # noqa: N802
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _MUTATORS
            and isinstance(f.value, ast.Name)
            and f.value.id in self.mutables
        ):
            self._record(node, f.value.id, f"mutated ({f.attr})")
        self.generic_visit(node)


class _RebindScanner(_FuncScanner):
    def visit_Assign(self, node):  # noqa: N802
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in self.mutables:
                self._record(node, t.id, "rebound (global)")
        self.generic_visit(node)

    def visit_Delete(self, node):  # noqa: N802
        self.generic_visit(node)

    def visit_Call(self, node):  # noqa: N802
        self.generic_visit(node)


class UnguardedGlobalPass(Pass):
    name = "unguarded-global"
    description = (
        "module-level registry writes must hold the owning lock — the SAME "
        "lock at every site"
    )
    severity = ERROR

    def _collect(self, mod: ParsedModule) -> List[_Write]:
        mutables = A.module_mutables(mod.tree)
        if not mutables:
            return []
        # tier-3 summaries: locks provably held at entry to each private
        # helper (intersection over its known call sites)
        from sentinel_tpu_torch.analysis.concurrency.summaries import (
            module_entry_locks,
        )

        entry = module_entry_locks(mod)
        writes: List[_Write] = []
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            declared_global: Set[str] = set()
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Global):
                    declared_global |= {n for n in stmt.names if n in mutables}
            held = entry.get(fn.name, frozenset())
            scanner = _FuncScanner(mutables, fn.name, held)
            for stmt in fn.body:
                scanner.visit(stmt)
            writes.extend(scanner.writes)
            if declared_global:
                rebind = _RebindScanner(declared_global, fn.name, held)
                for stmt in fn.body:
                    rebind.visit(stmt)
                writes.extend(rebind.writes)
        return writes

    def run(self, mod: ParsedModule) -> Iterable[Finding]:
        writes = self._collect(mod)

        # 1. lock presence (per site)
        for w in writes:
            if not w.locks:
                yield self.finding(
                    mod,
                    w.node,
                    f"module-global '{w.gname}' {w.verb} in '{w.fname}' without "
                    "the owning lock — registry writes are check-then-act; "
                    "serialize them (with <lock>:) or suppress with a "
                    "single-threaded rationale",
                )

        # 2. lockset consistency (per global, across sites): every guarded
        # site must share at least one common lock or the sites still race
        by_global: Dict[str, List[_Write]] = {}
        for w in writes:
            if w.locks:
                by_global.setdefault(w.gname, []).append(w)
        for gname, sites in sorted(by_global.items()):
            if len(sites) < 2:
                continue
            common = frozenset.intersection(*(w.locks for w in sites))
            if common:
                continue
            for w in sites:
                others = "; ".join(
                    f"line {o.node.lineno} in '{o.fname}' holds "
                    f"{{{', '.join(sorted(o.locks))}}}"
                    for o in sites
                    if o is not w
                )
                yield self.finding(
                    mod,
                    w.node,
                    f"module-global '{gname}' {w.verb} in '{w.fname}' under "
                    f"{{{', '.join(sorted(w.locks))}}}, but other sites hold "
                    f"different locks ({others}) — disjoint locksets do not "
                    "serialize; pick ONE owning lock for this global",
                )
