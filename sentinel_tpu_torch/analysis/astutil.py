"""Shared AST helpers for the hazard passes.

The port's copy of ``sentinel_tpu/analysis/astutil.py`` (pure ``ast``
work: it reads Python source and imports nothing of either package).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> canonical dotted origin, for module-level imports.

    ``import time as _time`` -> {'_time': 'time'};
    ``from time import monotonic as mono`` -> {'mono': 'time.monotonic'};
    ``import jax.numpy as jnp`` -> {'jnp': 'jax.numpy'}.
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def resolve_call(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """Canonical dotted name of a call target, aliases expanded.

    ``_time.monotonic()`` -> 'time.monotonic' when _time aliases time;
    ``mono()`` -> 'time.monotonic' when mono was from-imported.
    """
    name = dotted_name(node.func)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    origin = aliases.get(head)
    if origin is None:
        return name
    return f"{origin}.{rest}" if rest else origin


def func_defs(tree: ast.Module) -> Dict[str, ast.AST]:
    """name -> innermost def for every function/method in the module.

    Nested/duplicate names keep the LAST definition — fine for the
    call-graph heuristics here (same-module reachability, not a real
    resolver)."""
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def called_names(fn: ast.AST) -> Set[str]:
    """Names this function calls, as bare tails: ``self._foo()`` and
    ``_foo()`` both yield '_foo' (same-module resolution heuristic);
    functions passed as values (``Thread(target=self._foo)``,
    ``pool.submit(self._foo)``) count too — they run on behalf of the
    caller."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name:
                out.add(name.rsplit(".", 1)[-1])
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                ref = dotted_name(arg)
                if ref and (
                    ref.startswith("self.") or "." not in ref
                ):
                    out.add(ref.rsplit(".", 1)[-1])
    return out


def reachable_funcs(
    tree: ast.Module, roots: Iterable[str]
) -> Dict[str, ast.AST]:
    """Same-module call-graph closure from ``roots`` (by bare name)."""
    defs = func_defs(tree)
    seen: Set[str] = set()
    frontier = [r for r in roots if r in defs]
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        for callee in called_names(defs[name]):
            if callee in defs and callee not in seen:
                frontier.append(callee)
    return {n: defs[n] for n in seen}


def decorator_names(fn: ast.AST, aliases: Dict[str, str]) -> List[str]:
    """Canonical dotted names of a def's decorators; for decorator
    factories (``@partial(jax.jit, ...)``) the FIRST argument's name is
    appended too, so '@partial(jax.jit, static_argnums=...)' yields both
    'functools.partial' and 'jax.jit'."""
    out: List[str] = []
    for dec in getattr(fn, "decorator_list", []):
        if isinstance(dec, ast.Call):
            name = resolve_call(dec, aliases)
            if name:
                out.append(name)
            if dec.args:
                inner = dotted_name(dec.args[0])
                if inner:
                    head, _, rest = inner.partition(".")
                    origin = aliases.get(head, head)
                    out.append(f"{origin}.{rest}" if rest else origin)
        else:
            name = dotted_name(dec)
            if name:
                head, _, rest = name.partition(".")
                origin = aliases.get(head, head)
                out.append(f"{origin}.{rest}" if rest else origin)
    return out


def jitted_root_names(tree: ast.Module, aliases: Dict[str, str]) -> Set[str]:
    """Function names that end up inside ``jax.jit`` in this module.

    Catches the three idioms the codebase uses:
      1. ``@jax.jit`` / ``@partial(jax.jit, ...)`` decorators;
      2. direct ``jax.jit(fn)`` / ``jax.jit(functools.partial(fn, ...))``;
      3. the two-step ``f = functools.partial(fn, ...); f = jax.jit(f)``
         (ops.engine.make_tick), resolved through single-assignment
         locals within one function body.
    """
    roots: Set[str] = set()

    def _is_jit(call: ast.Call) -> bool:
        return resolve_call(call, aliases) in ("jax.jit", "jax.pjit", "jax.pmap")

    def _target_of(node: ast.AST, local_partials: Dict[str, str]) -> Optional[str]:
        """Function name inside a jit argument expression."""
        if isinstance(node, ast.Call):
            name = resolve_call(node, aliases)
            if name in ("functools.partial", "partial") and node.args:
                return dotted_name(node.args[0])
            return None
        ref = dotted_name(node)
        if ref is None:
            return None
        return local_partials.get(ref, ref)

    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for name in decorator_names(fn, aliases):
                if name in ("jax.jit", "jax.pjit", "jax.pmap"):
                    roots.add(fn.name)

    # walk each scope tracking name -> partial(fn) single assignments
    scopes: List[ast.AST] = [tree] + [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for scope in scopes:
        local_partials: Dict[str, str] = {}
        body = scope.body if isinstance(scope, ast.Module) else scope.body
        for stmt in body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                    continue
                tgt = dotted_name(node.targets[0])
                if tgt is None or not isinstance(node.value, ast.Call):
                    continue
                call = node.value
                cname = resolve_call(call, aliases)
                if cname in ("functools.partial", "partial") and call.args:
                    inner = dotted_name(call.args[0])
                    if inner:
                        local_partials[tgt] = inner
                elif _is_jit(call) and call.args:
                    target = _target_of(call.args[0], local_partials)
                    if target:
                        roots.add(target.rsplit(".", 1)[-1])
        for node in ast.walk(scope):
            if isinstance(node, ast.Call) and _is_jit(node) and node.args:
                target = _target_of(node.args[0], local_partials)
                if target:
                    roots.add(target.rsplit(".", 1)[-1])
    return roots


#: constructors whose module-level result is a mutable container
_MUTABLE_CTORS = ("dict", "list", "set", "defaultdict", "deque", "OrderedDict")


def module_mutables(tree: ast.Module) -> Set[str]:
    """Names bound at module level to a mutable container literal or
    constructor — shared by the unguarded-global (lockless registry
    writes) and jit-recompile (trace-stale closures) passes so the two
    detectors can never drift apart."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        mutable = isinstance(value, (ast.Dict, ast.List, ast.Set)) or (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in _MUTABLE_CTORS
        )
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def path_matches(path: str, globs: Iterable[str]) -> bool:
    """fnmatch against repo-relative forward-slash paths."""
    import fnmatch

    return any(fnmatch.fnmatch(path, g) for g in globs)


def handler_reraises(handler: ast.ExceptHandler) -> bool:
    """True when the except body re-raises (at any depth outside nested
    defs) — a re-raising handler cannot swallow a verdict."""
    for node in _walk_body(handler.body):
        if isinstance(node, ast.Raise):
            return True
    return False


def _walk_body(body: List[ast.stmt]):
    """ast.walk over statements, NOT descending into nested defs/lambdas
    (their raises don't execute in the handler)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        for child in ast.iter_child_nodes(node):
            stack.append(child)
