"""jit-recompile: what makes the tick's binding cache miss on the steady path.

The port of ``sentinel_tpu/analysis/passes/jit_recompile.py``, by
intent.  The reference flags the patterns that recompile a ``jax.jit``
program or bake stale values into it.  The port runs eagerly: its
counterpart of the compiled-tick cache is ``ops/engine.make_tick``, one
binding per ``(cfg, features)`` key under a lock.  A miss there is the
port's "retrace": it builds a binding, counts
``sentinel_engine_tick_builds_total`` and journals a retrace in
``obs/profile.RETRACE`` — a surprise one on the steady path, which an
operator reads as config churn.  And a tick that reads state outside its
key serves whatever that state held, whatever binding it runs under.

Four hazard shapes:

1. A tick bound outside the cache per call: ``functools.partial(...tick,
   ...)`` invoked at its own call site, or built inside a loop or a
   comprehension.  Each is a binding the cache never sees.
2. ``make_tick(...)`` inside a loop with a key built in the loop (a call
   in its arguments, such as ``dataclasses.replace(cfg, ...)``; a
   ``frozenset`` / ``tuple`` of equal parts is equal each time): every
   iteration may miss.
3. A cache key built from a mutable value: a list, dict or set (display,
   comprehension or constructor) in ``make_tick``'s arguments or in the
   key of a module-level ``*CACHE*`` / ``*PLANS*`` dict read.  It is
   unhashable, or hashes by identity, so equal keys miss.
4. The tick's closure (``tick`` and its same-module callees, in a module
   that defines ``make_tick``) reading a module-level mutable container:
   its value is not part of the key, so two calls under one binding can
   decide differently.
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

from sentinel_tpu_torch.analysis import astutil as A
from sentinel_tpu_torch.analysis.framework import ERROR, Finding, ParsedModule, Pass

_PARTIAL = {"functools.partial", "partial"}
_MUTABLE_CALLS = {"list", "dict", "set", "bytearray"}
#: calls that build a frozen value, equal each time from equal parts
_FROZEN_CALLS = {"frozenset", "tuple"}
_MUTABLE_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)
_CACHEISH = ("CACHE", "PLANS")
_LOOPS = (ast.For, ast.While, ast.AsyncFor, ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _is_tick_ref(node: ast.AST) -> bool:
    name = A.dotted_name(node) or ""
    return name.rsplit(".", 1)[-1] == "tick"


def _is_tick_partial(call: ast.AST, aliases) -> bool:
    return (
        isinstance(call, ast.Call)
        and A.resolve_call(call, aliases) in _PARTIAL
        and bool(call.args)
        and _is_tick_ref(call.args[0])
    )


def _is_make_tick(call: ast.AST) -> bool:
    return isinstance(call, ast.Call) and (A.dotted_name(call.func) or "").rsplit(".", 1)[-1] == "make_tick"


def _mutable_in(expr: ast.AST) -> bool:
    """True when the key expression holds a mutable value (a display, a
    comprehension or a constructor call) outside a frozen constructor."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
        if expr.func.id in _FROZEN_CALLS:
            return False
        if expr.func.id in _MUTABLE_CALLS:
            return True
    if isinstance(expr, _MUTABLE_NODES):
        return True
    return any(_mutable_in(c) for c in ast.iter_child_nodes(expr))


def _call_args(call: ast.Call):
    return list(call.args) + [k.value for k in call.keywords]


class JitRecompilePass(Pass):
    name = "jit-recompile"
    description = "tick bindings built outside make_tick's cache, churning or mutable cache keys, and state the tick reads outside its key"
    severity = ERROR

    def run(self, mod: ParsedModule) -> Iterable[Finding]:
        aliases = A.import_aliases(mod.tree)
        reported: Set[int] = set()

        # 1a. a tick partial invoked at its own call site
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and _is_tick_partial(node.func, aliases):
                reported.add(id(node.func))
                yield self.finding(
                    mod,
                    node,
                    "functools.partial(tick, ...) invoked at its own call "
                    "site — a tick binding built on every call, outside "
                    "make_tick's cache; bind once with ops.engine.make_tick "
                    "and reuse the callable",
                )

        # 1b / 2. bindings and churning keys inside loops
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, _LOOPS):
                continue
            for node in ast.walk(loop):
                if id(node) in reported:
                    continue
                if _is_tick_partial(node, aliases):
                    reported.add(id(node))
                    yield self.finding(
                        mod,
                        node,
                        "functools.partial(tick, ...) inside a loop — each "
                        "iteration builds a binding make_tick's cache never "
                        "sees; hoist it, or bind through make_tick",
                    )
                elif _is_make_tick(node) and any(
                    isinstance(n, ast.Call) and not (isinstance(n.func, ast.Name) and n.func.id in _FROZEN_CALLS)
                    for a in _call_args(node)
                    for n in ast.walk(a)
                ):
                    reported.add(id(node))
                    yield self.finding(
                        mod,
                        node,
                        "make_tick(...) inside a loop with a key built in "
                        "the loop — every iteration can miss the tick cache "
                        "(a surprise retrace each); build the key once "
                        "outside the loop",
                    )

        # 3. cache keys from mutable values
        mutables = A.module_mutables(mod.tree)
        caches = {m for m in mutables if any(t in m.upper() for t in _CACHEISH)}
        for node in ast.walk(mod.tree):
            key = None
            if _is_make_tick(node):
                key = next((a for a in _call_args(node) if _mutable_in(a)), None)
            elif isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and node.value.id in caches:
                key = node.slice if _mutable_in(node.slice) else None
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("get", "setdefault")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in caches
                and node.args
                and _mutable_in(node.args[0])
            ):
                key = node.args[0]
            if key is not None:
                yield self.finding(
                    mod,
                    node,
                    "cache key built from a mutable value (list / dict / "
                    "set) — unhashable, or hashed by identity so equal keys "
                    "miss; key the cache on frozen values (a frozen config, "
                    "a frozenset of features)",
                )

        # 4. module-level mutables read inside the tick's closure
        defs = A.func_defs(mod.tree)
        if "make_tick" not in defs or "tick" not in defs:
            return
        for fname, fn in sorted(A.reachable_funcs(mod.tree, {"tick"}).items()):
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) and node.id in mutables:
                    yield self.finding(
                        mod,
                        node,
                        f"the tick's closure ('{fname}') reads module-level "
                        f"mutable '{node.id}' — it is not part of make_tick's "
                        "(cfg, features) key, so one binding can decide "
                        "differently call to call; pass it as an argument "
                        "or make it immutable",
                    )
