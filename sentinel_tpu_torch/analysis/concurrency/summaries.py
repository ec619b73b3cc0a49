"""Per-function lock summaries + interprocedural propagation — the data
layer of the tier-3 concurrency analyzer.

Tier 1 looks at one statement, tier 2 at one traced program; neither can
see that ``ShardedTokenClient._call`` holds ``probe_lock`` while
``ClusterTokenClient.request_token`` five frames down blocks on a socket.
This module builds what that judgment needs:

* a :class:`FuncSummary` per function/method — locks acquired (``with``
  and ``.acquire()``), calls made and which locks were held at each call
  site, direct blocking operations, timeout-less waits, thread
  creations/joins;
* a package-wide :class:`SummaryDB` that resolves call references across
  modules (heuristically — see :meth:`SummaryDB.resolve_call`) and runs
  the fixpoint closures the passes consume: *locks transitively acquired
  under f*, *blocking ops transitively reachable from f*, and the global
  held→acquired **lock-order edge set** with reconstructable acquisition
  stacks.

Lock identity is *syntactic but canonicalized*:

* ``self._lock`` in class ``C`` of ``cluster/shard.py`` →
  ``cluster.shard.C._lock`` — every instance of the class maps to one
  graph node (instance-level aliasing is deliberately collapsed: the
  ordering discipline we enforce is per-class, and the runtime witness
  (``witness.py``) covers the instance-level residue);
* module global ``_LOCK`` → ``cluster.shard._LOCK``;
* an attribute on a non-``self`` receiver (``st.lock``) resolves through
  the package-wide *created-locks* map (``self.lock = threading.Lock()``
  in exactly one class ⇒ that class owns the identity); an ambiguous
  attribute degrades to a function-scoped identity — conservative in the
  direction of MISSING edges, never of false cycles.

Self-edges (re-acquiring a lock id already held) are excluded from the
order graph: at the class granularity they are usually two *instances*
(legal), and the genuinely fatal same-instance case is exactly what the
runtime witness detects precisely.
"""

from __future__ import annotations

import ast
import os
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, NamedTuple, Optional, Set, Tuple

from sentinel_tpu_torch.analysis import astutil as A
from sentinel_tpu_torch.analysis.framework import (
    ParsedModule,
    iter_py_files,
    parse_module,
)

#: constructors whose result is a lock for ordering purposes (Condition
#: embeds one; Semaphore blocks like one)
LOCK_CTORS = (
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
)

#: functions considered admission/tick roots — blocking reachable from
#: these is an ERROR, elsewhere a WARNING (the severity ranking the
#: blocking-under-lock pass applies)
ADMISSION_ROOTS = frozenset(
    {
        "entry",
        "tick_once",
        "_tick_loop",
        "_resolve_tick",
        "check_batch",
        "submit_acquire",
        "submit_block",
        "request_token",
        "request_token_async",
        "request_token_many",
        "request_token_batch",
        "request_param_token",
        "request_concurrent_token",
        "release_concurrent_token",
        "request_lease",
        "should_rate_limit",
        "_process",
        "_flow_and_reply",
        "_batch_and_reply",
        "decide",
    }
)

#: call tails too generic to resolve by package-wide uniqueness (they
#: shadow stdlib/container methods); self./same-module resolution still
#: applies to them
_COMMON_TAILS = frozenset(
    {
        "get",
        "put",
        "close",
        "stop",
        "start",
        "run",
        "send",
        "recv",
        "connect",
        "acquire",
        "release",
        "join",
        "wait",
        "result",
        "items",
        "values",
        "keys",
        "append",
        "add",
        "update",
        "pop",
        "clear",
        "submit",
        "flush",
        "read",
        "write",
        "open",
        "decode",
        "encode",
        "observe",
        "inc",
        "set",
        "note",
        "copy",
        "reset",
        "info",
    }
)

#: modules whose blocking ops are NOT hazards: the chaos plane's entire
#: purpose is injecting delays/faults (disarmed by a single flag check in
#: production), so its sleeps must not propagate a blocking-under-lock
#: finding to every instrumented call site — the runtime witness plus the
#: runtime.lock.contend failpoint cover injected contention dynamically
BLOCKING_EXEMPT_PREFIXES = ("chaos.",)

#: 'lock' must not match inside 'block' (submit_block, _blocks, ...)
_LOCK_TOKEN_RE = re.compile(r"(?<!b)lock|mutex|guard|(?<![a-z])sem(?![a-z])|cond")


def _is_lockish_name(tail: str) -> bool:
    t = tail.lower()
    return bool(_LOCK_TOKEN_RE.search(t)) or t in ("cv", "_cv") or t.endswith("_cv")


def module_stem(path: str) -> str:
    """'sentinel_tpu_torch/cluster/shard.py' → 'cluster.shard' (stable,
    short node names for the graph, package-relative as the reference's
    are); files outside the package keep their stem."""
    p = path.replace(os.sep, "/")
    for prefix in ("sentinel_tpu_torch/",):
        if p.startswith(prefix):
            p = p[len(prefix):]
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class LockAcq(NamedTuple):
    lock: str  # canonical id
    src: str  # source text identity ('self._lock')
    line: int
    held: Tuple[str, ...]  # canonical ids held at this acquisition
    held_src: Tuple[str, ...]


class CallSite(NamedTuple):
    ref: str  # dotted name as written ('self._foo', 'client.request_token')
    line: int
    held: Tuple[str, ...]
    held_src: Tuple[str, ...]


class BlockOp(NamedTuple):
    kind: str  # 'socket', 'connect', 'sleep', 'future-result', ...
    detail: str  # the call text tail, for messages
    line: int
    held: Tuple[str, ...]


class WaitOp(NamedTuple):
    recv: str  # dotted receiver ('self._cv')
    line: int
    held: Tuple[str, ...]


class ThreadNew(NamedTuple):
    line: int
    daemon: Optional[bool]  # None = not specified at the ctor
    bind: Optional[str]  # dotted assignment target, if any


@dataclass
class FuncSummary:
    """Everything the passes need to know about one function."""

    module: str  # repo-relative path
    modstem: str
    cls: Optional[str]
    name: str
    qualname: str  # 'Class.method' or 'func' (nested: 'outer.<locals>.inner')
    lineno: int
    acquires: List[LockAcq] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    blocking: List[BlockOp] = field(default_factory=list)
    waits: List[WaitOp] = field(default_factory=list)
    threads: List[ThreadNew] = field(default_factory=list)
    joins: List[str] = field(default_factory=list)  # receivers of .join()
    daemon_sets: List[str] = field(default_factory=list)  # 'x.daemon = True'

    @property
    def key(self) -> str:
        return f"{self.modstem}:{self.qualname}"

    def label(self) -> str:
        return f"{self.module}:{self.lineno} {self.qualname}"


# -- blocking-call classification --------------------------------------------

_SOCKET_TAILS = frozenset({"sendall", "recv", "recv_into", "accept"})
_CONNECT_TAILS = frozenset({"connect", "create_connection"})


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


#: the port's device syncs, the counterparts of the reference's
#: ``block_until_ready`` / ``jax.device_get``: the host waits for the card.
#: ``synchronize()``: torch.cuda's own, a stream's or an event's
_SYNC_TAILS = frozenset({"synchronize"})
#: a tensor read back to the host: ``.item()`` / ``.cpu()`` / ``.tolist()``
#: / ``.numpy()`` wait for every launch queued before them.  Matched as a
#: method called with no positional argument (the AST cannot tell a tensor
#: from a numpy array, whose ``.item()`` / ``.tolist()`` cost nothing: a
#: sanctioned host-side call carries a ``# stlint:`` rationale)
_READBACK_TAILS = frozenset({"item", "cpu", "tolist", "numpy"})


def _device_sync(call: ast.Call, name: str) -> Optional[str]:
    """The call's text when it is one of the port's device syncs."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in _SYNC_TAILS or (attr in _READBACK_TAILS and not call.args):
        # a call-rooted receiver (``torch.cuda.current_stream().synchronize()``)
        # has no dotted name
        return name or f"(...).{attr}"
    return None


def classify_blocking(
    call: ast.Call, aliases: Dict[str, str]
) -> Optional[Tuple[str, str]]:
    """(kind, detail) when ``call`` is a blocking operation, else None.

    Unbounded-only rules: ``Queue.get`` and ``.wait`` count only without
    a timeout (``waits`` are collected separately by the scanner — the
    thread-lifecycle pass owns them).  ``Future.result``/``Thread.join``/
    socket ops/``sleep``/device syncs count regardless of timeout: a
    bounded stall under a lock still serializes the admission path for
    the full bound.
    """
    resolved = A.resolve_call(call, aliases) or ""
    name = A.dotted_name(call.func) or ""
    tail = name.rsplit(".", 1)[-1]
    recv = name.rsplit(".", 1)[0] if "." in name else ""
    if resolved == "time.sleep" or tail == "sleep":
        return ("sleep", name)
    if resolved in ("socket.create_connection",) or tail in _CONNECT_TAILS:
        return ("connect", name)
    if tail in _SOCKET_TAILS:
        return ("socket", name)
    sync = _device_sync(call, name)
    if sync is not None:
        return ("device-sync", sync)
    if tail == "result":
        return ("future-result", name)
    if tail == "join" and not call.args:
        # zero-positional join = thread join (str.join always has an arg)
        return ("thread-join", name)
    if tail == "get":
        last = recv.rsplit(".", 1)[-1].lower()
        queueish = "queue" in last or last in ("q", "_q") or last.endswith("_q")
        if queueish and _kw(call, "timeout") is None:
            block_kw = _kw(call, "block")
            if isinstance(block_kw, ast.Constant) and block_kw.value is False:
                return None
            if call.args and isinstance(call.args[0], ast.Constant) and call.args[0].value is False:
                return None
            return ("queue-get", name)
    return None


# -- the per-function scanner ------------------------------------------------


class _Scanner(ast.NodeVisitor):
    """Walk one function body tracking the held-lock stack.

    ``with lock:`` brackets exactly; bare ``.acquire()``/``.release()``
    pairs are tracked in source order (the acquire pushes, the matching
    release pops) — an approximation that matches the repo's
    acquire-try-finally-release idiom.
    """

    def __init__(self, fs: FuncSummary, canon, aliases, created_attrs, mod=None):
        self.fs = fs
        self.canon = canon  # callable: (dotted src name) -> canonical id or None
        self.aliases = aliases
        self.created_attrs = created_attrs
        self.mod = mod  # ParsedModule, for source-site suppressions
        self.held: List[Tuple[str, str]] = []  # (canon, src)
        self._consumed: Set[int] = set()
        self._assign_bind: Optional[str] = None
        self._loop_aliases: Dict[str, str] = {}  # loop var -> iterated name

    # nested defs are scanned separately by the DB builder
    def visit_FunctionDef(self, node):  # noqa: N802
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _held_tuple(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        return tuple(h[0] for h in self.held), tuple(h[1] for h in self.held)

    def _lock_of(self, expr: ast.AST) -> Optional[Tuple[str, str]]:
        """(canonical, source) identity of a lock expression, or None."""
        name = A.dotted_name(expr)
        if name is None:
            # call-rooted: `with self._lock_for(x):` — take the func's name
            if isinstance(expr, ast.Call):
                name = A.dotted_name(expr.func)
            if name is None:
                return None
        tail = name.rsplit(".", 1)[-1]
        if not (_is_lockish_name(tail) or self._is_created(name)):
            return None
        canon = self.canon(name)
        if canon is None:
            return None
        return canon, name

    def _is_created(self, dotted: str) -> bool:
        tail = dotted.rsplit(".", 1)[-1]
        return tail in self.created_attrs

    def visit_With(self, node):  # noqa: N802
        pushed = 0
        for item in node.items:
            lk = self._lock_of(item.context_expr)
            if lk is not None:
                held, held_src = self._held_tuple()
                self.fs.acquires.append(
                    LockAcq(lk[0], lk[1], item.context_expr.lineno, held, held_src)
                )
                self.held.append(lk)
                pushed += 1
        self.generic_visit(node)
        if pushed:
            del self.held[-pushed:]

    visit_AsyncWith = visit_With

    def visit_Assign(self, node):  # noqa: N802
        # thread ctor bound to a name: record the binding for lifecycle
        if isinstance(node.value, ast.Call) and self._is_thread_ctor(node.value):
            bind = A.dotted_name(node.targets[0]) if len(node.targets) == 1 else None
            self._record_thread(node.value, bind)
            self._consumed.add(id(node.value))
        # `t.daemon = True` after creation counts as daemonizing
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and t.attr == "daemon"
                and isinstance(node.value, ast.Constant)
                and node.value.value is True
            ):
                owner = A.dotted_name(t.value)
                if owner:
                    self.fs.daemon_sets.append(owner)
        prev = self._assign_bind
        if len(node.targets) == 1:
            self._assign_bind = A.dotted_name(node.targets[0])
        self.generic_visit(node)
        self._assign_bind = prev

    def visit_For(self, node):  # noqa: N802
        # `for h in hops:` — joins on the loop var belong to the list
        if isinstance(node.target, ast.Name) and isinstance(node.iter, ast.Name):
            self._loop_aliases[node.target.id] = node.iter.id
        self.generic_visit(node)

    def _is_thread_ctor(self, call: ast.Call) -> bool:
        return A.resolve_call(call, self.aliases) == "threading.Thread"

    def _record_thread(self, call: ast.Call, bind: Optional[str]) -> None:
        daemon: Optional[bool] = None
        d = _kw(call, "daemon")
        if isinstance(d, ast.Constant):
            daemon = bool(d.value)
        elif d is not None:
            daemon = None  # computed — treated as unproven
        self.fs.threads.append(ThreadNew(call.lineno, daemon, bind))

    def visit_Call(self, node):  # noqa: N802
        name = A.dotted_name(node.func) or ""
        tail = name.rsplit(".", 1)[-1] if name else ""

        if id(node) not in self._consumed and self._is_thread_ctor(node):
            self._record_thread(node, self._assign_bind)
        elif tail == "acquire" and "." in name:
            lk = self._lock_of(node.func.value)
            if lk is not None:
                held, held_src = self._held_tuple()
                self.fs.acquires.append(
                    LockAcq(lk[0], lk[1], node.lineno, held, held_src)
                )
                self.held.append(lk)
        elif tail == "release" and "." in name:
            lk = self._lock_of(node.func.value)
            if lk is not None and lk in self.held:
                self.held.remove(lk)
        elif tail == "join" and not node.args and "." in name:
            recv = name.rsplit(".", 1)[0]
            recv = self._loop_aliases.get(recv, recv)
            self.fs.joins.append(recv)
        if tail == "wait" and not node.args and _kw(node, "timeout") is None and "." in name:
            recv = name.rsplit(".", 1)[0]
            held, _ = self._held_tuple()
            self.fs.waits.append(WaitOp(recv, node.lineno, held))

        if not self.fs.modstem.startswith(BLOCKING_EXEMPT_PREFIXES):
            blk = classify_blocking(node, self.aliases)
            # a `# stlint: disable=blocking-under-lock` ON the blocking
            # call itself removes the op from the summary entirely: the
            # sanctioned block must not re-surface at every transitive
            # caller (suppressing the rule at a CALL site, by contrast,
            # only silences that one path)
            if blk is not None and not (
                self.mod is not None
                and self.mod.suppressed(
                    "blocking-under-lock",
                    node.lineno,
                    getattr(node, "end_lineno", 0) or 0,
                )
            ):
                held, _ = self._held_tuple()
                self.fs.blocking.append(BlockOp(blk[0], blk[1], node.lineno, held))

        if name and tail not in ("acquire", "release") and not self._external(name):
            held, held_src = self._held_tuple()
            self.fs.calls.append(CallSite(name, node.lineno, held, held_src))
        self.generic_visit(node)

    def _external(self, dotted: str) -> bool:
        """True when the call root is an imported module outside the port
        (``os.path.exists`` must never resolve to a package-wide def that
        happens to share the ``exists`` tail)."""
        origin = self.aliases.get(dotted.partition(".")[0])
        return origin is not None and not origin.startswith("sentinel_tpu_torch")


# -- the package database ----------------------------------------------------


class EdgeSite(NamedTuple):
    module: str
    line: int
    func: str  # qualname of the function holding the outer lock
    chain: str  # human-readable acquisition stack


class SummaryDB:
    """Summaries + call resolution + closures over one root set."""

    def __init__(self) -> None:
        self.modules: Dict[str, ParsedModule] = {}  # relpath -> module
        self.funcs: Dict[str, FuncSummary] = {}
        self.by_tail: Dict[str, List[str]] = {}  # bare name -> [keys]
        #: attr -> {(modstem, Class)} where `self.attr = threading.Lock()`
        self.created_attrs: Dict[str, Set[Tuple[str, str]]] = {}
        #: module-level lock globals: (modstem, NAME)
        self.created_globals: Set[Tuple[str, str]] = set()
        #: (relpath, line) -> canonical id, for the runtime witness
        self.creation_sites: Dict[Tuple[str, int], str] = {}
        self._acq: Optional[Dict[str, Dict[str, tuple]]] = None
        self._blk: Optional[Dict[str, Dict[str, tuple]]] = None
        self._resolve_cache: Dict[Tuple[str, str, Optional[str]], Optional[str]] = {}
        self._admission: Optional[Set[str]] = None

    # -- construction --------------------------------------------------------

    def _scan_creations(self, mod: ParsedModule) -> None:
        stem = module_stem(mod.path)
        aliases = A.import_aliases(mod.tree)

        def is_lock_ctor(v: ast.AST) -> bool:
            return isinstance(v, ast.Call) and A.resolve_call(v, aliases) in LOCK_CTORS

        # module-level globals
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and is_lock_ctor(stmt.value):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.created_globals.add((stem, t.id))
                        self.creation_sites[(mod.path, stmt.lineno)] = f"{stem}.{t.id}"
        # self.attr = threading.Lock() inside class methods
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for node in ast.walk(cls):
                if not (isinstance(node, ast.Assign) and is_lock_ctor(node.value)):
                    continue
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        self.created_attrs.setdefault(t.attr, set()).add(
                            (stem, cls.name)
                        )
                        self.creation_sites[(mod.path, node.lineno)] = (
                            f"{stem}.{cls.name}.{t.attr}"
                        )

    def _canonicalizer(self, mod: ParsedModule, cls: Optional[str], qual: str):
        stem = module_stem(mod.path)

        def canon(dotted: str) -> Optional[str]:
            head, _, rest = dotted.partition(".")
            tail = dotted.rsplit(".", 1)[-1]
            if head == "self" and rest:
                owner = cls or qual
                return f"{stem}.{owner}.{rest}"
            if "." not in dotted:
                # bare name: a module global (created here or lockish by name)
                return f"{stem}.{dotted}"
            if head == "cls" and rest:
                owner = cls or qual
                return f"{stem}.{owner}.{rest}"
            # non-self receiver: resolve through the created-locks map
            owners = self.created_attrs.get(tail, set())
            if len(owners) == 1:
                om, oc = next(iter(owners))
                return f"{om}.{oc}.{tail}"
            # ambiguous/unknown — function-scoped identity (distinct node;
            # misses cross-function edges rather than inventing them)
            return f"{stem}.{qual}.{dotted}"

        return canon

    def _scan_functions(self, mod: ParsedModule) -> None:
        stem = module_stem(mod.path)
        aliases = A.import_aliases(mod.tree)
        created = set(self.created_attrs) | {
            n for (_, n) in self.created_globals
        }

        def scan(fn: ast.AST, cls: Optional[str], prefix: str) -> None:
            qual = f"{prefix}{fn.name}"
            fs = FuncSummary(
                module=mod.path,
                modstem=stem,
                cls=cls,
                name=fn.name,
                qualname=qual,
                lineno=fn.lineno,
            )
            sc = _Scanner(
                fs, self._canonicalizer(mod, cls, qual), aliases, created, mod
            )
            for stmt in fn.body:
                sc.visit(stmt)
            self.funcs[fs.key] = fs
            self.by_tail.setdefault(fn.name, []).append(fs.key)
            # recurse into directly nested defs (closures, thread targets)
            for inner in _direct_nested_defs(fn):
                scan(inner, cls, f"{qual}.<locals>.")

        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(stmt, None, "")
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        scan(sub, stmt.name, f"{stmt.name}.")

    # -- call resolution -----------------------------------------------------

    def resolve_call(self, caller: FuncSummary, ref: str) -> Optional[str]:
        """Heuristic target of ``ref`` as written inside ``caller``:

        1. ``self.X`` / ``cls.X`` → method X of the caller's class;
        2. bare ``X`` → same-module function X, else nested sibling;
        3. anything else → the UNIQUE package-wide def named X, unless X
           is a stdlib-shadowed common tail (``get``, ``close``, ...).

        Virtual dispatch, aliasing through variables, and ambiguous names
        resolve to None — the closures under-approximate, matching the
        linter's contract (the runtime witness covers the residue).
        """
        ck = (caller.key, ref, caller.cls)
        if ck in self._resolve_cache:
            return self._resolve_cache[ck]
        out = self._resolve_uncached(caller, ref)
        self._resolve_cache[ck] = out
        return out

    def _resolve_uncached(self, caller: FuncSummary, ref: str) -> Optional[str]:
        head, _, rest = ref.partition(".")
        tail = ref.rsplit(".", 1)[-1]
        if head in ("self", "cls") and rest and "." not in rest:
            if caller.cls:
                k = f"{caller.modstem}:{caller.cls}.{rest}"
                if k in self.funcs:
                    return k
            return None
        if "." not in ref:
            k = f"{caller.modstem}:{ref}"
            if k in self.funcs:
                return k
            # nested sibling / own nested def
            k2 = f"{caller.modstem}:{caller.qualname}.<locals>.{ref}"
            if k2 in self.funcs:
                return k2
        if tail in _COMMON_TAILS:
            return None
        cands = [
            k
            for k in self.by_tail.get(tail, ())
            if "<locals>" not in k
        ]
        if len(cands) == 1:
            return cands[0]
        return None

    # -- closures ------------------------------------------------------------

    def acq_closure(self) -> Dict[str, Dict[str, tuple]]:
        """key -> {lock: via} where via is ('direct', line) or
        ('call', callee_key, line) — locks transitively acquired when the
        function runs."""
        if self._acq is not None:
            return self._acq
        acq: Dict[str, Dict[str, tuple]] = {}
        for k, fs in self.funcs.items():
            d: Dict[str, tuple] = {}
            for a in fs.acquires:
                d.setdefault(a.lock, ("direct", a.line))
            acq[k] = d
        changed = True
        while changed:
            changed = False
            for k, fs in self.funcs.items():
                mine = acq[k]
                for cs in fs.calls:
                    g = self.resolve_call(fs, cs.ref)
                    if g is None or g == k:
                        continue
                    for lock in acq[g]:
                        if lock not in mine:
                            mine[lock] = ("call", g, cs.line)
                            changed = True
        self._acq = acq
        return acq

    def blocking_closure(self) -> Dict[str, Dict[str, tuple]]:
        """key -> {kind: via} for blocking ops transitively reachable."""
        if self._blk is not None:
            return self._blk
        blk: Dict[str, Dict[str, tuple]] = {}
        for k, fs in self.funcs.items():
            d: Dict[str, tuple] = {}
            for b in fs.blocking:
                d.setdefault(b.kind, ("direct", b.line, b.detail))
            blk[k] = d
        changed = True
        while changed:
            changed = False
            for k, fs in self.funcs.items():
                mine = blk[k]
                for cs in fs.calls:
                    g = self.resolve_call(fs, cs.ref)
                    if g is None or g == k:
                        continue
                    for kind in blk[g]:
                        if kind not in mine:
                            mine[kind] = ("call", g, cs.line)
                            changed = True
        self._blk = blk
        return blk

    def admission_reachable(self) -> Set[str]:
        """Function keys reachable from any ADMISSION_ROOTS-named def
        (forward call closure — 'this code can run on an admission/tick
        frame')."""
        if self._admission is not None:
            return self._admission
        seen: Set[str] = set()
        frontier = [k for k, fs in self.funcs.items() if fs.name in ADMISSION_ROOTS]
        while frontier:
            k = frontier.pop()
            if k in seen:
                continue
            seen.add(k)
            fs = self.funcs[k]
            for cs in fs.calls:
                g = self.resolve_call(fs, cs.ref)
                if g is not None and g not in seen:
                    frontier.append(g)
        self._admission = seen
        return seen

    def chain(self, key: str, lock: str, depth: int = 8) -> str:
        """Readable acquisition path: f → g → acquires L (module:line)."""
        acq = self.acq_closure()
        parts: List[str] = []
        k = key
        for _ in range(depth):
            via = acq.get(k, {}).get(lock)
            if via is None:
                break
            fs = self.funcs[k]
            if via[0] == "direct":
                parts.append(f"{fs.qualname} acquires {lock} ({fs.module}:{via[1]})")
                return " -> ".join(parts)
            parts.append(f"{fs.qualname} ({fs.module}:{via[2]})")
            k = via[1]
        parts.append(f"... acquires {lock}")
        return " -> ".join(parts)

    def lock_edges(self) -> Dict[Tuple[str, str], List[EdgeSite]]:
        """The global held→acquired graph with one EdgeSite per origin."""
        acq = self.acq_closure()
        edges: Dict[Tuple[str, str], List[EdgeSite]] = {}

        def add(src: str, dst: str, site: EdgeSite) -> None:
            if src == dst:
                return  # instance-ambiguous self-edge (see module docstring)
            edges.setdefault((src, dst), []).append(site)

        for k, fs in self.funcs.items():
            for a in fs.acquires:
                for held in a.held:
                    add(
                        held,
                        a.lock,
                        EdgeSite(
                            fs.module,
                            a.line,
                            fs.qualname,
                            f"{fs.qualname} holds {held}, acquires {a.lock} "
                            f"({fs.module}:{a.line})",
                        ),
                    )
            for cs in fs.calls:
                if not cs.held:
                    continue
                g = self.resolve_call(fs, cs.ref)
                if g is None or g == k:
                    continue
                for lock in acq[g]:
                    for held in cs.held:
                        add(
                            held,
                            lock,
                            EdgeSite(
                                fs.module,
                                cs.line,
                                fs.qualname,
                                f"{fs.qualname} holds {held} "
                                f"({fs.module}:{cs.line}) -> "
                                + self.chain(g, lock),
                            ),
                        )
        return edges


def _direct_nested_defs(fn: ast.AST) -> List[ast.AST]:
    """Defs nested anywhere inside ``fn`` (excluding ``fn`` itself and
    defs inside deeper defs — those recurse)."""
    out: List[ast.AST] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(child)
            else:
                walk(child)

    walk(fn)
    return out


# -- builders ----------------------------------------------------------------

#: serializes cache population — the CLI's --jobs mode runs tiers on
#: threads, and the witness + tier-1 upgrade share these caches too
_CACHE_LOCK = threading.Lock()
_DB_CACHE: Dict[Tuple[str, ...], SummaryDB] = {}


def build_db(roots: Iterable[str], rel_to: str, cached: bool = True) -> SummaryDB:
    roots = tuple(os.path.abspath(r) for r in roots)
    with _CACHE_LOCK:
        if cached and roots in _DB_CACHE:
            return _DB_CACHE[roots]
    db = SummaryDB()
    for root in roots:
        for abspath in iter_py_files(root):
            mod = parse_module(abspath, rel_to)
            if mod is None:
                continue
            db.modules[mod.path] = mod
            db._scan_creations(mod)
    for mod in db.modules.values():
        db._scan_functions(mod)
    if cached:
        with _CACHE_LOCK:
            _DB_CACHE[roots] = db
    return db


def invalidate_cache() -> None:
    with _CACHE_LOCK:
        _DB_CACHE.clear()
        _MOD_ENTRY_CACHE.clear()


# -- tier-1 consumption: locks held at function entry ------------------------

_MOD_ENTRY_CACHE: Dict[int, Dict[str, FrozenSet[str]]] = {}


def module_entry_locks(mod: ParsedModule) -> Dict[str, FrozenSet[str]]:
    """For each *private* function of one module: the source-name lockset
    provably held at EVERY known call site (the tier-1 `unguarded-global`
    upgrade: a helper whose callers all hold ``_LOCK`` inherits it, so
    ``with _LOCK: _store(k)`` no longer reports the helper's write as
    unguarded, and helper writes join the callers' lockset for the
    consistency check).

    Intersection semantics over (site-held ∪ caller-entry) with a fixpoint
    for helper-calls-helper chains; public (non-underscore) functions get
    the empty set — external callers are unknowable, so inheritance would
    be unsound for them.
    """
    cid = id(mod.tree)
    with _CACHE_LOCK:
        if cid in _MOD_ENTRY_CACHE:
            return _MOD_ENTRY_CACHE[cid]
    # build a throwaway single-module DB in SOURCE-name space: identity
    # canonicalizer keeps `self._lock` / `_LOCK` spelled as written, so
    # the result intersects directly with tier-1 site locksets
    db = SummaryDB()
    db.modules[mod.path] = mod
    db._scan_creations(mod)
    real_canon = db._canonicalizer

    def src_canon(m, cls, qual):
        return lambda dotted: dotted

    db._canonicalizer = src_canon  # type: ignore[assignment]
    db._scan_functions(mod)
    db._canonicalizer = real_canon  # type: ignore[assignment]

    TOP = None  # lattice top: 'no call site seen yet'
    entry: Dict[str, Optional[FrozenSet[str]]] = {
        k: TOP for k in db.funcs
    }
    # callers per key
    for _ in range(len(db.funcs) + 2):
        changed = False
        for k, fs in db.funcs.items():
            for cs in fs.calls:
                g = db.resolve_call(fs, cs.ref)
                if g is None or g == k:
                    continue
                incoming = frozenset(cs.held_src) | (
                    entry[fs.key] or frozenset()
                )
                cur = entry[g]
                new = incoming if cur is None else (cur & incoming)
                if new != cur:
                    entry[g] = new
                    changed = True
        if not changed:
            break
    out: Dict[str, FrozenSet[str]] = {}
    for k, fs in db.funcs.items():
        locks = entry[k]
        if locks and fs.name.startswith("_"):
            # same bare name in two scopes (methods of different classes):
            # keep only what BOTH inherit — tier-1 consumes by bare name
            prev = out.get(fs.name)
            out[fs.name] = (
                frozenset(locks) if prev is None else prev & frozenset(locks)
            )
    out = {n: ls for n, ls in out.items() if ls}
    with _CACHE_LOCK:
        _MOD_ENTRY_CACHE[cid] = out
    return out
