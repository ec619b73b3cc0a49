"""fail-open: broad exception swallows inside admission/verdict paths.

The port's copy of ``sentinel_tpu/analysis/passes/fail_open.py``: the
hazard is language-neutral, so the pass is the reference's; its scope
names the port's admission files.

The flow-control contract is FAIL CLOSED: when the engine, the cluster
token path, or a shard transport cannot decide, the item must BLOCK or
degrade to an explicit local-enforcement fallback — never silently PASS.
ADVICE.md round-5 documented exactly this class (an authority-mirror
divergence silently opening an unenforced cluster-limit window), and a
bare ``except Exception: return ...`` in an admission path is the
easiest way to reintroduce it.

Flagged, in admission-path files only: ``except:`` / ``except
Exception`` / ``except BaseException`` handlers that neither re-raise
nor guard a pure-cleanup try body.  Handlers that re-raise can't swallow
a verdict; try bodies that only call close/stop/cancel/join/unlink are
resource cleanup, not decisions.

Deliberate degrade points (the reference's fallbackToLocalOrPass) carry
``# stlint: disable=fail-open`` WITH a rationale — the suppression
comment is the documentation that the lenient behavior is a decision,
not an accident.
"""

from __future__ import annotations

import ast
from typing import Iterable

from sentinel_tpu_torch.analysis import astutil as A
from sentinel_tpu_torch.analysis.framework import ERROR, Finding, ParsedModule, Pass

#: admission / verdict path files (repo-relative globs)
_SCOPE = (
    "*sentinel_tpu_torch/ops/engine*.py",
    "*sentinel_tpu_torch/ops/fused.py",
    "*sentinel_tpu_torch/runtime/client.py",
    "*sentinel_tpu_torch/runtime/slots.py",
    "*sentinel_tpu_torch/cluster/*.py",
    "*sentinel_tpu_torch/parallel/remote_shard.py",
    "*sentinel_tpu_torch/parallel/router.py",
)

_BROAD = {"Exception", "BaseException"}

#: try bodies made only of these calls are cleanup, not admission logic
_CLEANUP_CALLS = {
    "close",
    "stop",
    "cancel",
    "join",
    "shutdown",
    "unlink",
    "flush",
    "terminate",
    "kill",
}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names = []
    if isinstance(t, ast.Tuple):
        names = [A.dotted_name(e) for e in t.elts]
    else:
        names = [A.dotted_name(t)]
    return any(n and n.rsplit(".", 1)[-1] in _BROAD for n in names)


def _cleanup_only(try_body: list) -> bool:
    for stmt in try_body:
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            name = A.dotted_name(stmt.value.func)
            if name and name.rsplit(".", 1)[-1] in _CLEANUP_CALLS:
                continue
        if isinstance(stmt, ast.Pass):
            continue
        return False
    return bool(try_body)


class FailOpenPass(Pass):
    name = "fail-open"
    description = (
        "broad except in an admission path must re-raise, fail closed, or "
        "carry an explicit degrade rationale"
    )
    severity = ERROR

    def run(self, mod: ParsedModule) -> Iterable[Finding]:
        if not A.path_matches(mod.path, _SCOPE):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not _is_broad(handler):
                    continue
                if A.handler_reraises(handler):
                    continue
                if _cleanup_only(node.body):
                    continue
                caught = (
                    A.dotted_name(handler.type) if handler.type else "everything"
                )
                yield self.finding(
                    mod,
                    handler,
                    f"broad except ({caught}) swallows failures on an "
                    "admission path — verdicts must fail closed; re-raise, "
                    "narrow the exception, or suppress with a degrade "
                    "rationale",
                )
