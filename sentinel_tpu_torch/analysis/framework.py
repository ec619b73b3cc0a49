"""AST lint framework for TPU-hazard passes.

The port's copy of ``sentinel_tpu/analysis/framework.py``: the findings,
the parsed modules with their ``# stlint:`` suppression table, the
baseline and the report formats that the port's concurrency tier
(``analysis/concurrency/``) shares with the tier-1 passes.

Sentinel's hot-path correctness discipline — fail-closed verdicts, a
single cached time source, no host↔device sync inside the tick — was
enforced only by convention; this package enforces it structurally at PR
time (the SALSA argument: sketch/kernel correctness must be guarded by
construction, not spot checks).

Pieces:

* :class:`Finding` — one rule violation at a file:line.
* :class:`Pass` — base class; subclasses implement ``run(module)``.
* :class:`ParsedModule` — parsed source + suppression table, shared by
  every pass so each file is read and parsed once.
* suppression comments (pylint-style, but namespaced ``stlint`` so the
  two tools never fight over a comment):

  - ``# stlint: disable=rule-a,rule-b`` — suppress on that line;
  - ``# stlint: disable-next-line=rule`` — suppress on the line below
    (for lines too dense to carry a trailing comment);
  - ``# stlint: disable-file=rule`` — suppress for the whole file.

  A bare ``disable`` / ``disable-file`` with no ``=rules`` suppresses
  every rule (discouraged; spell the rule out so the reader knows what
  hazard was accepted).

* a baseline (``baseline.json``): per ``(rule, path)`` accepted finding
  counts.  The CLI exits non-zero only on findings in EXCESS of the
  baseline, so pre-existing debt can be burned down file by file while
  new violations fail CI immediately.  Keeping the baseline near-empty
  is the goal; suppression comments (which carry an inline rationale)
  are preferred over baseline entries for violations that are accepted
  forever.
"""

from __future__ import annotations

import ast
import io
import json
import os
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: severity levels, ordered — reporters sort errors first
ERROR = "error"
WARNING = "warning"

_SEV_ORDER = {ERROR: 0, WARNING: 1}

_MAGIC = "stlint:"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    col: int
    message: str
    severity: str = ERROR
    #: last source line the finding's anchor statement spans.  Suppression
    #: comments anywhere in [line, end_line] apply — a trailing comment on
    #: the closing paren of a multi-line call, or on the decorator above a
    #: flagged def, suppresses the finding even though the AST node's
    #: lineno points elsewhere.  0 means "just `line`".
    end_line: int = 0

    def key(self) -> Tuple[str, str]:
        """Baseline bucket — line numbers drift across edits, so the
        baseline matches on (rule, path) counts, not exact positions."""
        return (self.rule, self.path)

    def span(self) -> Tuple[int, int]:
        return (self.line, max(self.line, self.end_line))


@dataclass
class ParsedModule:
    """One parsed source file plus its suppression table."""

    path: str  # repo-relative
    abspath: str
    source: str
    tree: ast.Module
    #: line -> set of suppressed rule names ('*' = all)
    line_disables: Dict[int, Set[str]] = field(default_factory=dict)
    #: rules suppressed for the entire file ('*' = all)
    file_disables: Set[str] = field(default_factory=set)

    def suppressed(self, rule: str, line: int, end_line: int = 0) -> bool:
        """True when ``rule`` is disabled on any line of the anchor span
        [line, max(line, end_line)] — multi-line statements accept the
        directive on any of their physical lines (the trailing comment
        naturally lands on the closing paren, not the first line)."""
        if "*" in self.file_disables or rule in self.file_disables:
            return True
        for ln in range(line, max(line, end_line) + 1):
            at = self.line_disables.get(ln, ())
            if "*" in at or rule in at:
                return True
        return False


class Pass:
    """One hazard detector.  Subclasses set ``name``/``description`` and
    implement :meth:`run` returning an iterable of findings (suppression
    filtering happens in the runner — passes stay oblivious to it)."""

    name: str = ""
    description: str = ""
    severity: str = ERROR

    def run(self, mod: ParsedModule) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(
        self,
        mod: ParsedModule,
        node: ast.AST,
        message: str,
        severity: Optional[str] = None,
    ) -> Finding:
        line, end_line = anchor_span(node)
        return Finding(
            rule=self.name,
            path=mod.path,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            severity=severity or self.severity,
            end_line=end_line,
        )


def anchor_span(node: ast.AST) -> Tuple[int, int]:
    """Physical-line span a suppression directive may sit on for a finding
    anchored at ``node``.

    - plain statements/expressions: every line of the node (a trailing
      ``# stlint: disable=`` on the closing paren of a multi-line call
      counts);
    - compound statements (def/if/with/try/for/...): the HEADER only —
      a directive inside the body belongs to the body statement it sits
      on, not to the whole block;
    - decorated defs: decorator lines are part of the header (the
      decorator is usually what the finding is about, e.g. ``@jax.jit``).
    """
    start = getattr(node, "lineno", 1)
    end = getattr(node, "end_lineno", None) or start
    body = getattr(node, "body", None)
    if isinstance(body, list) and body and hasattr(body[0], "lineno"):
        end = max(start, body[0].lineno - 1)
    decorators = getattr(node, "decorator_list", None) or ()
    for d in decorators:
        start = min(start, getattr(d, "lineno", start))
    return start, end


# -- suppression comments ----------------------------------------------------


def _parse_rule_list(spec: str) -> Set[str]:
    spec = spec.strip()
    if not spec:
        return {"*"}
    return {r.strip() for r in spec.split(",") if r.strip()}


def parse_suppressions(source: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """Scan comments for stlint directives.

    Uses tokenize (not regex over lines) so a directive inside a string
    literal is never misread as a comment.
    """
    line_disables: Dict[int, Set[str]] = {}
    file_disables: Set[str] = set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            text = tok.string.lstrip("#").strip()
            # the directive may share the comment with noqa/pragma text:
            # "# noqa: BLE001  # stlint: disable=fail-open — rationale"
            at = text.find(_MAGIC)
            if at < 0:
                continue
            directive = text[at + len(_MAGIC):].strip()
            # split "disable=a,b rationale..." — rationale text after the
            # rule list is encouraged and ignored by the parser
            head = directive.split()[0] if directive.split() else ""
            if head.startswith("disable-file"):
                _, _, spec = head.partition("=")
                file_disables |= _parse_rule_list(spec)
            elif head.startswith("disable-next-line"):
                _, _, spec = head.partition("=")
                rules = _parse_rule_list(spec)
                line_disables.setdefault(tok.start[0] + 1, set()).update(rules)
            elif head.startswith("disable"):
                _, _, spec = head.partition("=")
                rules = _parse_rule_list(spec)
                line_disables.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass  # stlint: disable=fail-open — a truncated token stream still lints on the AST
    return line_disables, file_disables


# -- module loading ----------------------------------------------------------


def parse_module(abspath: str, rel_to: str) -> Optional[ParsedModule]:
    """Parse one file; returns None when it isn't valid Python (the
    linter reports what it can and never takes CI down with a crash —
    a syntax error fails the build through the test suite anyway)."""
    try:
        with open(abspath, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=abspath)
    except (OSError, SyntaxError, ValueError):
        return None
    line_disables, file_disables = parse_suppressions(source)
    rel = os.path.relpath(abspath, rel_to).replace(os.sep, "/")
    return ParsedModule(
        path=rel,
        abspath=abspath,
        source=source,
        tree=tree,
        line_disables=line_disables,
        file_disables=file_disables,
    )


def iter_py_files(root: str) -> Iterable[str]:
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d not in ("__pycache__", ".git")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def run_passes(
    roots: Sequence[str],
    passes: Sequence[Pass],
    rel_to: Optional[str] = None,
) -> List[Finding]:
    """Run every pass over every .py file under ``roots``; suppressions
    applied; findings sorted (severity, path, line, rule)."""
    rel_to = rel_to or os.getcwd()
    findings: List[Finding] = []
    for root in roots:
        for abspath in iter_py_files(root):
            mod = parse_module(abspath, rel_to)
            if mod is None:
                continue
            for p in passes:
                for f in p.run(mod):
                    if not mod.suppressed(f.rule, *f.span()):
                        findings.append(f)
    findings.sort(
        key=lambda f: (_SEV_ORDER.get(f.severity, 9), f.path, f.line, f.rule)
    )
    return findings


# -- baseline ----------------------------------------------------------------


def baseline_counts(findings: Iterable[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        k = f"{f.rule}:{f.path}"
        out[k] = out.get(k, 0) + 1
    return out


def load_baseline(path: str) -> Dict[str, int]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return {}
    counts = data.get("accepted", {})
    return {str(k): int(v) for k, v in counts.items()}


def save_baseline(
    path: str,
    findings: Iterable[Finding],
    keep: Optional[Dict[str, int]] = None,
) -> None:
    """Write the baseline from ``findings``, preserving ``keep`` entries.

    ``keep`` carries accepted counts OUTSIDE the current run's scope — a
    scoped run (explicit paths, one tier, a --rules subset) must not
    silently delete debt it never re-measured (the CLI computes the
    out-of-scope set; see __main__)."""
    accepted = baseline_counts(findings)
    for k, v in (keep or {}).items():
        if k not in accepted:
            accepted[k] = v
    data = {
        "comment": (
            "Accepted pre-existing findings per 'rule:path'.  Regenerate "
            "with `save_baseline` and "
            "commit the diff ONLY after reviewing why each new entry "
            "cannot be fixed or suppressed inline with a rationale."
        ),
        "accepted": dict(sorted(accepted.items())),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=False)
        f.write("\n")


def new_findings(
    findings: Sequence[Finding], baseline: Dict[str, int]
) -> List[Finding]:
    """Findings in excess of the baseline's per-(rule,path) counts.

    Within one bucket the LAST findings (highest line numbers) are
    reported as new — arbitrary but stable, and the full list is always
    available in the report for a human deciding what actually changed.
    """
    remaining = dict(baseline)
    out: List[Finding] = []
    for f in findings:
        k = f"{f.rule}:{f.path}"
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
        else:
            out.append(f)
    return out


# -- reporting ---------------------------------------------------------------


def format_text(findings: Sequence[Finding], new: Sequence[Finding]) -> str:
    lines: List[str] = []
    new_set = {id(f) for f in new}
    for f in findings:
        tag = "NEW " if id(f) in new_set else ""
        lines.append(
            f"{f.path}:{f.line}:{f.col}: {tag}{f.severity} [{f.rule}] {f.message}"
        )
    lines.append(
        f"-- {len(findings)} finding(s), {len(new)} new vs baseline"
    )
    return "\n".join(lines)


def format_sarif(
    findings: Sequence[Finding],
    new: Sequence[Finding],
    rule_descriptions: Optional[Dict[str, str]] = None,
) -> str:
    """SARIF 2.1.0 report — GitHub code scanning renders these as inline
    PR annotations.  Only NEW findings (beyond the baseline) are emitted:
    accepted debt must not re-annotate every PR that touches the file."""
    rule_descriptions = rule_descriptions or {}
    rules_seen: List[str] = []
    for f in new:
        if f.rule not in rules_seen:
            rules_seen.append(f.rule)

    def _location(f: Finding) -> Dict:
        # repo-relative file paths resolve against SRCROOT; jaxpr-tier
        # whole-program findings carry a jaxpr:// pseudo-path, which is a
        # valid ABSOLUTE URI (scheme + path) and per SARIF 2.1.0 must NOT
        # combine with uriBaseId (that applies to relative references only)
        art = {"uri": f.path}
        if "://" not in f.path:
            art["uriBaseId"] = "SRCROOT"
        return {
            "physicalLocation": {
                "artifactLocation": art,
                "region": {
                    "startLine": max(f.line, 1),
                    "startColumn": f.col + 1,
                },
            }
        }

    sarif = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
            "Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "stlint",
                        # informationUri must be an absolute URI per the
                        # SARIF schema, so the repo-relative README path
                        # lives in the rule help text instead
                        "rules": [
                            {
                                "id": r,
                                "shortDescription": {
                                    "text": rule_descriptions.get(r, r)
                                },
                                "help": {
                                    "text": "see sentinel_tpu_torch/analysis/__init__.py"
                                },
                            }
                            for r in rules_seen
                        ],
                    }
                },
                "results": [
                    {
                        "ruleId": f.rule,
                        "level": "error" if f.severity == ERROR else "warning",
                        "message": {"text": f.message},
                        "locations": [_location(f)],
                    }
                    for f in new
                ],
            }
        ],
    }
    return json.dumps(sarif, indent=2)


def format_json(findings: Sequence[Finding], new: Sequence[Finding]) -> str:
    new_set = {id(f) for f in new}
    return json.dumps(
        {
            "findings": [
                {
                    "rule": f.rule,
                    "path": f.path,
                    "line": f.line,
                    "col": f.col,
                    "severity": f.severity,
                    "message": f.message,
                    "new": id(f) in new_set,
                }
                for f in findings
            ],
            "total": len(findings),
            "new": len(new),
        },
        indent=2,
    )
