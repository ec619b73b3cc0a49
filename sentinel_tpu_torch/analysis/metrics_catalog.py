"""Metric-catalog lint of the port: registry names in source vs the README.

The port's copy of ``sentinel_tpu/analysis/metrics_catalog.py``.  A
metric that exists but is undocumented never gets a dashboard, and a
documented metric that no longer exists breaks every alert built on it;
this check makes the README's catalog a verified contract for the port:

* scan every ``sentinel_tpu_torch/**/*.py`` for literal metric
  registrations — first-argument string constants of ``.counter(...)`` /
  ``.gauge(...)`` / ``.histogram(...)`` calls starting with ``sentinel_``;
* read the README's shared "Metric catalog" table (the backticked
  ``sentinel_*`` name in each row's first column) — the port registers
  the reference's metrics under the reference's names, so both packages
  are held to one table — plus the port's own table: rows whose first
  cell is ``port`` and whose second is the backticked name (``| port |
  `sentinel_x` | ... |``).  Port-only metrics go there: the reference's
  parser reads only the shared rows, so a port-only row in the shared
  table would fail the reference's lint as stale;
* report three problem classes: registered-but-undocumented,
  documented-but-unregistered (stale row), and names violating the
  ``sentinel_`` snake_case convention.

Run via ``python -m sentinel_tpu_torch.analysis --tier metrics``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Tuple

#: registration methods whose first literal argument is a metric name
_REGISTER_ATTRS = {"counter", "gauge", "histogram"}

_NAME_RE = re.compile(r"^sentinel_[a-z0-9]+(_[a-z0-9]+)*$")

#: README table rows: `| `sentinel_foo` | counter | ... |`
_ROW_RE = re.compile(r"^\|\s*`(sentinel_[a-zA-Z0-9_]*)`")
#: the port's own rows: `| port | `sentinel_foo` | counter | ... |`
_PORT_ROW_RE = re.compile(r"^\|\s*port\s*\|\s*`(sentinel_[a-zA-Z0-9_]*)`")


def scan_registered_metrics(root: str) -> Dict[str, List[Tuple[str, int]]]:
    """name -> [(relpath, line), ...] over every literal registration in
    the package tree (fixture dirs excluded — they exist to be wrong)."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [
            d for d in dirnames if d not in ("__pycache__", "fixtures")
        ]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path) as f:
                    tree = ast.parse(f.read(), filename=path)
            except (OSError, SyntaxError):
                continue
            rel = os.path.relpath(path, os.path.dirname(root)).replace(
                os.sep, "/"
            )
            for node in ast.walk(tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REGISTER_ATTRS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value.startswith("sentinel_")
                ):
                    out.setdefault(node.args[0].value, []).append(
                        (rel, node.lineno)
                    )
    return out


def readme_catalog_names(readme_path: str) -> List[str]:
    """Backticked ``sentinel_*`` names from the README catalog table
    rows — the shared table's and the port's own — in order (duplicates
    preserved so the lint can flag them)."""
    names: List[str] = []
    with open(readme_path) as f:
        for line in f:
            m = _ROW_RE.match(line.strip()) or _PORT_ROW_RE.match(line.strip())
            if m:
                names.append(m.group(1))
    return names


#: names the exposition synthesizes outside a registry registration site
#: (obs/fleet.py renders them as literal lines in the merged exposition)
SYNTHETIC_NAMES = {
    "sentinel_fleet_members",
    "sentinel_fleet_scrape_errors",
    "sentinel_fleet_scrape_duplicates",
    "sentinel_fleet_shard_info",
}


def check_catalog(package_root: str, readme_path: str) -> List[str]:
    """All three problem classes as human-readable strings (empty =
    clean).  ``package_root`` is the ``sentinel_tpu_torch`` directory."""
    from collections import Counter

    problems: List[str] = []
    registered = scan_registered_metrics(package_root)
    cataloged_list = readme_catalog_names(readme_path)
    cataloged = set(cataloged_list)
    for name, count in Counter(cataloged_list).items():
        if count > 1:
            problems.append(f"README catalog lists {name!r} more than once")
    for name, sites in sorted(registered.items()):
        if not _NAME_RE.match(name):
            where = ", ".join(f"{p}:{l}" for p, l in sites[:2])
            problems.append(
                f"{name!r} violates sentinel_ snake_case naming ({where})"
            )
        if name not in cataloged:
            where = ", ".join(f"{p}:{l}" for p, l in sites[:2])
            problems.append(
                f"{name!r} is registered ({where}) but missing from the "
                f"README metric catalog"
            )
    known = set(registered) | SYNTHETIC_NAMES
    for name in sorted(cataloged):
        if name not in known:
            problems.append(
                f"README catalog row {name!r} matches no registration in "
                f"source (stale row?)"
            )
    return problems
