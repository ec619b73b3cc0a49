"""CLI: ``python -m sentinel_tpu_torch.analysis [paths...]``.

The port of ``sentinel_tpu/analysis/__main__.py``, over the port.  Runs
ALL analyzer tiers by default:

* tier 1 — the AST linter over source files (cheap, per-file);
* tier 2 — the ``jaxpr`` tier: the 13 canonical entry points run eagerly
  under the op recorder, five passes over their dispatched ATen streams
  (repo-global, so it is skipped when explicit paths are given — pass
  ``--tier jaxpr`` to force it);
* tier 3 — the whole-program concurrency analyzer (interprocedural
  lock-order graph, blocking-under-lock, thread-lifecycle; repo-global
  like tier 2, skipped under explicit paths — ``--tier concurrency``
  forces it);
* tier 4 — the SPMD analyzer (collective ledger, implicit-reshard and
  replication hazards, shard divisibility, per-shard memory budget; its
  ranks are child processes on the blessed mesh — ``--tier spmd`` forces
  it).

Tiers 2 and 4 run on ``--device`` (default ``cuda``, as the port's
other entry points): without a card, pass ``--device cpu``, or they
raise.  The golden updates ``--update-fingerprints`` and
``--update-budgets`` record on ``--device`` too: with ``--device cpu``
they rewrite the goldens' CPU block, which the tests check; on the card
the ``"card"`` block, which a run on the card checks.

``--jobs N`` runs the selected tiers concurrently (threads).

Exit status: 0 — no findings beyond the checked-in baseline;
1 — new findings (print + fail, the CI contract); 2 — usage error.
"""

from __future__ import annotations

import argparse
import os
import sys

from sentinel_tpu_torch.analysis import (
    ALL_PASSES,
    DEFAULT_BASELINE,
    PACKAGE,
    REPO_ROOT,
    load_baseline,
    new_findings,
    run_passes,
    save_baseline,
)
from sentinel_tpu_torch.analysis.framework import (
    format_json,
    format_sarif,
    format_text,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sentinel_tpu_torch.analysis",
        description=(
            "the port's hazard analyzer: AST linter, the jaxpr tier over "
            "the dispatched ATen stream, concurrency and SPMD tiers "
            "(see sentinel_tpu_torch/analysis/__init__.py)"
        ),
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help=(
            "files/directories for the AST tier (default: the "
            "sentinel_tpu_torch package).  Explicit paths imply --tier ast: the jaxpr tier is "
            "repo-global, not per-file."
        ),
    )
    ap.add_argument("--json", action="store_true", help="JSON report on stdout")
    ap.add_argument(
        "--sarif",
        action="store_true",
        help=(
            "SARIF 2.1.0 report on stdout (GitHub code scanning renders "
            "NEW findings as inline PR annotations)"
        ),
    )
    ap.add_argument(
        "--tier",
        choices=("ast", "jaxpr", "concurrency", "spmd", "both", "all", "metrics"),
        default=None,
        help=(
            "which analyzer tier(s) to run (default: all without explicit "
            "paths, ast with them; 'both' = ast+jaxpr for older scripts; "
            "'metrics' runs only the metric-catalog lint — registry names "
            "in source vs the README catalog table)"
        ),
    )
    ap.add_argument(
        "--jobs",
        type=int,
        default=1,
        metavar="N",
        help=(
            "run the selected tiers concurrently on N threads (default 1: "
            "sequential; tiers are the unit of parallelism)"
        ),
    )
    ap.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help="baseline file (default: sentinel_tpu_torch/analysis/baseline.json)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="treat every finding as new (ignore the baseline)",
    )
    ap.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline to accept the current findings and exit 0",
    )
    ap.add_argument(
        "--update-fingerprints",
        action="store_true",
        help=(
            "re-record the entry points on --device and rewrite that "
            "device's block of the golden op-stream signatures "
            "(sentinel_tpu_torch/analysis/jaxpr/fingerprints.json: the CPU's "
            "or the card's); commit the diff when the program change is "
            "intended"
        ),
    )
    ap.add_argument(
        "--update-budgets",
        action="store_true",
        help=(
            "re-baseline the per-entry launch/byte ceilings of --device's "
            "block (sentinel_tpu_torch/analysis/jaxpr/budgets.json: the CPU's "
            "or the card's) at measured+25%%"
        ),
    )
    ap.add_argument(
        "--update-lock-order",
        action="store_true",
        help=(
            "re-derive the blessed held->acquired lock-order edge set "
            "(sentinel_tpu_torch/analysis/concurrency/lock_order.json); commit "
            "the diff ONLY after reviewing each new edge — every edge is "
            "an ordering constraint all future acquisitions must respect"
        ),
    )
    ap.add_argument(
        "--update-collectives",
        action="store_true",
        help=(
            "re-run the sharded entry points on --device and rewrite the "
            "golden collective ledger (sentinel_tpu_torch/analysis/spmd/"
            "collectives.json); "
            "commit the diff ONLY after reviewing each new collective — "
            "every pinned transfer is per-tick interconnect traffic"
        ),
    )
    ap.add_argument(
        "--rules",
        default="",
        help="comma-separated pass names to run (default: all, all tiers)",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help=(
            "the device the jaxpr and spmd tiers run on (default: cuda; "
            "'cpu' without a card)"
        ),
    )
    args = ap.parse_args(argv)

    if args.json and args.sarif:
        print("--json and --sarif are mutually exclusive", file=sys.stderr)
        return 2

    # -- golden updates (tier-2/3/4 maintenance verbs) ----------------------
    if (
        args.update_fingerprints
        or args.update_budgets
        or args.update_lock_order
        or args.update_collectives
    ):
        if args.update_fingerprints or args.update_budgets:
            import torch

            from sentinel_tpu_torch.analysis import jaxpr as J
            from sentinel_tpu_torch.analysis.jaxpr.entrypoints import check_device

            check_device(args.device)
            card = torch.device(args.device).type != "cpu"
            if args.update_fingerprints:
                n = J.update_fingerprints(card=card)
                print(
                    f"fingerprints updated: {n} entry point(s) -> {J.FINGERPRINTS_PATH}"
                )
            if args.update_budgets:
                n = J.update_budgets(card=card)
                print(f"budgets updated: {n} entry point(s) -> {J.BUDGETS_PATH}")
        if args.update_lock_order:
            from sentinel_tpu_torch.analysis import concurrency as CC

            n = CC.update_lock_order()
            print(f"lock order updated: {n} edge(s) -> {CC.LOCK_ORDER_PATH}")
        if args.update_collectives:
            from sentinel_tpu_torch.analysis import spmd as SP

            n = SP.update_collectives(device=args.device)
            print(
                f"collective ledger updated: {n} entry point(s) -> "
                f"{SP.COLLECTIVES_PATH}"
            )
        return 0

    tier = args.tier or ("ast" if args.paths else "all")
    if tier == "metrics":
        # standalone catalog lint: no Finding/baseline machinery — the
        # catalog is a strict contract, not accumulated debt
        from sentinel_tpu_torch.analysis.metrics_catalog import check_catalog

        problems = check_catalog(
            os.path.join(REPO_ROOT, PACKAGE),
            os.path.join(REPO_ROOT, "README.md"),
        )
        for p in problems:
            print(f"metric-catalog: {p}")
        print(f"-- metric catalog: {len(problems)} problem(s)")
        return 1 if problems else 0

    # -- tier selection (--tier value -> the set of tiers to run) -----------
    _TIER_SETS = {
        "ast": ("ast",),
        "jaxpr": ("jaxpr",),
        "concurrency": ("concurrency",),
        "spmd": ("spmd",),
        "both": ("ast", "jaxpr"),
        "all": ("ast", "jaxpr", "concurrency", "spmd"),
    }
    tiers = set(_TIER_SETS[tier])

    # -- pass selection (all tiers share the --rules namespace) -------------
    ast_passes = list(ALL_PASSES)
    jaxpr_passes = None  # None = all (resolved lazily: importing them is free,
    # but building the entry list costs a recording)
    conc_passes = None  # None = all tier-3 passes
    spmd_passes = None  # None = all tier-4 passes
    if args.rules:
        from sentinel_tpu_torch.analysis.concurrency.passes import (
            ALL_CONCURRENCY_PASSES,
        )
        from sentinel_tpu_torch.analysis.jaxpr.passes import ALL_JAXPR_PASSES
        from sentinel_tpu_torch.analysis.spmd.passes import ALL_SPMD_PASSES

        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        known = (
            {p.name for p in ALL_PASSES}
            | {p.name for p in ALL_JAXPR_PASSES}
            | {p.name for p in ALL_CONCURRENCY_PASSES}
            | {p.name for p in ALL_SPMD_PASSES}
        )
        unknown = wanted - known
        if unknown:
            print(
                f"unknown rule(s): {', '.join(sorted(unknown))} "
                f"(have: {', '.join(sorted(known))})",
                file=sys.stderr,
            )
            return 2
        ast_passes = [p for p in ALL_PASSES if p.name in wanted]
        jaxpr_passes = [p for p in ALL_JAXPR_PASSES if p.name in wanted]
        conc_passes = [p for p in ALL_CONCURRENCY_PASSES if p.name in wanted]
        spmd_passes = [p for p in ALL_SPMD_PASSES if p.name in wanted]
        # a --rules list naming only some tiers' passes narrows a
        # multi-tier run to those tiers (running the others with zero
        # passes is wasted recording)...
        if len(tiers) > 1:
            if not ast_passes:
                tiers.discard("ast")
            if not jaxpr_passes:
                tiers.discard("jaxpr")
            if not conc_passes:
                tiers.discard("concurrency")
            if not spmd_passes:
                tiers.discard("spmd")
        # ...and a selection that leaves the effective tier set with
        # ZERO passes must not masquerade as a clean run (exit 0 with
        # nothing executed): `--rules const-hoist some_file.py` pins the
        # tier to ast (explicit paths) while naming only jaxpr rules —
        # usage error
        _tier_passes = {
            "ast": ast_passes,
            "jaxpr": jaxpr_passes,
            "concurrency": conc_passes,
            "spmd": spmd_passes,
        }
        empty = sorted(t for t in tiers if not _tier_passes[t])
        if empty or not tiers:
            print(
                f"--rules {args.rules}: no pass selected for tier(s) "
                f"{', '.join(empty) or tier} (explicit paths pin the run "
                "to the ast tier; jaxpr/concurrency/spmd rules need "
                "--tier without paths)",
                file=sys.stderr,
            )
            return 2

    roots = args.paths or [os.path.join(REPO_ROOT, PACKAGE)]
    for r in roots:
        if not os.path.exists(r):
            print(f"no such path: {r}", file=sys.stderr)
            return 2

    if tiers & {"jaxpr", "spmd"}:
        from sentinel_tpu_torch.analysis.jaxpr.entrypoints import check_device

        check_device(args.device)

    def _run_ast():
        return run_passes(roots, ast_passes, rel_to=REPO_ROOT)

    def _run_jaxpr():
        from sentinel_tpu_torch.analysis.jaxpr import run_jaxpr_analysis

        return run_jaxpr_analysis(passes=jaxpr_passes, device=args.device)

    def _run_concurrency():
        from sentinel_tpu_torch.analysis.concurrency import run_concurrency_analysis

        return run_concurrency_analysis(passes=conc_passes)

    def _run_spmd():
        from sentinel_tpu_torch.analysis.spmd import run_spmd_analysis

        return run_spmd_analysis(passes=spmd_passes, device=args.device)

    # ordered so sequential runs report tiers 1..4 in catalog order; the
    # spmd ranks are child processes, so under --jobs they overlap the
    # jaxpr recording instead of serializing behind it
    tasks = [
        t
        for t in (
            ("ast", _run_ast),
            ("jaxpr", _run_jaxpr),
            ("concurrency", _run_concurrency),
            ("spmd", _run_spmd),
        )
        if t[0] in tiers
    ]
    findings = []
    if args.jobs > 1 and len(tasks) > 1:
        from concurrent.futures import ThreadPoolExecutor

        # the tier runners import overlapping module graphs lazily;
        # two threads resolving them concurrently can deadlock on
        # Python's per-module import locks (A holds X wants Y, B holds
        # Y wants X).  Importing is cheap — recording happens at
        # run time — so resolve every selected tier's imports here,
        # single-threaded, before fanning out.
        import importlib

        _TIER_MODULES = {
            "jaxpr": ("sentinel_tpu_torch.analysis.jaxpr",
                      "sentinel_tpu_torch.analysis.jaxpr.entrypoints",
                      "sentinel_tpu_torch.analysis.jaxpr.passes"),
            "concurrency": ("sentinel_tpu_torch.analysis.concurrency",
                            "sentinel_tpu_torch.analysis.concurrency.summaries",
                            "sentinel_tpu_torch.analysis.concurrency.passes"),
            "spmd": ("sentinel_tpu_torch.analysis.spmd",
                     "sentinel_tpu_torch.analysis.spmd.entrypoints",
                     "sentinel_tpu_torch.analysis.spmd.runner",
                     "sentinel_tpu_torch.analysis.spmd.passes"),
        }
        for t in sorted(tiers):
            for mod in _TIER_MODULES.get(t, ()):
                importlib.import_module(mod)

        with ThreadPoolExecutor(max_workers=min(args.jobs, len(tasks))) as ex:
            for chunk in ex.map(lambda t: t[1](), tasks):
                findings.extend(chunk)
    else:
        for _name, fn in tasks:
            findings.extend(fn())

    if args.update_baseline:
        # a SCOPED update (explicit paths / one tier / a --rules subset)
        # re-measures only part of the repo; baseline entries outside that
        # scope were not re-measured and must survive the rewrite, or the
        # next full run reports previously-accepted debt as NEW
        wanted_rules = (
            {r.strip() for r in args.rules.split(",") if r.strip()}
            if args.rules
            else None
        )
        rel_roots = [
            os.path.relpath(r, REPO_ROOT).replace(os.sep, "/") for r in roots
        ]

        from sentinel_tpu_torch.analysis.concurrency.passes import (
            ALL_CONCURRENCY_PASSES as _CC_PASSES,
        )
        from sentinel_tpu_torch.analysis.spmd.passes import (
            ALL_SPMD_PASSES as _SP_PASSES,
        )

        conc_rules = {p.name for p in _CC_PASSES}
        spmd_rules = {p.name for p in _SP_PASSES}

        def _in_scope(key: str) -> bool:
            rule, _, path = key.partition(":")
            if wanted_rules is not None and rule not in wanted_rules:
                return False
            if path.startswith("jaxpr://"):
                return "jaxpr" in tiers
            if path.startswith("concurrency://"):
                return "concurrency" in tiers
            if path.startswith("spmd://"):
                return "spmd" in tiers
            # tier-3/4 rules also land on real files (blocking-under-lock,
            # implicit-reshard et al.) — scope them by their own tier,
            # not ast
            if rule in spmd_rules:
                owner = "spmd"
            elif rule in conc_rules:
                owner = "concurrency"
            else:
                owner = "ast"
            if owner not in tiers:
                return False
            return any(
                rr in (".", "") or path == rr or path.startswith(rr + "/")
                for rr in rel_roots
            )

        existing = load_baseline(args.baseline)
        keep = {k: v for k, v in existing.items() if not _in_scope(k)}
        save_baseline(args.baseline, findings, keep=keep)
        print(
            f"baseline updated: {len(findings)} accepted finding(s) "
            f"(+{len(keep)} out-of-scope entr{'y' if len(keep) == 1 else 'ies'} "
            f"preserved) -> {args.baseline}"
        )
        return 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new = new_findings(findings, baseline)

    if args.sarif:
        from sentinel_tpu_torch.analysis import rule_catalog

        out = format_sarif(findings, new, rule_catalog())
    elif args.json:
        out = format_json(findings, new)
    else:
        out = format_text(findings, new)
    print(out)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
