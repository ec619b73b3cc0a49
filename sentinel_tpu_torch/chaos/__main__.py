"""CLI: ``python -m sentinel_tpu_torch.chaos [--seed N] [--scenario NAME ...]``.

The port's copy of ``sentinel_tpu/chaos/__main__.py``, with ``--device``.

Runs the built-in chaos scenarios under their seeded fault plans and
prints per-scenario invariant verdicts plus injected-event counts.
Exit status 0 iff every invariant of every selected scenario is green.

Options:
  --seed N              plan seed (default 7); identical seeds inject
                        identical per-scenario event counts
  --scenario NAME       run only NAME (repeatable); default: all
  --fast                only the tier-1 CI subset
  --json                machine-readable report (the determinism check
                        diffs this)
  --check-determinism   run everything twice and fail on any injected-
                        count difference
  --list                list scenarios and exit
  --sites               list registered failpoint sites and exit
  --plan FILE           print a scenario-free replay note: validates the
                        JSON plan against the registered sites
  --device DEV          where the scenarios' clients run (default cuda:
                        the card; ``--device cpu`` runs them on the CPU)
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sentinel_tpu_torch.chaos")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scenario", action="append", default=None)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--check-determinism", action="store_true")
    ap.add_argument("--list", action="store_true", dest="list_scenarios")
    ap.add_argument("--sites", action="store_true")
    ap.add_argument("--plan", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sentinel_tpu_torch.chaos import failpoints as FP

    # sites register at module import; pull in every instrumented layer so
    # the catalog (and plan validation) is complete regardless of what the
    # process happened to import already
    import sentinel_tpu_torch.analysis.concurrency.witness  # noqa: F401
    import sentinel_tpu_torch.cluster.client  # noqa: F401
    import sentinel_tpu_torch.cluster.server  # noqa: F401
    import sentinel_tpu_torch.cluster.shard  # noqa: F401
    import sentinel_tpu_torch.datasource.stores  # noqa: F401
    import sentinel_tpu_torch.parallel.remote_shard  # noqa: F401
    import sentinel_tpu_torch.runtime.client  # noqa: F401
    import sentinel_tpu_torch.transport.heartbeat  # noqa: F401
    import sentinel_tpu_torch.transport.http_server  # noqa: F401

    if args.sites:
        for name, site in sorted(FP.catalog().items()):
            print(f"{name:32s} [{','.join(site.kinds)}] {site.desc}")
        return 0

    if args.plan:
        from sentinel_tpu_torch.chaos.plans import FaultPlan

        with open(args.plan) as f:
            plan = FaultPlan.from_json(f.read())
        plan.validate(FP.catalog())
        print(
            f"plan {plan.name or '<unnamed>'}: seed={plan.seed}, "
            f"{len(plan.faults)} fault spec(s) — valid against "
            f"{len(FP.catalog())} registered sites"
        )
        return 0

    from sentinel_tpu_torch.chaos.runner import SCENARIOS, report, run_all

    if args.list_scenarios:
        for name, s in SCENARIOS.items():
            tags = []
            if s.fast:
                tags.append("fast")
            if s.eager:
                tags.append("eager")
            print(f"{name:24s} [{','.join(tags) or '-'}] {s.description}")
        return 0

    unknown = [n for n in (args.scenario or ()) if n not in SCENARIOS]
    if unknown:
        print(f"unknown scenario(s): {unknown}", file=sys.stderr)
        return 2

    results = run_all(args.seed, names=args.scenario, fast_only=args.fast, device=args.device)
    if args.check_determinism:
        again = run_all(args.seed, names=args.scenario, fast_only=args.fast, device=args.device)
        mismatches = {
            a.name: (a.injected, b.injected)
            for a, b in zip(results, again)
            if a.injected != b.injected
        }
        if mismatches:
            print(report(results, as_json=args.as_json))
            print(f"DETERMINISM VIOLATION: {json.dumps(mismatches, indent=2)}")
            return 1
        print(report(results, as_json=args.as_json))
        print("determinism: two runs injected identical per-scenario counts")
        return 0 if all(r.ok for r in results) else 1
    print(report(results, as_json=args.as_json))
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
