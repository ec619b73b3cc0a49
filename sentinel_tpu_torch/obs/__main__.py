"""CLI: dump / summarize / merge span traces, analyze flight bundles,
query the verdict provenance plane.

The port's copy of ``sentinel_tpu/obs/__main__.py``.  The self-captures
run on the card unless ``--device cpu`` asks for the CPU.

Usage:

    python -m sentinel_tpu_torch.obs --summary [trace.json]
    python -m sentinel_tpu_torch.obs --chrome out.json [trace.json]
    python -m sentinel_tpu_torch.obs --json [trace.json]
    python -m sentinel_tpu_torch.obs --merge a.json b.json ... -o merged.json
    python -m sentinel_tpu_torch.obs --postmortem bundle.json
    python -m sentinel_tpu_torch.obs --profile [ms] [-o capture.json]
    python -m sentinel_tpu_torch.obs explain [--target host:port]
                                       [--resource NAME] [--top N] [--json]

``explain`` prints the provenance plane (obs/explain.py): coverage, the
top block-cause leaderboard, and the newest block explanations — each
one the device-packed record of WHY a decision was blocked (rule slot +
verdict kind, observed value vs threshold, sketch-tier / eps-confidence
flags).  With ``--target`` it queries a live process's ``GET
/api/explain``; with no target it SELF-CAPTURES: drives a small
``SentinelClient`` past a tight flow limit and explains the resulting
blocks — the zero-setup demo of the plane (``--device``: where it runs).

With a ``trace.json`` argument (a Chrome-trace file from ``GET
/api/traces`` or ``SpanTracer.dump``) the CLI reads it; with no input it
performs a SELF-CAPTURE: runs a small ``SentinelClient`` on the
fast-path engine configuration (fused and segment effects: on the card
the B1-B4 kernels) with ``pipeline_depth > 0`` and tracing enabled, on
``--device`` (the card by default), then reports from the live ring.  ``--summary`` prints per-stage
count / p50 / p99 / mean for every traced stage — the six tick stages
(``tick.assemble``/``presort``/``dispatch``/``device``/``readback``/
``resolve``) decompose where each millisecond of a decision goes.

``--merge`` joins per-process dumps (client + token server + shard
hosts) into ONE Perfetto/Chrome trace: each input keeps its own pid
lane (collisions remapped, a process_name metadata row names the source
file), each process's monotonic clock is re-based to its earliest span
(cross-process clocks share no epoch — causality comes from flows, not
from the time axis), and every client RPC span that carries a
``span_id`` is linked to the server spans that recorded it as
``parent`` with Chrome flow events (``ph: s``/``f``) — the wire-level
``(trace_id, parent_span_id)`` pair made visible.

``--postmortem`` prints a flight bundle (obs/flight.py) as one merged
timeline: journal events and trace spans interleaved on the bundle's
monotonic clock, followed by the provider sections and the non-zero
incident counters.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from sentinel_tpu_torch.obs import trace as OT

#: the six pipelined tick stages every capture should surface
TICK_STAGES = (
    "tick.assemble",
    "tick.presort",
    "tick.dispatch",
    "tick.device",
    "tick.readback",
    "tick.resolve",
)


def _self_capture(n_blocks: int = 4, block: int = 64, device: str = "cuda") -> List[dict]:
    """Run a tiny SentinelClient workload with tracing on; return spans.

    ``device``: the card unless the caller asks for the CPU (where the
    kernels' plain versions run: a semantics/shape capture).
    pipeline_depth > 0 exercises the resolver thread, so device/readback/
    resolve spans come from it while assemble/presort/dispatch come from
    the submitting thread — the cross-thread trace-id correlation the
    explicit begin/end API exists for.
    """
    import numpy as np

    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.core.rules import FlowRule
    from sentinel_tpu_torch.runtime.client import SentinelClient

    cfg = small_engine_config(
        use_mxu_tables=True,
        fused_effects=True,
        seg_effects=True,
        flow_rules_per_resource=1,
        degrade_rules_per_resource=1,
        param_rules_per_resource=1,
    )
    was_enabled = OT.TRACER.enabled
    OT.TRACER.enable()
    try:
        c = SentinelClient(cfg=cfg, mode="sync", pipeline_depth=2, device=device)
        c.start()
        try:
            names = [f"cli-res-{i}" for i in range(8)]
            ids = np.asarray([c.registry.resource_id(n) for n in names], np.int32)
            c.flow_rules.load([FlowRule(resource=n, count=1000.0) for n in names])
            rng = np.random.default_rng(0)
            for _ in range(n_blocks):
                res = ids[rng.integers(0, len(ids), block)].astype(np.int32)
                fut = c.submit_block(res)
                c.submit_completion_block(
                    res, np.abs(rng.normal(2.0, 1.0, block)).astype(np.float32)
                )
                if fut is not None:
                    fut.result(timeout=60.0)
        finally:
            c.stop()
    finally:
        if not was_enabled:
            OT.TRACER.disable()
    return OT.TRACER.snapshot()


def _profile_capture(ms: float, blocks: int, device: str = "cuda") -> dict:
    """``--profile``: one bounded dense-capture window
    (obs/profile.capture_profile) over the self-capture workload running
    on a background thread — the standalone analog of ``GET
    /api/profile?ms=``.  Returns the capture payload (fail-open: an
    ``error`` key instead of a trace on any failure)."""
    import threading

    from sentinel_tpu_torch.obs.profile import capture_profile

    done = threading.Event()

    def work() -> None:
        try:
            _self_capture(n_blocks=max(1, blocks), device=device)
        finally:
            done.set()

    t = threading.Thread(target=work, name="obs-profile-workload", daemon=True)
    t.start()
    cap = capture_profile(ms)
    done.wait(timeout=300.0)
    return cap


def merge_traces(paths: List[str]) -> dict:
    """Join multi-process Chrome-trace dumps into one document with flow
    events linking RPC client spans to the server spans they caused.

    Linking contract: a span recorded with ``args.span_id = S`` (the
    client half of a cross-process edge — ``cluster.rpc``,
    ``shard.chunk``) is the flow SOURCE; every span in any input whose
    ``args.parent == S`` (``token.decision*``, ``server.res_check``) is
    a flow TARGET.  Chrome binds flow events to slices by (pid, tid,
    ts), so the s/f events are stamped inside their respective spans.
    """
    all_events: List[dict] = []
    used_pids: dict = {}
    for idx, path in enumerate(paths):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and "traceEvents" in data:
            events = [dict(e) for e in data["traceEvents"]]
        elif isinstance(data, list):  # raw snapshot list
            events = [
                {
                    "name": s.get("name", "?"),
                    "ph": "X",
                    "ts": s.get("t0_ns", 0) / 1000.0,
                    "dur": s.get("dur_ns", 0) / 1000.0,
                    "pid": idx,
                    "tid": s.get("tid", 0),
                    "args": dict(
                        s.get("attrs") or {}, **(
                            {"trace": s["trace"]} if s.get("trace") else {}
                        )
                    ),
                }
                for s in data
            ]
        else:
            raise ValueError(f"{path}: neither a chrome trace nor a span snapshot")
        # one pid lane per input file; collide-remap keeps lanes distinct
        # even when two dumps came from the same (or a re-used) pid
        orig_pids = {e.get("pid", 0) for e in events} or {0}
        remap = {}
        for p in sorted(orig_pids):
            q = p
            while q in used_pids:
                q += 100_000
            remap[p] = q
            used_pids[q] = path
        # re-base each process's monotonic clock to its earliest event:
        # cross-process monotonic clocks share no epoch, so absolute
        # offsets are meaningless — flows carry the causality
        t_min = min((e.get("ts", 0.0) for e in events), default=0.0)
        for e in events:
            e["pid"] = remap.get(e.get("pid", 0), e.get("pid", 0))
            e["ts"] = e.get("ts", 0.0) - t_min
        for new_pid in remap.values():
            all_events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": new_pid,
                    "tid": 0,
                    "args": {"name": os.path.basename(path)},
                }
            )
        all_events.extend(events)

    # flow events: span_id (source) -> parent (targets), matched over ALL
    # merged inputs so in-process parent/child pairs link too
    sources = {}
    for e in all_events:
        sid = (e.get("args") or {}).get("span_id")
        if sid and e.get("ph") == "X":
            sources[sid] = e
    flows: List[dict] = []
    n_links = 0
    for e in all_events:
        parent = (e.get("args") or {}).get("parent")
        if not parent or e.get("ph") != "X":
            continue
        src = sources.get(parent)
        if src is None or src is e:
            continue
        n_links += 1
        flows.append(
            {
                "name": "rpc",
                "cat": "rpc",
                "ph": "s",
                "id": parent,
                "ts": src["ts"],
                "pid": src["pid"],
                "tid": src.get("tid", 0),
            }
        )
        flows.append(
            {
                "name": "rpc",
                "cat": "rpc",
                "ph": "f",
                "bp": "e",
                "id": parent,
                "ts": e["ts"],
                "pid": e["pid"],
                "tid": e.get("tid", 0),
            }
        )
    return {
        "traceEvents": all_events + flows,
        "displayTimeUnit": "ms",
        "otherData": {"merged_from": [os.path.basename(p) for p in paths],
                      "flow_links": n_links},
    }


def _print_postmortem(path: str, out=None) -> None:
    """Flight-bundle analysis: journal events + trace spans on one
    timeline (they share the capturing process's monotonic clock)."""
    from sentinel_tpu_torch.obs.flight import load_bundle

    out = out or sys.stdout  # resolved at call time (test capture swaps it)
    b = load_bundle(path)
    print(
        f"flight bundle: reason={b['reason']!r} pid={b['pid']} "
        f"captured_wall_ms={b['captured_wall_ms']}",
        file=out,
    )
    rows = []  # (t_ns, kind, text)
    for ev in b.get("journal", ()):
        fields = " ".join(f"{k}={v}" for k, v in sorted(ev["fields"].items()))
        rows.append((ev["t_ns"], "event", f"{ev['kind']}  {fields}".rstrip()))
    for s in b.get("spans", ()):
        attrs = s.get("attrs") or {}
        extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        rows.append(
            (
                s["t0_ns"],
                "span",
                f"{s['name']}  dur={s['dur_ns'] / 1e6:.3f}ms  {extra}".rstrip(),
            )
        )
    rows.sort(key=lambda r: r[0])
    t_ref = b.get("captured_mono_ns", rows[-1][0] if rows else 0)
    print(f"timeline ({len(rows)} entries, t relative to capture):", file=out)
    for t_ns, kind, text in rows:
        print(f"  {(t_ns - t_ref) / 1e6:>12.3f}ms  {kind:<5} {text}", file=out)
    provs = b.get("providers") or {}
    for name, section in sorted(provs.items()):
        if name == "timeline" and isinstance(section, dict) and "rows" in section:
            # the last ~30 s of per-resource per-second rows as a table —
            # what each hot resource was doing going into the incident
            print(
                f"provider [timeline] (last {section.get('window_s', '?')}s, "
                f"{len(section.get('resources', []))} resources):",
                file=out,
            )
            _print_timeline_rows(section["rows"], out)
            continue
        print(f"provider [{name}]: {json.dumps(section, sort_keys=True)}", file=out)
    metrics = b.get("metrics") or {}
    hot = {
        k: v
        for k, v in sorted(metrics.items())
        if not isinstance(v, dict)
        and v
        and any(
            t in k
            for t in ("degrade", "failures", "dropped", "shed", "injections",
                      "flight", "resize")
        )
    }
    if hot:
        print("incident counters (non-zero):", file=out)
        for k, v in hot.items():
            print(f"  {k} = {v:g}", file=out)
    # histogram p99 exemplars: the trace ids to chase in the merged
    # Perfetto view — a bad quantile's own span, by id
    exemplars = {
        k: v["p99_exemplar"]
        for k, v in sorted(metrics.items())
        if isinstance(v, dict) and "p99_exemplar" in v
    }
    if exemplars:
        print("p99 exemplars (trace-linkable):", file=out)
        for k, e in exemplars.items():
            print(
                f"  {k} le={e['le']} value={e['value']:g}ms "
                f"trace_id={e['trace_id']}",
                file=out,
            )


def _print_timeline_rows(rows: List[dict], out=None) -> None:
    """Per-second timeline rows (obs/timeline.py dicts) as one table —
    shared by ``--timeline`` and the post-mortem's provider section."""
    out = out or sys.stdout
    if not rows:
        print("  (no timeline rows)", file=out)
        return
    w = max(len(str(r.get("resource", ""))) for r in rows) + 2
    print(
        f"  {'second'.ljust(15)}{'resource'.ljust(w)}{'pass':>8}{'block':>8}"
        f"{'succ':>6}{'exc':>6}{'avgRt':>8}{'minRt':>8}{'conc':>6}  sources",
        file=out,
    )
    for r in rows:
        succ = float(r.get("success", 0))
        avg = float(r.get("rt_sum", 0.0)) / succ if succ else 0.0
        src = r.get("sources")
        src_s = (
            " ".join(f"{k}={v:g}" for k, v in sorted(src.items())) if src else ""
        )
        print(
            f"  {str(r.get('ts', 0)).ljust(15)}"
            f"{str(r.get('resource', '')).ljust(w)}"
            f"{r.get('pass', 0):>8g}{r.get('block', 0):>8g}"
            f"{r.get('success', 0):>6g}{r.get('exception', 0):>6g}"
            f"{avg:>8.2f}{r.get('rt_min', 0.0):>8.2f}"
            f"{r.get('concurrency', 0):>6g}  {src_s}",
            file=out,
        )


def _print_summary(spans: List[dict], out=None) -> None:
    out = out or sys.stdout  # resolved at call time (test capture swaps it)
    summ = OT.summarize(spans)
    if not summ:
        print("no spans recorded", file=out)
        return
    w = max(len(n) for n in summ) + 2
    print(
        f"{'stage'.ljust(w)}{'count':>8}{'p50 ms':>12}{'p99 ms':>12}"
        f"{'mean ms':>12}{'total ms':>12}",
        file=out,
    )
    for name, s in summ.items():
        print(
            f"{name.ljust(w)}{s['count']:>8}{s['p50_ms']:>12.3f}"
            f"{s['p99_ms']:>12.3f}{s['mean_ms']:>12.3f}{s['total_ms']:>12.3f}",
            file=out,
        )
    missing = [n for n in TICK_STAGES if n not in summ]
    if missing:
        print(f"(tick stages absent from this trace: {', '.join(missing)})", file=out)


def _explain_self_capture(device: str = "cuda") -> dict:
    """Drive a small client past a tight flow limit on ``device`` and
    return its provenance-plane payload — the zero-setup ``explain``
    demo (same philosophy as ``_self_capture``)."""
    from sentinel_tpu_torch.core.config import small_engine_config
    from sentinel_tpu_torch.core.rules import FlowRule
    from sentinel_tpu_torch.runtime.client import SentinelClient

    c = SentinelClient(cfg=small_engine_config(), mode="sync", device=device)
    c.start()
    try:
        names = ["cli/checkout", "cli/search"]
        c.flow_rules.load([FlowRule(resource=n, count=2.0) for n in names])
        for _ in range(4):  # one window: 2 pass per resource, rest block
            c.check_batch(names * 2)
        payload = {
            "coverage": c.explain_coverage(),
            "top_causes": c.explain_top_causes(10),
            "recent": [r.to_dict() for r in c.explain_plane.recent(64)],
        }
    finally:
        c.stop()
    return payload


def _print_explain(payload: dict, resource: Optional[str], top: int, out=None) -> None:
    out = out or sys.stdout
    cov = payload.get("coverage") or {}
    print(
        f"explain coverage: blocked={cov.get('blocked', 0)} "
        f"explained={cov.get('explained', 0)} "
        f"({100.0 * float(cov.get('frac', 1.0)):.1f}%)",
        file=out,
    )
    causes = payload.get("top_causes") or []
    if causes:
        print(f"top block causes ({min(top, len(causes))}):", file=out)
        print(
            f"  {'count':>7}  {'kind':<9} {'rule':>5}  {'origin':<8} resource",
            file=out,
        )
        for c in causes[:top]:
            res = c.get("name") or str(c.get("resource", "?"))
            rule = c.get("rule")
            print(
                f"  {c.get('count', 0):>7}  {c.get('kind', '?'):<9} "
                f"{'-' if rule is None else rule:>5}  "
                f"{c.get('origin', ''):<8} {res}",
                file=out,
            )
    recs = payload.get("recent") or []
    if resource:
        recs = [
            r for r in recs
            if r.get("name") == resource or str(r.get("resource")) == resource
        ]
    print(f"recent explanations ({len(recs)}, newest first):", file=out)
    for r in recs:
        res = r.get("name") or str(r.get("resource", "?"))
        obs_v, thr, margin = r.get("observed"), r.get("threshold"), r.get("margin")
        fmt = lambda v: "?" if v is None else f"{v:g}"  # noqa: E731
        flags = "".join(
            tag
            for cond, tag in (
                (r.get("sketch_tier"), "~sketch"),
                (r.get("forced"), " forced"),
                (r.get("possibly_false"), " possibly-false"),
            )
            if cond
        )
        eps = r.get("eps")
        if eps is not None:
            flags += f" eps={eps:g}"
        rule = r.get("rule")
        print(
            f"  {r.get('ts_ms', 0):>13}ms  {res:<24} {r.get('kind', '?'):<9} "
            f"rule={'-' if rule is None else rule:<4} "
            f"observed={fmt(obs_v)} threshold={fmt(thr)} "
            f"margin={fmt(margin)}  [{r.get('origin', '')}]{flags}",
            file=out,
        )


def _explain_cli(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sentinel_tpu_torch.obs explain",
        description="query the verdict provenance plane: why were "
        "decisions blocked?",
    )
    ap.add_argument(
        "--target",
        metavar="HOST:PORT",
        help="live process to query (GET /api/explain); omitted => "
        "self-capture demo",
    )
    ap.add_argument("--resource", help="restrict records to one resource")
    ap.add_argument(
        "--top", type=int, default=10, help="cause-leaderboard rows (default 10)"
    )
    ap.add_argument(
        "--json", action="store_true", dest="as_json", help="raw JSON payload"
    )
    ap.add_argument(
        "--device", default="cuda",
        help="self-capture: where the client runs (default cuda: the card)",
    )
    args = ap.parse_args(argv)
    if args.target:
        from sentinel_tpu_torch.obs.fleet import _http_fetch

        base = (
            args.target
            if args.target.startswith(("http://", "https://"))
            else f"http://{args.target}"
        )
        url = base.rstrip("/") + "/api/explain"
        if args.resource:
            import urllib.parse as _up

            url += f"?resource={_up.quote(args.resource)}"
        payload = json.loads(_http_fetch(url))
    else:
        payload = _explain_self_capture(args.device)
    if args.as_json:
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        _print_explain(payload, args.resource, max(1, args.top))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "explain":
        return _explain_cli(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m sentinel_tpu_torch.obs",
        description="dump / summarize a sentinel-tpu span trace",
    )
    ap.add_argument(
        "input",
        nargs="?",
        help="chrome-trace JSON (from /api/traces or SpanTracer.dump); "
        "omitted => self-capture a SentinelClient run",
    )
    ap.add_argument(
        "--summary", action="store_true", help="per-stage count/p50/p99 table"
    )
    ap.add_argument("--chrome", metavar="OUT", help="write Chrome-trace JSON to OUT")
    ap.add_argument(
        "--json", action="store_true", dest="as_json", help="summary as JSON"
    )
    ap.add_argument(
        "--blocks", type=int, default=4, help="self-capture: blocks to submit"
    )
    ap.add_argument(
        "--device", default="cuda",
        help="self-capture: where the client runs (default cuda: the card)",
    )
    ap.add_argument(
        "--merge",
        nargs="+",
        metavar="TRACE",
        help="join multi-process chrome-trace dumps into one (flow events "
        "link client RPC spans to the server decision spans)",
    )
    ap.add_argument(
        "-o", "--out", metavar="OUT",
        help="output path for --merge (default: stdout)",
    )
    ap.add_argument(
        "--profile",
        nargs="?",
        const=250.0,
        type=float,
        metavar="MS",
        help="deep-profile capture: force-enable tracing for MS "
        "milliseconds (default 250) over a self-capture workload and "
        "emit the window as a Chrome trace (-o/--chrome to write it)",
    )
    ap.add_argument(
        "--postmortem",
        metavar="BUNDLE",
        help="analyze a flight-recorder bundle (GET /api/flight / "
        "SENTINEL_FLIGHT_DIR): merged event/span timeline + providers",
    )
    ap.add_argument(
        "--fleet",
        nargs="*",
        metavar="TARGET",
        help="scrape + merge fleet /metrics into one exposition "
        "(targets: host:port or URL; none => SENTINEL_FLEET_TARGETS + "
        "registered targets + this process's registry)",
    )
    ap.add_argument(
        "--timeline",
        nargs="*",
        metavar="TARGET",
        help="fetch + merge fleet /api/metric per-second timelines "
        "(targets as for --fleet; none => SENTINEL_FLEET_TARGETS + "
        "registered targets + this process's live recorders); filter "
        "with --resource / --start / --end",
    )
    ap.add_argument("--resource", help="--timeline: restrict to one resource")
    ap.add_argument(
        "--start", type=int, default=0, help="--timeline: range start (wall ms)"
    )
    ap.add_argument(
        "--end", type=int, default=2**62, help="--timeline: range end (wall ms)"
    )
    args = ap.parse_args(argv)

    if args.timeline is not None:
        from sentinel_tpu_torch.obs.fleet import fleet_timeline

        rows = fleet_timeline(
            resource=args.resource,
            start_ms=args.start,
            end_ms=args.end,
            targets=args.timeline or None,
        )
        if args.as_json or args.out:
            text = json.dumps(rows, indent=2)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(text)
                print(f"wrote {args.out} ({len(rows)} rows)")
            else:
                print(text)
        else:
            _print_timeline_rows(rows)
        return 0

    if args.fleet is not None:
        from sentinel_tpu_torch.obs.fleet import fleet_exposition

        text = fleet_exposition(targets=args.fleet or None)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
            print(f"wrote {args.out} ({len(text.splitlines())} lines)")
        else:
            sys.stdout.write(text)
        return 0
    if args.profile is not None:
        cap = _profile_capture(args.profile, max(1, args.blocks), args.device)
        if "error" in cap:
            print(f"capture failed: {json.dumps(cap)}", file=sys.stderr)
            return 1
        out_path = args.out or args.chrome
        if out_path:
            with open(out_path, "w") as f:
                json.dump(cap["chrome_trace"], f)
            print(
                f"wrote {out_path} ({cap['span_count']} spans, "
                f"{cap['ms']:g}ms window)"
            )
        else:
            print(
                json.dumps(
                    {k: cap[k] for k in ("ms", "t0_ns", "t1_ns", "span_count")},
                    indent=2,
                )
            )
            window = [
                s
                for s in OT.TRACER.snapshot()
                if cap["t0_ns"] <= s["t0_ns"] <= cap["t1_ns"]
            ]
            _print_summary(window)
        return 0
    if args.postmortem:
        _print_postmortem(args.postmortem)
        return 0
    if args.merge:
        doc = merge_traces(args.merge)
        n = len(doc["traceEvents"])
        links = doc["otherData"]["flow_links"]
        if args.out:
            with open(args.out, "w") as f:
                json.dump(doc, f)
            print(f"wrote {args.out} ({n} events, {links} flow links)")
        else:
            json.dump(doc, sys.stdout)
            print()
        return 0

    if args.input:
        spans = OT.load_spans(args.input)
    else:
        spans = _self_capture(n_blocks=max(1, args.blocks), device=args.device)

    did = False
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(OT.TRACER.chrome_trace(spans), f)
        print(f"wrote {args.chrome} ({len(spans)} spans)")
        did = True
    if args.as_json:
        print(json.dumps(OT.summarize(spans), indent=2))
        did = True
    if args.summary or not did:
        _print_summary(spans)
    return 0


if __name__ == "__main__":
    sys.exit(main())
