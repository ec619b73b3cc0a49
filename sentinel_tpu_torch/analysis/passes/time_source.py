"""time-source: raw clock reads outside utils/time_source.py.

The port's copy of ``sentinel_tpu/analysis/passes/time_source.py``: the
hazard is language-neutral, so the pass is the reference's; the
allowlist names the same three modules.

Sentinel's rule (the cached-TimeUtil discipline, TimeUtil.java:25-50):
every clock read goes through ONE module.  Kernels take ``now_ms`` as an
explicit input; the host side reads ``TimeSource``/``VirtualTimeSource``
or the module helpers in utils/time_source.py.  A raw ``time.time()``
elsewhere (a) escapes virtual time, silently making a test
wall-clock-dependent, and (b) re-opens the per-call syscall cost the
cached source exists to amortize.

Flagged: time.time / time.monotonic / time.monotonic_ns / time.time_ns /
datetime.now / datetime.utcnow, via any import alias.  Not flagged:
time.perf_counter* (profiling-only, never feeds a decision), time.sleep
(not a clock READ), and everything inside the allowlisted module.
"""

from __future__ import annotations

import ast
from typing import Iterable

from sentinel_tpu_torch.analysis import astutil as A
from sentinel_tpu_torch.analysis.framework import ERROR, Finding, ParsedModule, Pass

_BANNED = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
}

#: the modules allowed to touch the clock: utils/time_source (the host
#: time discipline); obs/trace.py, whose ``now_ns()`` is the span
#: tracer's single sanctioned monotonic read point — span brackets at µs
#: durations need the raw ns clock, and keeping that read in ONE
#: function preserves the greppability rule this pass enforces; and
#: chaos/failpoints.py, the fault-injection plane's single sanctioned
#: home for time manipulation (the ``delay`` action sleeps and
#: ``clock_skew`` shifts values an armed plan dictates — any future
#: clock read those actions need must live there, nowhere else)
_ALLOWED_FILES = (
    "*utils/time_source.py",
    "*obs/trace.py",
    "*chaos/failpoints.py",
)


class TimeSourcePass(Pass):
    name = "time-source"
    description = "raw clock reads must route through utils/time_source"
    severity = ERROR

    def run(self, mod: ParsedModule) -> Iterable[Finding]:
        if A.path_matches(mod.path, _ALLOWED_FILES):
            return
        aliases = A.import_aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = A.resolve_call(node, aliases)
            if name in _BANNED:
                yield self.finding(
                    mod,
                    node,
                    f"raw clock read {name}() — use the client's TimeSource "
                    "or a utils.time_source helper (keeps virtual time and "
                    "the cached-clock discipline intact)",
                )
