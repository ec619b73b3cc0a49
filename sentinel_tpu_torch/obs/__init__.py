"""sentinel_tpu_torch.obs — the port's observability plane.

Copies of the JAX package's jax-free host modules (``sentinel_tpu/obs``):

* ``obs.trace``    — the lock-light fixed-capacity span tracer (ring
  buffer, Chrome-trace / Perfetto export, the wire trace context), whose
  profiler passthrough enters ``torch.profiler.record_function``;
* ``obs.registry`` — counters, gauges and power-of-two histograms with
  Prometheus text exposition; the port's own process-global ``REGISTRY``;
* ``obs.timeline`` — the per-resource timeline: the tick's top-K rows
  folded into per-second records and an indexed on-disk metric log;
* ``obs.explain`` — the verdict-provenance plane: the wire's explain
  section decoded into per-resource "why blocked" rings.

Tracing defaults OFF: call ``obs.enable()`` (or set ``SENTINEL_TRACE=1``)
to start recording; ``summarize(TRACER.snapshot())`` gives each span
name's count, p50 / p99, mean and total ms.  Disabled, every instrumented
call site pays one flag check — no allocation, no formatting, no clock
read.

* ``obs.flight``   — the black-box flight recorder: an always-on journal
  of state transitions and triggered post-mortem bundles (``FLIGHT``);
* ``obs.profile``  — the continuous profiling plane: the device memory
  ledger (``LEDGER``), the retrace journal of new tick bindings
  (``RETRACE``), bounded profile capture and the online sketch-accuracy
  audit (``SketchAudit``);
* ``obs.slo``      — declarative SLOs judged by multi-window burn rates
  over the registry (``SloEngine``, ``default_slos``);
* ``obs.fleet``    — the fleet view: scrapes merged into one exposition
  (``GET /metrics?fleet=1``) and one per-resource timeline.

The trace CLI (``python -m sentinel_tpu.obs`` in the reference) is not
ported yet (ROADMAP.md, Queue A item A10).
"""

from sentinel_tpu_torch.obs.flight import FLIGHT, FlightRecorder, load_bundle
from sentinel_tpu_torch.obs.profile import (
    LEDGER,
    RETRACE,
    MemoryLedger,
    RetraceObservatory,
    SketchAudit,
    capture_profile,
    expected_retrace,
    ledger_owner,
)
from sentinel_tpu_torch.obs.registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    register_build_info,
    register_scrape_id,
)
from sentinel_tpu_torch.obs.trace import (
    TRACER,
    SpanTracer,
    current_ctx,
    event,
    load_spans,
    maybe_ctx,
    new_span_id,
    new_trace_id,
    now_ns,
    stage,
    stage_ns,
    summarize,
    t0,
    trace_ctx,
)

# every /metrics scrape says what it scraped, and from which process
register_build_info()
register_scrape_id()


def enable(torch_annotations: bool = False) -> None:
    """Turn span recording on (optionally mirroring spans into
    ``torch.profiler.record_function`` so they land in a torch.profiler
    capture beside the kernels)."""
    TRACER.enable(torch_annotations=torch_annotations)


def disable() -> None:
    TRACER.disable()


def enabled() -> bool:
    return TRACER.enabled


def span(name: str, trace: int = 0, **attrs):
    """Context-manager span on the default tracer (no-op when disabled)."""
    return TRACER.span(name, trace, **attrs)


__all__ = [
    "FLIGHT",
    "LEDGER",
    "REGISTRY",
    "RETRACE",
    "TRACER",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MemoryLedger",
    "MetricRegistry",
    "RetraceObservatory",
    "SketchAudit",
    "SpanTracer",
    "capture_profile",
    "current_ctx",
    "disable",
    "enable",
    "enabled",
    "event",
    "expected_retrace",
    "ledger_owner",
    "load_bundle",
    "load_spans",
    "maybe_ctx",
    "new_span_id",
    "new_trace_id",
    "now_ns",
    "register_build_info",
    "register_scrape_id",
    "span",
    "stage",
    "stage_ns",
    "summarize",
    "t0",
    "trace_ctx",
]
