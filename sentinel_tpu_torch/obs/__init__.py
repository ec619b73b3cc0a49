"""sentinel_tpu_torch.obs — the port's observability plane.

Copies of the JAX package's jax-free host modules (``sentinel_tpu/obs``):

* ``obs.registry`` — counters, gauges and power-of-two histograms with
  Prometheus text exposition; the port's own process-global ``REGISTRY``;
* ``obs.timeline`` — the per-resource timeline: the tick's top-K rows
  folded into per-second records and an indexed on-disk metric log;
* ``obs.explain`` — the verdict-provenance plane: the wire's explain
  section decoded into per-resource "why blocked" rings.

The span tracer, the flight recorder, the SLO engine, the fleet view and
the device profile are not ported yet (ROADMAP.md, Queue A items 6 and 10).
"""

from sentinel_tpu_torch.obs.registry import REGISTRY, Counter, Gauge, Histogram, MetricRegistry

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricRegistry"]
