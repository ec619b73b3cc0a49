"""Metrics plane: the external-metrics callback SPI.

The port's copy of what it has ported of ``sentinel_tpu/metrics``: the
metric extension SPI (``metrics/extension.py``), whose callbacks the
client fires on every pass, block, completion and business exception.
The metric log writer / searcher, the per-second aggregation and the
block log are not ported yet (ROADMAP.md, Queue A items 4 and 6).
"""

from sentinel_tpu_torch.metrics.extension import (
    MetricExtension,
    clear_extensions,
    get_extensions,
    register_extension,
    safe_dispatch,
    unregister_extension,
)

__all__ = [
    "MetricExtension",
    "register_extension",
    "unregister_extension",
    "clear_extensions",
    "get_extensions",
    "safe_dispatch",
]
