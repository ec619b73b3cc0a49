"""Observability plane: metric log writer/searcher, per-second aggregation,
and the external-metrics callback SPI (SURVEY §3.5).

The port's copy of what it has ported of ``sentinel_tpu/metrics``: the
metric line codec (``node.py``), the metric log writer and searcher, the
per-second ``MetricTimerListener`` over ``ClientStats.snapshot``, and the
metric extension SPI, whose callbacks the client fires on every pass,
block, completion and business exception; and the block log
(``block_log.py``: ``sentinel-block.log``, one line per blocked key a
second, with the explain plane's cause and rule slot when it has them).
"""

from sentinel_tpu_torch.metrics.block_log import BlockLogger, default_block_logger, parse_line
from sentinel_tpu_torch.metrics.extension import (
    MetricExtension,
    clear_extensions,
    get_extensions,
    register_extension,
    safe_dispatch,
    unregister_extension,
)
from sentinel_tpu_torch.metrics.node import MetricNode
from sentinel_tpu_torch.metrics.searcher import MetricSearcher
from sentinel_tpu_torch.metrics.timer import MetricTimerListener
from sentinel_tpu_torch.metrics.writer import MetricWriter, list_metric_files, metric_file_base

__all__ = [
    "BlockLogger",
    "default_block_logger",
    "parse_line",
    "MetricNode",
    "MetricWriter",
    "MetricSearcher",
    "MetricTimerListener",
    "MetricExtension",
    "register_extension",
    "unregister_extension",
    "clear_extensions",
    "get_extensions",
    "safe_dispatch",
    "list_metric_files",
    "metric_file_base",
]
