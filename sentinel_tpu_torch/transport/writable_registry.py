"""Write-back registry: dashboard-pushed rules → durable datasources.

The port's copy of ``sentinel_tpu/transport/writable_registry.py``.

The analog of WritableDataSourceRegistry.java: when ``setRules`` arrives on
the command plane, the new rule list is also written to the
WritableDataSource registered for that rule kind, so pushed config survives
process restart (rules durable, counters disposable — SURVEY §5).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class WritableDataSourceRegistry:
    def __init__(self):
        self._sources: Dict[str, object] = {}
        self._lock = threading.Lock()

    def register(self, kind: str, source) -> None:
        """kind: "flow" | "degrade" | "system" | "authority" | "param-flow"."""
        with self._lock:
            self._sources[kind] = source

    def get(self, kind: str) -> Optional[object]:
        return self._sources.get(kind)

    def write(self, kind: str, rules: list) -> bool:
        src = self._sources.get(kind)
        if src is None:
            return False
        src.write(rules)
        return True


_default = WritableDataSourceRegistry()


def default_registry() -> WritableDataSourceRegistry:
    return _default
