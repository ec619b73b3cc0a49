"""Machine discovery — who is alive, per app.

The analog of sentinel-dashboard's discovery package
(SimpleMachineDiscovery / AppManagement + MachineRegistryController):
heartbeats POSTed to /registry/machine upsert a MachineInfo; a machine is
healthy while its last heartbeat is younger than ``stale_after_s``.

The port's copy of ``sentinel_tpu/dashboard/discovery.py``; it touches no tensor.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from sentinel_tpu_torch.utils.time_source import wall_s


@dataclass
class MachineInfo:
    app: str
    ip: str
    port: int
    hostname: str = ""
    pid: int = 0
    version: str = ""
    last_heartbeat: float = field(default_factory=wall_s)

    @property
    def key(self) -> str:
        return f"{self.ip}:{self.port}"

    def healthy(self, stale_after_s: float = 30.0) -> bool:
        return (wall_s() - self.last_heartbeat) < stale_after_s

    def to_json(self) -> dict:
        return {
            "app": self.app,
            "ip": self.ip,
            "port": self.port,
            "hostname": self.hostname,
            "pid": self.pid,
            "version": self.version,
            "lastHeartbeat": int(self.last_heartbeat * 1000),
            "healthy": self.healthy(),
        }


class AppManagement:
    def __init__(self, stale_after_s: float = 30.0):
        self._apps: Dict[str, Dict[str, MachineInfo]] = {}
        self._lock = threading.Lock()
        self.stale_after_s = stale_after_s

    def register(self, info: MachineInfo) -> None:
        with self._lock:
            machines = self._apps.setdefault(info.app, {})
            existing = machines.get(info.key)
            if existing is not None:
                existing.last_heartbeat = info.last_heartbeat
                existing.pid = info.pid
                existing.hostname = info.hostname
                existing.version = info.version
            else:
                machines[info.key] = info

    def apps(self) -> List[str]:
        return sorted(self._apps)

    def machines(self, app: str, only_healthy: bool = False) -> List[MachineInfo]:
        out = list(self._apps.get(app, {}).values())
        if only_healthy:
            out = [m for m in out if m.healthy(self.stale_after_s)]
        return sorted(out, key=lambda m: m.key)

    def get_machine(self, app: str, ip: str, port: int) -> Optional[MachineInfo]:
        return self._apps.get(app, {}).get(f"{ip}:{port}")

    def remove_stale(self, older_than_s: float = 600.0) -> int:
        """Drop machines silent for a long time; returns #removed."""
        cutoff = wall_s() - older_than_s
        removed = 0
        with self._lock:
            for machines in self._apps.values():
                for key in [k for k, m in machines.items() if m.last_heartbeat < cutoff]:
                    del machines[key]
                    removed += 1
        return removed
