"""Heartbeat sender — registers this instance with the dashboard.

The port's copy of ``sentinel_tpu/transport/heartbeat.py``.

The analog of SimpleHttpHeartbeatSender.java:61 + HeartbeatSenderInitFunc:
a daemon loop POSTs ``/registry/machine`` on every configured dashboard
address at a fixed interval, carrying app/ip/port/hostname/version, so the
dashboard's machine discovery stays fresh.  Failures rotate to the next
dashboard address and never propagate.
"""

from __future__ import annotations

import os
import socket
import threading
import urllib.parse
import urllib.request
from typing import List, Optional

from sentinel_tpu_torch.chaos import failpoints as FP

DEFAULT_INTERVAL_S = 10.0

#: chaos failpoint: a raise rides the rotate-on-failure catch below
_FP_HB_SEND = FP.register(
    "transport.heartbeat.send", "dashboard heartbeat POST", FP.HIT_ACTIONS
)


def _local_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


class HeartbeatSender:
    def __init__(
        self,
        app_name: str,
        command_port: Optional[int] = None,
        dashboard_addresses: List[str] = (),
        interval_s: float = DEFAULT_INTERVAL_S,
        ip: Optional[str] = None,
        auth_token: Optional[str] = None,
        center=None,
    ):
        # auth_token is the DASHBOARD's bearer token: when the dashboard
        # runs with auth, /registry/machine requires it too (an open
        # registry would feed its proxy allowlist and metric fetcher).
        # Passing center= (the SimpleHttpCommandCenter) derives both the
        # port and the advertised ip: a loopback-bound center must
        # advertise 127.0.0.1 — advertising the NIC ip would make the
        # dashboard dial an address nothing listens on.
        self.app_name = app_name
        if center is not None:
            if command_port is None:
                command_port = center.port
                if command_port is None:
                    raise ValueError("center is not started yet (center.port is None)")
            if ip is None:
                if center.host in ("127.0.0.1", "localhost", "::1"):
                    ip = "127.0.0.1"
                elif center.host not in ("", "0.0.0.0", "::"):
                    # bound to one concrete NIC address: advertise exactly
                    # that — _local_ip() could pick a different interface
                    ip = center.host
        if command_port is None:
            raise ValueError("command_port or center is required")
        self.command_port = command_port
        self.auth_token = auth_token
        self.addresses = [a.strip() for a in dashboard_addresses if a.strip()]
        self.interval_s = interval_s
        self.ip = ip or _local_ip()
        self.hostname = socket.gethostname()
        self._idx = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sent_ok = 0
        self.sent_fail = 0

    def start(self) -> None:
        if self._thread is not None or not self.addresses:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="sentinel-tpu-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def send_once(self, timeout_s: float = 3.0) -> bool:
        """One heartbeat to the current dashboard address; rotates on failure."""
        import sentinel_tpu_torch

        if not self.addresses:
            return False

        params = urllib.parse.urlencode(
            {
                "app": self.app_name,
                "ip": self.ip,
                "port": self.command_port,
                "pid": os.getpid(),
                "hostname": self.hostname,
                "version": sentinel_tpu_torch.__version__,
            }
        )
        addr = self.addresses[self._idx % len(self.addresses)]
        url = f"http://{addr}/registry/machine"
        try:
            FP.hit(_FP_HB_SEND)
            from sentinel_tpu_torch.utils.authn import bearer_header

            # the custom header doubles as CSRF proof: a cross-site form
            # POST cannot set it, so a browser on the operator's machine
            # can't forge registrations into a loopback-bound dashboard
            headers = {"X-Sentinel-Heartbeat": "1", **bearer_header(self.auth_token)}
            req = urllib.request.Request(
                url,
                data=params.encode("ascii"),
                method="POST",
                headers=headers,
            )
            with urllib.request.urlopen(req, timeout=timeout_s) as rsp:
                ok = 200 <= rsp.status < 300
        except Exception:  # noqa: BLE001 — a bad address (InvalidURL is not
            # an OSError) must rotate, never kill the heartbeat loop
            ok = False
        if ok:
            self.sent_ok += 1
        else:
            self.sent_fail += 1
            self._idx += 1  # rotate to the next dashboard address
        return ok

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.send_once()
