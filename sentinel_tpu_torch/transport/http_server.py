"""HTTP command center — the per-instance command plane.

The port's copy of ``sentinel_tpu/transport/http_server.py``.

The analog of sentinel-transport-simple-http's SimpleHttpCommandCenter:
a small HTTP/1.1 server (stdlib ThreadingHTTPServer — the reference
hand-rolls one on ServerSocket) exposing every registered command at
``GET/POST /<commandName>``.  Default port 8719; when taken, the port
auto-increments, as TransportConfig does.

Responses: JSON for structured results, text/plain for strings; failures
get HTTP 400 with the message.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.transport.command import CommandRegistry, CommandRequest

DEFAULT_PORT = 8719

#: chaos failpoint: a raise aborts just this HTTP exchange (the threading
#: server's per-connection handler); the command center stays up
_FP_HTTP_REQ = FP.register(
    "transport.http.request", "command-center HTTP request service", FP.HIT_ACTIONS
)
MAX_PORT_PROBES = 100


class _Handler(BaseHTTPRequestHandler):
    registry: CommandRegistry = None  # set by server factory
    auth_token: Optional[str] = None  # set by server factory
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs to command log
        from sentinel_tpu_torch.utils.record_log import command_center_log

        command_center_log().info("%s - %s", self.address_string(), fmt % args)

    def _dispatch(self, body: str = "") -> None:
        from sentinel_tpu_torch.utils.authn import check_bearer

        if not check_bearer(self.headers.get("Authorization"), self.auth_token):
            payload = b"unauthorized"
            self.send_response(401)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return
        parsed = urllib.parse.urlparse(self.path)
        name = parsed.path.strip("/")
        params = {k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        if body and "=" in body and not body.lstrip().startswith(("[", "{")):
            # form-encoded POST body merges into params (data=... uploads)
            for k, v in urllib.parse.parse_qs(body).items():
                params.setdefault(k, v[-1])
            body = params.get("data", body)
        FP.hit(_FP_HTTP_REQ)
        rsp = self.registry.handle(name, CommandRequest(parameters=params, body=body))
        if rsp.success:
            if isinstance(rsp.result, str):
                payload = rsp.result.encode("utf-8")
                ctype = "text/plain; charset=utf-8"
            else:
                payload = json.dumps(rsp.result).encode("utf-8")
                ctype = "application/json; charset=utf-8"
            self.send_response(200)
        else:
            payload = str(rsp.result).encode("utf-8")
            ctype = "text/plain; charset=utf-8"
            self.send_response(400)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        self._dispatch()

    def do_POST(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length).decode("utf-8") if length else ""
        self._dispatch(body)


class SimpleHttpCommandCenter:
    """Command-plane HTTP server.

    ``host=None`` binds 127.0.0.1; serving other machines (mutating
    commands: setRules, setSwitch, setClusterMode) requires an explicit
    ``host='0.0.0.0'``, ideally with ``auth_token`` — when a token is set
    every command requires ``Authorization: Bearer``.
    """

    def __init__(
        self,
        registry: CommandRegistry,
        host: Optional[str] = None,
        port: int = DEFAULT_PORT,
        auth_token: Optional[str] = None,
    ):
        from sentinel_tpu_torch.utils.authn import default_bind_host, normalize_token

        self.registry = registry
        self.auth_token = normalize_token(auth_token)
        self.host = default_bind_host(host)
        self.requested_port = port
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._server is not None:
            return
        handler = type(
            "BoundHandler",
            (_Handler,),
            {"registry": self.registry, "auth_token": self.auth_token},
        )
        last_err = None
        for probe in range(MAX_PORT_PROBES):
            try:
                self._server = ThreadingHTTPServer((self.host, self.requested_port + probe), handler)
                break
            except OSError as e:
                last_err = e
        if self._server is None:
            raise OSError(f"no free command-center port near {self.requested_port}: {last_err}")
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="sentinel-tpu-command-center", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.port = None
