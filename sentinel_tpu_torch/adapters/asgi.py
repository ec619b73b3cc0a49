"""ASGI middleware — the reactive web adapter.

The analog of sentinel-spring-webflux-adapter's SentinelWebFluxFilter:
guards async HTTP apps (Starlette/FastAPI/...). The entry handshake is a
blocking wait on the engine tick (~1 ms); it runs in a thread-pool executor
so the event loop never blocks, mirroring how the reactor adapter moves
the entry onto subscription (SentinelReactorSubscriber).
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from sentinel_tpu_torch.adapters._common import resolve_client
from sentinel_tpu_torch.core import errors as ERR

DEFAULT_BLOCK_BODY = b"Blocked by Sentinel (flow limiting)"


def default_resource_extractor(scope) -> str:
    return f"{scope.get('method', 'GET')}:{scope.get('path', '/')}"


def default_origin_parser(scope) -> str:
    for k, v in scope.get("headers", []):
        if k.lower() == b"s-user":
            return v.decode("latin-1")
    return ""


class SentinelASGIMiddleware:
    def __init__(
        self,
        app,
        client=None,
        resource_extractor: Callable = default_resource_extractor,
        origin_parser: Callable = default_origin_parser,
        block_status: int = 429,
        block_body: bytes = DEFAULT_BLOCK_BODY,
    ):
        self.app = app
        self._client = client
        self.resource_extractor = resource_extractor
        self.origin_parser = origin_parser
        self.block_status = block_status
        self.block_body = block_body

    @property
    def client(self):
        if self._client is None:
            self._client = resolve_client(None)
        return self._client

    async def __call__(self, scope, receive, send):
        if scope.get("type") != "http":
            await self.app(scope, receive, send)
            return
        resource = self.resource_extractor(scope)
        origin = self.origin_parser(scope) or ""
        loop = asyncio.get_running_loop()
        try:
            entry = await loop.run_in_executor(
                None, lambda: self.client.entry(resource, inbound=True, origin=origin)
            )
        except ERR.BlockException:
            await send(
                {
                    "type": "http.response.start",
                    "status": self.block_status,
                    "headers": [
                        (b"content-type", b"text/plain; charset=utf-8"),
                        (b"content-length", str(len(self.block_body)).encode()),
                    ],
                }
            )
            await send({"type": "http.response.body", "body": self.block_body})
            return
        try:
            await self.app(scope, receive, send)
        except Exception as e:
            entry.trace(e)
            raise
        finally:
            entry.exit()
