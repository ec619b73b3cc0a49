"""WSGI middleware — the servlet-filter adapter.

The analog of sentinel-web-servlet's CommonFilter + the WebMVC
interceptor's lifecycle (AbstractSentinelInterceptor.java:88-137): every
request enters a resource named ``METHOD:path`` (customizable), with the
origin parsed from the request (S-user header by default); blocked requests
get a 429 response; the entry exits when the response body is fully
consumed, so RT covers streaming responses.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from sentinel_tpu_torch.adapters._common import resolve_client
from sentinel_tpu_torch.core import errors as ERR

DEFAULT_BLOCK_BODY = b"Blocked by Sentinel (flow limiting)"
ORIGIN_HEADER = "HTTP_S_USER"  # S-user: the reference's default origin header


def default_resource_extractor(environ) -> str:
    return f"{environ.get('REQUEST_METHOD', 'GET')}:{environ.get('PATH_INFO', '/')}"


def default_origin_parser(environ) -> str:
    return environ.get(ORIGIN_HEADER, "")


class _EntryClosingIterator:
    """Wraps the app's response iterable; exits the entry on close so RT
    spans the full response, and traces errors raised mid-stream."""

    def __init__(self, iterable: Iterable[bytes], entry):
        self._it = iter(iterable)
        self._iterable = iterable
        self._entry = entry

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            raise
        except Exception as e:
            self._entry.trace(e)
            raise

    def close(self):
        try:
            close = getattr(self._iterable, "close", None)
            if close is not None:
                close()
        finally:
            self._entry.exit()


class SentinelWSGIMiddleware:
    def __init__(
        self,
        app,
        client=None,
        resource_extractor: Callable = default_resource_extractor,
        origin_parser: Callable = default_origin_parser,
        block_status: str = "429 Too Many Requests",
        block_body: bytes = DEFAULT_BLOCK_BODY,
        context_name: Optional[str] = None,
    ):
        self.app = app
        self._client = client
        self.resource_extractor = resource_extractor
        self.origin_parser = origin_parser
        self.block_status = block_status
        self.block_body = block_body
        self.context_name = context_name

    @property
    def client(self):
        if self._client is None:
            self._client = resolve_client(None)
        return self._client

    def __call__(self, environ, start_response):
        resource = self.resource_extractor(environ)
        if not resource:
            return self.app(environ, start_response)
        origin = self.origin_parser(environ) or ""
        try:
            entry = self.client.entry(resource, inbound=True, origin=origin)
        except ERR.BlockException:
            start_response(
                self.block_status,
                [
                    ("Content-Type", "text/plain; charset=utf-8"),
                    ("Content-Length", str(len(self.block_body))),
                ],
            )
            return [self.block_body]
        try:
            result = self.app(environ, start_response)
        except Exception as e:
            entry.trace(e)
            entry.exit()
            raise
        return _EntryClosingIterator(result, entry)
