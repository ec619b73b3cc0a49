"""Outbound HTTP client guard — the okhttp/apache-httpclient adapter.

The analog of sentinel-okhttp-adapter / sentinel-apache-httpclient-adapter:
wrap outbound HTTP calls as outbound resources so dependencies can be
flow-limited and circuit-broken.  Two surfaces:

- ``guarded_urlopen(url, ...)`` — drop-in for urllib.request.urlopen
- ``SentinelHttpClient`` — wraps any callable transport (e.g. a
  requests.Session.request) with resource naming per (method, host, path)
"""

from __future__ import annotations

import urllib.parse
import urllib.request
from typing import Callable, Optional

from sentinel_tpu_torch.adapters._common import resolve_client


def default_url_resource(method: str, url: str) -> str:
    """`METHOD:scheme://host/path` — query stripped, like the reference's
    default URL cleaner (avoids unbounded resource cardinality)."""
    p = urllib.parse.urlparse(url)
    return f"{method.upper()}:{p.scheme}://{p.netloc}{p.path}"


def guarded_urlopen(url, data=None, timeout=None, *, client=None, resource=None, **kw):
    c = resolve_client(client)
    if resource is None:
        target = url.full_url if hasattr(url, "full_url") else url
        method = "POST" if data is not None else "GET"
        if hasattr(url, "get_method"):
            method = url.get_method()
        resource = default_url_resource(method, target)
    # Entry.__exit__ traces the propagating exception — no manual trace here
    # or each failure would count twice
    with c.entry(resource, inbound=False):
        return urllib.request.urlopen(url, data=data, timeout=timeout, **kw)


class SentinelHttpClient:
    """Wraps a transport callable ``send(method, url, **kw)``."""

    def __init__(
        self,
        send: Callable,
        client=None,
        resource_fn: Callable[[str, str], str] = default_url_resource,
    ):
        self._send = send
        self._client = client
        self._resource_fn = resource_fn

    def request(self, method: str, url: str, **kw):
        c = resolve_client(self._client)
        with c.entry(self._resource_fn(method, url), inbound=False):
            return self._send(method, url, **kw)
