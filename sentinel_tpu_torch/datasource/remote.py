"""Remote datasources — the store-specific module family, as two patterns.

The reference ships eight store-specific datasource modules (nacos, zk,
etcd, redis, consul, apollo, eureka, spring-cloud-config), each a thin
binding of one client library onto the same two patterns:

- POLL:  re-read the source on an interval (AutoRefreshDataSource)
- PUSH:  a store watcher calls back with the new content

This module provides both patterns store-agnostically:

- ``HttpDataSource``     — polls any HTTP(S) endpoint (config servers,
                           spring-cloud-config, consul KV's HTTP API, ...)
- ``CallbackDataSource`` — push-style: wire ANY client's watch callback to
                           ``.update(source)`` (nacos Listener, zookeeper
                           watcher, etcd watch, redis pub/sub handler)

Store clients themselves are not bundled (none are available in this
image); binding one is 5 lines on top of CallbackDataSource — see the
class docstring.

The port's copy of ``sentinel_tpu/datasource/remote.py``; it touches no tensor.
"""

from __future__ import annotations

import urllib.request
from typing import Callable, Optional

from sentinel_tpu_torch.datasource.base import (
    AbstractDataSource,
    AutoRefreshDataSource,
    Converter,
)


class HttpDataSource(AutoRefreshDataSource[str, object]):
    """Poll an HTTP(S) URL for rule content.

    Uses ETag/Last-Modified when the server provides them (304 → no
    property push), mirroring FileRefreshableDataSource's mtime check."""

    def __init__(
        self,
        url: str,
        parser: Converter,
        refresh_ms: int = 3000,
        timeout_s: float = 3.0,
        headers: Optional[dict] = None,
    ):
        self.url = url
        self.timeout_s = timeout_s
        self.headers = dict(headers or {})
        self._etag: Optional[str] = None
        self._last_modified: Optional[str] = None
        self._not_modified = False
        super().__init__(parser, refresh_ms=refresh_ms)
        try:
            self.get_property().update_value(self.load_config())
        except Exception:  # noqa: BLE001 — initial fetch may fail; poll retries
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log().warning("HttpDataSource initial load failed: %s", url)

    def read_source(self) -> str:
        req = urllib.request.Request(self.url, headers=self.headers)
        if self._etag:
            req.add_header("If-None-Match", self._etag)
        if self._last_modified:
            req.add_header("If-Modified-Since", self._last_modified)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as rsp:
                self._etag = rsp.headers.get("ETag")
                self._last_modified = rsp.headers.get("Last-Modified")
                self._not_modified = False
                return rsp.read().decode("utf-8")
        except urllib.error.HTTPError as e:
            if e.code == 304:
                self._not_modified = True
                return ""
            raise

    def is_modified(self) -> bool:
        return True  # delegated to the conditional GET in read_source

    def refresh(self) -> bool:
        try:
            source = self.read_source()
        except Exception:  # noqa: BLE001
            self.on_refresh_failed()
            return False
        if self._not_modified:
            return False
        self.get_property().update_value(self.load_config(source))
        return True


class CallbackDataSource(AbstractDataSource):
    """Push-style datasource: an external watcher feeds ``update()``.

    Binding a real store is the same 5 lines the reference's modules are
    made of, e.g. nacos:

        ds = CallbackDataSource(json_rule_converter("flow"))
        nacos_client.add_config_watcher(data_id, group,
                                        lambda cfg: ds.update(cfg.content))
        client.flow_rules.register_property(ds.get_property())

    or redis pub/sub:

        pubsub.subscribe(**{channel: lambda m: ds.update(m["data"])})
    """

    def __init__(self, parser: Converter, initial: Optional[str] = None):
        super().__init__(parser)
        if initial is not None:
            self.update(initial)

    def read_source(self) -> str:
        raise NotImplementedError("push-style source; use update()")

    def update(self, source: str) -> None:
        """Called by the store watcher with new raw content."""
        self.get_property().update_value(self.load_config(source))
