"""Datasource SPI: readable/writable config sources feeding properties.

The port's copy of ``sentinel_tpu/datasource/base.py``.

Reference surface (sentinel-datasource-extension):
  * ReadableDataSource.java:28 — loadConfig():36 / readSource():44 / getProperty()
  * WritableDataSource.java:24 — write(value)
  * AbstractDataSource holds a DynamicSentinelProperty + a Converter
  * AutoRefreshDataSource polls readSource on a daemon timer (default 3 s),
    guarded by an ``is_modified`` hook
  * FileRefreshableDataSource checks file mtime; first load happens in the
    constructor; oversized files are refused (MAX_SIZE 4 MiB)
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Generic, Optional, TypeVar

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.datasource.property import DynamicSentinelProperty, SentinelProperty

S = TypeVar("S")
T = TypeVar("T")

#: Converter<S, T> (datasource/Converter.java): parse source payload → config.
Converter = Callable[[S], T]

MAX_FILE_SIZE = 4 * 1024 * 1024
DEFAULT_REFRESH_MS = 3000

#: chaos failpoints: a raise on ``refresh.read`` rides the poll loop's
#: existing catch (rules stay, on_refresh_failed re-arms); ``file.read``
#: strikes inside read_source so first loads degrade too
_FP_REFRESH = FP.register(
    "datasource.refresh.read", "auto-refresh poll iteration", FP.HIT_ACTIONS
)
_FP_FILE_READ = FP.register(
    "datasource.file.read", "rule file read", FP.HIT_ACTIONS
)


class ReadableDataSource(Generic[S, T]):
    def load_config(self) -> T:
        raise NotImplementedError

    def read_source(self) -> S:
        raise NotImplementedError

    def get_property(self) -> SentinelProperty[T]:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class WritableDataSource(Generic[T]):
    """WritableDataSource.java:24 — persistence sink for ``setRules``."""

    def write(self, value: T) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class AbstractDataSource(ReadableDataSource[S, T]):
    def __init__(self, parser: Converter[S, T]):
        if parser is None:
            raise ValueError("parser can't be None")
        self.parser = parser
        self._property: DynamicSentinelProperty[T] = DynamicSentinelProperty()

    def load_config(self, source: Optional[S] = None) -> T:
        if source is None:
            source = self.read_source()
        return self.parser(source)

    def get_property(self) -> SentinelProperty[T]:
        return self._property


class AutoRefreshDataSource(AbstractDataSource[S, T]):
    """Polling datasource (AutoRefreshDataSource.java:32-80)."""

    def __init__(self, parser: Converter[S, T], refresh_ms: int = DEFAULT_REFRESH_MS):
        super().__init__(parser)
        if refresh_ms <= 0:
            raise ValueError("refresh_ms must be > 0, got %s" % refresh_ms)
        self.refresh_ms = refresh_ms
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="sentinel-datasource-auto-refresh", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.refresh_ms / 1000.0):
            self.refresh()

    def refresh(self) -> bool:
        """One poll iteration; exposed for deterministic tests."""
        try:
            FP.hit(_FP_REFRESH)
            if not self.is_modified():
                return False
            new_value = self.load_config()
            return self._property.update_value(new_value)
        except Exception:
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log().info("[AutoRefreshDataSource] loadConfig exception", exc_info=True)
            self.on_refresh_failed()
            return False

    def on_refresh_failed(self) -> None:
        """Hook: a modified source failed to read/parse; sources that consume
        their modification marker in ``is_modified`` must re-arm it here so
        the next poll retries instead of dropping the update."""

    def is_modified(self) -> bool:
        return True

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)


class FileRefreshableDataSource(AutoRefreshDataSource[str, T]):
    """File poller keyed on mtime (FileRefreshableDataSource.java:40-150)."""

    def __init__(
        self,
        path: str,
        parser: Converter[str, T],
        refresh_ms: int = DEFAULT_REFRESH_MS,
        max_size: int = MAX_FILE_SIZE,
        encoding: str = "utf-8",
    ):
        if os.path.isdir(path):
            raise ValueError("File can't be a directory: %s" % path)
        self.path = path
        self.max_size = max_size
        self.encoding = encoding
        self._last_modified = os.path.getmtime(path) if os.path.exists(path) else 0.0
        super().__init__(parser, refresh_ms)
        self._first_load()

    def _first_load(self) -> None:
        try:
            self._property.update_value(self.load_config())
        except Exception:
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log().info("[FileRefreshableDataSource] first load failed", exc_info=True)
            self.on_refresh_failed()  # re-arm mtime so the poll loop retries

    def read_source(self) -> str:
        FP.hit(_FP_FILE_READ)
        size = os.path.getsize(self.path)
        if size > self.max_size:
            raise ValueError(
                "%s file size=%d is bigger than max=%d, can't read" % (self.path, size, self.max_size)
            )
        with open(self.path, "r", encoding=self.encoding) as f:
            return f.read()

    def is_modified(self) -> bool:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return False
        if mtime != self._last_modified:
            self._last_modified = mtime
            return True
        return False

    def on_refresh_failed(self) -> None:
        # a half-written file consumed the mtime marker; re-arm so the next
        # poll re-reads the (by then complete) file
        self._last_modified = -1.0


class FileWritableDataSource(WritableDataSource[T]):
    """Writes encoded rules back to a file (FileWritableDataSource.java)."""

    def __init__(self, path: str, encoder: Callable[[T], str], encoding: str = "utf-8"):
        if not path:
            raise ValueError("path can't be empty")
        self.path = path
        self.encoder = encoder
        self.encoding = encoding
        self._lock = threading.Lock()

    def write(self, value: T) -> None:
        with self._lock:
            payload = self.encoder(value)
            with open(self.path, "w", encoding=self.encoding) as f:
                f.write(payload)
