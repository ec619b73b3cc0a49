"""SentinelProperty: push-style typed config values.

The port's copy of ``sentinel_tpu/datasource/property.py``.

Reference semantics (property/SentinelProperty.java:31,
DynamicSentinelProperty.java:24):
  * ``add_listener`` immediately replays the current value (config_load);
  * ``update_value`` no-ops when the value is unchanged, otherwise fans out
    config_update to every listener;
  * listeners are typed callbacks owned by rule managers.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class PropertyListener(Generic[T]):
    """Listener interface (property/PropertyListener.java:23)."""

    def config_update(self, value: T) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def config_load(self, value: T) -> None:
        # default: initial load behaves like an update
        self.config_update(value)


class SimplePropertyListener(PropertyListener[T]):
    """Adapts a plain callable to the listener interface."""

    def __init__(self, fn: Callable[[T], None]):
        self._fn = fn

    def config_update(self, value: T) -> None:
        self._fn(value)


class SentinelProperty(Generic[T]):
    """Interface type (property/SentinelProperty.java:31)."""

    def add_listener(self, listener: PropertyListener[T]) -> None:
        raise NotImplementedError

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        raise NotImplementedError

    def update_value(self, value: T) -> bool:
        raise NotImplementedError


class DynamicSentinelProperty(SentinelProperty[T]):
    # A single RLock covers both list mutation and listener fan-out: the
    # add_listener replay and update_value fan-out are serialized so a
    # subscriber can never see a newer value overwritten by a stale replay
    # (a race the reference actually has; RLock so listeners may reenter).
    def __init__(self, value: Optional[T] = None):
        self._listeners: List[PropertyListener[T]] = []
        self._value: Optional[T] = value
        self._lock = threading.RLock()

    @property
    def value(self) -> Optional[T]:
        """Current value (read-side peek for dashboards/tests; the
        reference keeps this package-private but the need is the same)."""
        return self._value

    def add_listener(self, listener: PropertyListener[T]) -> None:
        with self._lock:
            self._listeners.append(listener)
            listener.config_load(self._value)

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def update_value(self, value: T) -> bool:
        with self._lock:
            if value == self._value:
                return False  # DynamicSentinelProperty.java:52 skip-unchanged
            self._value = value
            for l in list(self._listeners):
                l.config_update(value)
        return True

    def get_value(self) -> Optional[T]:
        return self._value

    def close(self) -> None:
        with self._lock:
            self._listeners.clear()


class NoOpSentinelProperty(SentinelProperty[T]):
    """Discard-all property (property/NoOpSentinelProperty.java)."""

    def add_listener(self, listener: PropertyListener[T]) -> None:
        pass

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        pass

    def update_value(self, value: T) -> bool:
        return False
