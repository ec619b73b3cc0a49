"""Generic RPC adapter — the chained-resource provider/consumer pattern.

The reference's Dubbo adapters (sentinel-apache-dubbo-adapter,
SentinelDubboProviderFilter.java / SentinelDubboConsumerFilter.java)
guard every RPC with a RESOURCE CHAIN rather than a single entry:

  provider side:  ContextUtil.enter(interfaceResource, remoteApplication)
                  -> SphU.entry(interfaceResource)   (EntryType.IN)
                  -> SphU.entry(methodResource)
  consumer side:  SphU.entry(interfaceResource)      (EntryType.OUT)
                  -> SphU.entry(methodResource)

so operators can limit per-interface AND per-method, and the invocation
tree shows method nodes under interface nodes with the caller app as
origin.  This module is the framework-agnostic form of that pattern: any
RPC server/client integration calls ``provider_call``/``consumer_call``
(or uses the context managers) around its handler invocation.

Resource naming follows the reference (interface, then
``interface:method(argTypes...)`` is up to the caller — pass any string).
Block exceptions propagate; business exceptions feed Tracer semantics on
BOTH entries, and exits run method-first (LIFO), matching the filter's
finally-block order.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from sentinel_tpu_torch.adapters._common import resolve_client
from sentinel_tpu_torch.runtime import context as CTX


@contextmanager
def provider_entry(
    interface: str,
    method: str,
    origin: str = "",
    client=None,
):
    """Provider-side chained entries under a context carrying the caller
    app as origin (SentinelDubboProviderFilter.java:46-70)."""
    c = resolve_client(client)
    token = CTX.enter(interface, origin or "")
    iface_entry = None
    method_entry = None
    try:
        iface_entry = c.entry(interface, inbound=True, origin=origin or None)
        method_entry = c.entry(method, inbound=True, origin=origin or None)
        try:
            yield
        except BaseException as exc:
            method_entry.trace(exc)
            iface_entry.trace(exc)
            raise
    finally:
        if method_entry is not None:
            method_entry.exit()
        if iface_entry is not None:
            iface_entry.exit()
        CTX.exit_ctx(token)


@contextmanager
def consumer_entry(interface: str, method: str, client=None):
    """Consumer-side chained entries in the CURRENT context (outbound —
    SentinelDubboConsumerFilter.java:45-63)."""
    c = resolve_client(client)
    iface_entry = None
    method_entry = None
    try:
        iface_entry = c.entry(interface, inbound=False)
        method_entry = c.entry(method, inbound=False)
        try:
            yield
        except BaseException as exc:
            method_entry.trace(exc)
            iface_entry.trace(exc)
            raise
    finally:
        if method_entry is not None:
            method_entry.exit()
        if iface_entry is not None:
            iface_entry.exit()


def provider_call(interface: str, method: str, fn, *args, origin: str = "", client=None, **kw):
    """Invoke ``fn`` guarded by the provider chain; returns its result."""
    with provider_entry(interface, method, origin=origin, client=client):
        return fn(*args, **kw)


def consumer_call(interface: str, method: str, fn, *args, client=None, **kw):
    """Invoke ``fn`` guarded by the consumer chain; returns its result."""
    with consumer_entry(interface, method, client=client):
        return fn(*args, **kw)
