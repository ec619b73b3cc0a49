"""Async-streaming adapter — entry on subscribe, exit on complete/error.

The reference's reactor adapter (sentinel-reactor-adapter,
SentinelReactorSubscriber.java) lifts flow control onto reactive
streams: the entry happens when the stream is SUBSCRIBED (not when the
pipeline is assembled), the whole stream holds one concurrency slot
while it runs, a BlockException surfaces through the stream's error
channel, and the entry exits on complete OR error with the stream's
full lifetime as RT; cancel() releases without error accounting.

Python's reactive analog is the async iterator / async generator:

    async for item in guard_stream("res", upstream()): ...

``guard_stream`` returns an async GENERATOR wrapping ``upstream`` —
generator semantics give the subscriber lifecycle for free:

- lazy: nothing is acquired until the first ``__anext__`` (subscription);
- early ``break``: the generator's ``aclose()`` runs the ``finally``
  (CPython refcounting makes this immediate), releasing the entry
  without error accounting — the cancel() path;
- ``asyncio`` cancellation / ``GeneratorExit``: released, NOT traced as a
  business exception (routine cancellation must not trip error-ratio
  circuit breakers);
- upstream exception: traced on the entry, then re-raised.

``guard_aiter`` is the decorator form; ``guard_awaitable`` guards a
single awaitable the same way — the Mono analog.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterable, Awaitable, Optional

from sentinel_tpu_torch.adapters._common import resolve_client


async def guard_stream(
    resource: str,
    source: AsyncIterable,
    client=None,
    inbound: bool = False,
    origin: Optional[str] = None,
    args: Optional[tuple] = None,
):
    """Async generator wrapping ``source`` with stream-scoped flow control
    (one entry spanning the whole stream; see module docstring)."""
    c = resolve_client(client)
    entry = await c.entry_async(
        resource,
        inbound=inbound,
        origin=origin,
        args=list(args) if args else None,
    )
    try:
        async for item in source:
            yield item
    except (asyncio.CancelledError, GeneratorExit):
        raise  # cancel(): release (finally) without error accounting
    except BaseException as exc:
        entry.trace(exc)
        raise
    finally:
        entry.exit()
        closer = getattr(source, "aclose", None)
        if closer is not None:
            try:
                await closer()
            except RuntimeError:
                pass  # already closing / closed


def guard_aiter(resource: str, client=None, **kw):
    """Decorator form for async-generator functions:

        @guard_aiter("stream-res")
        async def numbers():
            yield 1
    """

    def wrap(fn):
        def inner(*a, **k):
            return guard_stream(resource, fn(*a, **k), client=client, **kw)

        return inner

    return wrap


async def guard_awaitable(
    resource: str,
    aw: Awaitable,
    client=None,
    inbound: bool = False,
    origin: Optional[str] = None,
):
    """Guard a single awaitable (the Mono analog): entry before awaiting,
    trace on exception (not on cancellation), exit when it resolves."""
    c = resolve_client(client)
    entry = await c.entry_async(resource, inbound=inbound, origin=origin)
    try:
        result = await aw
    except asyncio.CancelledError:
        entry.exit()
        raise
    except BaseException as exc:
        entry.trace(exc)
        entry.exit()
        raise
    entry.exit()
    return result
