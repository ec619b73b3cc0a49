"""Per-caller invocation context.

The analog of Context/ContextUtil (context/ContextUtil.java:45,
Context.java): the reference pins a Context to the current thread and
builds a DefaultNode tree per (resource, context).  Here the context is a
``contextvars.ContextVar`` (works across threads AND asyncio tasks), and
the "tree" is flat: context/origin stat rows are interned in the Registry.
"""

from __future__ import annotations

import contextvars
from typing import List, Optional, Tuple

# Constants.CONTEXT_DEFAULT_NAME in the reference
DEFAULT_CONTEXT_NAME = "sentinel_default_context"

_current: contextvars.ContextVar[Tuple[str, str]] = contextvars.ContextVar(
    "sentinel_tpu_torch_context", default=(DEFAULT_CONTEXT_NAME, "")
)
# stack of live Entry objects (for Tracer.trace attribution)
_entries: contextvars.ContextVar[Tuple] = contextvars.ContextVar(
    "sentinel_tpu_torch_entries", default=()
)


def current() -> Tuple[str, str]:
    """(context_name, origin)."""
    return _current.get()


def enter(name: str, origin: str = ""):
    """Returns a token for exit()."""
    return _current.set((name or DEFAULT_CONTEXT_NAME, origin or ""))


def exit_ctx(token) -> None:
    _current.reset(token)


def push_entry(entry) -> None:
    _entries.set(_entries.get() + (entry,))


def pop_entry(entry) -> None:
    stack = _entries.get()
    if stack and stack[-1] is entry:
        _entries.set(stack[:-1])
    else:
        # out-of-order exit: drop it wherever it is (CtEntry chain repair)
        _entries.set(tuple(e for e in stack if e is not entry))


def clear() -> None:
    """Reset this context's entry stack and context name — the
    ContextTestUtil.cleanUpContext analog for tests/tools."""
    _entries.set(())
    _current.set((DEFAULT_CONTEXT_NAME, ""))


def current_entry():
    stack = _entries.get()
    return stack[-1] if stack else None
