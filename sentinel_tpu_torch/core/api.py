"""Public facade — the analog of SphU/SphO/Tracer/ContextUtil.

The port's counterpart of ``sentinel_tpu/core/api.py``: one process-wide
SentinelClient (created on the card unless ``init(device="cpu")`` asks
for the CPU), and the module-level entry points that route to it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterable

from sentinel_tpu_torch.core import rules as R

_client = None
_client_lock = threading.Lock()
_init_funcs: list = []
# a lock of its own for the registration list: init() runs the init funcs
# while holding _client_lock, and an init func may register more
_init_funcs_lock = threading.Lock()


def register_init_func(fn, order: int = 0):
    """Register a one-time init callback run when the process-wide client
    first starts, in ascending ``order`` (registration order breaks ties)
    — the InitFunc SPI + @InitOrder analog (InitExecutor.java:41-64).
    Receives the SentinelClient."""
    with _init_funcs_lock:
        _init_funcs.append((order, len(_init_funcs), fn))


def init(**kwargs):
    """Create (or return) the process-wide SentinelClient and start it, then
    run the registered init funcs once.  Keyword arguments go to
    ``SentinelClient``; with no ``device`` it runs on ``cuda`` and raises
    where there is no CUDA device.  A failing init func stops the client
    and re-raises, leaving no half-initialized singleton."""
    global _client
    with _client_lock:
        if _client is None:
            from sentinel_tpu_torch.runtime.client import SentinelClient

            c = SentinelClient(**kwargs)
            c.start()
            try:
                with _init_funcs_lock:
                    funcs = sorted(_init_funcs, key=lambda t: t[:2])
                # funcs registered DURING init take effect on a later init()
                for _, _, fn in funcs:
                    fn(c)
            except Exception:
                c.stop()
                raise
            _client = c
        return _client


def get_client():
    return init()


def reset():
    """Tear down the process-wide client (tests)."""
    global _client
    with _client_lock:
        if _client is not None:
            _client.stop()
            _client = None


def entry(resource: str, count: int = 1, prioritized: bool = False, args=None):
    """Guard a code block; raises BlockException when rejected (SphU.entry):

        with st.entry("res"):
            ...
    """
    return get_client().entry(resource, count=count, prioritized=prioritized, args=args)


def entry_async(resource: str, count: int = 1, prioritized: bool = False, args=None):
    """Awaitable entry (AsyncEntry analog): ``e = await st.entry_async(r)``;
    exit with ``e.exit()``."""
    return get_client().entry_async(resource, count=count, prioritized=prioritized, args=args)


def try_entry(resource: str, count: int = 1, args=None):
    """Boolean variant (SphO.java). Returns an Entry or None."""
    return get_client().try_entry(resource, count=count, args=args)


def trace(exc: BaseException, count: int = 1):
    """Record a business exception on the current entry (Tracer.java)."""
    return get_client().trace(exc, count)


@contextmanager
def context(name: str, origin: str = ""):
    """Set the invocation context (ContextUtil.enter/exit)."""
    client = get_client()
    token = client.enter_context(name, origin)
    try:
        yield
    finally:
        client.exit_context(token)


def load_flow_rules(rules: Iterable[R.FlowRule]):
    get_client().flow_rules.load(list(rules))


def load_degrade_rules(rules: Iterable[R.DegradeRule]):
    get_client().degrade_rules.load(list(rules))


def load_system_rules(rules: Iterable[R.SystemRule]):
    get_client().system_rules.load(list(rules))


def load_authority_rules(rules: Iterable[R.AuthorityRule]):
    get_client().authority_rules.load(list(rules))


def load_param_flow_rules(rules: Iterable[R.ParamFlowRule]):
    """Hot-parameter rules; ``entry(resource, args=...)`` then limits per
    argument value.  A cluster-mode rule asks the attached cluster's token
    service, and compiles in as a local rule while the client is degraded
    (runtime/client.py, ``_recompile_rules``)."""
    get_client().param_flow_rules.load(list(rules))


def clear_rules():
    c = get_client()
    for mgr in (c.flow_rules, c.degrade_rules, c.system_rules, c.authority_rules, c.param_flow_rules):
        mgr.load([])
