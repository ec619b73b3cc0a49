"""``@sentinel_resource`` — the annotation adapter.

The analog of sentinel-annotation-aspectj's @SentinelResource +
SentinelResourceAspect.java:36-42 / AbstractSentinelAspectSupport: wrap any
callable as a guarded resource with declarative block/fallback handling.

    @sentinel_resource("getUser", block_handler=on_block, fallback=on_err)
    def get_user(uid): ...

- ``block_handler(*args, block_exception=e, **kwargs)`` runs when the entry
  is rejected (BlockException); if absent, the exception propagates.
- ``fallback(*args, exception=e, **kwargs)`` runs when the function raises
  a business exception (after it is traced); if absent, it propagates.
- ``exceptions_to_ignore`` are neither traced nor sent to the fallback.
- positional args are forwarded as the entry's ``args`` so hot-param rules
  (ParamFlowRule.param_idx) see them, as the aspect forwards method args.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple, Type

from sentinel_tpu_torch.adapters._common import resolve_client
from sentinel_tpu_torch.core import errors as ERR


def sentinel_resource(
    resource: Optional[str] = None,
    *,
    block_handler: Optional[Callable] = None,
    fallback: Optional[Callable] = None,
    exceptions_to_ignore: Tuple[Type[BaseException], ...] = (),
    inbound: bool = False,
    count: int = 1,
    client=None,
):
    def decorate(fn: Callable) -> Callable:
        name = resource or f"{fn.__module__}:{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c = resolve_client(client)
            try:
                entry = c.entry(name, count=count, inbound=inbound, args=args or None)
            except ERR.BlockException as be:
                if block_handler is not None:
                    return block_handler(*args, block_exception=be, **kwargs)
                raise
            try:
                return fn(*args, **kwargs)
            except exceptions_to_ignore:
                raise  # not traced, not fell back (exceptionsToIgnore)
            except ERR.BlockException:
                raise  # nested resource blocked; not a business error here
            except Exception as e:
                entry.trace(e)
                if fallback is not None:
                    return fallback(*args, exception=e, **kwargs)
                raise
            finally:
                entry.exit()

        wrapper.__sentinel_resource__ = name
        return wrapper

    return decorate
