"""Command plane primitives — the analog of sentinel-transport-common's

The port's copy of ``sentinel_tpu/transport/command.py``.
CommandHandler SPI (@CommandMapping name/desc + CommandHandlerProvider).

Handlers are plain callables ``fn(CommandRequest) -> CommandResponse``
registered in a CommandRegistry under their command name; the HTTP command
center dispatches ``GET/POST /<name>`` to them.  Registration is explicit
(build_default_handlers) or via the ``@command_mapping`` decorator on
methods of a handler group class.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from sentinel_tpu_torch.chaos import failpoints as FP

#: chaos failpoint: a raise converts to the command plane's of_failure
#: response — the "command plane must not crash" contract under test
_FP_DISPATCH = FP.register(
    "transport.command.dispatch", "command handler dispatch", FP.HIT_ACTIONS
)


@dataclass
class CommandRequest:
    parameters: Dict[str, str] = field(default_factory=dict)
    body: str = ""

    def param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        v = self.parameters.get(name)
        return v if v not in (None, "") else default


@dataclass
class CommandResponse:
    success: bool
    result: Any = None

    @staticmethod
    def of_success(result: Any) -> "CommandResponse":
        return CommandResponse(True, result)

    @staticmethod
    def of_failure(message: str) -> "CommandResponse":
        return CommandResponse(False, message)


def command_mapping(name: str, desc: str = ""):
    """Mark a method as a command handler (@CommandMapping analog)."""

    def wrap(fn):
        fn.__command_name__ = name
        fn.__command_desc__ = desc
        return fn

    return wrap


class CommandRegistry:
    def __init__(self):
        self._handlers: Dict[str, Tuple[str, Callable[[CommandRequest], CommandResponse]]] = {}

    def register(self, name: str, fn, desc: str = "") -> None:
        self._handlers[name] = (desc, fn)

    def register_group(self, group: Any) -> None:
        """Register every @command_mapping-decorated method of an object."""
        if getattr(group, "_registry", None) is None:
            group._registry = self  # lets handlers like "api" introspect us
        for attr in dir(group):
            fn = getattr(group, attr)
            name = getattr(fn, "__command_name__", None)
            if name:
                self.register(name, fn, getattr(fn, "__command_desc__", ""))

    def handle(self, name: str, request: CommandRequest) -> CommandResponse:
        entry = self._handlers.get(name)
        if entry is None:
            return CommandResponse.of_failure(f"unknown command: {name}")
        try:
            FP.hit(_FP_DISPATCH)
            return entry[1](request)
        except Exception as e:  # noqa: BLE001 — command plane must not crash
            return CommandResponse.of_failure(f"{type(e).__name__}: {e}")

    def names(self) -> List[Tuple[str, str]]:
        return [(n, d) for n, (d, _) in sorted(self._handlers.items())]
