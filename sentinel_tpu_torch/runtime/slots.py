"""Custom processor-slot SPI — ordered slots with entry AND exit hooks.

The port's copy of ``sentinel_tpu/runtime/slots.py``.

The reference lets users insert full ProcessorSlots anywhere in the chain
(slotchain/ProcessorSlot.java:29 — entry/fireEntry/exit/fireExit, ordered
by @SpiOrder, demo sentinel-demo-slot-chain-spi).  The TPU build's chain
is a fused device kernel, so custom slots run HOST-side around the engine
check, keeping the same contract:

- ``on_entry`` runs BEFORE the device decision, in ascending ``order``
  (negative orders run earlier, like @SpiOrder); raising a BlockException
  rejects the entry — the engine still RECORDS the block (the exception
  rides the batch as a pre-verdict, so stats/block-log/SPI all fire, the
  way a custom slot's exception flows through StatisticSlot).
- ``on_exit`` runs for every slot whose ``on_entry`` ran — including the
  slot that raised the BlockException — in REVERSE order (fireExit
  unwinds the chain LIFO), both on completion (with rt/success/errors)
  and on rejection (with ``block_exception`` set) — matching CtEntry.exit
  walking the chain even for blocked entries.  Slots later in the chain
  than the blocker never entered, so they do not exit (divergence from
  the reference's full-chain fireExit, which calls exit on slots whose
  entry never ran; pairing resources between entry and exit is safe
  here).
- ``SlotContext.attachments`` is scratch state shared between a slot's
  entry and exit sides for the same request (Context#customized data).

Slot exceptions other than BlockException propagate to the caller
unwrapped, like a throwing ProcessorSlot would.
"""

from __future__ import annotations

import bisect
import logging
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.core import errors as ERR

_log = logging.getLogger(__name__)


@dataclass
class SlotContext:
    """Per-request view handed to custom slots."""

    resource: str
    origin: str = ""
    args: Optional[Sequence[Any]] = None
    count: int = 1
    prioritized: bool = False
    inbound: bool = False
    # exit-side fields (populated before on_exit)
    rt_ms: float = 0.0
    success: int = 0
    errors: int = 0
    block_exception: Optional[BaseException] = None
    attachments: dict = field(default_factory=dict)


class ProcessorSlot:
    """Base custom slot (subclass and override either hook)."""

    #: ascending execution order for on_entry (reverse for on_exit);
    #: mirror of @SpiOrder — negative = earlier
    order: int = 0

    def on_entry(self, ctx: SlotContext) -> None:  # pragma: no cover - base
        """Pre-decision hook; raise a BlockException to reject."""

    def on_exit(self, ctx: SlotContext) -> None:  # pragma: no cover - base
        """Unwind hook: completion (rt/success/errors) or rejection
        (block_exception set)."""


class SlotChain:
    """Ordered registry of custom slots (DefaultSlotChainBuilder analog:
    stable sort by order; same-order slots keep registration order)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: List[Tuple[int, int, ProcessorSlot]] = []
        self._seq = 0

    def register(self, slot: ProcessorSlot) -> ProcessorSlot:
        with self._lock:
            self._seq += 1
            bisect.insort(self._slots, (int(slot.order), self._seq, slot))
        return slot

    def unregister(self, slot: ProcessorSlot) -> None:
        with self._lock:
            self._slots = [t for t in self._slots if t[2] is not slot]

    def snapshot(self) -> List[ProcessorSlot]:
        with self._lock:
            return [t[2] for t in self._slots]

    def __len__(self) -> int:
        return len(self._slots)


def run_entry(slots: List[ProcessorSlot], ctx: SlotContext):
    """Run on_entry in order.  Returns (entered, block_exc): ``entered``
    are the slots to unwind LIFO — including the slot whose on_entry
    raised the BlockException (its entry ran up to the raise, and the
    reference fires exit through the raising slot too: CtEntry.exit walks
    the whole chain's fireExit).  Any non-Block exception unwinds the
    already-entered slots and propagates."""
    entered: List[ProcessorSlot] = []
    for s in slots:
        try:
            s.on_entry(ctx)
        except ERR.BlockException as be:
            entered.append(s)
            return entered, be
        except BaseException:
            ctx.block_exception = None
            run_exit(entered, ctx)
            raise
        entered.append(s)
    return entered, None


def run_exit(entered: List[ProcessorSlot], ctx: SlotContext) -> None:
    """Unwind on_exit in reverse order; slot exit errors are contained
    (an exit hook must never mask the request outcome)."""
    for s in reversed(entered):
        try:
            s.on_exit(ctx)
        except BaseException as e:  # noqa: BLE001  # stlint: disable=fail-open — exit-side isolation of USER slot code; the verdict was already decided at entry
            _log.warning("custom slot %r on_exit failed: %s", s, e)
