"""transfer-guard: no host round trip inside a tick.

The port of ``sentinel_tpu/analysis/jaxpr/passes/transfer_guard.py``, by
intent.  The admission path's performance model is "one dispatch, no
host↔device sync a tick": the clock and the system load enter as
arguments, verdicts leave as tensors, and the one designed readback
lives outside the tick (the client's ``_resolve_tick``).  The reference
flags callback, infeed and placement primitives in the traced program;
the port's counterparts are in its dispatched stream.  Inside a tick
entry this pass flags:

* any ``aten::_local_scalar_dense`` — ``.item()``, ``int(t)``,
  ``float(t)``, ``bool(t)`` of a tensor: the host waits for the card;
* any call of ``Tensor.cpu()``, ``.numpy()``, ``.tolist()`` or
  ``np.asarray(t)`` (the recording's host reads);
* any copy from the entry's device to the host;
* any upload of host data that did not come in through the entry's
  arguments: a tensor made from host data (``torch.tensor``, …) whose
  contents do not move with the arguments in the shadow run, or a copy to
  the device of a host tensor the entry was not given.

A readback, a host read and a made-from-host tensor show on the CPU as on
the card.  A copy to the host shows only on the card, where its source
lies on the device: a ``.to("cpu")`` or a ``copy_`` into a host tensor
of a CPU run copies from host to host, which the recording cannot tell
from the tick's own host work.

Packed-wire readback surface, as in the reference: under
``cfg.packed_wire`` the resolve phase reads ONE wire buffer, so the tick
may return no other TickOutput tensor than ``wire``, ``wait_ms`` (the
sidecar-overflow escape hatch) and ``seg_dropped``.
"""

from __future__ import annotations

from typing import Dict, Iterable

from sentinel_tpu_torch.analysis.framework import ERROR, Finding
from sentinel_tpu_torch.analysis.jaxpr.framework import HOST_MADE, JaxprPass, OpRecord, TracedEntry

#: the ONLY TickOutput fields a packed-wire tick may return as tensors
_PACKED_READBACK_OK = frozenset({"wire", "wait_ms", "seg_dropped"})

_COPIES = frozenset({"aten::_to_copy", "aten::copy_"})


class TransferGuardPass(JaxprPass):
    name = "transfer-guard"
    description = "no readback, device->host copy or host-constant upload inside a tick"
    severity = ERROR

    def run(self, entry: TracedEntry) -> Iterable[Finding]:
        if entry.packed_wire and entry.readback_fields is not None:
            fields = set(entry.readback_fields)
            if "wire" not in fields:
                yield self.finding(
                    entry,
                    "packed-wire tick returns no 'wire' buffer — the resolve "
                    "phase would fall back to per-array readbacks",
                )
            for f in sorted(fields - _PACKED_READBACK_OK):
                yield self.finding(
                    entry,
                    f"TickOutput field '{f}' is still returned by the "
                    "packed-wire tick — packed mode folds every readback "
                    "into the one wire buffer (ops/wire.py); an extra output "
                    "tensor re-opens a per-array device->host read in "
                    "_resolve_tick",
                )
        if not entry.tick:
            return
        for r in entry.host_reads:
            yield self.finding(
                entry,
                f"Tensor.{r.method}() of {r.dtype}{list(r.shape)} inside the "
                "tick — it hands the tensor to the host, a device->host "
                "read on the card; keep the value on the device or read it "
                "in _resolve_tick, THE designed sync point",
                source=r.source,
            )
        made_by: Dict[int, OpRecord] = {}
        for op in entry.ops:
            if op.base == "aten::_local_scalar_dense":
                yield self.finding(
                    entry,
                    f"{op.name} inside the tick — a tensor read as a Python "
                    "number (.item(), int(), float(), bool()) makes the host "
                    "wait for the card; keep the value on the device or read "
                    "it in _resolve_tick, THE designed sync point",
                    source=op.source,
                )
            elif op.base in _COPIES:
                srcs = [t for t in op.tensor_inputs() if t.shape != ()]
                for src in srcs:
                    for out in op.outputs:
                        if src.device != "cpu" and out.device == "cpu":
                            yield self.finding(
                                entry,
                                f"{op.name} copies {src.dtype}{list(src.shape)} "
                                "from the card to the host inside the tick — a "
                                "device->host sync; move the read to "
                                "_resolve_tick",
                                source=op.source,
                            )
                        elif src.device == "cpu" and out.device != "cpu" and src.origin != "arg":
                            maker = made_by.get(src.tid)
                            if maker is None or not maker.host_varies:
                                yield self.finding(
                                    entry,
                                    f"{op.name} uploads {src.dtype}{list(src.shape)} "
                                    "of host data the tick was not given — "
                                    "pass it as an argument (or keep it "
                                    "on the device)",
                                    source=op.source,
                                )
            elif op.base in HOST_MADE and op.outputs and op.outputs[0].shape != ():
                made_by[op.outputs[0].tid] = op
                if not op.host_varies:
                    t = op.outputs[0]
                    yield self.finding(
                        entry,
                        f"{op.name} makes {t.dtype}{list(t.shape)} from host "
                        "data that does not come in through the tick's "
                        "arguments — an upload of a host constant every tick; "
                        "make it once outside the tick and pass it in",
                        source=op.source,
                    )
