"""const-hoist: tensors an entry reads from outside its call, and host
constants it uploads on every call.

The port of ``sentinel_tpu/analysis/jaxpr/passes/const_hoist.py``, by
intent.  The reference flags a module-level device array hoisted into a
jaxpr's consts (an extra executable parameter the dispatch fastpath can
drop) and warns on large numpy consts baked into the program.  Eager
PyTorch hoists nothing, but the same two shapes show in its stream:

* an op input that is neither one of the entry's arguments nor made
  during the call — a module-level, closure or cached tensor.  Its value
  is not part of the call's inputs: the result depends on state the
  caller cannot see, and under the mesh it is one copy every rank reads
  (ERROR);
* a host constant of at least ``BIG_HOST_CONST_BYTES`` made into a tensor
  on every call (an upload every call, on the card) — pass it in, or make
  it once (WARNING, as the reference's large-numpy-const warning).

The second half is also the const half of tier 4's
``replication-hazard`` (``analysis/spmd/passes.py``): a constant every
call uploads is one copy on every rank.
"""

from __future__ import annotations

from typing import Iterable

from sentinel_tpu_torch.analysis.framework import WARNING, Finding
from sentinel_tpu_torch.analysis.jaxpr.framework import HOST_MADE, JaxprPass, TracedEntry

#: a host constant made into a tensor this large on every call is flagged
BIG_HOST_CONST_BYTES = 256 << 10


class ConstHoistPass(JaxprPass):
    name = "const-hoist"
    description = "no tensor read from outside the entry's call; no large host constant uploaded every call"

    def run(self, entry: TracedEntry) -> Iterable[Finding]:
        seen = set()
        for op in entry.ops:
            for t in op.tensor_inputs():
                if t.origin != "external" or t.tid in seen:
                    continue
                seen.add(t.tid)
                yield self.finding(
                    entry,
                    f"{op.name} reads {t.dtype}{list(t.shape)} on {t.device}, "
                    "a tensor that is neither an argument of the entry nor "
                    "made during the call (a module-level, closure or cached "
                    "tensor) — its value is not an input of the call; pass "
                    "it as an argument, or make it inside the call",
                    source=op.source,
                )
            if op.base in HOST_MADE and op.outputs and op.outputs[0].shape != () and not op.host_varies:
                t = op.outputs[0]
                if t.nbytes >= BIG_HOST_CONST_BYTES:
                    yield self.finding(
                        entry,
                        f"host constant {t.dtype}{list(t.shape)} ({t.nbytes} "
                        "bytes) made into a tensor on every call — an upload "
                        "of the same bytes each call (and a copy on every "
                        "rank under the mesh); make it once and pass it in",
                        severity=WARNING,
                        source=op.source,
                    )
