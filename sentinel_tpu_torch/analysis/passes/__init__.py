"""The five tier-1 hazard passes of the port.

``fail_open``, ``time_source`` and ``unguarded_global`` are the
reference's passes (``sentinel_tpu/analysis/passes/``) pointed at the
port; ``host_sync`` and ``jit_recompile`` carry the intent of the
reference's two JAX-specific passes over torch code.  ``ALL_PASSES`` is
the CI set, in the reference's order.
"""

from __future__ import annotations

from sentinel_tpu_torch.analysis.passes.fail_open import FailOpenPass
from sentinel_tpu_torch.analysis.passes.host_sync import HostSyncPass
from sentinel_tpu_torch.analysis.passes.jit_recompile import JitRecompilePass
from sentinel_tpu_torch.analysis.passes.time_source import TimeSourcePass
from sentinel_tpu_torch.analysis.passes.unguarded_global import UnguardedGlobalPass

ALL_PASSES = (
    FailOpenPass(),
    HostSyncPass(),
    JitRecompilePass(),
    TimeSourcePass(),
    UnguardedGlobalPass(),
)

__all__ = [
    "ALL_PASSES",
    "FailOpenPass",
    "HostSyncPass",
    "JitRecompilePass",
    "TimeSourcePass",
    "UnguardedGlobalPass",
]
