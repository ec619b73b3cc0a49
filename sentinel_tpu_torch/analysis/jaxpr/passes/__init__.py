"""The five passes of the port's ``jaxpr`` tier.

Each runs over :class:`~sentinel_tpu_torch.analysis.jaxpr.framework.TracedEntry`
objects recorded by entrypoints.py; ``ALL_JAXPR_PASSES`` is the CI set,
with the reference's rule ids in its order.
"""

from __future__ import annotations

from sentinel_tpu_torch.analysis.jaxpr.passes.const_hoist import ConstHoistPass
from sentinel_tpu_torch.analysis.jaxpr.passes.cost_budget import CostBudgetPass
from sentinel_tpu_torch.analysis.jaxpr.passes.dtype_overflow import DtypeOverflowPass
from sentinel_tpu_torch.analysis.jaxpr.passes.fingerprint import FingerprintPass
from sentinel_tpu_torch.analysis.jaxpr.passes.transfer_guard import TransferGuardPass

ALL_JAXPR_PASSES = (
    TransferGuardPass(),
    DtypeOverflowPass(),
    ConstHoistPass(),
    FingerprintPass(),
    CostBudgetPass(),
)

__all__ = [
    "ALL_JAXPR_PASSES",
    "ConstHoistPass",
    "CostBudgetPass",
    "DtypeOverflowPass",
    "FingerprintPass",
    "TransferGuardPass",
]
