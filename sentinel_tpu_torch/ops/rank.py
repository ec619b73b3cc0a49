"""Within-tick sequencing: grouped exclusive prefix sums.

The PyTorch counterpart of ``sentinel_tpu/ops/rank.py``.  Requests for the
same decision node inside one micro-batch are RANKED instead of racing on
a CAS: item i's check sees the values of the eligible items 0..i-1 that
carry the same key.  Admitting exactly the items whose exclusive rank plus
own cost fits the quota reproduces sequential first-come-first-served
admission (DefaultController.java:31).

One sort on the composite key ``(key << 32) | position`` puts each group's
items together in arrival order; prefix sums run in float64 (exact for
integer values far past the float32 range the JAX package is exact in) and
the results come back as float32, the reference's dtype.  Both the JAX
package's sort-based and sort-free (``_small``) variants give these same
integers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def grouped_exclusive_cumsum(
    keys: torch.Tensor,  # int32 [N] group key per item
    values: Sequence[torch.Tensor],  # each float32/int32 [N]
    eligible: torch.Tensor,  # bool [N] — ineligible items contribute 0
) -> Tuple[torch.Tensor, ...]:
    """For each item: sum over eligible earlier same-key items, per value."""
    n = keys.shape[0]
    dev = keys.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    comp = ((keys.to(torch.int64) + (1 << 31)) << 32) | pos
    sk, order = torch.sort(comp)
    ks = sk >> 32
    seg_start = torch.ones((n,), dtype=torch.bool, device=dev)
    seg_start[1:] = ks[1:] != ks[:-1]
    # index of each item's segment head (positions increase along the sort)
    head_idx = torch.cummax(torch.where(seg_start, pos, -1), dim=0).values
    out = []
    for v in values:
        vs = torch.where(eligible, v.to(torch.float64), 0.0)[order]
        csum_excl = torch.cumsum(vs, dim=0) - vs
        ranks_sorted = csum_excl - csum_excl[head_idx]
        r = torch.empty((n,), dtype=torch.float64, device=dev).scatter_(0, order, ranks_sorted)
        out.append(r.to(torch.float32))
    return tuple(out)
