"""Host-side presort of a batch by the engine's segment keys.

The segment path (ops/engine_seg.py) aggregates per run of equal keys, so
the client sorts each batch stably by those keys before upload and maps
the verdicts back through the inverse permutation.  A stable sort keeps
arrival order inside every run, so within-tick FCFS ranks are unchanged.
The sort is the native library's (``native/ring.batch_sort5`` /
``batch_sort3``, C++ ``std::stable_sort``), which is ``np.lexsort``'s
order element for element and falls back to ``np.lexsort`` where the
library cannot be built; ``sort_kind()`` says which one runs.  The live-
segment count is the port's copy of the reference client's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from sentinel_tpu_torch.native import ring as RING
from sentinel_tpu_torch.native.loader import load_native

#: segments never span a BLOCK-item boundary (ops/segment.py)
BLOCK = 256


def sort_kind() -> str:
    """Which host sort ``batch_sort5`` / ``batch_sort3`` run: ``"native"``
    (the C++ library) or ``"numpy"`` (``np.lexsort``, no toolchain)."""
    return "numpy" if load_native() is None else "native"


def batch_sort5(k0, k1, k2, k3, k4):
    """Stable argsort by (k0, k1, k2, k3, k4), k0 most significant:
    ``np.lexsort((k4, k3, k2, k1, k0))``.  Returns ``(order, inv)`` int32
    arrays; ``inv[order] == arange(n)``."""
    return RING.batch_sort5(k0, k1, k2, k3, k4)


def batch_sort3(k0, k1, k2, want_inv: bool = True):
    """Stable argsort by (k0, k1, k2); see :func:`batch_sort5` (``inv`` is
    None unless wanted: the client never unsorts completions)."""
    return RING.batch_sort3(k0, k1, k2, want_inv=want_inv)


def host_seg_count(cols: Sequence[np.ndarray]) -> int:
    """The live-segment count the engine will see for these sorted key
    columns (trash-row padding included): key-change heads plus the
    synthetic heads at positions divisible by BLOCK."""
    n = len(cols[0])
    if n == 0:
        return 0
    change = np.zeros(n - 1, dtype=bool)
    for c in cols:
        c = np.asarray(c)
        change |= c[1:] != c[:-1]
    pos = np.arange(1, n)
    return 1 + int(np.count_nonzero(change | (pos % BLOCK == 0)))
