"""Host-side presort of a batch by the engine's segment keys.

The port's copy of the numpy forms of ``batch_sort5`` / ``batch_sort3``
(``sentinel_tpu/native/ring.py``) and of the client's live-segment count.
The segment path (ops/engine_seg.py) aggregates per run of equal keys, so
the client sorts each batch stably by those keys before upload and maps
the verdicts back through the inverse permutation.  A stable sort keeps
arrival order inside every run, so within-tick FCFS ranks are unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

#: segments never span a BLOCK-item boundary (ops/segment.py)
BLOCK = 256


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _with_inverse(order: np.ndarray):
    inv = np.empty(order.shape[0], np.int32)
    inv[order] = np.arange(order.shape[0], dtype=np.int32)
    return order, inv


def batch_sort5(k0, k1, k2, k3, k4):
    """Stable argsort by (k0, k1, k2, k3, k4), k0 most significant:
    ``np.lexsort((k4, k3, k2, k1, k0))``.  Returns ``(order, inv)`` int32
    arrays; ``inv[order] == arange(n)``."""
    k0, k1, k2, k3, k4 = map(_as_i32, (k0, k1, k2, k3, k4))
    return _with_inverse(np.lexsort((k4, k3, k2, k1, k0)).astype(np.int32))


def batch_sort3(k0, k1, k2):
    """Stable argsort by (k0, k1, k2); see :func:`batch_sort5`."""
    k0, k1, k2 = map(_as_i32, (k0, k1, k2))
    return _with_inverse(np.lexsort((k2, k1, k0)).astype(np.int32))


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
