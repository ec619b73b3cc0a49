"""Sorted-batch segment machinery.

The PyTorch counterpart of ``sentinel_tpu/ops/segment.py``.  A batch that
arrives SORTED by a composite key (resource id first) has equal-key items
in contiguous *segments*, so

  - per-table scatters contract SEGMENT SUMS over a short compacted axis
    (U entries) instead of per-item payloads over the whole batch,
  - per-item table reads happen once per segment and expand back with ONE
    monotone gather,
  - within-tick FCFS ranks become segmented prefix sums on the sorted
    order (ops/segscan.py).

Segments are capped at BLOCK = 256 items by synthetic heads at every
position divisible by 256, so per-segment digit-plane sums stay small
(<= 255 * 256) and integer-exact.

Compaction: the JAX package sorts a segment-end key with an unstable sort
to place each live segment's last item at slot ``sid``; the port scatters
each tail position to slot ``sid`` directly.  Live slots hold the same
values either way; dead slots hold junk in both packages (different
junk): mask them with ``ctx.live``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

#: segments never span a BLOCK-item boundary (synthetic heads)
BLOCK = 256

_INT_MIN = -(2**31) + 1
I32 = torch.int32


class SegCtx(NamedTuple):
    """Segment structure of one sorted batch (item axis N, capacity U)."""

    head: torch.Tensor  # bool [N] — first item of its segment
    sid: torch.Tensor  # int32 [N] — segment id, 0-based, nondecreasing
    n_seg: torch.Tensor  # int32 scalar — live segment count
    ok: torch.Tensor  # bool scalar — n_seg <= U (compacted outputs valid)
    seg_end: torch.Tensor  # int32 [U] — last item position per live segment
    live: torch.Tensor  # bool [U] — segment slot holds a live segment

    @property
    def U(self) -> int:
        return self.seg_end.shape[0]


def _first_true(n: int, device) -> torch.Tensor:
    return torch.ones((min(n, 1),), dtype=torch.bool, device=device)


def heads_from_keys(*cols: torch.Tensor) -> torch.Tensor:
    """Segment-start marks from sorted key columns + BLOCK boundaries."""
    n = cols[0].shape[0]
    dev = cols[0].device
    change = torch.zeros((n,), dtype=torch.bool, device=dev)
    for c in cols:
        change = change | torch.cat([_first_true(n, dev), c[1:] != c[:-1]])
    pos = torch.arange(n, dtype=I32, device=dev)
    return change | (pos % BLOCK == 0)


def build(key_cols: Sequence[torch.Tensor], U: int, payloads: Sequence[torch.Tensor] = ()):
    """Segment structure for a batch sorted by ``key_cols`` (stably), and
    each payload's value at each live segment's last item ([U] each; dead
    slots junk).  When the live segment count exceeds U, ``ok`` is False
    and slots hold the first U segments."""
    return build_from_head(heads_from_keys(*key_cols), U, payloads)


def build_from_head(head: torch.Tensor, U: int, payloads: Sequence[torch.Tensor] = ()):
    """build() for a precomputed head vector (see heads_from_keys)."""
    n = head.shape[0]
    dev = head.device
    sid = (torch.cumsum(head.to(I32), dim=0, dtype=I32) - 1).to(I32)
    n_seg = sid[-1] + 1
    ok = n_seg <= U
    tail = torch.cat([head[1:], _first_true(n, dev)])
    pos = torch.arange(n, dtype=I32, device=dev)
    # each kept segment's tail lands in slot sid; everything else in a spare
    # slot U that is cut off
    slot = torch.where(tail & (sid < U), sid, U).to(torch.int64)
    ends = torch.zeros((U + 1,), dtype=I32, device=dev).scatter_(0, slot, pos)
    seg_end = ends[:U]
    live = torch.arange(U, dtype=I32, device=dev) < n_seg
    ctx = SegCtx(head=head, sid=sid, n_seg=n_seg, ok=ok, seg_end=seg_end, live=live)
    idx = seg_end.to(torch.int64)
    return ctx, [p[idx] for p in payloads]


def compact(ctx: SegCtx, arr: torch.Tensor, fill=0) -> torch.Tensor:
    """Per-segment value (constant within each segment): [N(,P)] -> [U(,P)].
    Reads each segment's LAST item; dead slots get ``fill``."""
    g = arr[ctx.seg_end.to(torch.int64)]
    mask = ctx.live if g.dim() == 1 else ctx.live[:, None]
    return torch.where(mask, g, fill)


def cum_cols(planes: Sequence[torch.Tensor], maxes: Sequence[int]):
    """Digit-split payload planes + exact int32 inclusive prefix sums.

    Returns (C_rows: list of [N] int32 cumsums, split: list of
    (plane_idx, weight)).  Planes wider than 255 are split into base-256
    digits BEFORE the prefix sum, so the int32 cumsum stays exact."""
    n = planes[0].shape[0]
    assert n <= (1 << 23), "item axis too long for exact int32 digit cumsum"
    split: list = []
    cols = []
    for p, (v, m) in enumerate(zip(planes, maxes)):
        v = v.to(I32)
        if m <= 255:
            cols.append(v)
            split.append((p, 1))
        else:
            d = max(1, (int(m).bit_length() + 7) // 8)
            for k in range(d):
                cols.append((v >> (8 * k)) & 0xFF)
                split.append((p, 1 << (8 * k)))
    C = torch.cumsum(torch.stack(cols, dim=0), dim=1, dtype=I32)  # [Pd, N]
    return [C[i] for i in range(C.shape[0])], split


def sums_from_ce(ctx: SegCtx, ce_cols: Sequence[torch.Tensor], split) -> list:
    """Per-segment sums from compacted cumsum columns (each [U] int32, the
    cumsum at each segment's last item).  Returns, per input plane, a list
    of (sums [U] int32, weight, digits): the plane's segment sum is
    sum(weight_k * sums_k), each sums_k < 2^24."""
    Ce = torch.stack(ce_cols, dim=1)  # [U, Pd]
    prev = torch.cat([torch.zeros((1, Ce.shape[1]), dtype=I32, device=Ce.device), Ce[:-1]])
    sums_d = torch.where(ctx.live[:, None], Ce - prev, 0)  # each <= 255 * BLOCK

    n_planes = max(p for p, _ in split) + 1
    out: list = [[] for _ in range(n_planes)]
    j = 0
    while j < len(split):
        p, w = split[j]
        if j + 1 < len(split) and split[j + 1][0] == p and split[j + 1][1] == w * 256:
            out[p].append((sums_d[:, j] + sums_d[:, j + 1] * 256, w, 3))
            j += 2
        else:
            out[p].append((sums_d[:, j], w, 2))
            j += 1
    return out


def seg_sums(ctx: SegCtx, planes: Sequence[torch.Tensor], maxes: Sequence[int]) -> list:
    """Exact per-segment sums of int32 payload planes (cum_cols + ONE packed
    row gather at seg_end + sums_from_ce)."""
    C_rows, split = cum_cols(planes, maxes)
    Ce = torch.stack(C_rows, dim=1)[ctx.seg_end.to(torch.int64)]
    return sums_from_ce(ctx, [Ce[:, i] for i in range(Ce.shape[1])], split)


def seg_excl_cumsum(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Segmented EXCLUSIVE prefix sums over sorted items, int32-exact.

    ``head`` marks segment starts (position 0 always starts one);
    ``values`` is [V, N] (or [N]) int32 with each row's total below 2^31.
    Item i receives the sum of the earlier items of its segment: the
    inclusive cumsum minus the running maximum of the segment bases."""
    squeeze = values.dim() == 1
    v = (values[None, :] if squeeze else values).to(I32)
    C = torch.cumsum(v, dim=1, dtype=I32)
    E = C - v
    h = torch.cat([_first_true(head.shape[0], head.device), head[1:]])
    base = torch.cummax(torch.where(h[None, :], E, _INT_MIN), dim=1).values
    out = E - base
    return out[0] if squeeze else out


def seg_excl_cumsum_wide(head: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """seg_excl_cumsum for values up to 2^24 whose batch total may overflow
    int32: two 12-bit lanes through the integer scan, recombined in f32
    AFTER the exact differences (one rounding)."""
    v = values.to(I32)
    r = seg_excl_cumsum(head, torch.stack([v & 0xFFF, v >> 12]))
    return r[1].to(torch.float32) * 4096.0 + r[0].to(torch.float32)


def seg_running_min(head: torch.Tensor, v: torch.Tensor, fill: float) -> torch.Tensor:
    """True segmented inclusive running minimum over the whole row (heads
    reset it; items before the first head start from ``fill``): log-step
    doubling, ceil(log2 N) steps."""
    n = v.shape[0]
    m = v
    f = head
    d = 1
    while d < n:
        m_prev = torch.cat([torch.full((d,), fill, dtype=v.dtype, device=v.device), m[:-d]])
        f_prev = torch.cat([torch.zeros((d,), dtype=torch.bool, device=v.device), f[:-d]])
        m = torch.where(f, m, torch.minimum(m, m_prev))
        f = f | f_prev
        d *= 2
    return m


def block_min_inclusive(head: torch.Tensor, v: torch.Tensor, fill: float) -> torch.Tensor:
    """Within-segment inclusive running minimum, [N] -> [N], resetting at
    every head AND at every BLOCK boundary (heads_from_keys puts heads
    there anyway).  f32 min is order-free, so this is bit-exact."""
    n = v.shape[0]
    pos = torch.arange(n, device=v.device)
    return seg_running_min(head | (pos % BLOCK == 0), v, fill)


def seg_min_f32(ctx: SegCtx, v: torch.Tensor, fill: float) -> torch.Tensor:
    """Per-segment minimum of a float32 plane, compacted to [U]."""
    inc = block_min_inclusive(ctx.head, v, fill)
    return torch.where(ctx.live, inc[ctx.seg_end.to(torch.int64)], fill)


def expand(ctx: SegCtx, seg_vals: torch.Tensor) -> torch.Tensor:
    """Broadcast per-segment values back to items: [U(,P)] -> [N(,P)].
    Items past the capacity read slot U-1 (JAX clamps its gathers the
    same way); the engine fails them closed."""
    return seg_vals[torch.clamp_max(ctx.sid, ctx.U - 1).to(torch.int64)]


def sort_batch(key_cols: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor]):
    """Device-side stable lexicographic sort (first key most significant):
    returns (perm, sorted_payloads).  The client presorts on the host
    instead (runtime/presort.py) and never calls this."""
    n = key_cols[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=key_cols[0].device)
    for k in reversed(list(key_cols)):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm.to(I32), [p[perm] for p in payloads]


def unsort(perm: torch.Tensor, cols: Sequence[torch.Tensor]):
    """Restore batch order for output planes (device-side fallback)."""
    idx = perm.to(torch.int64)
    inv = torch.empty_like(idx).scatter_(0, idx, torch.arange(idx.shape[0], device=idx.device))
    return [c[inv] for c in cols]
