"""Consistent-hash ring with virtual nodes — the fleet's placement law.

The port's copy of ``sentinel_tpu/cluster/ring.py``: the same hash, the
same vnode points and the same tie-break, so a port fleet places every
key where the reference's does (``tests/test_torch_ring.py`` holds the
two rings to each other and to the reference's golden assignment).

Replaces the bare ``crc32 % n`` placement (``parallel/router.py``'s
original scheme) for anything that must survive membership change: with
``V`` virtual nodes per member, adding or removing one member of ``N``
remaps only the keys the arriving/departing member owns — ~``K/N`` of
``K`` keys — instead of reshuffling ~``(N-1)/N`` of the space the way a
modulus does.  Both the cluster token fleet (``cluster/shard.py``) and
the host-layer resource router (``parallel/router.py``) place through
this ring LAW — same hash, same vnode scheme, same stability bound —
but each over its OWN member set and keyspace (shard names × ``flow/``
keys vs shard indices × raw resource strings), so the two layers'
assignments are deterministic per layer, not equal across layers.

Determinism contract (pinned by the golden assignment in
``tests/test_ring.py``, which ``tests/test_torch_ring.py`` reuses):
hashes are ``zlib.crc32`` — process- and version-independent, unlike
Python's salted ``hash()`` — and ties on the ring are broken by member
name, so the assignment is a pure function of ``(members, vnodes,
key)``.
"""

from __future__ import annotations

import bisect
import zlib
from typing import Dict, Iterable, List, Sequence, Tuple

DEFAULT_VNODES = 64


def _h(s: str) -> int:
    return zlib.crc32(s.encode("utf-8"))


def flow_key(flow_id: int) -> str:
    """Canonical ring key for a cluster flow id (stable across layers:
    the RLS front door, the sharded token client, and tests all derive
    the owner from this one string)."""
    return f"flow/{int(flow_id)}"


class HashRing:
    """Immutable-point consistent-hash ring; membership edits rebuild
    the point list (cheap: ``N × vnodes`` crc32 calls, never on a
    request path)."""

    def __init__(self, members: Iterable[str], vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._members: List[str] = []
        #: (sorted hashes, sorted (hash, member) points) — ONE attribute,
        #: so a reader never pairs one membership's points with another's
        #: hash index (see ``_rebuild``)
        self._table: Tuple[List[int], List[Tuple[int, str]]] = ([], [])
        for m in members:
            if m in self._members:
                raise ValueError(f"duplicate ring member {m!r}")
            self._members.append(m)
        if not self._members:
            raise ValueError("ring needs at least one member")
        self._rebuild()

    # -- membership ----------------------------------------------------------

    @property
    def members(self) -> List[str]:
        return list(self._members)

    def add(self, member: str) -> None:
        if member in self._members:
            raise ValueError(f"ring member {member!r} already present")
        self._members.append(member)
        self._rebuild()

    def remove(self, member: str) -> None:
        if member not in self._members:
            raise ValueError(f"ring member {member!r} not present")
        if len(self._members) == 1:
            raise ValueError("cannot remove the last ring member")
        self._members.remove(member)
        self._rebuild()

    def _rebuild(self) -> None:
        # ties (two vnodes hashing equal) break by member name — the
        # tuple sort — so the walk order is a pure function of members
        pts = sorted(
            (_h(f"{m}#{v}"), m)
            for m in self._members
            for v in range(self.vnodes)
        )
        # atomic publish: a concurrent owner() during add/remove either
        # sees the old table or the new one, never a torn pair
        self._table = ([h for h, _m in pts], pts)

    # -- placement -----------------------------------------------------------

    def owner(self, key: str) -> str:
        """The member owning ``key``: first ring point clockwise of the
        key's hash (wrapping at the top)."""
        hashes, points = self._table
        i = bisect.bisect_right(hashes, _h(key))
        if i == len(points):
            i = 0
        return points[i][1]

    def owner_of_flow(self, flow_id: int) -> str:
        return self.owner(flow_key(flow_id))

    def assignment(self, keys: Sequence[str]) -> Dict[str, str]:
        """key -> owner for a batch (test/diagnostic convenience)."""
        return {k: self.owner(k) for k in keys}

    def spread(self, keys: Sequence[str]) -> Dict[str, int]:
        """owner -> owned-key count over ``keys`` (balance diagnostics;
        the ``/api/shards`` exposition reports this for live fleets)."""
        out: Dict[str, int] = {m: 0 for m in self._members}
        for k in keys:
            out[self.owner(k)] += 1
        return out
