"""String → dense-id interning for resources, origins, contexts and stat rows.

The analog of the reference's copy-on-write resource→chain map
(CtSph.lookProcessChain, CtSph.java:194-216) and the per-resource /
per-origin node maps (ClusterBuilderSlot.java:69-88,
ContextUtil.trueEnter:120).  Dense ids index the engine's structure-of-
arrays tensors directly.

Capacity semantics mirror the reference:
- beyond ``max_resources`` new resources degrade to PASS-THROUGH
  (returned id is None), exactly as lookProcessChain returns null past
  MAX_SLOT_CHAIN_SIZE=6000 (Constants.java:37);
- beyond ``max_nodes`` origin/context stat rows degrade to the trash row
  (stats dropped, decisions still made on the resource node), akin to
  MAX_CONTEXT_NAME_SIZE overflow returning NullContext
  (ContextUtil.java:120).

Thread-safe; reads are lock-free dict lookups (GIL-atomic).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.core.config import EngineConfig


class Registry:
    #: cap on interned origins (MAX_CONTEXT_NAME_SIZE-style degradation)
    MAX_ORIGINS = 10_000

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self._lock = threading.RLock()
        # resource rows occupy [1, max_resources); row 0 is the ENTRY node.
        # The TOP of the row space is a PROMOTION RESERVE: ordinary
        # first-use interning stops short of it, so a rule arriving for a
        # tail resource can still claim an exact row (SALSA-style hot
        # promotion) after organic traffic has "filled" the space.
        self._resources: Dict[str, int] = {}
        self._resource_names: List[Optional[str]] = [None] * 1
        self._next_res = 1
        reserve = min(max(cfg.max_resources // 16, 1), max(cfg.max_resources // 2, 1))
        self._organic_limit = max(cfg.max_resources - reserve, 2)
        # extra stat rows (origin nodes, context default-nodes) live in
        # [max_resources, max_nodes)
        self._extra_rows: Dict[Tuple[str, str], int] = {}
        self._next_extra = cfg.max_resources
        # sketch resources: ids beyond node_rows, stats tracked in the
        # global CMS sketch (ops/gsketch.py) instead of exact rows
        self._sketch_names: Dict[int, str] = {}
        self._next_sketch = cfg.node_rows
        # exact rows freed by demotion, quarantined until their engine
        # window state has fully expired (reuse-after ordered by free
        # time): (row, reusable_at mono_s)
        self._quarantined_rows: List[Tuple[int, float]] = []
        # origins are a separate id space (matched against limitApp)
        self._origins: Dict[str, int] = {}
        self._origin_names: List[str] = []
        # context names (CHAIN-strategy matching)
        self._contexts: Dict[str, int] = {}

    # -- resources ----------------------------------------------------------

    def resource_id(self, name: str) -> Optional[int]:
        """Dense id for a resource, interning on first use.

        Returns None when capacity is exhausted → caller passes through
        (no stats, no rules), mirroring CtSph.java:200-205.
        """
        rid = self._resources.get(name)
        if rid is not None:
            return rid
        with self._lock:
            rid = self._resources.get(name)
            if rid is not None:
                return rid
            if self._next_res >= self._organic_limit:
                # organic rows exhausted (the remainder is the promotion
                # reserve) → sketch id, or pass-through when the sketch is
                # off (CtSph.java:200-205 degradation)
                if (
                    self.cfg.sketch_stats
                    and self._next_sketch - self.cfg.node_rows
                    < self.cfg.sketch_capacity
                ):
                    rid = self._next_sketch
                    self._next_sketch += 1
                    self._resources[name] = rid
                    self._sketch_names[rid] = name
                    return rid
                return None
            rid = self._next_res
            self._next_res += 1
            self._resources[name] = rid
            self._resource_names.append(name)
            return rid

    def peek_resource_id(self, name: str) -> Optional[int]:
        return self._resources.get(name)

    def _claim_quarantined_row(self) -> Optional[int]:
        """Reusable demoted row, or None (caller holds the lock).  Rows
        become reusable only after their quarantine lapses — the engine's
        window buckets for the old occupant must have rotated out (and
        in-flight entries completed) before a new name inherits the row,
        or the newcomer would start life with the old stats/concurrency."""
        from sentinel_tpu_torch.utils.time_source import mono_s

        if self._quarantined_rows and mono_s() >= self._quarantined_rows[0][1]:
            return self._quarantined_rows.pop(0)[0]
        return None

    def promote_resource(self, name: str) -> Optional[int]:
        """Move a sketch-id resource into the exact row space (so rules can
        bind to real windows) — the SALSA-style hot-promotion half of tail
        enforcement.  Returns the exact row, or None when the exact space
        is full (the rule then enforces approximately via the tail CMS
        tables).  In-flight events carrying the old sketch id land in the
        sketch one last time — an observability-only transient.

        Demoted rows past quarantine are reclaimed first, so a hot-set
        promote/demote cycle does not burn through the reserve."""
        with self._lock:
            rid = self._resources.get(name)
            if rid is None or rid < self.cfg.node_rows:
                return rid  # unknown or already exact
            new = self._claim_quarantined_row()
            if new is None:
                if self._next_res >= self.cfg.max_resources:
                    return None  # even the reserve is spent
                new = self._next_res
                self._next_res += 1
            self._resources[name] = new
            while len(self._resource_names) <= new:
                self._resource_names.append(None)
            self._resource_names[new] = name
            self._sketch_names.pop(rid, None)
            return new

    def demote_resource(self, name: str, quarantine_s: float) -> Optional[int]:
        """Move an exact-row resource back into the sketch tail (the
        hot-set manager's cold path).  The freed row is quarantined for
        ``quarantine_s`` REAL (wall-clock) seconds before promotion may
        reuse it — the caller sizes it to outlive every engine window
        holding the old occupant's counts plus in-flight entries on the
        row (HotSetManager uses 2x the longest window interval + 30 s).
        Virtual-time harnesses whose engine clock is decoupled from wall
        time must pass a quarantine matched to their own advance rate
        (engine windows rotate on ENGINE time, this quarantine on wall
        time).  Returns the new sketch id, or None when the resource
        cannot demote (unknown, the ENTRY row, or sketch capacity
        exhausted)."""
        from sentinel_tpu_torch.utils.time_source import mono_s

        with self._lock:
            rid = self._resources.get(name)
            if rid is None or rid >= self.cfg.node_rows:
                return rid if rid is not None else None  # already sketch
            if rid <= 0:
                return None  # ENTRY row never demotes
            if self._next_sketch - self.cfg.node_rows >= self.cfg.sketch_capacity:
                return None
            new = self._next_sketch
            self._next_sketch += 1
            self._resources[name] = new
            self._sketch_names[new] = name
            if rid < len(self._resource_names):
                self._resource_names[rid] = None
            self._quarantined_rows.append((rid, mono_s() + quarantine_s))
            return new

    def resource_name(self, rid: int) -> Optional[str]:
        if 0 < rid < len(self._resource_names):
            return self._resource_names[rid]
        return self._sketch_names.get(rid)

    def is_sketch_id(self, rid: int) -> bool:
        return rid >= self.cfg.node_rows

    @property
    def num_resources(self) -> int:
        return self._next_res

    def resources(self) -> Dict[str, int]:
        return dict(self._resources)

    # -- origin / context stat rows ----------------------------------------

    def extra_row(self, kind: str, key: str) -> int:
        """Stat row for an origin node ('origin', '<res>|<origin>') or a
        context DefaultNode ('ctx', '<res>|<ctx>').  Trash row on overflow."""
        k = (kind, key)
        row = self._extra_rows.get(k)
        if row is not None:
            return row
        with self._lock:
            row = self._extra_rows.get(k)
            if row is not None:
                return row
            if self._next_extra >= self.cfg.max_nodes:
                return self.cfg.trash_row
            row = self._next_extra
            self._next_extra += 1
            self._extra_rows[k] = row
            return row

    def origin_node_row(self, resource: str, origin: str) -> int:
        return self.extra_row("origin", f"{resource}\x00{origin}")

    def origin_row_if_exists(self, resource: str, origin: str) -> Optional[int]:
        """Non-creating lookup of an origin stat row (None until that
        caller has been seen) — the single place the key encoding lives
        besides origin_node_row."""
        row = self._extra_rows.get(("origin", f"{resource}\x00{origin}"))
        return None if row is None or row == self.cfg.trash_row else row

    def ctx_node_row(self, resource: str, ctx: str) -> int:
        return self.extra_row("ctx", f"{resource}\x00{ctx}")

    def extra_rows(self) -> Dict[Tuple[str, str], int]:
        return dict(self._extra_rows)

    # -- origins ------------------------------------------------------------

    def context_id(self, name: str) -> int:
        """Intern a context name (for CHAIN-strategy matching). '' → -1."""
        if not name:
            return -1
        cid = self._contexts.get(name)
        if cid is not None:
            return cid
        with self._lock:
            cid = self._contexts.get(name)
            if cid is not None:
                return cid
            cid = len(self._contexts)
            self._contexts[name] = cid
            return cid

    def origin_id(self, origin: str) -> int:
        """Intern an origin string. '' (no origin) maps to -1.

        Capped at MAX_ORIGINS distinct values: beyond that, new origins map
        to -1 (anonymous) instead of growing without bound — the analog of
        MAX_CONTEXT_NAME_SIZE pass-through degradation (Constants.java:36)
        for adversarial/high-cardinality origins (e.g. client IPs)."""
        if not origin:
            return -1
        oid = self._origins.get(origin)
        if oid is not None:
            return oid
        with self._lock:
            oid = self._origins.get(origin)
            if oid is not None:
                return oid
            if len(self._origin_names) >= self.MAX_ORIGINS:
                return -1
            oid = len(self._origin_names)
            self._origins[origin] = oid
            self._origin_names.append(origin)
            return oid

    def peek_origin_id(self, origin: str) -> int:
        if not origin:
            return -1
        return self._origins.get(origin, -1)
