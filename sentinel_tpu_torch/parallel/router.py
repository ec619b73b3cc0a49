"""Host-layer shard-by-resource routing — the multi-host story (SURVEY §2.9).

A multi-host deployment splits the resource space across hosts: each host's
engine owns the exact rows for its shard (decisions + stats stay local, no
cross-host chatter on the hot path), and GLOBAL budgets ride the cluster
token protocol exactly as in a single-host deployment.  This router is the
host-layer piece: deterministic resource→shard assignment and a fan-out
`check_batch` that groups a mixed batch per shard.

ACROSS hosts, this router is the network-level partitioning.  Shards are
any objects with the SentinelClient surface — in-process clients in tests,
remote host stubs (``parallel/remote_shard.RemoteShard``) in a real
deployment.

The port's copy of ``sentinel_tpu/parallel/router.py``: host code; each
shard's decisions run on that shard's device.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.cluster.ring import HashRing
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS

_ROUTE_FAIL_HELP = (
    "shard check_batch fan-out legs that raised, by shard index and "
    "failure kind (timeout|io|error); the affected spans degrade per "
    "on_shard_error (block = fail closed, fallback = local re-check)"
)

#: shared index rings so ``shard_of`` and every ``ShardRouter`` of the
#: same width agree on placement (and tests can derive expectations)
_RINGS: Dict[int, HashRing] = {}
_RINGS_LOCK = threading.Lock()


def _index_ring(n_shards: int) -> HashRing:
    ring = _RINGS.get(n_shards)
    if ring is None:
        with _RINGS_LOCK:
            ring = _RINGS.get(n_shards)
            if ring is None:
                ring = HashRing([str(i) for i in range(n_shards)])
                _RINGS[n_shards] = ring
    return ring


def shard_of(resource: str, n_shards: int) -> int:
    """Deterministic, process-independent shard assignment — now through
    the consistent-hash ring (``cluster/ring.py``) instead of the old
    bare ``crc32 % n``, so growing the host set remaps ~1/N of the
    resource space rather than reshuffling nearly all of it."""
    return int(_index_ring(n_shards).owner(resource))


class ShardRouter:
    """Deterministic resource→shard fan-out.

    ``on_shard_error`` governs what happens to the spans of a shard
    whose ``check_batch`` leg RAISES mid-fan-out (the other shards'
    results are always kept):

      ``"block"``     (default) those spans fail CLOSED — verdict
                      ``BLOCK_SYSTEM``, the engine's explicit degrade
                      verdict, never a silent pass
      ``"fallback"``  those spans re-check on the ``fallback`` client
                      (local enforcement, the degrade-to-local shape)
      ``"raise"``     legacy behavior: the first failing leg's exception
                      propagates (once every leg has finished) and the
                      whole batch is lost

    Every failed leg counts in
    ``sentinel_shard_route_failures_total{shard,kind}``.
    """

    def __init__(
        self,
        shards: Sequence[Any],
        on_shard_error: str = "block",
        fallback: Optional[Any] = None,
    ):
        assert shards, "at least one shard"
        if on_shard_error not in ("block", "fallback", "raise"):
            raise ValueError(f"bad on_shard_error {on_shard_error!r}")
        if on_shard_error == "fallback" and fallback is None:
            raise ValueError("on_shard_error='fallback' needs a fallback client")
        self.shards = list(shards)
        self.on_shard_error = on_shard_error
        self.fallback = fallback
        # PRIVATE copy, not the shared _RINGS instance (HashRing
        # advertises add/remove — mutating a shared ring would corrupt
        # every same-width router and shard_of), and it IS this router's
        # routing authority: shard_for/check_batch consult it, so a
        # mutation at least fails loudly instead of silently diverging
        self.ring = HashRing([str(i) for i in range(len(self.shards))])

    def _owner(self, resource: str) -> int:
        return int(self.ring.owner(resource))

    @staticmethod
    def _fail_kind(exc: BaseException) -> str:
        if isinstance(exc, TimeoutError):
            return "timeout"
        if isinstance(exc, OSError):
            return "io"
        return "error"

    @staticmethod
    def _count_route_failure(shard: int, kind: str) -> None:
        _OBS.counter(
            "sentinel_shard_route_failures_total",
            _ROUTE_FAIL_HELP,
            labels={"shard": str(shard), "kind": kind},
        ).inc()

    def shard_for(self, resource: str):
        return self.shards[self._owner(resource)]

    def entry(self, resource: str, **kw):
        """Single entry routes to the owning shard (SphU.entry surface)."""
        return self.shard_for(resource).entry(resource, **kw)

    def check_batch(
        self,
        resources: Sequence[str],
        counts: Optional[Sequence[int]] = None,
        origins: Optional[Sequence[str]] = None,
        params: Optional[Sequence[Any]] = None,
        prioritized: Optional[Sequence[bool]] = None,
        **kw,
    ) -> List[Tuple[int, int]]:
        """Mixed-shard bulk check: group per shard (EVERY per-item sequence
        sliced with its group), shards consulted concurrently — one network
        round-trip of latency, not one per shard — results restored to
        input order.

        A shard leg that raises no longer loses its spans (nor the other
        shards' answers, which the old first-``result()``-raises shape
        discarded): the failed group degrades per ``on_shard_error`` and
        the failure is counted by (shard, kind)."""
        from sentinel_tpu_torch.core import errors as ERR

        n = len(resources)
        groups: Dict[int, List[int]] = {}
        for i, r in enumerate(resources):
            groups.setdefault(self._owner(r), []).append(i)
        out: List[Optional[Tuple[int, int]]] = [None] * n

        def pick(seq, idxs):
            return [seq[i] for i in idxs] if seq is not None else None

        def run(s, idxs, client=None):
            return (client or self.shards[s]).check_batch(
                pick(resources, idxs),
                counts=pick(counts, idxs),
                origins=pick(origins, idxs),
                params=pick(params, idxs),
                prioritized=pick(prioritized, idxs),
                **kw,
            )

        def capture(s, call):
            # one leg-failure policy for BOTH fan-out shapes: a raising
            # leg becomes its exception (counted by shard+kind) instead
            # of poisoning the whole batch
            try:
                return call()
            except Exception as e:  # stlint: disable=fail-open — captured exception routes to the fail-closed BLOCK_SYSTEM fill below
                self._count_route_failure(s, self._fail_kind(e))
                return e

        if len(groups) == 1:
            ((s, idxs),) = groups.items()
            results = {s: capture(s, lambda: run(s, idxs))}
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=len(groups)) as pool:
                futures = {s: pool.submit(run, s, idxs) for s, idxs in groups.items()}
                results = {s: capture(s, f.result) for s, f in futures.items()}
        if self.on_shard_error == "raise":
            for got in results.values():
                if isinstance(got, Exception):
                    raise got
        for s, idxs in groups.items():
            got = results[s]
            if isinstance(got, Exception):
                if self.on_shard_error == "fallback":
                    try:
                        got = run(s, idxs, client=self.fallback)
                    except Exception as e:  # stlint: disable=fail-open — double fault: the spans fall through to the fail-closed fill below
                        self._count_route_failure(s, self._fail_kind(e))
                        got = e
                if isinstance(got, Exception):
                    got = [(ERR.BLOCK_SYSTEM, 0)] * len(idxs)
            for j, i in enumerate(idxs):
                out[i] = got[j]
        return out  # type: ignore[return-value]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Merged per-resource stats across shards.  A resource can appear
        on several hosts (cluster-mode traffic through load-balanced
        ingress), so numeric fields are SUMMED, not overwritten; minRt
        takes the min of observed values."""
        merged: Dict[str, Dict[str, float]] = {}
        for s in self.shards:
            for name, stats in s.stats.snapshot().items():
                prev = merged.get(name)
                if prev is None:
                    merged[name] = dict(stats)
                    continue
                for k, v in stats.items():
                    if k == "minRt":
                        nonzero = [x for x in (prev[k], v) if x > 0]
                        prev[k] = min(nonzero) if nonzero else 0.0
                    elif k == "avgRt":
                        pass  # recomputed below from summed successes
                    else:
                        prev[k] = prev[k] + v
                # weighted avgRt over summed successes
                s_prev = prev["successQps"] - stats["successQps"]
                if prev["successQps"] > 0:
                    prev["avgRt"] = (
                        prev["avgRt"] * s_prev + stats["avgRt"] * stats["successQps"]
                    ) / prev["successQps"]
        return merged
