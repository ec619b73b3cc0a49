"""Sharded cluster token fleet: N token servers behind a consistent-hash
ring, with per-shard failover and bounded-slack budget leases.

This is the distributed L6 the reference architecture describes (PAPER.md
§2.9): instead of one localhost ``ClusterTokenServer``, the flow-id space
is split across N real token servers — each shard owns the flows the
``HashRing`` (``cluster/ring.py``) assigns to it, so capacity scales with
shards and a membership change remaps only ~1/N of the id space.

Pieces:

  ``ShardedTokenClient``  a ``TokenService`` that routes every request to
      the owning shard's ``ClusterTokenClient``.  Per-shard health rides
      the SAME hysteresis shape as the runtime's cluster degrade
      (enter-on-failure with a cooldown, hold, exit on the first healthy
      probe) but scoped to ONE shard: a dead shard degrades only its own
      flows, the rest of the fleet keeps answering remotely.

  budget leases  while a shard is healthy, the client keeps a standing
      LEASE of ``lease_slack × rule_count`` tokens per active flow
      (``MSG_TYPE_LEASE``, granted by the owner out of the same engine
      budget as ordinary tokens).  When the shard dies, decisions for its
      flows are served by debiting the lease balance — and fail CLOSED
      (``STATUS_BLOCKED``) once it is spent or expired, or when no lease
      was ever established (ambiguity never passes).  Token conservation:
      every fallback grant was debited from the global budget when the
      lease was acquired, so the worst-case overshoot is one outstanding
      lease per (client, flow) — the bounded-slack window of
      "Give Me Some Slack" (arXiv 1703.01166) — not an unmetered local
      re-enforcement.

  ``ShardFleet``  in-process N-shard fleet builder (tests, chaos
      scenarios, the bench's ``cluster_sharded`` row, local demos): N
      ``DefaultTokenService`` + ``ClusterTokenServer`` pairs, rules
      partitioned onto their owners through the ring, one
      ``ShardedTokenClient`` fronting them, plus ``kill``/``rejoin`` to
      exercise failover.  Its ``flow_rules`` facade quacks like a
      ``ClusterFlowRuleManager`` so the Envoy RLS rule manager
      (``rls/rules.py``) can project descriptors straight onto a fleet.

Observability: every decision, failover transition, and lease grant is
labeled by shard (``sentinel_shard_*`` series); degrade transitions land
in the flight recorder; routed requests adopt the ambient trace context
so a merged dump shows client → RLS → shard as one timeline.

The port's copy of ``sentinel_tpu/cluster/shard.py``: host code over the
port's token client, token service and server.  Each shard's decisions
run on its decision client's device (the card unless the factory asks
for the CPU), through the token column or that client's engine ticks.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from sentinel_tpu_torch.adaptive.degrade import Hysteresis
from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.cluster import constants as C
from sentinel_tpu_torch.cluster.client import ClusterTokenClient
from sentinel_tpu_torch.cluster.ring import DEFAULT_VNODES, HashRing, flow_key
from sentinel_tpu_torch.cluster.token_service import TokenResult, TokenService
from sentinel_tpu_torch.obs import flight as FL
from sentinel_tpu_torch.obs import trace as OT
from sentinel_tpu_torch.obs.registry import REGISTRY as _OBS
from sentinel_tpu_torch.utils.time_source import mono_s, wall_ms_now

#: chaos failpoints — the exact points a fleet-level fault strikes.  The
#: route site guards every remote dispatch (a raise here is "the shard is
#: unreachable" without tearing down real sockets, so scheduled hit
#: indices stay deterministic); the probe site marks health re-probes of
#: a degraded shard; the lease site covers the slack-lease refresh RPC.
_FP_ROUTE = FP.register(
    "cluster.shard.route", "sharded-client dispatch to the owning shard", FP.HIT_ACTIONS
)
_FP_PROBE = FP.register(
    "cluster.shard.probe", "health re-probe of a degraded shard", FP.HIT_ACTIONS
)
_FP_LEASE = FP.register(
    "cluster.shard.lease", "bounded-slack lease refresh round-trip", FP.HIT_ACTIONS
)
_FP_LEASE_ASYNC = FP.register(
    "cluster.lease.refresh_async",
    "ahead-of-exhaustion lease top-up dispatch",
    FP.HIT_ACTIONS,
)

_REQ_HELP = "token requests routed by the sharded client, by owning shard"
_LOCAL_ADMIT_HELP = (
    "decisions admitted locally against a healthy shard's standing lease "
    "(the zero-RPC fast path), by shard"
)
_FALLBACK_HELP = (
    "decisions served by the shard-local lease fallback while the owning "
    "shard is degraded, by verdict (pass = lease debit, block = fail-closed)"
)
_TRANSITION_HELP = "per-shard failover transitions (enter|exit)"
_DEGRADED_HELP = "1 while this shard is degraded to lease-fallback serving"
_LEASE_HELP = "budget tokens granted to this client as slack leases, by shard"

#: live fleets, for the ``/api/shards`` exposition (weak: a stopped
#: fleet must not be pinned by the command plane)
_FLEET_REGISTRY: "weakref.WeakSet[ShardedTokenClient]" = weakref.WeakSet()


def describe_fleets() -> List[dict]:
    """Topology + health of every live ``ShardedTokenClient`` in the
    process (the ``GET /api/shards`` payload)."""
    return [c.describe() for c in list(_FLEET_REGISTRY)]


class _Lease:
    """One flow's standing slack lease: ``granted`` tokens spendable
    until ``expires_ms`` (wall clock, the wire's accounting domain).
    ``retry_at_ms`` backs off ahead-of-exhaustion top-ups after the
    owner DENIED one while this lease still had spendable carry — the
    carry keeps draining, but re-asking before the horizon would retry
    a saturated budget on every local admit."""

    __slots__ = ("granted", "used", "expires_ms", "retry_at_ms")

    def __init__(self, granted: int, expires_ms: int):
        self.granted = granted
        self.used = 0
        self.expires_ms = expires_ms
        self.retry_at_ms = 0


class _ShardState:
    """Health + lease bookkeeping for one ring member."""

    def __init__(self, name: str, client: ClusterTokenClient):
        self.name = name
        self.client = client
        self.lock = threading.Lock()
        self.leases: Dict[int, _Lease] = {}
        #: flows with a LEASE RPC in flight — a second concurrent refresh
        #: would debit the global budget twice and keep only one grant
        self.lease_inflight: set = set()
        #: the shard's lease validity window as last reported by a grant
        #: (denials answer wait_ms=0, so they borrow this for their cache
        #: expiry — a 600 s-window fleet must not retry denials every 1 s)
        self.lease_ttl_hint_ms: int = C.DEFAULT_LEASE_TTL_MS
        #: single-flight gate for the failover probe: when the cooldown
        #: expires, exactly one thread pays the RPC against the
        #: maybe-still-dead shard; the rest keep serving the fallback
        self.probe_lock = threading.Lock()
        labels = {"shard": name}
        self.c_requests = _OBS.counter(
            "sentinel_shard_requests_total", _REQ_HELP, labels=labels
        )
        self.c_fallback = {
            v: _OBS.counter(
                "sentinel_shard_fallback_total",
                _FALLBACK_HELP,
                labels={"shard": name, "verdict": v},
            )
            for v in ("pass", "block")
        }
        self.c_enter = _OBS.counter(
            "sentinel_shard_degrade_transitions_total",
            _TRANSITION_HELP,
            labels={"shard": name, "transition": "enter"},
        )
        self.c_exit = _OBS.counter(
            "sentinel_shard_degrade_transitions_total",
            _TRANSITION_HELP,
            labels={"shard": name, "transition": "exit"},
        )
        self.g_degraded = _OBS.gauge(
            "sentinel_shard_degraded", _DEGRADED_HELP, labels=labels
        )
        self.c_lease_tokens = _OBS.counter(
            "sentinel_shard_lease_tokens_total", _LEASE_HELP, labels=labels
        )
        self.c_local_admits = _OBS.counter(
            "sentinel_lease_local_admits_total", _LOCAL_ADMIT_HELP, labels=labels
        )
        # the shared degrade-hysteresis primitive (adaptive/degrade.py),
        # scoped to THIS shard: same journal kinds ("shard.degrade.*"),
        # counters and gauge as the hand-rolled state it replaced.  The
        # cooldown is re-armed per enter() by the owning client (it owns
        # retry_interval_s).
        self.hy = Hysteresis(
            "shard.degrade",
            cooldown_s=5.0,
            attrs={"shard": name},
            counter_enter=self.c_enter,
            counter_exit=self.c_exit,
            gauge=self.g_degraded,
        )

    # attribute-compatible views (tests and the chaos harness poke these)
    @property
    def degraded_active(self) -> bool:
        return self.hy.active

    @degraded_active.setter
    def degraded_active(self, v: bool) -> None:
        self.hy.active = bool(v)

    @property
    def degraded_until(self) -> float:
        return self.hy.until

    @degraded_until.setter
    def degraded_until(self, v: float) -> None:
        self.hy.until = float(v)


class ShardedTokenClient(TokenService):
    """Hash-ring fan-out over N ``ClusterTokenClient`` connections.

    ``members`` maps shard name → ``(host, port)``.  Shard names are the
    ring members, so placement depends only on the NAMES — restarting a
    shard on a new port moves no keys.

    ``lease_slack`` sizes the per-flow standing lease as a fraction of
    the flow's threshold (0 disables leasing: a dead shard's flows then
    fail closed immediately).  Rule thresholds are learned via
    ``register_flow_rule`` — the ``ShardFleet``/RLS loaders call it; a
    client wired by hand must feed it the same rules its servers hold,
    or fallback (correctly) fails closed for unknown flows.

    Lease-first admission (protocol v2): with ``lease_slack > 0`` the
    standing lease is not just failover slack — it is the PRIMARY
    admission path.  A healthy flow admits locally by debiting the
    lease (zero RPCs) and tops the lease up in the background once the
    spendable remainder dips under ``lease_refresh_frac`` of the grant
    (or the TTL nears expiry).  Expiry still fails closed exactly as
    before: an expired or spent lease routes the request remotely.
    ``lease_refresh_async=False`` (or an armed chaos plan — see
    ``_refresh_lease_soon``) runs the top-up inline on the admitting
    thread, keeping failpoint hit counts a pure function of the seed.
    """

    def __init__(
        self,
        members: Dict[str, Tuple[str, int]],
        namespace: str = C.DEFAULT_NAMESPACE,
        timeout_ms: int = C.DEFAULT_REQUEST_TIMEOUT_MS,
        vnodes: int = DEFAULT_VNODES,
        retry_interval_s: float = 5.0,
        lease_slack: float = 0.25,
        reconnect_interval_s: float = 2.0,
        clients: Optional[Dict[str, ClusterTokenClient]] = None,
        lease_refresh_frac: float = 0.5,
        lease_refresh_async: bool = True,
    ):
        if not members:
            raise ValueError("sharded client needs at least one member")
        self.namespace = namespace
        self.retry_interval_s = retry_interval_s
        self.lease_slack = float(lease_slack)
        self.lease_refresh_frac = float(lease_refresh_frac)
        self.lease_refresh_async = bool(lease_refresh_async)
        self._refresher = _LeaseRefresher(self)
        self.ring = HashRing(sorted(members), vnodes=vnodes)
        self._order = sorted(members)  # index ↔ name, for composite token ids
        self._shards: Dict[str, _ShardState] = {}
        for name in self._order:
            host, port = members[name]
            cli = (clients or {}).get(name) or ClusterTokenClient(
                host,
                port,
                namespace=namespace,
                timeout_ms=timeout_ms,
                reconnect_interval_s=reconnect_interval_s,
            )
            self._shards[name] = _ShardState(name, cli)
        self._rule_counts: Dict[int, float] = {}
        self._rules_lock = threading.Lock()
        #: ClusterFlowRuleManager-quacking loader.  The default facade
        #: only LEARNS thresholds (lease sizing — pushing the rules to
        #: the shard servers is whoever runs them); ShardFleet replaces
        #: it with _FleetFlowRules, which also partitions rules onto the
        #: owners, so the RLS rule manager can project onto either shape
        self.flow_rules = _ClientFlowRules(self)
        _FLEET_REGISTRY.add(self)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for st in self._shards.values():
            st.client.start()

    def close(self) -> None:
        # deregister FIRST: a closed client must drop out of the
        # GET /api/shards topology even while callers still hold a ref
        _FLEET_REGISTRY.discard(self)
        self._refresher.close()
        for st in self._shards.values():
            st.client.close()

    @property
    def connected(self) -> bool:
        return any(st.client.connected for st in self._shards.values())

    # -- topology ------------------------------------------------------------

    def owner_of(self, flow_id: int) -> str:
        return self.ring.owner_of_flow(flow_id)

    def register_flow_rule(self, flow_id: int, count: float) -> None:
        """Teach the client a flow's threshold (lease sizing + fallback
        legality).  ``count <= 0`` forgets the flow — and its standing
        leases: a dropped rule must not keep admitting fallback traffic
        until the lease TTL runs out (this is also the only eviction
        ``st.leases`` has, so churning flow ids don't grow it forever)."""
        fid = int(flow_id)
        with self._rules_lock:
            if count > 0:
                self._rule_counts[fid] = float(count)
            else:
                self._rule_counts.pop(fid, None)
        if count <= 0:
            for st in self._shards.values():
                with st.lock:
                    st.leases.pop(fid, None)

    def shard_degraded(self, name: str) -> bool:
        return self._shards[name].degraded_active

    def describe(self) -> dict:
        now = mono_s()
        with self._rules_lock:
            # snapshot under the lock: a concurrent rule push mutating
            # the dict mid-iteration would fail the /api/shards request
            flow_ids = sorted(self._rule_counts)
        return {
            "namespace": self.namespace,
            "vnodes": self.ring.vnodes,
            "lease_slack": self.lease_slack,
            "flows_registered": len(flow_ids),
            "ring_spread": self.ring.spread(
                [flow_key(fid) for fid in flow_ids]
            ),
            "shards": [
                {
                    "name": st.name,
                    "addr": f"{st.client.host}:{st.client.port}",
                    "connected": st.client.connected,
                    "degraded": st.degraded_active,
                    "cooldown_remaining_s": round(
                        max(st.degraded_until - now, 0.0), 3
                    )
                    if st.degraded_active
                    else 0.0,
                    "leases": len(st.leases),
                }
                for st in self._shards.values()
            ],
        }

    # -- failover hysteresis (per shard) ------------------------------------

    def _enter_degraded(self, st: _ShardState) -> None:
        # transition mechanics (cooldown, counters, gauge, journal) live
        # in the shared adaptive.degrade.Hysteresis — scoped to ONE shard
        st.hy.enter(cooldown_s=self.retry_interval_s)

    def _exit_degraded(self, st: _ShardState) -> None:
        st.hy.exit()

    # -- routing core --------------------------------------------------------

    def _call(
        self,
        flow_id: int,
        remote: Callable[[ClusterTokenClient], TokenResult],
        fallback: Callable[[_ShardState], TokenResult],
    ) -> TokenResult:
        """Route one request to the owning shard with the failover
        protocol: degraded-and-cooling serves the fallback, an expired
        cooldown probes the shard (success exits degraded, failure
        re-arms the cooldown), and any transport-level failure —
        exception or ``STATUS_FAIL`` — enters degraded for THIS shard
        only."""
        st = self._shards[self.ring.owner_of_flow(flow_id)]
        st.c_requests.inc()
        degraded = st.degraded_active
        if degraded:
            if mono_s() < st.degraded_until:
                return fallback(st)
            # cooldown expired: single-flight the probe, or every thread
            # in flight pays timeout_ms against the dead shard at once
            if not st.probe_lock.acquire(blocking=False):
                return fallback(st)
        try:
            if degraded:
                FP.hit(_FP_PROBE)
            FP.hit(_FP_ROUTE)
            r = remote(st.client)
        except Exception:  # stlint: disable=fail-open — degrade to the shard-local lease fallback (fail-closed when no lease), never PASS
            self._enter_degraded(st)
            return fallback(st)
        finally:
            if degraded:
                st.probe_lock.release()
        if r.status == C.STATUS_FAIL:
            self._enter_degraded(st)
            return fallback(st)
        # BAD_REQUEST is synthesized client-side (oversized frame): it
        # proves nothing about shard health, so it must not exit degraded
        if degraded and r.status != C.STATUS_BAD_REQUEST:
            self._exit_degraded(st)
        return r

    # -- leases --------------------------------------------------------------

    def _lease_units(self, flow_id: int) -> int:
        count = self._rule_counts.get(int(flow_id), 0.0)
        if count <= 0 or self.lease_slack <= 0:
            return 0
        return min(
            max(int(math.ceil(count * self.lease_slack)), 1), C.MAX_LEASE_UNITS
        )

    def _maybe_refresh_lease(self, flow_id: int) -> None:
        """Bootstrap/expiry refresh on the request path: at most one
        blocking LEASE round-trip per validity window per flow, exactly
        the pre-lease-first contract.  In the v2 steady state the
        ahead-of-exhaustion top-up (``_refresh_lease_soon``) keeps the
        lease from ever expiring, so this fires only for a flow's FIRST
        request (or after an owner outage).  Failures are ignored — a
        missing lease just means the fallback fails closed, which is
        the safe direction."""
        if self._lease_units(flow_id) <= 0:
            return
        st = self._shards[self.ring.owner_of_flow(flow_id)]
        if st.degraded_active:
            # never refresh against a degraded shard — not even once the
            # cooldown expires (fallback-served requests would stampede
            # timeout_ms LEASE RPCs past the single-flight route probe);
            # the probe that heals the shard clears degraded_active, and
            # the same request then refreshes right below
            return
        now = wall_ms_now()
        with st.lock:
            lease = st.leases.get(flow_id)
            if lease is not None and now < lease.expires_ms:
                return
            if flow_id in st.lease_inflight:
                return
            st.lease_inflight.add(flow_id)
        self._refresh_lease_now(st, flow_id)

    def _lease_admit(self, flow_id: int, count: int) -> Optional[TokenResult]:
        """Lease-first fast path: admit locally against the standing
        bounded-slack lease while the owner is HEALTHY — zero RPCs on
        the request.  Returns ``None`` whenever the fast path does not
        apply (leasing disabled, shard degraded, lease missing, spent,
        or expired) and the caller routes remotely exactly as before —
        expiry fails closed into the remote path, never a local pass.
        Every grant here was debited from the global budget when the
        lease was acquired, so local admits conserve tokens."""
        if self.lease_slack <= 0 or count <= 0:
            return None
        st = self._shards[self.ring.owner_of_flow(flow_id)]
        if st.degraded_active:
            return None  # degraded flows use the metered fallback path
        now = wall_ms_now()
        refresh = False
        with st.lock:
            lease = st.leases.get(flow_id)
            if (
                lease is None
                or lease.granted <= 0
                or now >= lease.expires_ms
                or lease.used + count > lease.granted
            ):
                return None
            lease.used += count
            remaining = lease.granted - lease.used
            st.c_local_admits.inc()
            # top up ahead of exhaustion: once the spendable remainder
            # dips under refresh_frac of the grant — or the TTL enters
            # its last quarter — schedule a background refresh so the
            # NEXT admission window never pays a blocking RPC
            low = remaining <= lease.granted * self.lease_refresh_frac
            near = (lease.expires_ms - now) <= st.lease_ttl_hint_ms * 0.25
            if (low or near) and now >= lease.retry_at_ms:
                refresh = True
        if refresh:
            self._refresh_lease_soon(st, flow_id)
        return TokenResult(C.STATUS_OK, remaining=remaining)

    def _refresh_lease_soon(self, st: _ShardState, flow_id: int) -> None:
        """Ahead-of-exhaustion top-up dispatch: claim the single-flight
        marker and hand the RPC to the background refresher so the
        admitting request never pays transport latency.  While a chaos
        plan is armed — or ``lease_refresh_async=False`` — the hop runs
        INLINE instead: a background worker would make the LEASE
        failpoints fire at a nondeterministic point, breaking the chaos
        plane's injected-counts-are-a-pure-function-of-the-seed
        contract."""
        with st.lock:
            if flow_id in st.lease_inflight:
                return
            st.lease_inflight.add(flow_id)
        if self.lease_refresh_async and not FP.is_armed():
            self._refresher.enqueue(st, flow_id)
            return
        try:
            FP.hit(_FP_LEASE_ASYNC)
        except Exception:  # stlint: disable=fail-open — an injected dispatch fault skips ONE top-up; the lease keeps draining and fails closed at exhaustion
            with st.lock:
                st.lease_inflight.discard(flow_id)
            return
        self._refresh_lease_now(st, flow_id)

    def flush_lease_refresh(self, timeout_s: float = 5.0) -> bool:
        """Block until every queued ahead-of-exhaustion top-up has
        drained (tests and the bench use this to sequence assertions
        against the background refresher)."""
        return self._refresher.flush(timeout_s)

    def _lease_ask(self, st: _ShardState, flow_id: int) -> Tuple[int, int]:
        """``(ask, units_total)`` for a top-up: the lease target minus
        the still-spendable carry of the current lease."""
        units_total = self._lease_units(flow_id)
        if units_total <= 0:
            return 0, 0
        now = wall_ms_now()
        with st.lock:
            lease = st.leases.get(flow_id)
            carry = 0
            if lease is not None and now < lease.expires_ms:
                carry = max(lease.granted - lease.used, 0)
        return units_total - carry, units_total

    def _refresh_lease_now(self, st: _ShardState, flow_id: int) -> None:
        """Blocking lease top-up; the caller must already hold the
        in-flight marker for this flow (single-flight)."""
        ask, units_total = self._lease_ask(st, flow_id)
        if ask <= 0:
            with st.lock:
                st.lease_inflight.discard(flow_id)
            return
        try:
            FP.hit(_FP_LEASE)
            r = st.client.request_lease(flow_id, ask)
        except Exception:  # stlint: disable=fail-open — no lease acquired: the fallback path fails CLOSED for this flow
            with st.lock:
                st.lease_inflight.discard(flow_id)
            return
        if r.status == C.STATUS_FAIL:
            # transport-shaped failure, NOT an admission denial: caching
            # it would pin a zero-unit lease for a whole TTL window and
            # silently disable the failover slack.  Leave it uncached —
            # a genuinely sick shard degrades via the route path, which
            # then skips refresh entirely.
            with st.lock:
                st.lease_inflight.discard(flow_id)
            return
        self._store_lease_result(st, flow_id, r, units_total)

    def _store_lease_result(
        self, st: _ShardState, flow_id: int, r: TokenResult, units_total: int
    ) -> None:
        """Fold one grant/denial into the standing lease, in the SAME
        critical section that clears the in-flight marker:
        discard-then-store would let another thread slip in between and
        double-debit the budget."""
        if r.status == C.STATUS_OK and r.remaining > 0:
            st.c_lease_tokens.inc(r.remaining)
        now = wall_ms_now()
        with st.lock:
            st.lease_inflight.discard(flow_id)
            if int(flow_id) not in self._rule_counts:
                # the rule was dropped while the RPC was in flight —
                # storing the grant would resurrect a deleted rule's
                # standing lease past register_flow_rule's eviction
                return
            lease = st.leases.get(flow_id)
            carry = 0
            if lease is not None and now < lease.expires_ms:
                # recompute the carry NOW — local admits kept debiting
                # while the RPC was in flight, so the grant folds onto
                # whatever is genuinely left (bounded by units_total:
                # a shrunken carry only under-fills, never over)
                carry = max(lease.granted - lease.used, 0)
            if r.status == C.STATUS_OK and r.remaining > 0:
                st.lease_ttl_hint_ms = max(r.wait_ms, 1)
                st.leases[flow_id] = _Lease(
                    min(carry + r.remaining, units_total),
                    now + max(r.wait_ms, 1),
                )
            elif carry > 0:
                # top-up DENIED but the standing lease still has carry:
                # keep draining it and just back off further asks until
                # the denial horizon — replacing it with a zero-lease
                # would throw away slack the budget already paid for
                lease.retry_at_ms = now + max(r.wait_ms, st.lease_ttl_hint_ms)
            else:
                # cache the DENIAL too: a saturated flow otherwise
                # retries a blocking LEASE round-trip on every request
                # for the rest of the window, breaking the ≤1
                # RPC/TTL-window/flow contract.  A zero-unit lease
                # behaves exactly like no lease in the fallback (fails
                # closed) while suppressing the retries.
                st.leases[flow_id] = _Lease(
                    0, now + max(r.wait_ms, st.lease_ttl_hint_ms)
                )

    def _refresh_leases_batch(self, st: _ShardState, flow_ids: List[int]) -> None:
        """Background top-up for several of one shard's flows at once:
        a v2 peer answers them as ONE batched LEASE frame (one
        round-trip for the whole group), a v1 peer gets pipelined
        individual requests.  The caller (the refresher thread) already
        holds every flow's in-flight marker."""
        if st.degraded_active:
            with st.lock:
                for fid in flow_ids:
                    st.lease_inflight.discard(fid)
            return
        live: List[Tuple[int, int]] = []  # (flow_id, units_total)
        entries: List[Tuple[int, int, int]] = []
        for fid in flow_ids:
            ask, units_total = self._lease_ask(st, fid)
            if ask <= 0:
                with st.lock:
                    st.lease_inflight.discard(fid)
                continue
            live.append((fid, units_total))
            entries.append((C.BATCH_KIND_LEASE, fid, ask))
        if not live:
            return
        try:
            FP.hit(_FP_LEASE)
            results = st.client.request_batch(entries)
        except Exception:  # stlint: disable=fail-open — no lease acquired: the fallback fails CLOSED for these flows
            with st.lock:
                for fid, _ in live:
                    st.lease_inflight.discard(fid)
            return
        for (fid, units_total), r in zip(live, results):
            if r.status == C.STATUS_FAIL:
                # transport-shaped — leave uncached (see _refresh_lease_now)
                with st.lock:
                    st.lease_inflight.discard(fid)
                continue
            self._store_lease_result(st, fid, r, units_total)

    def _fallback_flow(self, st: _ShardState, flow_id: int, count: int) -> TokenResult:
        """Shard-local decision while the owner is unreachable: debit the
        standing lease, fail CLOSED when it is missing, spent, or expired
        — an unknown budget never passes."""
        now = wall_ms_now()
        with st.lock:
            lease = st.leases.get(flow_id)
            if (
                lease is not None
                and now < lease.expires_ms
                and lease.used + count <= lease.granted
            ):
                lease.used += count
                st.c_fallback["pass"].inc()
                return TokenResult(
                    C.STATUS_OK, remaining=lease.granted - lease.used
                )
        st.c_fallback["block"].inc()
        return TokenResult(C.STATUS_BLOCKED)

    def _fallback_block(self, st: _ShardState) -> TokenResult:
        st.c_fallback["block"].inc()
        return TokenResult(C.STATUS_BLOCKED)

    # -- TokenService --------------------------------------------------------

    def request_token(
        self, flow_id: int, count: int = 1, prioritized: bool = False
    ) -> TokenResult:
        r = self._lease_admit(flow_id, count)
        if r is not None:
            return r
        r = self._call(
            flow_id,
            lambda c: c.request_token(flow_id, count, prioritized),
            lambda st: self._fallback_flow(st, flow_id, count),
        )
        if r.status in (C.STATUS_OK, C.STATUS_SHOULD_WAIT, C.STATUS_BLOCKED):
            self._maybe_refresh_lease(flow_id)
        return r

    def request_token_batch(self, flow_id: int, units: int) -> TokenResult:
        r = self._lease_admit(flow_id, units)
        if r is not None:
            return TokenResult(C.STATUS_OK, remaining=units)

        def _fb(st: _ShardState) -> TokenResult:
            r = self._fallback_flow(st, flow_id, units)
            if r.status == C.STATUS_OK:
                return TokenResult(C.STATUS_OK, remaining=units)
            return TokenResult(C.STATUS_BLOCKED, remaining=0)

        r = self._call(
            flow_id, lambda c: c.request_token_batch(flow_id, units), _fb
        )
        if r.status in (C.STATUS_OK, C.STATUS_SHOULD_WAIT, C.STATUS_BLOCKED):
            self._maybe_refresh_lease(flow_id)
        return r

    def request_token_many(
        self, requests: Sequence[Tuple[int, int]]
    ) -> List[TokenResult]:
        """Admit many ``(flow_id, count)`` asks in one pass: lease-local
        admits cost nothing, and whatever must route remotely is grouped
        per owning shard into ONE protocol-v2 batch frame each (a v1
        peer gets a pipelined burst over the same multiplexed socket).
        The RLS front door drives multi-descriptor requests through
        this instead of one blocking round-trip per descriptor."""
        out: List[Optional[TokenResult]] = [None] * len(requests)
        per: Dict[str, List[int]] = {}
        for i, (fid, cnt) in enumerate(requests):
            r = self._lease_admit(fid, cnt)
            if r is not None:
                out[i] = r
                continue
            per.setdefault(self.ring.owner_of_flow(fid), []).append(i)
        for name, idxs in per.items():
            st = self._shards[name]
            st.c_requests.inc(len(idxs))
            entries = [
                (C.BATCH_KIND_FLOW, requests[i][0], requests[i][1]) for i in idxs
            ]
            rs = self._call_batch(st, entries)
            if rs is None:
                for i in idxs:
                    out[i] = self._fallback_flow(st, requests[i][0], requests[i][1])
                continue
            for i, r in zip(idxs, rs):
                out[i] = r
            for i in idxs:
                if out[i].status in (
                    C.STATUS_OK,
                    C.STATUS_SHOULD_WAIT,
                    C.STATUS_BLOCKED,
                ):
                    self._maybe_refresh_lease(requests[i][0])
        return [r if r is not None else TokenResult(C.STATUS_FAIL) for r in out]

    def _call_batch(
        self, st: _ShardState, entries: List[Tuple[int, int, int]]
    ) -> Optional[List[TokenResult]]:
        """One shard's slice of a many-flow request, under the same
        failover protocol as ``_call``.  Returns ``None`` when the
        exchange failed at the transport level (the caller serves every
        entry from the lease fallback)."""
        degraded = st.degraded_active
        if degraded:
            if mono_s() < st.degraded_until:
                return None
            if not st.probe_lock.acquire(blocking=False):
                return None
        try:
            if degraded:
                FP.hit(_FP_PROBE)
            FP.hit(_FP_ROUTE)
            rs = st.client.request_batch(entries)  # stlint: disable=blocking-under-lock — single-flight probe: probe_lock is only taken with blocking=False, so contenders serve the lease fallback instantly instead of queuing behind this round-trip
        except Exception:  # stlint: disable=fail-open — degrade to the shard-local lease fallback (fail-closed when no lease), never PASS
            self._enter_degraded(st)
            return None
        finally:
            if degraded:
                st.probe_lock.release()
        if rs and all(r.status == C.STATUS_FAIL for r in rs):
            # request_batch fails closed as a UNIT on transport trouble
            # (whole-frame FAIL, timeout, dead socket), so all-FAIL is
            # the batched shape of a single STATUS_FAIL round-trip
            self._enter_degraded(st)
            return None
        if degraded:
            self._exit_degraded(st)
        return rs

    def request_param_token(
        self, flow_id: int, count: int, params: List
    ) -> TokenResult:
        # no lease covers hot-param budgets (per-value state lives only
        # on the owner) → degraded param flows fail closed
        return self._call(
            flow_id,
            lambda c: c.request_param_token(flow_id, count, params),
            self._fallback_block,
        )

    def request_lease(self, flow_id: int, units: int) -> TokenResult:
        # a lease minted by anyone but the owner would double the budget
        return self._call(
            flow_id,
            lambda c: c.request_lease(flow_id, units),
            lambda st: TokenResult(C.STATUS_FAIL),
        )

    # concurrent tokens: the grantor must also see the release, so the
    # sharded token id carries the shard index in its high bits — ids
    # stay opaque int64s on the wire and release routes without a map
    _SHARD_BITS = 48

    def request_concurrent_token(self, flow_id: int, count: int = 1) -> TokenResult:
        name = self.ring.owner_of_flow(flow_id)
        idx = self._order.index(name)
        r = self._call(
            flow_id,
            lambda c: c.request_concurrent_token(flow_id, count),
            self._fallback_block,
        )
        if r.status == C.STATUS_OK and r.token_id:
            r = TokenResult(
                r.status, token_id=(idx << self._SHARD_BITS) | r.token_id
            )
        return r

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        idx, raw = token_id >> self._SHARD_BITS, token_id & ((1 << self._SHARD_BITS) - 1)
        if not (0 <= idx < len(self._order)):
            return TokenResult(C.STATUS_BAD_REQUEST)
        st = self._shards[self._order[idx]]
        if st.degraded_active and mono_s() < st.degraded_until:
            # don't stall timeout_ms against a shard already known dead —
            # the server-side TTL sweep expires the lost release
            return TokenResult(C.STATUS_FAIL)
        try:
            return st.client.release_concurrent_token(raw)
        except Exception:  # stlint: disable=fail-open — a lost release expires via the server-side TTL sweep; never PASSes anything
            return TokenResult(C.STATUS_FAIL)


class _LeaseRefresher:
    """Background lease top-up worker for one ``ShardedTokenClient``:
    the admitting thread only enqueues ``(shard, flow)``; this thread
    drains the queue and groups everything bound for the same shard
    into one batched LEASE exchange (``_refresh_leases_batch``).  The
    thread starts lazily on the first enqueue, so clients that never
    trigger an async top-up (slack 0, chaos runs, ``lease_refresh_async
    =False``) cost nothing.  Every queued flow's single-flight marker
    is already held by the enqueuer; whatever drops out of the queue —
    including at ``close()`` — must release it."""

    def __init__(self, client: "ShardedTokenClient"):
        # weakref: the refresher thread must not pin a dropped client
        # (close() also stops it explicitly, but tests that leak
        # clients still shouldn't leak fleets through the daemon)
        self._client = weakref.ref(client)
        self._cv = threading.Condition()
        self._q: List[Tuple[_ShardState, int]] = []
        self._busy = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def enqueue(self, st: _ShardState, flow_id: int) -> None:
        with self._cv:
            if not self._closed:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="sentinel-lease-refresh", daemon=True
                    )
                    self._thread.start()
                self._q.append((st, flow_id))
                self._cv.notify()
                return
        with st.lock:
            st.lease_inflight.discard(flow_id)

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait until the queue is empty AND no drain is in progress."""
        deadline = mono_s() + timeout_s
        with self._cv:
            while self._q or self._busy:
                left = deadline - mono_s()
                if left <= 0:
                    return False
                self._cv.wait(timeout=left)
        return True

    def close(self) -> None:
        with self._cv:
            self._closed = True
            pending, self._q = self._q, []
            self._cv.notify_all()
        for st, fid in pending:
            with st.lock:
                st.lease_inflight.discard(fid)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    # bounded: the predicate loop makes the timeout free
                    # (spurious wakeups just re-check), and a notify lost
                    # to a future refactor degrades to a 1 s idle poll
                    # instead of wedging this thread and close() forever
                    self._cv.wait(timeout=1.0)
                if self._closed:
                    return
                batch, self._q = self._q, []
                self._busy = True
            try:
                per: Dict[str, List[int]] = {}
                states: Dict[str, _ShardState] = {}
                for st, fid in batch:
                    states[st.name] = st
                    per.setdefault(st.name, []).append(fid)
                client = self._client()
                if client is None:
                    for st, fid in batch:
                        with st.lock:
                            st.lease_inflight.discard(fid)
                elif len(per) == 1:
                    ((name, fids),) = per.items()
                    client._refresh_leases_batch(states[name], fids)
                else:
                    # one blocking exchange PER OWNING SHARD — issued
                    # concurrently, not in a serial loop: each shard's
                    # connection is independently multiplexed, and a
                    # serial sweep would charge one drain cycle the SUM
                    # of every shard's round-trip (the fleet's lease
                    # capacity would then shrink as shards are added)
                    hops = [
                        threading.Thread(
                            target=client._refresh_leases_batch,
                            args=(states[name], fids),
                            daemon=True,
                        )
                        for name, fids in per.items()
                    ]
                    for h in hops:
                        h.start()
                    for h in hops:
                        h.join()
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()


class _ClientFlowRules:
    """Threshold-learning ``ClusterFlowRuleManager`` facade for a
    hand-built ``ShardedTokenClient`` (no fleet): ``load`` teaches the
    client each flow's count so lease sizing works and the RLS rule
    manager can project onto it without crashing.  It does NOT push the
    rules to the shard servers — whoever operates them must load the
    same rules there, or decisions return NO_RULE (and fallback fails
    closed).  ``ShardFleet`` replaces this with ``_FleetFlowRules``,
    which does both."""

    def __init__(self, client: "ShardedTokenClient"):
        self._client = client
        self._by_ns: Dict[str, list] = {}

    def load(self, namespace: str, rules: list) -> None:
        old_fids = {r.cluster_flow_id for r in self._by_ns.get(namespace, [])}
        self._by_ns[namespace] = list(rules)
        for r in rules:
            self._client.register_flow_rule(r.cluster_flow_id, r.count)
        for fid in old_fids - {r.cluster_flow_id for r in rules}:
            self._client.register_flow_rule(fid, 0)

    def get(self, namespace: str) -> list:
        return list(self._by_ns.get(namespace, []))


class _FleetFlowRules:
    """``ClusterFlowRuleManager``-shaped facade over a fleet: ``load``
    partitions a namespace's rules onto their ring owners (every shard
    sees a load, so rules leaving a shard are cleared there) and teaches
    the sharded client the thresholds for lease sizing."""

    def __init__(self, fleet: "ShardFleet"):
        self._fleet = fleet
        # the learn/forget-thresholds half is exactly the bare-client
        # facade's job — delegate, don't duplicate
        self._learn = _ClientFlowRules(fleet.client)

    def load(self, namespace: str, rules: list) -> None:
        fleet = self._fleet
        self._learn.load(namespace, rules)
        parts: Dict[str, list] = {name: [] for name in fleet.names}
        for r in rules:
            parts[fleet.client.ring.owner_of_flow(r.cluster_flow_id)].append(r)
        for name in fleet.names:
            fleet.services[name].flow_rules.load(namespace, parts[name])

    def get(self, namespace: str) -> list:
        return self._learn.get(namespace)


class ShardFleet:
    """In-process N-shard token fleet (tests / chaos / bench / demos).

    Each shard is a full ``DefaultTokenService`` on its own decision
    engine client behind its own TCP ``ClusterTokenServer``;
    ``client_factory`` builds the decision engines (tests pass their
    fixture factory; each returns a STARTED client).  ``kill``/``rejoin`` stop and restart a
    shard's server on its original port, the fleet-level fault the chaos
    ``shard_failover`` scenario and the bench failover-blip measurement
    drive."""

    def __init__(
        self,
        client_factory: Callable[[], object],
        n_shards: int = 2,
        names: Optional[Sequence[str]] = None,
        host: str = "127.0.0.1",
        lease_ttl_ms: int = C.DEFAULT_LEASE_TTL_MS,
        warm: bool = True,
        **sharded_kw,
    ):
        from sentinel_tpu_torch.cluster.server import ClusterTokenServer
        from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

        self.names: List[str] = list(names or (f"shard-{i}" for i in range(n_shards)))
        self.services: Dict[str, DefaultTokenService] = {}
        self.servers: Dict[str, Optional[ClusterTokenServer]] = {}
        members: Dict[str, Tuple[str, int]] = {}
        try:
            for name in self.names:
                decision = client_factory()
                if warm:
                    # pay the decision engine's first tick NOW, on a
                    # throwaway resource — otherwise the fleet's first token
                    # request times out against a shard still making its
                    # first tick (on the card: loading the built kernels,
                    # building the tick's plans) and flips it straight into
                    # failover
                    decision.registry.resource_id(f"shard/warm/{name}")
                    f = decision.submit_acquire(f"shard/warm/{name}")
                    if f is not None:
                        f.result(timeout=120.0)
                svc = DefaultTokenService(decision, lease_ttl_ms=lease_ttl_ms)
                server = ClusterTokenServer(svc, host=host, port=0)
                server.start()
                self.services[name] = svc
                self.servers[name] = server
                members[name] = (host, server.port)
            self._host = host
            self._ports = {name: members[name][1] for name in self.names}
            self.client = ShardedTokenClient(members, **sharded_kw)
            self.client.flow_rules = _FleetFlowRules(self)
            self.client.start()
        except BaseException:
            # a failed 3rd-of-4 shard must not strand the first two's
            # live TCP servers with no fleet object to stop() (decision
            # engines stay caller-owned — client_factory's maker stops
            # them, exactly as fleet.stop() leaves them running too)
            client = getattr(self, "client", None)
            if client is not None:
                client.close()
            for server in self.servers.values():
                if server is not None:
                    server.stop()
            raise

    # -- rules ---------------------------------------------------------------

    def load_flow_rules(self, namespace: str, rules: list) -> None:
        self.client.flow_rules.load(namespace, rules)

    # -- fleet-level faults --------------------------------------------------

    def kill(self, name: str) -> None:
        """Stop one shard's server (its decision engine stays up, so
        ``rejoin`` restores service without a new first tick)."""
        server = self.servers[name]
        if server is not None:
            server.stop()
            self.servers[name] = None

    def rejoin(self, name: str) -> None:
        """Restart a killed shard on its ORIGINAL port — ring placement
        keys on the shard NAME, so no flows move."""
        from sentinel_tpu_torch.cluster.server import ClusterTokenServer

        if self.servers[name] is not None:
            return
        server = ClusterTokenServer(
            self.services[name], host=self._host, port=self._ports[name]
        )
        server.start()
        self.servers[name] = server

    def stop(self) -> None:
        self.client.close()
        for name, server in self.servers.items():
            if server is not None:
                server.stop()
                self.servers[name] = None

    def describe(self) -> dict:
        return self.client.describe()
