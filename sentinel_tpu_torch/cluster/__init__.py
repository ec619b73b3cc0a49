"""Cluster flow control: the distributed token backend.

The port of ``sentinel_tpu/cluster/``: the token *decisions* run on a
dedicated decision client's device — the batched token column
(ops/token_col.py) or the client's engine — while the host provides the
wire protocol, connection bookkeeping, namespace guard, and
concurrent-token TTL cache.

Modules:
  constants      — wire message types / status codes (ClusterConstants.java)
  protocol       — length-prefixed binary frame codec (v1, v2 BATCH, v3
                   deny provenance, trace tails)
  rules          — ClusterFlowRuleManager / ClusterParamFlowRuleManager /
                   server+client config managers
  token_service  — TokenService interface + DefaultTokenService
  server         — asyncio TCP token server + ConnectionManager
  client         — ClusterTokenClient (xid-correlated, auto-reconnect)
  state          — ClusterStateManager (NOT_STARTED / CLIENT / SERVER flips)
  front_door     — NativeFrontDoor: the C epoll token front door whose
                   ring a SentinelClient drains into its engine batches
                   (imported from its module, as in the reference)

Not ported yet (ROADMAP.md item A7b): the consistent-hash ring and the
N-shard fleet with bounded-slack leases.  The Envoy RLS front door is
``sentinel_tpu_torch.rls``.
"""

from sentinel_tpu_torch.cluster.constants import (  # noqa: F401
    MSG_TYPE_PING,
    MSG_TYPE_FLOW,
    MSG_TYPE_PARAM_FLOW,
    MSG_TYPE_CONCURRENT_ACQUIRE,
    MSG_TYPE_CONCURRENT_RELEASE,
    STATUS_OK,
    STATUS_BLOCKED,
    STATUS_SHOULD_WAIT,
    STATUS_FAIL,
    STATUS_NO_RULE,
    STATUS_TOO_MANY_REQUEST,
    STATUS_BAD_REQUEST,
    STATUS_RELEASE_OK,
    STATUS_ALREADY_RELEASE,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: F401
    TokenResult,
    TokenService,
    DefaultTokenService,
)
from sentinel_tpu_torch.cluster.state import ClusterStateManager  # noqa: F401
