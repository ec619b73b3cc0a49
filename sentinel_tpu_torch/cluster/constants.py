"""Cluster wire constants.

The port's copy of ``sentinel_tpu/cluster/constants.py``: the wire is the
reference's, byte for byte.

Message-type and status values mirror the reference's public wire contract
(`sentinel-core/.../cluster/ClusterConstants.java` and
`TokenResultStatus.java`) so a reference client could in principle talk to
this token server after swapping the transport framing for ours.
"""

# -- message types (ClusterConstants.MSG_TYPE_*) -----------------------------
MSG_TYPE_PING = 0
MSG_TYPE_FLOW = 1
MSG_TYPE_PARAM_FLOW = 2
MSG_TYPE_CONCURRENT_ACQUIRE = 3
MSG_TYPE_CONCURRENT_RELEASE = 4
# extension beyond the reference protocol: partial-grant batch acquire —
# request n units, response carries granted k (0..n) in `remaining`.  The
# server answers it with n unit-acquires in ONE engine tick.
MSG_TYPE_FLOW_BATCH = 10
# extension: host-shard RESOURCE batch check (parallel/remote_shard.py) —
# a mixed batch of 5-tuples (name, count, prioritized, origin, typed-param:
# "i:<n>"/"s:<text>"/"") answered with per-item (verdict, wait_ms); lets a
# ShardRouter treat a remote host as a shard over the same framing/codec
# as token requests
MSG_TYPE_RES_CHECK = 12
# extension: bounded-slack budget LEASE (cluster/shard.py) — request n
# units against a flow's budget; the owning shard grants k (0..n) in
# `remaining` and a validity window in `wait_ms`.  The holder may spend
# the granted units locally while the shard is unreachable (failover
# fallback), so global overshoot is bounded by the outstanding leases —
# the slack-window reconciliation idea (arXiv 1703.01166)
MSG_TYPE_LEASE = 13
# protocol v2 extension: BATCH — one frame carries many flows' token
# requests as fixed-width column entries (see protocol.py "v2 BATCH
# frame layout").  The server coalesces BATCH frames across connections
# into one device decision batch (ops/token_col.py), so the shard
# answers at engine speed instead of socket speed.  Version-negotiated
# via HELLO: a v1 peer never sees a BATCH frame.
MSG_TYPE_BATCH = 14
# protocol v2 extension: HELLO — version negotiation.  A v2 client sends
# HELLO (its version in `count`) after connect; a v2 server answers
# STATUS_OK with its own version in `remaining`.  A v1 server drops the
# unknown frame on the floor, the HELLO times out, and the client keeps
# speaking v1 — legacy frames stay byte-identical either way.
MSG_TYPE_HELLO = 15

# -- token result status (TokenResultStatus.java) ----------------------------
STATUS_BAD_REQUEST = -4
STATUS_TOO_MANY_REQUEST = -2  # namespace guard tripped
STATUS_FAIL = -1  # transport / unexpected failure
STATUS_OK = 0
STATUS_BLOCKED = 2
STATUS_SHOULD_WAIT = 4
STATUS_NO_RULE = 5
STATUS_NO_REF_RULE = 6
STATUS_NOT_AVAILABLE = 7
STATUS_RELEASE_OK = 8
STATUS_ALREADY_RELEASE = 9

# -- defaults (ServerFlowConfig.java:26-40, ClusterConstants) ----------------
DEFAULT_PORT = 18730
DEFAULT_IDLE_SECONDS = 600
DEFAULT_MAX_ALLOWED_QPS = 30_000.0  # per-namespace guard
DEFAULT_EXCEED_COUNT = 1.0
DEFAULT_MAX_OCCUPY_RATIO = 1.0
DEFAULT_SAMPLE_COUNT = 10
DEFAULT_INTERVAL_MS = 1000
DEFAULT_NAMESPACE = "default"
DEFAULT_REQUEST_TIMEOUT_MS = 200
# lease validity window: one flow-rule accounting interval — granted
# units are spendable for at most this long, so a dead shard's budget
# stops leaking exactly one window after its last grant
DEFAULT_LEASE_TTL_MS = 1000
# hard ceiling on units per LEASE grant, enforced on BOTH sides of the
# wire: the server answers a lease with `units` unit-acquires in engine
# micro-batches, so an uncapped request against a huge-threshold rule
# (slack × 1e9) would stall the decision engine for everyone.  Large
# budgets just re-lease more often; slack stays bounded either way.
MAX_LEASE_UNITS = 1024

# cluster threshold types (ClusterRuleConstant)
FLOW_THRESHOLD_AVG_LOCAL = 0
FLOW_THRESHOLD_GLOBAL = 1

# -- protocol v2 (BATCH frames) ----------------------------------------------
# v3 adds deny provenance: a client that sets BATCH_FLAG_EXPLAIN on an
# entry asks the server to append a _T_PROV block to the batch response —
# (kind, rule, observed, limit) for each BLOCKED entry whose cause is
# known — so a remote block explains itself like a local one
# (obs/explain.py).  Negotiated via the same HELLO exchange; a v2 peer
# never sees the flag or the block, and frames without it are
# byte-identical to v2.
PROTOCOL_VERSION = 3
# per-entry kinds inside a BATCH frame (NOT wire message types — the
# frame's type byte is MSG_TYPE_BATCH; these select the per-entry
# decision semantics)
BATCH_KIND_FLOW = 1  # all-or-nothing acquire of `count` units
BATCH_KIND_FLOW_BATCH = 2  # partial-grant acquire (granted k in remaining)
BATCH_KIND_LEASE = 3  # bounded-slack lease top-up (granted k + TTL)
# per-entry flag bits
BATCH_FLAG_PRIORITIZED = 0x01
# v3: request deny provenance for this entry (set only after HELLO
# negotiated version >= 3; a v2 server treats unknown flag bits as
# garbage, so the client gates it on the negotiated version)
BATCH_FLAG_EXPLAIN = 0x02
# hard ceiling on entries per BATCH frame: 14 B/entry keeps the frame
# comfortably under MAX_FRAME (65535) and bounds one coalesced device
# decision batch
MAX_BATCH_ENTRIES = 2048
