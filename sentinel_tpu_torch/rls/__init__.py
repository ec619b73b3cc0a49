"""Envoy Rate Limit Service (RLS) front door.

The port of ``sentinel_tpu/rls``: a wire-compatible reimplementation of
the reference's sentinel-cluster-server-envoy-rls module.  An Envoy proxy
configured with a gRPC rate_limit_service can point at
``SentinelRlsGrpcServer`` (``sentinel_tpu_torch.rls.server``) and get
cluster-wide token decisions from a ``DefaultTokenService`` whose
decisions run on its decision client's device.  Backed by a
``ShardFleet``'s ``ShardedTokenClient`` (``cluster/shard.py``), each
descriptor's flow id routes through the consistent-hash ring to its
owning token-server shard.  ``rls.server`` is imported lazily (it needs
grpcio and protobuf); the rule model here does not need either.
"""

from sentinel_tpu_torch.rls.rules import (  # noqa: F401
    EnvoyRlsRule,
    EnvoyRlsRuleManager,
    RlsKeyValue,
    RlsResourceDescriptor,
)

__all__ = [
    "EnvoyRlsRule",
    "EnvoyRlsRuleManager",
    "RlsKeyValue",
    "RlsResourceDescriptor",
]
