"""Host-layer sharding: the resource router (``router.ShardRouter``,
``router.shard_of``) and the remote host shard it fans out to over the
cluster protocol's RES_CHECK extension (``remote_shard.RemoteShard``).

The port of ``sentinel_tpu/parallel/``'s network half.  Not ported yet
(ROADMAP.md Queue A item A9): ``meshspec.py`` and ``spmd.py``, which shard
one engine's state over a device mesh.
"""
