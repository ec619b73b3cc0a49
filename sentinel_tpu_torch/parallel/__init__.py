"""Scale-out of the engine: the host-layer resource router, the remote
host shard it fans out to, and the row-sharded engine on a device mesh.

The port of ``sentinel_tpu/parallel/``:

* ``router.py`` (``ShardRouter``, ``shard_of``) and ``remote_shard.py``
  (``RemoteShard``, over the cluster protocol's RES_CHECK extension) — the
  network half;
* ``meshspec.py`` — the one mesh description (axis ``'res'``, 8 ranks)
  and the recipe of an n-rank gloo group on the CPU;
* ``spmd.py`` — the declared shardings (``PartitionSpec`` pytrees),
  ``make_mesh`` over the default process group and ``make_sharded_tick``,
  the engine tick on the rank's shard of the state;
* ``collectives.py`` — every collective the sharded path sends, the shard
  context the ops layer reads, and the ledger the tier-4 analyzer
  (``analysis/spmd``) reads;
* ``launch.py`` — starting n ranks with a deadline (tests, the analyzer's
  runner, ``chip_smoke.py``).
"""
