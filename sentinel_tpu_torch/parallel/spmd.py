"""Multi-rank SPMD: shard the resource/node axis of one engine over a mesh.

The port of ``sentinel_tpu/parallel/spmd.py``.  The reference scales
horizontally by adding JVMs behind a token server (sentinel-cluster,
SURVEY.md §2.5); intra-process it scales by striped LongAdders.  The
accelerator-native scale-out axis is the *resource cardinality*: all
window/stat tensors are sharded on their node-row dimension across a
mesh with the axis ``'res'``, batches stay replicated, and the reads and
writes of the row tables turn into shard-local work plus collectives.

Why this layout: per-tick the engine reads O(B·K) scattered rows and
writes O(B) rows of a [node_rows, ...] table.  Sharding rows means each
rank owns 1/n of the table (device memory scales with the mesh), while the
replicated [B]-sized batch and verdict tensors travel once per tick.

Controller/rule-slot state (per-rule tensors) is replicated: it is small
(O(rules)) and every rank derives identical updates from the replicated
batch, so no communication is needed for it.

The layout is declared twice over, as in the reference: MESH-FREE
``PartitionSpec`` pytrees (``state_partition_specs`` and friends — what
the tier-4 analyzer reads, no devices needed) and their bindings to a
live mesh (``state_shardings``).  ``PartitionSpec`` here is the port's
own marker, not ``torch.distributed.tensor``'s ``Shard`` / ``Replicate``:
a tuple with one mesh-axis name (or None) per dimension, so a spec reads
exactly as the reference's.  The mesh shape comes from
``meshspec.mesh_spec()``.

Where the reference differs by design: XLA's partitioner places every
collective of ``jax.jit(tick, in_shardings=..., out_shardings=...)``.
The port runs eagerly and has no partitioner, so the ops layer does it by
hand, and only while a shard context is set (``collectives.scope``, which
``make_sharded_tick`` enters): every read of a row-sharded table is a
shard-local read followed by an all-reduce over the mesh's group, and
every write lands only the rank's own rows (the scatter kernel's jobs are
rebased to the shard and drop the other ranks' ids by their contract).
With no shard context the single-device path runs as before.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import NamedTuple, Optional

import torch

from sentinel_tpu_torch.core.config import EngineConfig
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import gsketch as GS
from sentinel_tpu_torch.ops import rtq as RQ
from sentinel_tpu_torch.ops import token_col as TC
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.parallel import collectives as CL
from sentinel_tpu_torch.parallel import meshspec as MS

#: how long a rank waits in a collective or at the rendezvous before its
#: group raises (a rank that died leaves its peers blocked otherwise)
GROUP_TIMEOUT_S = 120.0


class PartitionSpec(tuple):
    """The port's sharding marker: one mesh-axis name (or None) per leading
    dimension; dimensions past its length are replicated.  ``PartitionSpec()``
    is a replicated leaf."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"

    def sharded_dim(self) -> Optional[int]:
        for i, a in enumerate(self):
            if a is not None:
                return i
        return None


PS = PartitionSpec


# -- the mesh -----------------------------------------------------------------


class Mesh(NamedTuple):
    """A 1-D mesh over the default process group."""

    axis: str
    world: int
    rank: int
    device: torch.device
    backend: str
    group: object = None

    def shard_ctx(self) -> CL.ShardCtx:
        return CL.ShardCtx(self.rank, self.world, self.group)


def _backend_for(device: torch.device, world: int) -> str:
    """nccl for one rank a card; gloo on the CPU, and for more ranks than
    the machine has cards (NCCL refuses two ranks on one device)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def _recipe_backend(device: torch.device, world: int) -> str:
    """The backend of the mesh recipe (``meshspec.BACKEND_ENV``) where it
    names one, else ``_backend_for``'s; a recipe that asks for nccl where
    nccl cannot run (the CPU, more ranks than cards) raises."""
    backend = os.environ.get(MS.BACKEND_ENV) or _backend_for(device, world)
    if backend == "nccl" and _backend_for(device, world) != "nccl":
        raise ValueError(f"make_mesh: the mesh recipe asks for nccl, which {world} ranks on {device} cannot use")
    return backend


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the default process group, its axis named by
    ``meshspec``.

    ``device``: ``cuda`` unless the caller asks for the CPU (it raises
    where there is no card).  An uninitialized default group is started
    from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``meshspec.force_cpu_mesh_env`` writes them; a
    single rank when none is set) with the backend the device and the
    world size call for (or the one the recipe names:
    ``meshspec.BACKEND_ENV``), and a timeout; the choice is printed.
    ``n_devices``, when given, must be the world size."""
    import torch.distributed as dist

    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' to run on the CPU)")
    if not dist.is_initialized():
        world = int(os.environ.get(MS.WORLD_ENV, "1"))
        rank = int(os.environ.get("RANK", "0"))
        backend = _recipe_backend(device, world)
        if device.type == "cuda" and backend == "nccl":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        os.environ.setdefault(MS.ADDR_ENV, "127.0.0.1")
        os.environ.setdefault(MS.PORT_ENV, str(MS.free_port()))
        print(
            f"spmd.make_mesh: rank {rank} of {world} on {device} over {backend}",
            file=sys.stderr,
            flush=True,
        )
        dist.init_process_group(
            backend, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group has {world} ranks")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(MS.mesh_spec().axis, world, rank, device, dist.get_backend())


# -- mesh-free PartitionSpec pytrees ----------------------------------------
#
# These are the BLESSED shardings: pure data, no device touched.  The
# tier-4 analyzer (analysis/spmd) folds them with the leaf shapes of a
# state built on the meta device to project per-shard bytes and check axis
# divisibility without a mesh; state_shardings() below binds the same
# specs to a live mesh, so runtime and analyzer cannot drift.


def window_partition_specs(rows_sharded: bool = True) -> W.WindowState:
    """PartitionSpec pytree for one WindowState: bucket/running tensors
    split on their row axis, epoch/rotation scalars replicated."""
    axis = MS.mesh_spec().axis
    r = PS(axis) if rows_sharded else PS()
    rep = PS()
    # the O(1) running sums are row-indexed like the bucket tensors,
    # so they shard on the same axis; epoch/rotation scalars replicate
    return W.WindowState(
        counts=r, rt_sum=r, rt_min=r, epochs=rep,
        run=r, run_rt=r, run_rt_min=r, rot_wid=rep,
    )


def token_col_partition_specs() -> TC.TokenColState:
    """PartitionSpec pytree for the cluster token-column ledger: flow
    slots are the scale-out axis (one row per flow), limits ride along."""
    axis = MS.mesh_spec().axis
    return TC.TokenColState(
        win=window_partition_specs(rows_sharded=True),
        limits=PS(axis),
    )


def _sketch_partition_specs(cfg: EngineConfig):
    """PartitionSpec pytree for EngineState.gs, per the live sketch impl."""
    axis = MS.mesh_spec().axis
    rep = PS()
    if not cfg.sketch_stats:
        return GS.SketchState(counts=rep, epochs=rep)
    if cfg.sketch_salsa:
        from sentinel_tpu_torch.sketch import salsa as SA

        return SA.SalsaState(
            words=PS(None, None, None, axis),
            lvlmap=PS(None, None, None, axis),
            run=PS(None, None, axis),
            epochs=rep,
            rot_wid=rep,
            # the unpacked current bucket shards on width like run
            cur=PS(None, None, axis),
            cur_wid=rep,
        )
    return GS.SketchState(counts=PS(None, None, axis, None), epochs=rep)


def state_partition_specs(cfg: EngineConfig) -> E.EngineState:
    """PartitionSpec pytree matching EngineState: node-row tensors split
    on the mesh axis, per-rule tensors replicated."""
    axis = MS.mesh_spec().axis
    row = PS(axis)
    rep = PS()

    return E.EngineState(
        win_sec=window_partition_specs(True),
        win_min=window_partition_specs(cfg.enable_minute_window),
        concurrency=row,
        latest_passed_ms=rep,
        warmup_tokens=rep,
        warmup_last_s=rep,
        warm_acc=rep,
        occ_tokens=row,  # node-keyed borrow pools shard with their rows
        occ_epoch=row,
        cb_state=rep,
        cb_retry_ms=rep,
        cb_counts=rep,
        cb_epochs=rep,
        # the hashed param store is REPLICATED, deliberately: the
        # reference's tier-4 SPMD analyzer measured the width-sharded
        # layout paying four partial-result all-reduces per tick
        # (s32[2B] x2 + s32[2B,P] x2 — the param scatter/read computing
        # per-shard partials and reducing them across the mesh; ~5 KiB
        # per tick at CI scale, scaling with batch x depth x planes).
        # The store is small (single-digit MiB even at the 1M-resource
        # config) next to the row tables, so replication costs little
        # device memory and removes those collectives entirely.  Re-shard
        # only together with a shard-local param kernel, and re-pin
        # analysis/spmd/collectives.json when you do.
        pcms=rep,
        pcms_epochs=rep,
        pconc=rep,
        # the global sketch shards on its width axis so tail-resource
        # observability scales with ranks; with the sketch off the state
        # is a unit dummy — replicate it.  The salsa tier shards its packed
        # words/bitmap on the word axis and the running sums on the
        # logical width axis — all width-aligned, so the shards stay
        # co-local with the seed layout's
        gs=_sketch_partition_specs(cfg),
        rtq=RQ.RtqState(counts=rep, epochs=rep),
    )


# -- bindings to a live mesh --------------------------------------------------


class RankSharding(NamedTuple):
    """A PartitionSpec bound to one rank of a live mesh: which slice of a
    leaf the rank holds."""

    spec: PartitionSpec
    rank: int
    world: int

    def span(self, leaf_shape) -> tuple:
        """(dim, lo, hi) of the rank's slice, or (None, 0, 0) when the leaf
        is replicated.  An indivisible dimension raises."""
        d = self.spec.sharded_dim()
        if d is None or d >= len(leaf_shape):
            return None, 0, 0
        n = int(leaf_shape[d])
        if n % self.world:
            raise ValueError(
                f"a sharded dimension of {n} ({self.spec!r} over shape {tuple(leaf_shape)}) "
                f"does not divide over {self.world} ranks"
            )
        lo, hi = CL.ShardCtx(self.rank, self.world).span(n)
        return d, lo, hi

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's slice of the whole leaf ``t`` (a view)."""
        d, lo, hi = self.span(t.shape)
        return t if d is None else t.narrow(d, lo, hi - lo)


def _tree_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over matching NamedTuple trees (specs first)."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *trees)
    return type(trees[0])(*[_tree_map(fn, s, *ls) for s, *ls in zip(specs, *trees)])


def bind_shardings(specs, mesh: Mesh):
    """PartitionSpec pytree -> RankSharding pytree on ``mesh``."""
    if isinstance(specs, PartitionSpec):
        return RankSharding(specs, mesh.rank, mesh.world)
    return type(specs)(*[bind_shardings(s, mesh) for s in specs])


def state_shardings(cfg: EngineConfig, mesh: Mesh) -> E.EngineState:
    """RankSharding pytree matching EngineState (the blessed specs bound
    to a live mesh)."""
    return bind_shardings(state_partition_specs(cfg), mesh)


def shard_tree(tree, specs, mesh: Mesh):
    """The rank's copy of a whole state tree: its slice of every sharded
    leaf and a copy of every replicated one, on the mesh's device."""
    return _tree_map(
        lambda ps, t: RankSharding(ps, mesh.rank, mesh.world).local(t).to(mesh.device).clone(),
        specs, tree,
    )


def shard_state(state: E.EngineState, cfg: EngineConfig, mesh: Mesh) -> E.EngineState:
    return shard_tree(state, state_partition_specs(cfg), mesh)


def gather_tree(tree, specs, mesh: Mesh):
    """The whole tree from every rank's shard (an all-gather of every
    sharded leaf along its sharded dimension; replicated leaves as they
    are) — the counterpart of reading a sharded ``jax.Array`` back."""
    def one(ps, t):
        d = ps.sharded_dim()
        return t if d is None or d >= t.dim() else CL.all_gather(t, dim=d)

    with CL.scope(mesh.shard_ctx()):
        return _tree_map(one, specs, tree)


def gather_state(state: E.EngineState, cfg: EngineConfig, mesh: Mesh) -> E.EngineState:
    return gather_tree(state, state_partition_specs(cfg), mesh)


def check_divisible(cfg: EngineConfig, world: int) -> None:
    """Raise unless every sharded dimension of ``cfg``'s state divides over
    ``world`` ranks (the tick never pads a shard in silence)."""
    shapes = E.init_state(cfg, "meta")
    _tree_map(lambda ps, t: RankSharding(ps, 0, world).span(t.shape), state_partition_specs(cfg), shapes)


def make_sharded_tick(cfg: EngineConfig, mesh: Mesh, features: frozenset = E.ALL_FEATURES):
    """The engine tick on the rank's shard of the state.

    Takes ``make_tick``'s arguments — the state being the rank's shard
    (``shard_state``) — and returns the rank's new shard and a TickOutput
    that every rank holds whole (the outputs are replicated: every rank
    sees every verdict).  Batches and rule tensors are replicated.  A row
    count the world size does not divide raises here."""
    E.check_supported(cfg, features)
    check_divisible(cfg, mesh.world)
    ctx = mesh.shard_ctx()

    def fn(state, rules, acq, comp, now_ms, sys_load, sys_cpu, seg_fits=None):
        with CL.scope(ctx):
            return E.tick(state, rules, acq, comp, now_ms, sys_load, sys_cpu, cfg, features, seg_fits)

    return fn
