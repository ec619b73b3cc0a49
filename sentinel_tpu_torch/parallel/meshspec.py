"""The ONE mesh description every sharded consumer of the port shares.

The port's copy of ``sentinel_tpu/parallel/meshspec.py``.  Three things
need the same answer to "what mesh do we shard over, and how do we start
a copy of it on the CPU?":

* ``parallel/spmd.py``      — builds the mesh over the default process
  group and binds the declared shardings to the rank's rows;
* ``analysis/spmd/``        — the tier-4 analyzer runs the sharded entry
  points on ``mesh_spec().n_devices`` ranks (runner.py) and reads the
  collectives they send;
* the tests and ``chip_smoke.py`` — they start their ranks from the same
  recipe.

The reference forces a virtual n-device CPU platform on XLA.  PyTorch has
no such thing: the port's mesh is n ranks of ``torch.distributed``, and on
the CPU they are ``gloo`` processes.  ``force_cpu_mesh_env`` writes that
recipe (backend, world size, rendezvous address) into an environment
mapping; each rank then adds its own ``RANK``.

IMPORT CONSTRAINT: stdlib only, as the reference's is.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import MutableMapping, Optional

#: the resource/node-row mesh axis every sharded tensor splits on
MESH_AXIS = "res"

#: blessed mesh width: the tier-4 analyzer and the multi-rank tests start
#: this many ranks (a v5e-8 tray's shape in the reference)
MESH_DEVICES = 8

#: the environment variables of the recipe: torch.distributed's own
#: rendezvous names (``env://``) plus the backend the ranks must use
#: (``spmd.make_mesh`` reads it; unset, it picks by device and world size)
BACKEND_ENV = "SENTINEL_MESH_BACKEND"
WORLD_ENV = "WORLD_SIZE"
ADDR_ENV = "MASTER_ADDR"
PORT_ENV = "MASTER_PORT"


@dataclass(frozen=True)
class MeshSpec:
    """Shape of the blessed device mesh (1-D over the resource axis)."""

    n_devices: int = MESH_DEVICES
    axis: str = MESH_AXIS


def mesh_spec() -> MeshSpec:
    """The single source of truth consumed by runtime and analyzer."""
    return MeshSpec()


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port on ``host`` that no one listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def force_cpu_mesh_env(
    environ: MutableMapping[str, str],
    n_devices: Optional[int] = None,
    keep_existing_count: bool = False,
) -> int:
    """Write into ``environ`` the recipe of an n-rank ``gloo`` group on the
    CPU: the backend, the world size, and a rendezvous address on this
    host (a free port).

    With ``keep_existing_count`` a world size already set in ``environ``
    wins (a caller who chose a topology gets to keep it); otherwise it is
    replaced.  Returns the world size in effect."""
    n = n_devices if n_devices is not None else mesh_spec().n_devices
    environ[BACKEND_ENV] = "gloo"
    environ.setdefault(ADDR_ENV, "127.0.0.1")
    environ.setdefault(PORT_ENV, str(free_port(environ[ADDR_ENV])))
    if keep_existing_count:
        try:
            return int(environ[WORLD_ENV])
        except (KeyError, ValueError):
            pass  # unset or malformed: fall through and set it
    environ[WORLD_ENV] = str(n)
    return n
