"""Multi-host orchestration scaffolding.

The reference is single-process (pthreads + shared memory); this
framework's multi-host story is: `jax.distributed` + a global `gop` mesh
(closed GOPs need no cross-host traffic), with per-host I/O feeding each
process's addressable shard.  The same jit runs SPMD on every host; the
network between hosts only moves raw frames in and encoded bits out.

tests/test_multihost.py exercises this path with two processes on
virtual CPU devices.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """Bring up the jax.distributed runtime (no-op if single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_gop_mesh() -> Mesh:
    """Mesh over every device of every host, axis 'gop'."""
    return Mesh(np.asarray(jax.devices()), axis_names=("gop",))


def host_local_gop_batch(y, cb, cr, mesh: Mesh):
    """Build a globally-sharded GOP batch from per-host local data.

    Each process passes its local (G_local, P, H, W) arrays; the result is
    a global array of shape (G_local * nprocesses, P, H, W) sharded over
    the 'gop' axis, assembled without cross-host transfers
    (make_array_from_process_local_data).
    """
    sharding = NamedSharding(mesh, P("gop"))
    out = []
    for arr in (y, cb, cr):
        global_shape = (arr.shape[0] * jax.process_count(),) + arr.shape[1:]
        out.append(
            jax.make_array_from_process_local_data(sharding, np.asarray(arr), global_shape)
        )
    return tuple(out)
