"""Worker for the 2-process multi-host simulation test.

Usage: python tools/multihost_worker.py <process_id> <num_processes> <port> <outdir>

Each process owns 2 virtual CPU devices; together they form a global
4-device 'gop' mesh.  Every process feeds only its host-local GOPs
(host_local_gop_batch), runs the same sharded encode SPMD, and writes a
checksum of the global result; the test compares the checksums against a
single-process encode of the same data.
"""
import os
import pathlib
import sys

pid, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
).strip()

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from icspcodec.parallel.distributed import (
    global_gop_mesh,
    host_local_gop_batch,
    initialize,
)
from icspcodec.parallel.gop import encode_gops_sharded

initialize(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc
assert jax.device_count() == 2 * nproc

mesh = global_gop_mesh()

g, p, h, w = 2 * nproc, 2, 64, 64
rng = np.random.default_rng(0)
y = rng.integers(0, 256, (g, p, h, w), dtype=np.uint8)
cb = rng.integers(0, 256, (g, p, h // 2, w // 2), dtype=np.uint8)
cr = rng.integers(0, 256, (g, p, h // 2, w // 2), dtype=np.uint8)

lo, hi = pid * 2, (pid + 1) * 2  # this host's GOPs
yg, cbg, crg = host_local_gop_batch(y[lo:hi], cb[lo:hi], cr[lo:hi], mesh)

intra, inter = encode_gops_sharded(yg, cbg, crg, 16, 16, mesh, dtype=jnp.float32)

# materialize the FULL global result on every process (the outputs are
# G-sharded jax.Arrays; all-gather via replication so each process can dump
# the complete symbol arrays for byte-comparison against the single-process
# reference — a checksum could hide compensating errors)
from jax.sharding import NamedSharding, PartitionSpec as P

rep = NamedSharding(mesh, P())
gather = jax.jit(lambda x: x, out_shardings=rep)
full = {
    f"{tag}_{k}": np.asarray(gather(v))
    for tag, tree in (("intra", intra), ("inter", inter))
    for k, v in tree.items()
}
out = pathlib.Path(outdir) / f"proc{pid}.npz"
np.savez(out, **full)
print(f"proc {pid}: wrote {len(full)} arrays")
