"""GOP/data parallelism over a device mesh — the production encode path.

The reference's entire parallelism story is a pthread pool over closed
GOPs (ICSP_thread.cpp:39-77, reachable from the CLI flag --EnMultiThread,
enc src:150-157): GOPs never reference each other, so they are
embarrassingly parallel.  Here they map to a mesh axis `gop`: the
(G, P, H, W) GOP batch is sharded on G and the whole encode_gop program
becomes SPMD with zero collectives — the direct analog of the reference's
job queue, but compiled.  codec.encode() routes every GOP batch through
this module (CodecConfig.gop_shards picks the mesh size; 1 = the same
program on a trivial mesh), pads the GOP axis up to a mesh multiple, and
drops the padding on the host — so a sharded encode emits a bitstream
byte-identical to the single-device one.

Multi-host: the same jit works under jax.distributed with a global mesh;
per-host I/O feeds the local shard (closed GOPs need no halo) — see
parallel/distributed.py and tools/multihost_worker.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import COS_DEC, COS_ENC
from ..engine.inter import decode_gop, encode_gop
from ..engine.intra import DEC_I_KEYS, decode_intra_frames, encode_intra_frames


def gop_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("gop",))


def mesh_for(shards: int, devices=None) -> Mesh:
    """Build the `gop` mesh for a production encode/decode over the
    first `shards` devices of the default backend.  The devices are a
    flat list: the GOP program runs with zero collectives, so their
    interconnect does not matter."""
    devices = jax.devices() if devices is None else devices
    if len(devices) < shards:
        raise ValueError(
            f"gop_shards={shards} but only {len(devices)} devices are available"
        )
    return gop_mesh(devices[:shards])


@functools.lru_cache(maxsize=None)
def _sharded_gop_fn(mesh: Mesh, qdc: int, qac: int, dtype):
    shard = NamedSharding(mesh, P("gop"))

    def run(y, cb, cr):
        return encode_gop(y, cb, cr, qdc, qac, table=COS_ENC, dtype=dtype)

    return jax.jit(run, in_shardings=(shard, shard, shard)), shard


@functools.lru_cache(maxsize=None)
def _sharded_intra_fn(mesh: Mesh, qdc: int, qac: int, dtype):
    shard = NamedSharding(mesh, P("gop"))

    def run(y, cb, cr):
        return encode_intra_frames(y, cb, cr, qdc, qac, table=COS_ENC, dtype=dtype)

    return jax.jit(run, in_shardings=(shard, shard, shard)), shard


def _pad_to(n: int, mult: int) -> int:
    return (-n) % mult


def encode_gops_sharded(y, cb, cr, qdc: int, qac: int, mesh: Mesh, dtype=jnp.float32):
    """Encode (G, P, H, W) GOPs with G sharded across the mesh.

    G must be divisible by the mesh size (use encode_gops_padded for
    arbitrary G).  Returns the same (intra, inter) pytrees as
    engine.inter.encode_gop, sharded on their leading G axis.
    """
    fn, shard = _sharded_gop_fn(mesh, qdc, qac, dtype)
    return fn(
        jax.device_put(jnp.asarray(y), shard),
        jax.device_put(jnp.asarray(cb), shard),
        jax.device_put(jnp.asarray(cr), shard),
    )


def encode_gops_padded(y, cb, cr, qdc: int, qac: int, mesh: Mesh, dtype=jnp.float32):
    """encode_gops_sharded for arbitrary G: pads the GOP axis with zero
    GOPs up to a mesh multiple (closed GOPs are independent, so padding
    changes nothing), runs SPMD, and drops the padded outputs.

    Returns (intra, inter) as host numpy trees with leading axis G.
    """
    g = y.shape[0]
    n = mesh.shape["gop"]
    padg = _pad_to(g, n)
    if padg:
        padder = lambda a: np.concatenate(
            [a, np.zeros((padg,) + a.shape[1:], a.dtype)]
        )
        y, cb, cr = padder(np.asarray(y)), padder(np.asarray(cb)), padder(np.asarray(cr))
    intra, inter = encode_gops_sharded(y, cb, cr, qdc, qac, mesh, dtype=dtype)
    trim = lambda t: jax.tree.map(lambda a: np.asarray(a)[:g], t)
    return trim(intra), (None if inter is None else trim(inter))


def encode_intra_padded(y, cb, cr, qdc: int, qac: int, mesh: Mesh, dtype=jnp.float32):
    """Sharded all-intra encode of (F, H, W) frames: the frame axis is the
    data-parallel axis (every intra frame is independent).  Pads F up to a
    mesh multiple with zero frames and drops them after.

    Returns the encode_intra_frames dict as host numpy arrays.
    """
    f = y.shape[0]
    n = mesh.shape["gop"]
    padf = _pad_to(f, n)
    if padf:
        padder = lambda a: np.concatenate(
            [a, np.zeros((padf,) + a.shape[1:], a.dtype)]
        )
        y, cb, cr = padder(np.asarray(y)), padder(np.asarray(cb)), padder(np.asarray(cr))
    fn, shard = _sharded_intra_fn(mesh, qdc, qac, dtype)
    out = fn(
        jax.device_put(jnp.asarray(y), shard),
        jax.device_put(jnp.asarray(cb), shard),
        jax.device_put(jnp.asarray(cr), shard),
    )
    return jax.tree.map(lambda a: np.asarray(a)[:f], out)


# ---------------------------------------------------------------------------
# decode-side sharding.  The reference decoder is strictly serial
# (decoder src:2083-2272 per-frame loop) — no referent — but GOPs are as
# independent on decode as on encode, so the same `gop` mesh axis applies:
# the per-GOP frame scan runs SPMD with the recon carry local to each shard.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sharded_decode_gop_fn(mesh: Mesh, qdc: int, qac: int, dtype):
    shard = NamedSharding(mesh, P("gop"))

    def run(sym_i, sym_p):
        return decode_gop(sym_i, sym_p, qdc, qac, table=COS_DEC, dtype=dtype)

    return jax.jit(run, in_shardings=(shard, shard)), shard


@functools.lru_cache(maxsize=None)
def _sharded_decode_intra_fn(mesh: Mesh, qdc: int, qac: int, dtype):
    shard = NamedSharding(mesh, P("gop"))

    def run(sym):
        return decode_intra_frames(
            *(sym[k] for k in DEC_I_KEYS), qdc, qac, table=COS_DEC, dtype=dtype
        )

    return jax.jit(run, in_shardings=(shard,)), shard


def _pad_tree(tree: dict, pad: int) -> dict:
    return {
        k: np.concatenate([np.asarray(a), np.zeros((pad,) + a.shape[1:], a.dtype)])
        for k, a in tree.items()
    }


def decode_gops_padded(sym_i: dict, sym_p: dict, qdc: int, qac: int, mesh: Mesh,
                       dtype=jnp.float32):
    """Sharded decode of G GOPs: sym_i (G, ...) intra symbols, sym_p
    (G, P-1, ...) inter symbols.  Pads G with zero-symbol GOPs (decoded
    then discarded — shards never interact) up to a mesh multiple.

    Returns (first, rest) plane dicts as host numpy, leading axis G.
    """
    g = sym_i["y_scan"].shape[0]
    padg = _pad_to(g, mesh.shape["gop"])
    if padg:
        sym_i, sym_p = _pad_tree(sym_i, padg), _pad_tree(sym_p, padg)
    fn, shard = _sharded_decode_gop_fn(mesh, qdc, qac, dtype)
    put = lambda t: {k: jax.device_put(jnp.asarray(v), shard) for k, v in t.items()}
    first, rest = fn(put(sym_i), put(sym_p))
    trim = lambda t: jax.tree.map(lambda a: np.asarray(a)[:g], t)
    return trim(first), trim(rest)


def decode_intra_padded(sym: dict, qdc: int, qac: int, mesh: Mesh, dtype=jnp.float32):
    """Sharded decode of F independent intra frames (keys DEC_I_KEYS)."""
    f = sym["y_scan"].shape[0]
    padf = _pad_to(f, mesh.shape["gop"])
    if padf:
        sym = _pad_tree(sym, padf)
    fn, shard = _sharded_decode_intra_fn(mesh, qdc, qac, dtype)
    out = fn({k: jax.device_put(jnp.asarray(v), shard) for k, v in sym.items()})
    return jax.tree.map(lambda a: np.asarray(a)[:f], out)
