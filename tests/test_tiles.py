"""Tile-sharded intra wavefront == single-device engine, bit for bit.

The halo exchange (reconstructed boundary pixel columns, intra modes and
dequantized DCs flowing rightward; upper-right DCs flowing leftward) must
reproduce the sequential raster semantics exactly at every seam.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from icspcodec.constants import SPIRAL_UNION
from icspcodec.engine.inter import encode_inter_frame, mv_reconstruct_scan
from icspcodec.engine.intra import encode_intra_frames, from_blocks, to_blocks
from icspcodec.engine.wavefront import intra_luma_scan
from icspcodec.io import load_yuv420
from icspcodec.ops.me import N_CANON
from icspcodec.parallel.tiles import encode_inter_frames_tiled, encode_intra_luma_tiled
from tools.make_content import synth_sequence

W, H = 352, 288


@pytest.mark.parametrize("ntiles", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tiled_intra_equals_single(ntiles, dtype):
    if len(jax.devices()) < ntiles:
        pytest.skip("not enough devices")
    dt = jnp.float64 if dtype == "float64" else jnp.float32
    nf = 3
    raw = synth_sequence("synthA", nf).tobytes()
    y, _, _ = load_yuv420(raw, W, H, nf)

    mesh = Mesh(np.asarray(jax.devices()[:ntiles]), axis_names=("tile",))
    tiled = encode_intra_luma_tiled(y, 16, 16, mesh, dtype=dt)

    orig = to_blocks(jnp.asarray(y)).astype(jnp.int32)
    single = jax.jit(
        lambda o: intra_luma_scan(o, 16, 16, dtype=dt)
    )(orig)

    assert np.array_equal(tiled["y_scan"], np.asarray(single["scan"])), "scan"
    assert np.array_equal(tiled["mpm"], np.asarray(single["mpm"])), "mpm"
    assert np.array_equal(tiled["mode_bit"], np.asarray(single["mode_bit"])), "bit"
    rec_single = np.asarray(from_blocks(single["recon"]).astype(jnp.uint8))
    assert np.array_equal(tiled["recon_y"], rec_single), "recon"


# single-device engine steps, jitted once per worker so that the two
# inter tests share their compiles (both encode one CIF P-frame)
_intra_single = jax.jit(
    lambda a, b, c: encode_intra_frames(a, b, c, 16, 16, dtype=jnp.float32))
_inter_single = jax.jit(
    lambda *a: encode_inter_frame(*a, 16, 16, dtype=jnp.float32))


def _inter_tiled_and_single(seq: str, ntiles: int):
    """Frame 1 of `seq` encoded as a P-frame over an `ntiles` tile mesh and
    on one device, both predicting from the single-device intra recon of
    frame 0."""
    if len(jax.devices()) < ntiles:
        pytest.skip("not enough devices")
    nf = 2
    y, cb, cr = load_yuv420(synth_sequence(seq, nf).tobytes(), W, H, nf)
    intra = _intra_single(jnp.asarray(y[:1]), jnp.asarray(cb[:1]), jnp.asarray(cr[:1]))
    prev = {k: np.asarray(intra[f"recon_{k}"]) for k in ("y", "cb", "cr")}
    cur = dict(y=y[1:], cb=cb[1:], cr=cr[1:])

    mesh = Mesh(np.asarray(jax.devices()[:ntiles]), axis_names=("tile",))
    tiled = encode_inter_frames_tiled(cur, prev, 16, 16, mesh)
    single = _inter_single(*(jnp.asarray(d[k]) for d in (cur, prev)
                             for k in ("y", "cb", "cr")))
    return tiled, single


@pytest.mark.parametrize("ntiles", [2, 11])  # must divide the 22 MB columns
def test_tiled_inter_equals_single(ntiles):
    tiled, single = _inter_tiled_and_single("synthB", ntiles)
    for k in single:
        assert np.array_equal(np.asarray(tiled[k]), np.asarray(single[k])), k


@pytest.mark.parametrize("ntiles", [2, 11])
def test_tiled_inter_stateful_me_across_seams(ntiles):
    """Stateful spiral-ME on tiles: the flag/xflag/yflag walk state crosses
    every tile seam 18x per CIF frame (the state carry follows the GLOBAL
    MB raster).  synthStatic's saturated regions fire zero-SAD breaks in
    many MBs, so the all-gathered table composition must reproduce the
    single-device stateful search exactly."""
    tiled, single = _inter_tiled_and_single("synthStatic", ntiles)
    # the static content must actually exercise the break path: some MV
    # must be a non-canonical (mirror-walk) offset
    mv = mv_reconstruct_scan(jnp.asarray(np.asarray(single["mv_diff"]), jnp.int32))
    canon = {tuple(-o) for o in np.asarray(SPIRAL_UNION[:N_CANON])}
    assert any(tuple(m) not in canon for m in np.asarray(mv).reshape(-1, 2)), \
        "trigger content failed to produce a mirror-walk MV"
    for k in single:
        assert np.array_equal(np.asarray(tiled[k]), np.asarray(single[k])), k
