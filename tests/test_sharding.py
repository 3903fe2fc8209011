"""Sharded-vs-single-device equality on the virtual 8-device CPU mesh.

The sharded encoder must produce byte-identical symbols/recon to the
single-device path (SURVEY.md section 4, distributed test tier).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from icspcodec.engine.inter import encode_gop
from icspcodec.constants import COS_ENC
from icspcodec.io import load_yuv420
from icspcodec.parallel import encode_gops_sharded, gop_mesh
from tools.make_content import synth_sequence

W, H = 352, 288


@pytest.fixture(scope="module")
def gops():
    nf = 16  # 8 GOPs x 2 frames
    raw = synth_sequence("synthA", nf).tobytes()
    y, cb, cr = load_yuv420(raw, W, H, nf)
    g, p = 8, 2
    return (
        y.reshape(g, p, H, W),
        cb.reshape(g, p, H // 2, W // 2),
        cr.reshape(g, p, H // 2, W // 2),
    )


def test_gop_sharded_equals_single(gops):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    y, cb, cr = gops
    mesh = gop_mesh(jax.devices()[:8])
    intra_s, inter_s = encode_gops_sharded(y, cb, cr, 16, 16, mesh, dtype=jnp.float32)
    intra_1, inter_1 = jax.jit(
        lambda a, b, c: encode_gop(a, b, c, 16, 16, table=COS_ENC, dtype=jnp.float32)
    )(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
    for k in intra_1:
        assert np.array_equal(np.asarray(intra_s[k]), np.asarray(intra_1[k])), k
    for k in inter_1:
        assert np.array_equal(np.asarray(inter_s[k]), np.asarray(inter_1[k])), k


def _seq(nf):
    raw = synth_sequence("synthA", nf).tobytes()
    return load_yuv420(raw, W, H, nf)


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("period,precision", [(10, "fast"), (10, "exact"), (0, "fast")])
def test_encode_production_sharded_bitstream(shards, period, precision):
    """codec.encode() with gop_shards>1 (the production path) emits a
    byte-identical bitstream and recon to the single-device encode —
    including a non-dividing GOP count (padding path) and both precisions."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from icspcodec.codec import encode
    from icspcodec.config import CodecConfig

    nf = 25 if period else 7  # 2 full GOPs + a 5-frame tail / 7 intra frames
    y, cb, cr = _seq(nf)
    base = dict(width=W, height=H, qp_dc=16, qp_ac=16,
                intra_period=period, precision=precision)
    bits1, rec1 = encode(y, cb, cr, CodecConfig(**base))
    bitsN, recN = encode(y, cb, cr, CodecConfig(**base, gop_shards=shards))
    assert bitsN == bits1
    for k in rec1:
        assert np.array_equal(recN[k], rec1[k]), k


@pytest.mark.parametrize("period", [10, 0])
def test_decode_production_sharded(period):
    """decode() with gop_shards>1 reproduces the single-device planes."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from icspcodec.codec import decode, encode
    from icspcodec.config import CodecConfig

    nf = 25 if period else 7
    y, cb, cr = _seq(nf)
    cfg = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16,
                      intra_period=period, precision="fast")
    bits, _ = encode(y, cb, cr, cfg)
    out1 = decode(bits, nf, precision="fast")
    outN = decode(bits, nf, precision="fast", gop_shards=8)
    for k in out1:
        assert np.array_equal(outN[k], out1[k]), k


def test_gop_sharding_is_spmd(gops):
    """The sharded computation must not introduce cross-GOP collectives:
    compiling for the mesh should keep the per-device shard shape G/8."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    y, cb, cr = gops
    mesh = gop_mesh(jax.devices()[:8])
    intra_s, _ = encode_gops_sharded(y, cb, cr, 16, 16, mesh, dtype=jnp.float32)
    shard_shapes = {
        s.data.shape for s in intra_s["recon_y"].addressable_shards
    }
    assert shard_shapes == {(1, H, W)}
