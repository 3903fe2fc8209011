"""Production tile_shards path: codec.encode()/decode() byte-identical to
the single-device path across shard counts, periods and precisions.

(Kept apart from test_tiles.py so that the two slowest test files run on
different workers.)
"""
import numpy as np
import pytest

import jax

from icspcodec.io import load_yuv420
from tools.make_content import synth_sequence

W, H = 352, 288


@pytest.mark.parametrize("shards,period,precision", [
    # full matrix at 2 shards; the max split (11) covers both periods in
    # fast precision (the f64 CPU-mesh cases are covered at 2 shards —
    # the seam machinery is shard-count-invariant, runtime is not)
    (2, 10, "fast"), (2, 10, "exact"), (2, 0, "fast"), (2, 0, "exact"),
    (11, 10, "fast"), (11, 0, "fast"),
])
def test_tile_shards_production_encode_decode(shards, period, precision):
    """Full production matrix: encode bitstream + recon and decode planes
    at tile_shards ∈ {2, 11} == single-device, periods {0, 10}, both
    precisions (reference semantics: allintraPrediction enc src:446-555,
    decoder src:2083-2272)."""
    if len(jax.devices()) < shards:
        pytest.skip("not enough devices")
    from icspcodec.codec import decode, encode
    from icspcodec.config import CodecConfig

    nf = 12 if period else 3  # one full GOP + 2-frame tail / 3 intra frames
    raw = synth_sequence("synthB", nf).tobytes()
    y, cb, cr = load_yuv420(raw, W, H, nf)
    base = dict(width=W, height=H, qp_dc=16, qp_ac=16,
                intra_period=period, precision=precision)
    bits1, rec1 = encode(y, cb, cr, CodecConfig(**base))
    bitsN, recN = encode(y, cb, cr, CodecConfig(**base, tile_shards=shards))
    assert bitsN == bits1, "tiled bitstream differs"
    for k in rec1:
        assert np.array_equal(recN[k], rec1[k]), f"tiled recon {k}"

    out1 = decode(bits1, nf, precision=precision)
    outN = decode(bits1, nf, precision=precision, tile_shards=shards)
    for k in out1:
        assert np.array_equal(outN[k], out1[k]), f"tiled decode {k}"
