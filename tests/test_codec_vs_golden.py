"""End-to-end: the JAX codec vs the C++ reference's golden hashes.

Byte-exact bitstreams, encoder reconstructions, and decoder outputs in
`exact` precision (float64), compared by sha256 with
tests/golden/MANIFEST.sha256.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

from icspcodec.codec import decode, encode  # noqa: E402
from icspcodec.config import CodecConfig  # noqa: E402
from golden_manifest import (  # noqa: E402
    NF,
    bin_name,
    content,
    exact_encode,
    golden_bits,
    manifest,
    recon_name,
    sha256,
    yuv_sha256,
)

CONFIGS = [
    ("synthA", 16, 16, 1),
    ("synthA", 16, 16, 10),
    ("synthA", 8, 8, 10),
    ("synthA", 1, 1, 1),
    ("synthA", 16, 8, 1),
    ("synthA", 16, 16, 0),
    ("synthB", 16, 16, 10),
    ("synthB", 1, 1, 10),
    # akiyo-class static content: zero-SAD MBs fire the spiral-ME early
    # break every P-frame -> pins the stateful flag-mirroring semantics
    # against the compiled C++ binary
    ("synthStatic", 16, 16, 10),
    ("synthStatic", 8, 8, 10),
    ("synthStatic", 1, 1, 10),
    ("synthStatic", 16, 16, 1),
]


@pytest.mark.parametrize("seq,qdc,qac,period", CONFIGS)
def test_encode_bitexact(seq, qdc, qac, period):
    bits, rec = exact_encode(seq, qdc, qac, period)
    assert sha256(bits) == manifest()[bin_name(seq, qdc, qac, period)]
    assert yuv_sha256(rec) == manifest()[recon_name(seq, qdc, qac, period, "enc")]


@pytest.mark.parametrize("seq,qdc,qac,period", [c for c in CONFIGS if c[3] != 0])
def test_decode_bitexact(seq, qdc, qac, period):
    dec = decode(golden_bits(seq, qdc, qac, period), NF)
    assert yuv_sha256(dec) == manifest()[recon_name(seq, qdc, qac, period, "dec")]


def test_fast_mode_roundtrip():
    """fast (float32) precision: not bit-pinned to the C++ reference, but
    must self-roundtrip (our decoder reproduces our encoder's recon on
    I-frames) and stay PSNR-equivalent."""
    y, cb, cr = content("synthA")
    y, cb, cr = y[:8], cb[:8], cr[:8]
    cfg = CodecConfig(qp_dc=16, qp_ac=16, intra_period=1, precision="fast")
    bits, rec = encode(y, cb, cr, cfg)
    dec = decode(bits, 8, precision="fast")
    # intra frames: decoder (double table) vs encoder recon (float table)
    # may differ by +-1 LSB occasionally in fast mode; require near-equality
    diff = np.abs(dec["y"].astype(int) - rec["y"].astype(int))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3
    mse = np.mean((dec["y"].astype(float) - y.astype(float)) ** 2)
    psnr = 20 * np.log10(255.0 / np.sqrt(mse))
    assert psnr > 30
