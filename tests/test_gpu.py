"""Checks that only the card can run (marked `gpu`; they skip elsewhere).

`python chip_smoke.py` runs them on the GPU in its own process:
device-entropy bytes equal host-entropy bytes, the fast-mode bounds of
decode() against the encoder's recon, and exact mode against the C++
reference's manifest hashes.
"""
import jax
import numpy as np
import pytest

from chip_smoke import check_fast_decode
from icspcodec.codec import decode, encode
from icspcodec.config import CodecConfig
from golden_manifest import (
    NF,
    bin_name,
    content,
    exact_encode,
    manifest,
    recon_name,
    sha256,
    yuv_sha256,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def x64():
    """float64 on for exact mode, restored afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize("period", [0, 10])
def test_device_entropy_matches_host(gpu, period):
    y, cb, cr = content("synthStatic")
    cfg = CodecConfig(qp_dc=16, qp_ac=16, intra_period=period, precision="fast")
    bd, rd = encode(y, cb, cr, cfg)
    bh, rh = encode(y, cb, cr, CodecConfig(qp_dc=16, qp_ac=16, intra_period=period,
                                           precision="fast", entropy="host"))
    assert bd == bh
    for k in rd:
        assert np.array_equal(rd[k], rh[k]), k


@pytest.mark.parametrize("period", [0, 10])
def test_fast_decode_within_bounds(gpu, period):
    y, cb, cr = content("synthA")
    bits, rec = encode(y, cb, cr, CodecConfig(qp_dc=16, qp_ac=16, intra_period=period,
                                              precision="fast"))
    check_fast_decode(decode(bits, NF, precision="fast"), rec, y, period)


@pytest.mark.parametrize("seq,qdc,qac,period", [
    ("synthA", 16, 16, 1),
    ("synthA", 16, 16, 10),
    ("synthA", 8, 8, 10),
    ("synthA", 1, 1, 1),
    ("synthStatic", 16, 16, 10),   # the stateful-ME branch
    ("synthStatic", 1, 1, 10),
])
def test_exact_mode_matches_reference_hashes(gpu, x64, seq, qdc, qac, period):
    assert jax.devices()[0].platform == "gpu"
    bits, rec = exact_encode(seq, qdc, qac, period)
    where = f"first differing recon frame: {_first_diff_vs_cpu(seq, qdc, qac, period, rec)}"
    assert sha256(bits) == manifest()[bin_name(seq, qdc, qac, period)], where
    assert yuv_sha256(rec) == manifest()[recon_name(seq, qdc, qac, period, "enc")], where
    dec = decode(bits, NF)
    assert yuv_sha256(dec) == manifest()[recon_name(seq, qdc, qac, period, "dec")]


def _first_diff_vs_cpu(seq, qdc, qac, period, rec):
    """Index of the first frame whose GPU recon differs from the CPU's
    (the CPU backend matches the reference), or None."""
    if yuv_sha256(rec) == manifest()[recon_name(seq, qdc, qac, period, "enc")]:
        return None
    y, cb, cr = content(seq)
    with jax.default_device(jax.devices("cpu")[0]):
        _, want = encode(y, cb, cr, CodecConfig(qp_dc=qdc, qp_ac=qac, intra_period=period))
    for n in range(NF):
        if any(not np.array_equal(rec[k][n], want[k][n]) for k in ("y", "cb", "cr")):
            return n
    return None
