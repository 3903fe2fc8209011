"""Beyond-the-reference capabilities: arbitrary resolutions (multiples of
16) and fast-mode self-consistency.  The C++ reference hardcodes CIF;
these paths have no golden, so the contract is self-roundtrip: our
decoder must reproduce our encoder's reconstruction exactly in exact
mode (same float regime on both sides would differ only on P-frames via
the table regimes — so we check intra exactly and inter within the known
+-1 LSB envelope, mirroring the reference's own behavior)."""
import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

from icspcodec.codec import decode, encode
from icspcodec.config import CodecConfig


def _synth(nf, h, w, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w)).astype(np.uint8)
    y = np.stack([np.roll(base, 2 * i, axis=1) for i in range(nf)])
    cb = np.full((nf, h // 2, w // 2), 100, np.uint8)
    cr = rng.integers(0, 256, (nf, h // 2, w // 2)).astype(np.uint8)
    return y, cb, cr


def test_non_cif_resolution_roundtrip():
    for (h, w) in ((64, 96), (144, 176)):
        y, cb, cr = _synth(6, h, w)
        cfg = CodecConfig(width=w, height=h, qp_dc=16, qp_ac=16, intra_period=3)
        bits, rec = encode(y, cb, cr, cfg)
        out = decode(bits, 6)
        # intra frames decode byte-identically in the double-table regime
        # only when the encoder regime matches; P-frames may drift +-1 LSB
        # (the reference's own float-vs-double behavior, SURVEY.md sec. 4)
        for n in (0, 3):
            assert np.array_equal(out["y"][n], rec["y"][n]), (h, w, n)
        diff = np.abs(out["y"].astype(int) - rec["y"].astype(int))
        assert diff.max() <= 1
        assert np.abs(out["cb"].astype(int) - rec["cb"].astype(int)).max() <= 1
        mse = ((out["y"].astype(float) - y) ** 2).mean()
        psnr = 20 * np.log10(255.0 / np.sqrt(max(mse, 1e-9)))
        assert psnr > 28, psnr


def test_qp_generality():
    """QPs beyond the reference's {16,8,1} work end-to-end."""
    y, cb, cr = _synth(4, 64, 96)
    for qdc, qac in ((4, 32), (2, 2)):
        cfg = CodecConfig(width=96, height=64, qp_dc=qdc, qp_ac=qac, intra_period=2)
        bits, rec = encode(y, cb, cr, cfg)
        out = decode(bits, 4)
        assert np.array_equal(out["y"][0], rec["y"][0])
