"""Bit-exactness of the NumPy oracle against the compiled C++ reference.

These tests pin the oracle (the specification every JAX engine is tested
against) to the reference binaries' actual outputs: bitstream bytes,
encoder reconstruction, and decoder output.
"""
import numpy as np
import pytest

from icspcodec import oracle
from icspcodec.io import load_yuv420, frames_to_planes
from tools.make_content import synth_sequence

NF = 32
W, H = 352, 288

CONFIGS = [
    ("synthA", 16, 16, 1),
    ("synthA", 16, 16, 10),
    ("synthA", 8, 8, 1),
    ("synthA", 8, 8, 10),
    ("synthA", 1, 1, 1),
    ("synthA", 1, 1, 10),
    ("synthA", 16, 8, 1),
    ("synthA", 8, 16, 10),
    ("synthB", 16, 16, 1),
    ("synthB", 16, 16, 10),
    # static saturated regions: every P-frame fires the spiral-ME zero-SAD
    # break -> pins the stateful state machine against the C++ binary
    ("synthStatic", 16, 16, 10),
    ("synthStatic", 1, 1, 10),
]


def _frames(seq):
    raw = synth_sequence(seq, NF).tobytes()
    return frames_to_planes(*load_yuv420(raw, W, H, NF))


@pytest.mark.parametrize("seq,qdc,qac,period", CONFIGS)
def test_oracle_encode_bitexact(golden_dir, seq, qdc, qac, period):
    frames = _frames(seq)
    bitstream, recons = oracle.encode(frames, qdc, qac, period)

    golden_bin = (golden_dir / f"{seq}_compCIF_{qdc}_{qac}_{period}.bin").read_bytes()
    assert len(bitstream) == len(golden_bin), (
        f"bitstream length {len(bitstream)} != golden {len(golden_bin)}"
    )
    diff = np.flatnonzero(
        np.frombuffer(bitstream, np.uint8) != np.frombuffer(golden_bin, np.uint8)
    )
    assert diff.size == 0, f"first byte mismatch at offset {diff[:5]}"

    golden_rec = (golden_dir / f"{seq}_{qdc}_{qac}_{period}.encrecon.yuv").read_bytes()
    gy, gcb, gcr = load_yuv420(golden_rec, W, H, NF)
    for n, r in enumerate(recons):
        assert np.array_equal(r.y, gy[n]), f"frame {n} Y recon mismatch"
        assert np.array_equal(r.cb, gcb[n]), f"frame {n} Cb recon mismatch"
        assert np.array_equal(r.cr, gcr[n]), f"frame {n} Cr recon mismatch"


@pytest.mark.parametrize("seq,qdc,qac,period", CONFIGS)
def test_oracle_decode_bitexact(golden_dir, seq, qdc, qac, period):
    golden_bin = (golden_dir / f"{seq}_compCIF_{qdc}_{qac}_{period}.bin").read_bytes()
    recons = oracle.decode(golden_bin, NF)
    golden_dec = (golden_dir / f"{seq}_{qdc}_{qac}_{period}.decrecon.yuv").read_bytes()
    gy, gcb, gcr = load_yuv420(golden_dec, W, H, NF)
    for n, r in enumerate(recons):
        assert np.array_equal(r.y, gy[n]), f"frame {n} Y decode mismatch"
        assert np.array_equal(r.cb, gcb[n]), f"frame {n} Cb decode mismatch"
        assert np.array_equal(r.cr, gcr[n]), f"frame {n} Cr decode mismatch"


def test_period0_equals_period1_body(golden_dir):
    """ALL_INTRA (period 0) bitstreams differ from period-1 only in the
    header's period bits."""
    b0 = (golden_dir / "synthA_compCIF_16_16_0.bin").read_bytes()
    b1 = (golden_dir / "synthA_compCIF_16_16_1.bin").read_bytes()
    assert b0[14:] == b1[14:]
    frames = _frames("synthA")
    ours, _ = oracle.encode(frames, 16, 16, 0)
    assert ours == b0
