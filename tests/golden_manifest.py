"""The C++ reference's golden hashes (golden/MANIFEST.sha256) and the
exact-mode encodes that are held to them.

The manifest pins the reference encoder's bitstreams and reconstructions
and the reference decoder's output for 32-frame CIF content from
tools/make_content.py, so the codec is checked against it without the
reference binaries or the artifacts themselves.
"""
import functools
import hashlib
import pathlib

import numpy as np

NF, W, H = 32, 352, 288
_MANIFEST = pathlib.Path(__file__).resolve().parent / "golden" / "MANIFEST.sha256"


@functools.lru_cache(maxsize=None)
def manifest() -> dict:
    """artifact name -> sha256 hex digest."""
    out = {}
    for line in _MANIFEST.read_text().splitlines():
        digest, name = line.split()
        out[name] = digest
    return out


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def yuv_sha256(planes: dict) -> str:
    """Hash of (F, ...) y/cb/cr planes laid out as a planar YUV420 file."""
    h = hashlib.sha256()
    for n in range(planes["y"].shape[0]):
        for k in ("y", "cb", "cr"):
            h.update(np.ascontiguousarray(planes[k][n]).tobytes())
    return h.hexdigest()


def bin_name(seq, qdc, qac, period) -> str:
    return f"{seq}_compCIF_{qdc}_{qac}_{period}.bin"


def recon_name(seq, qdc, qac, period, side: str) -> str:
    """side: "enc" (encoder reconstruction) or "dec" (decoder output)."""
    return f"{seq}_{qdc}_{qac}_{period}.{side}recon.yuv"


@functools.lru_cache(maxsize=None)
def content(seq: str):
    from icspcodec.io import load_yuv420
    from tools.make_content import synth_sequence

    return load_yuv420(synth_sequence(seq, NF).tobytes(), W, H, NF)


@functools.lru_cache(maxsize=None)
def exact_encode(seq: str, qdc: int, qac: int, period: int):
    """(bits, recon) of the exact-mode encode on the default device."""
    from icspcodec.codec import encode
    from icspcodec.config import CodecConfig

    y, cb, cr = content(seq)
    return encode(y, cb, cr, CodecConfig(qp_dc=qdc, qp_ac=qac, intra_period=period))


def golden_bits(seq: str, qdc: int, qac: int, period: int) -> bytes:
    """The reference's bitstream: the exact encode once its hash has
    matched the manifest."""
    bits, _ = exact_encode(seq, qdc, qac, period)
    assert sha256(bits) == manifest()[bin_name(seq, qdc, qac, period)]
    return bits
