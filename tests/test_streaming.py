"""Streaming encoder: identical output to the one-shot encoder + resume."""
import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

from icspcodec.codec import encode
from icspcodec.config import CodecConfig
from icspcodec.io import load_yuv420
from icspcodec.streaming import encode_streaming
from icspcodec.metrics import MetricsLog
from tools.make_content import synth_sequence

W, H = 352, 288


def test_streaming_matches_oneshot(tmp_path):
    nf = 8
    raw = synth_sequence("synthA", nf).tobytes()
    y, cb, cr = load_yuv420(raw, W, H, nf)
    cfg = CodecConfig(qp_dc=16, qp_ac=16, intra_period=4)
    want, _ = encode(y, cb, cr, cfg)

    log = MetricsLog(str(tmp_path / "m.jsonl"))
    got = encode_streaming(y, cb, cr, cfg, str(tmp_path / "wd"), metrics=log)
    assert got == want
    s = log.summary()
    assert s["gops"] == 2 and s["frames"] == nf
    assert s["mean_psnr_y_db"] > 25

    # resume: drop one chunk, re-run — only that GOP re-encodes, output same
    (tmp_path / "wd" / "gop_00001.npz").unlink()
    log2 = MetricsLog()
    got2 = encode_streaming(y, cb, cr, cfg, str(tmp_path / "wd"), metrics=log2)
    assert got2 == want
    assert len(log2.records) == 1  # only the missing GOP was recomputed


def test_streaming_device_entropy_matches_host(tmp_path):
    """The plain streaming path routes through the
    device entropy pack (per-frame packed rows in the chunks, no symbol
    pull).  Bytes must equal the host-entropy stream AND the one-shot
    encoder; resume must splice device-packed chunks with legacy host
    "items" chunks at bit granularity."""
    nf = 8
    raw = synth_sequence("synthC", nf).tobytes()
    y, cb, cr = load_yuv420(raw, W, H, nf)
    base = dict(qp_dc=16, qp_ac=16, intra_period=4)
    want, _ = encode(y, cb, cr, CodecConfig(**base))

    got = encode_streaming(y, cb, cr, CodecConfig(**base), str(tmp_path / "wd"))
    assert got == want
    d = np.load(tmp_path / "wd" / "gop_00000.npz")
    assert "packed" in d and "nbits" in d  # device chunk format

    goth = encode_streaming(
        y, cb, cr, CodecConfig(**base, entropy="host"), str(tmp_path / "wh")
    )
    assert goth == want
    d = np.load(tmp_path / "wh" / "gop_00000.npz")
    assert "codes" in d  # host chunks keep the items format

    # mixed resume: one host items chunk + one device-packed chunk
    import shutil
    (tmp_path / "wm").mkdir()
    shutil.copy(tmp_path / "wh" / "gop_00000.npz", tmp_path / "wm" / "gop_00000.npz")
    shutil.copy(tmp_path / "wd" / "gop_00001.npz", tmp_path / "wm" / "gop_00001.npz")
    log = MetricsLog()
    gotm = encode_streaming(y, cb, cr, CodecConfig(**base), str(tmp_path / "wm"), metrics=log)
    assert gotm == want
    assert len(log.records) == 0  # nothing re-encoded


def test_streaming_rejects_stale_chunks(tmp_path):
    """Resume with mismatched config or content must raise, never splice
    stale GOP chunks into the bitstream."""
    import pytest

    nf = 8
    raw = synth_sequence("synthA", nf).tobytes()
    y, cb, cr = load_yuv420(raw, W, H, nf)
    cfg = CodecConfig(qp_dc=16, qp_ac=16, intra_period=4)
    encode_streaming(y, cb, cr, cfg, str(tmp_path / "wd"))

    # different QP, same workdir -> stale chunks must be rejected
    cfg2 = CodecConfig(qp_dc=8, qp_ac=8, intra_period=4)
    with pytest.raises(ValueError, match="fingerprint"):
        encode_streaming(y, cb, cr, cfg2, str(tmp_path / "wd"))

    # different content, same config -> rejected too
    y2 = y.copy()
    y2[0, 0, 0] ^= 255
    with pytest.raises(ValueError, match="fingerprint"):
        encode_streaming(y2, cb, cr, cfg, str(tmp_path / "wd"))

    # pre-fingerprint chunks (no field at all) are also stale
    import numpy as _np
    old = dict(_np.load(tmp_path / "wd" / "gop_00000.npz"))
    old.pop("fingerprint")
    _np.savez_compressed(tmp_path / "wd" / "gop_00000.npz", **old)
    with pytest.raises(ValueError, match="fingerprint"):
        encode_streaming(y, cb, cr, cfg, str(tmp_path / "wd"))


def test_streaming_sharded_matches_oneshot(tmp_path):
    """Streaming with gop_shards>1: GOP rounds run
    SPMD over the gop mesh, chunks stay per-GOP, and the bitstream is
    byte-identical to the unsharded one-shot encode — including a
    non-dividing GOP count and a short tail GOP."""
    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs 4 devices")
    nf = 22  # 5 GOPs of 4 + tail of 2 -> two full rounds + tail round
    raw = synth_sequence("synthB", nf).tobytes()
    y, cb, cr = load_yuv420(raw, W, H, nf)
    base = dict(qp_dc=16, qp_ac=16, intra_period=4)
    want, _ = encode(y, cb, cr, CodecConfig(**base))

    cfg = CodecConfig(**base, gop_shards=4)
    log = MetricsLog()
    got = encode_streaming(y, cb, cr, cfg, str(tmp_path / "wd"), metrics=log)
    assert got == want
    assert len(log.records) == 6  # one durable chunk per GOP

    # resume still works at single-GOP granularity
    (tmp_path / "wd" / "gop_00003.npz").unlink()
    log2 = MetricsLog()
    got2 = encode_streaming(y, cb, cr, cfg, str(tmp_path / "wd"), metrics=log2)
    assert got2 == want
    assert len(log2.records) == 1

    # tile_shards is explicitly unsupported in streaming
    import pytest
    with pytest.raises(ValueError, match="tile_shards"):
        encode_streaming(
            y, cb, cr, CodecConfig(**base, tile_shards=2), str(tmp_path / "wd2")
        )
