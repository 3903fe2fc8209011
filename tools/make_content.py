#!/usr/bin/env python3
"""Deterministic synthetic YUV420 test content (CIF unless asked otherwise).

The reference codec's data/ sequences (akiyo, foreman, ...) are not shipped
(/root/reference/.MISSING_LARGE_BLOBS), so tests and goldens use synthetic
sequences generated here.  Content is seeded and reproducible so tests can
regenerate it on the fly instead of committing multi-MB YUVs.

Each sequence mixes smooth gradients, moving rectangles/discs (exercises
motion search), texture (exercises AC energy / entropy coder), and noise.
"""
import zlib

import numpy as np

W, H = 352, 288
CW, CH = W // 2, H // 2


def synth_sequence(name: str, nframes: int, width: int = W, height: int = H) -> np.ndarray:
    """Return packed planar YUV420 bytes for `nframes` frames, CIF unless
    `width`/`height` say otherwise (multiples of 16, at least CIF).

    Output shape: (nframes * (W*H + 2*CW*CH),) uint8, frame-interleaved
    Y,Cb,Cr exactly as the reference's YCbCrLoad expects
    (encoder/ICSP_Codec_Encoder_source.cpp:247-283).

    Names beginning with "synthStatic" produce the akiyo-class trigger
    content for the spiral-ME state machine: large saturated static
    regions (black reconstructs to exactly 0, white to exactly 255, at
    any QP) plus a small moving object — P-frames then hit zero-SAD MBs,
    firing the reference's early break (enc src:2136-2141) and mirroring
    the walk state for the rest of each frame.
    """
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("synthStatic"):
        return _static_sequence(rng, nframes, width, height)
    W, H = width, height
    CW, CH = W // 2, H // 2
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cyy, cxx = np.mgrid[0:CH, 0:CW].astype(np.float32)

    # static base: gradient + sinusoidal texture
    phase = rng.uniform(0, 6.28, size=4)
    base = (
        96
        + 48 * np.sin(xx / 37.0 + phase[0])
        + 32 * np.sin(yy / 23.0 + phase[1])
        + 16 * np.sin((xx + yy) / 11.0 + phase[2])
    )
    noise = rng.normal(0, 3.0, size=(H, W)).astype(np.float32)

    # moving objects: (x0, y0, w, h, vx, vy, level)
    objs = []
    for _ in range(5):
        objs.append(
            (
                rng.integers(0, W - 64),
                rng.integers(0, H - 64),
                int(rng.integers(24, 80)),
                int(rng.integers(24, 80)),
                float(rng.integers(-6, 7)),
                float(rng.integers(-6, 7)),
                float(rng.integers(30, 226)),
            )
        )

    out = []
    for t in range(nframes):
        y = base + noise
        # global pan, wraps around
        shift = int(t * 1.0) % W
        y = np.roll(y, shift, axis=1)
        for (x0, y0, w, h, vx, vy, lvl) in objs:
            px = int(x0 + vx * t) % W
            py = int(y0 + vy * t) % H
            x1, y1 = min(px + w, W), min(py + h, H)
            y[py:y1, px:x1] = 0.7 * y[py:y1, px:x1] + 0.3 * lvl
        yq = np.clip(y, 0, 255).astype(np.uint8)

        cb = np.clip(
            128 + 40 * np.sin(cxx / 29.0 + phase[3] + 0.05 * t), 0, 255
        ).astype(np.uint8)
        cr = np.clip(
            128 + 40 * np.cos(cyy / 31.0 + phase[0] - 0.03 * t), 0, 255
        ).astype(np.uint8)
        out += [yq.tobytes(), cb.tobytes(), cr.tobytes()]
    return np.frombuffer(b"".join(out), dtype=np.uint8)


def _static_sequence(rng, nframes: int, W: int, H: int) -> np.ndarray:
    """Static textured background + saturated black/white rectangles + one
    small moving disc.  No pan, no per-frame noise: everything except the
    disc is identical across frames, so once the saturated regions
    reconstruct exactly, every later P-frame sees dozens of zero-SAD MBs."""
    CW, CH = W // 2, H // 2
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cyy, cxx = np.mgrid[0:CH, 0:CW].astype(np.float32)
    base = (
        96
        + 48 * np.sin(xx / 37.0)
        + 32 * np.sin(yy / 23.0)
        + rng.normal(0, 3.0, size=(H, W)).astype(np.float32)
    )
    base[64:160, 48:176] = 0      # saturated black rectangle
    base[176:256, 208:320] = 255  # saturated white rectangle
    cb0 = np.clip(128 + 40 * np.sin(cxx / 29.0), 0, 255).astype(np.uint8)
    cr0 = np.clip(128 + 40 * np.cos(cyy / 31.0), 0, 255).astype(np.uint8)
    out = []
    for t in range(nframes):
        y = base.copy()
        px, py = (40 + 5 * t) % (W - 24), (30 + 3 * t) % (H - 24)
        y[py:py + 24, px:px + 24] = 200.0
        out += [
            np.clip(y, 0, 255).astype(np.uint8).tobytes(),
            cb0.tobytes(),
            cr0.tobytes(),
        ]
    return np.frombuffer(b"".join(out), dtype=np.uint8)


def write_sequence(path: str, name: str, nframes: int) -> None:
    synth_sequence(name, nframes).tofile(path)


if __name__ == "__main__":
    import sys

    name, nframes, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    write_sequence(path, name, nframes)
    print(f"wrote {path}: {nframes} frames of {name}")
