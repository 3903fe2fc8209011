#!/usr/bin/env python3
"""Run the codec's main path on the GPU and check what comes out.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the gop/tile mesh paths on four cards

Everything runs in this one process: a second JAX process would not get
the card's memory.  On one card the phases are encode and decode of 300
CIF frames (all-intra and period 10) through encode()/decode(), the
host-entropy path against the device-entropy path, the streaming encoder,
a 1280x720 sequence, the CLI, the compiled GOP step's memory, and the
gpu-marked tests (among them exact mode against the C++ reference's
hashes).  With --four-cards only the mesh paths run, each against the
one-card run of the same content.  A phase raises on a wrong result; the
last line, one JSON object naming the device, is printed only when every
phase passed.  Where JAX finds no GPU the script exits non-zero at once.
"""
import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
CIF = (300, 352, 288)        # frames, width, height: the bench's content size
HD = (30, 1280, 720)         # second size: a larger macroblock grid
QP = 16

# Fast mode, encoder recon against decode() of the same bytes.  Fast mode
# promises the reference's tolerance, not bit equality: the encoder's
# cosine table is float-rounded and the decoder's double (as in the
# reference), and a compiler may order float32 work differently on each
# side, so a rounding tie may differ by one level.  All-intra:
INTRA_MAX_DIFF, INTRA_DIFF_SHARE, MIN_PSNR_DB = 1, 1e-3, 30.0
# Period 10: a P-frame predicts from the previous recon, so a one-level
# difference can carry forward within a GOP (the reference's own encoder
# and decoder differ by +-1 LSB on P-frames).  Bound per GOP, with room
# for one carried level.  Measured on an H100 with the separable float32
# transforms (both tables round to the same float32 values): max|diff| 0
# at CIF300 and 1280x720; a 64x64 matrix-product DCT gave max|diff| 1
# and shares up to 7.0e-5.
GOP_MAX_DIFF, GOP_DIFF_SHARE = 2, 1e-3


def require_gpu(count: int = 1):
    """The first `count` GPU devices; exits non-zero where JAX has fewer."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: JAX found no accelerator: {e}")
    gpus = [d for d in devices if d.platform == "gpu"]
    if len(gpus) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPU device(s); JAX sees "
            f"{[d.platform for d in devices]}"
        )
    return gpus[:count]


def card_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def timed(name: str, fn, runs: int = 2):
    """Run fn `runs` times; prints the first (cold, with compile) and the
    last (warm) wall time.  Returns (last result, warm seconds)."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    warm = f", warm {times[-1]:.3f} s" if runs > 1 else ""
    print(f"phase {name}: cold {times[0]:.3f} s (with compile){warm}", flush=True)
    return out, times[-1]


def content(name: str, frames: int, width: int, height: int):
    from icspcodec.io import load_yuv420
    from tools.make_content import synth_sequence

    raw = synth_sequence(name, frames, width, height).tobytes()
    return load_yuv420(raw, width, height, frames)


def psnr_y(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(20 * np.log10(255.0 / np.sqrt(max(mse, 1e-12))))


def check_fast_decode(dec: dict, rec: dict, src_y, period: int) -> str:
    """decode() planes against the encoder's recon, per GOP, within the
    fast-mode bounds above; and Y-PSNR against the source."""
    nf = src_y.shape[0]
    gop = nf if period == 0 else period
    max_diff, share = (INTRA_MAX_DIFF, INTRA_DIFF_SHARE) if period in (0, 1) else (
        GOP_MAX_DIFF, GOP_DIFF_SHARE)
    worst_d, worst_s = 0, 0.0
    for s in range(0, nf, gop):
        d = [np.abs(dec[k][s:s + gop].astype(np.int32) - rec[k][s:s + gop])
             for k in ("y", "cb", "cr")]
        worst_d = max(worst_d, max(int(x.max()) for x in d))
        worst_s = max(worst_s, sum(int((x != 0).sum()) for x in d) / sum(x.size for x in d))
    psnr = psnr_y(dec["y"], src_y)
    stats = f"max|diff| {worst_d}, differing share {worst_s:.3g}, Y-PSNR {psnr:.2f} dB"
    if worst_d > max_diff or worst_s >= share or psnr <= MIN_PSNR_DB:
        raise AssertionError(
            f"period {period}: decode vs encoder recon out of bounds: {stats} "
            f"(bounds: max|diff| <= {max_diff}, share < {share}, PSNR > {MIN_PSNR_DB})"
        )
    return stats


def assert_planes_equal(a: dict, b: dict, what: str):
    for k in ("y", "cb", "cr"):
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} planes differ")


def one_card(card: str, cif=CIF, hd=HD):
    from icspcodec.cli import main as cli_main
    from icspcodec.codec import _encode_gop_items_jit, decode, encode
    from icspcodec.config import CodecConfig
    from icspcodec.io import load_yuv420, save_yuv420
    from icspcodec.streaming import encode_streaming

    nf, w, h = cif
    y, cb, cr = content("benchA", nf, w, h)
    for period in (0, 10):
        cfg = CodecConfig(width=w, height=h, qp_dc=QP, qp_ac=QP,
                          intra_period=period, precision="fast")
        tag = "allintra" if period == 0 else f"p{period}"
        (bits, rec), t_enc = timed(f"encode_{tag}", lambda: encode(y, cb, cr, cfg))
        print(f"encode {tag} CIF{nf}: {nf / t_enc:.1f} frames/s ({card}), "
              f"{len(bits)} bytes", flush=True)
        (bits_h, rec_h), _ = timed(
            f"encode_{tag}_host_entropy",
            lambda: encode(y, cb, cr, dataclasses.replace(cfg, entropy="host")))
        if bits_h != bits:
            raise AssertionError(f"{tag}: host-entropy bytes differ from device-entropy bytes")
        assert_planes_equal(rec_h, rec, f"{tag} host-entropy recon")
        dec, t_dec = timed(f"decode_{tag}", lambda: decode(bits, nf, precision="fast"))
        print(f"decode {tag} CIF{nf}: {nf / t_dec:.1f} frames/s ({card})", flush=True)
        print(f"decode {tag} vs encoder recon: "
              f"{check_fast_decode(dec, rec, y, period)}", flush=True)

    # bits/cfg/dec now belong to period 10
    with tempfile.TemporaryDirectory() as tmp:
        runs = iter(range(2))
        got, _ = timed("streaming_p10", lambda: encode_streaming(
            y, cb, cr, cfg, os.path.join(tmp, f"run{next(runs)}")))
        if got != bits:
            raise AssertionError("encode_streaming bytes differ from encode() bytes")

        src = os.path.join(tmp, "benchA_cif.yuv")
        out_bin = os.path.join(tmp, "out.bin")
        out_yuv = os.path.join(tmp, "out.yuv")
        save_yuv420(src, y, cb, cr)
        t0 = time.perf_counter()
        cli_main(["encode", "-i", src, "-n", str(nf), "-q", str(QP), "--intraPeriod", "10",
                  "--width", str(w), "--height", str(h), "--precision", "fast",
                  "-o", out_bin])
        cli_main(["decode", "-i", out_bin, "-n", str(nf), "--precision", "fast",
                  "--orig", src, "-o", out_yuv])
        print(f"phase cli: {time.perf_counter() - t0:.3f} s", flush=True)
        if pathlib.Path(out_bin).read_bytes() != bits:
            raise AssertionError("CLI bitstream differs from encode() bytes")
        cy, ccb, ccr = load_yuv420(out_yuv, w, h, nf)
        assert_planes_equal(dict(y=cy, cb=ccb, cr=ccr), dec, "CLI decode")

    g = nf // 10
    step = _encode_gop_items_jit.lower(
        y[:g * 10].reshape(g, 10, h, w), cb[:g * 10].reshape(g, 10, h // 2, w // 2),
        cr[:g * 10].reshape(g, 10, h // 2, w // 2), QP, QP, False,
    ).compile()
    print(f"memory_analysis of the period-10 GOP step ({g} GOPs): "
          f"{step.memory_analysis()}", flush=True)

    nf, w, h = hd
    y, cb, cr = content("benchHD", nf, w, h)
    cfg = CodecConfig(width=w, height=h, qp_dc=QP, qp_ac=QP, intra_period=10,
                      precision="fast")
    (bits, rec), t_enc = timed(f"encode_{w}x{h}_p10", lambda: encode(y, cb, cr, cfg))
    dec, t_dec = timed(f"decode_{w}x{h}_p10", lambda: decode(bits, nf, precision="fast"))
    if dec["y"].shape != (nf, h, w) or dec["cb"].shape != (nf, h // 2, w // 2):
        raise AssertionError(f"{w}x{h}: decoded shapes {dec['y'].shape}, {dec['cb'].shape}")
    print(f"{w}x{h} p10: encode {nf / t_enc:.1f}, decode {nf / t_dec:.1f} frames/s "
          f"({card}); decode vs encoder recon: {check_fast_decode(dec, rec, y, 10)}",
          flush=True)

    import pytest

    os.environ["ICSP_TEST_GPU"] = "1"
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
                      "--durations=0", str(REPO / "tests" / "test_gpu.py")])
    print(f"phase gpu_tests: {time.perf_counter() - t0:.3f} s", flush=True)
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit code {rc})")


def four_cards(devices, card: str, cif=CIF, hd=HD):
    """gop_shards=4 on CIF at period 10 and tile_shards=4 at 1280x720, each
    against the one-card run of the same content in this process."""
    from icspcodec.codec import decode, encode
    from icspcodec.config import CodecConfig

    n = len(devices)
    for (nf, w, h), name, field in ((cif, "benchA", "gop_shards"),
                                    (hd, "benchHD", "tile_shards")):
        y, cb, cr = content(name, nf, w, h)
        cfg = CodecConfig(width=w, height=h, qp_dc=QP, qp_ac=QP, intra_period=10,
                          precision="fast")
        (bits1, rec1), t1 = timed(f"encode_{w}x{h}_p10_1card", lambda: encode(y, cb, cr, cfg))
        cfgn = dataclasses.replace(cfg, **{field: n})
        (bitsn, recn), tn = timed(f"encode_{w}x{h}_p10_{field}{n}",
                                  lambda: encode(y, cb, cr, cfgn))
        if bitsn != bits1:
            raise AssertionError(f"{field}={n}: bitstream differs from the one-card run")
        assert_planes_equal(recn, rec1, f"{field}={n} encoder recon")
        dec1, d1 = timed(f"decode_{w}x{h}_p10_1card",
                         lambda: decode(bits1, nf, precision="fast"))
        decn, dn = timed(f"decode_{w}x{h}_p10_{field}{n}", lambda: decode(
            bits1, nf, precision="fast", **{field: n}))
        assert_planes_equal(decn, dec1, f"{field}={n} decode")
        print(f"{field}={n} {w}x{h} p10: bytes and planes equal the one-card run; "
              f"encode {nf / t1:.1f} -> {nf / tn:.1f}, decode {nf / d1:.1f} -> "
              f"{nf / dn:.1f} frames/s ({card})", flush=True)
    # every card held its share of the work, not only the first
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devices]
    print(f"peak device memory per card: {peaks}", flush=True)
    if min(peaks) <= 0:
        raise AssertionError(f"a card took no part in the sharded runs: {peaks}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the gop/tile mesh paths on four cards")
    args = ap.parse_args(argv)
    devices = require_gpu(4 if args.four_cards else 1)

    import jax
    import jaxlib

    from icspcodec.compile_cache import enable_compile_cache

    print(f"cache: {enable_compile_cache()}", flush=True)
    card = card_info()
    print(card, flush=True)  # name, power limit: one line per card
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, devices {jax.devices()}",
          flush=True)
    first_card = card.splitlines()[0]
    if args.four_cards:
        four_cards(devices, first_card)
    else:
        one_card(first_card)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
