"""Unit tests: JAX ops vs the NumPy oracle (which is pinned to the C++)."""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from icspcodec import oracle  # noqa: E402
from icspcodec.constants import COS_DEC, COS_ENC, SPIRAL  # noqa: E402
from icspcodec.ops import (  # noqa: E402
    dequant_block,
    fdct,
    idct,
    izigzag,
    median3,
    median3_mv_y,
    mv_diff_field,
    pad_image,
    spiral_search,
    zigzag,
)
from icspcodec.ops.quant import quant_block  # noqa: E402
from icspcodec import bitstream as bs  # noqa: E402

rng = np.random.default_rng(42)


def test_fdct_idct_bitexact_both_tables():
    err = rng.integers(-255, 256, size=(500, 8, 8)).astype(np.int64)
    for table in (COS_ENC, COS_DEC):
        want = oracle.fdct(err, table)
        got = np.asarray(jax.jit(lambda e: fdct(e, table=table))(err))
        assert np.array_equal(got, want)
    iq = rng.integers(-2048, 2048, size=(500, 8, 8)).astype(np.int64)
    for table in (COS_ENC, COS_DEC):
        want = oracle.idct(iq, table)
        got = np.asarray(jax.jit(lambda q: idct(q, table=table))(iq))
        assert np.array_equal(got, want)


def test_quant_rules_negatives():
    # values straddling the truncation-vs-floor difference
    d = rng.uniform(-600, 600, size=(1000, 8, 8))
    d[0, 0, 0] = -32.5  # exact tie
    d[0, 0, 1] = -0.5
    d[0, 1, 0] = 0.5
    for qdc, qac in ((16, 16), (8, 16), (1, 1)):
        want_l = oracle.quant_luma(d.copy(), qdc, qac)
        got_l = np.asarray(quant_block(jnp.asarray(d), qdc, qac, chroma=False))
        assert np.array_equal(got_l, want_l)
        want_c = oracle.quant_chroma(d.copy(), qdc, qac)
        got_c = np.asarray(quant_block(jnp.asarray(d), qdc, qac, chroma=True))
        assert np.array_equal(got_c, want_c)
        q = rng.integers(-100, 100, size=(50, 8, 8))
        assert np.array_equal(
            np.asarray(dequant_block(jnp.asarray(q), qdc, qac)),
            oracle.dequant(q, qdc, qac),
        )


def test_zigzag_roundtrip():
    q = rng.integers(-100, 100, size=(30, 8, 8))
    sc = np.asarray(zigzag(jnp.asarray(q)))
    assert np.array_equal(sc, oracle.zigzag(q))
    assert np.array_equal(np.asarray(izigzag(jnp.asarray(sc))), q)


def test_pad_quirk():
    img = rng.integers(0, 256, size=(288, 352)).astype(np.uint8)
    for p in (16, 8):
        want = oracle.pad_image(img, p)
        got = np.asarray(pad_image(jnp.asarray(img), p))
        assert np.array_equal(got, want)
        # the quirk: last row/col zero, second-to-last replicated
        assert got[-1].sum() == 0 and got[:, -1].sum() == 0
        assert (got[-2, p:-p] == img[-1]).all()


def test_medians_incl_typo():
    a, b, c = (rng.integers(-20, 20, size=1000) for _ in range(3))
    x3 = rng.integers(-20, 20, size=1000)
    assert np.array_equal(
        np.asarray(median3(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))),
        oracle.c_median3(a, b, c),
    )
    assert np.array_equal(
        np.asarray(
            median3_mv_y(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(x3))
        ),
        oracle.c_median3_mv_y(a, b, c, x3),
    )


def test_spiral_search_vs_oracle():
    prev = rng.integers(0, 256, size=(288, 352)).astype(np.uint8)
    # build a current frame by shifting so real motion exists
    cur = np.roll(np.roll(prev, 3, axis=0), -5, axis=1)
    want = oracle.motion_estimation(cur, prev)
    pad = pad_image(jnp.asarray(prev), 16)
    got = np.asarray(spiral_search(jnp.asarray(cur), pad))
    assert np.array_equal(got, want)


def test_spiral_second_zero_rule():
    # constant frame: every SAD == 0 -> the second spiral candidate (also
    # offset (0,0)) wins; mv must be (0, 0)
    prev = np.full((288, 352), 77, np.uint8)
    got = np.asarray(spiral_search(jnp.asarray(prev), pad_image(jnp.asarray(prev), 16)))
    # interior MBs see all-zero SADs; candidate 2 is offset (0,0)
    assert (got[1:-1, 1:-1] == 0).all()


def test_mv_diff_field_vs_oracle():
    mv = rng.integers(-16, 17, size=(18, 22, 2)).astype(np.int64)
    want = oracle.mv_predict_parallel(mv)
    got = np.asarray(mv_diff_field(jnp.asarray(mv)))
    assert np.array_equal(got, want)


def test_vlc_encode_vs_oracle():
    vals = np.concatenate(
        [np.arange(-4100, 4100), rng.integers(-2048, 2048, size=1000)]
    )
    codes, lengths = bs.vlc_encode(vals)
    for i in rng.choice(vals.size, 300, replace=False):
        want = oracle.vlc_bits(int(vals[i]))
        assert lengths[i] == len(want), vals[i]
        got = [(int(codes[i]) >> (lengths[i] - 1 - j)) & 1 for j in range(lengths[i])]
        assert got == want, vals[i]


def test_pack_items_tail_convention():
    for nbits in (0, 1, 7, 8, 9, 16, 23):
        bits = rng.integers(0, 2, size=nbits)
        w = oracle.BitWriter()
        w.extend(bits.tolist())
        want = w.tobytes()
        got = bs.pack_items(bits.astype(np.uint64), np.ones(nbits, np.int64))
        assert got == want, nbits


def _ref_me_with_state(cur: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """Behavioral spec of the reference's motionEstimation state machine
    INCLUDING the SAD==0 early break and the cross-MB flag/xflag/yflag
    carry-over (enc src:2073-2155) — the one behavior the fixed SPIRAL
    table cannot model (constants.spiral_offsets docstring)."""
    h, w = cur.shape
    mbh, mbw = h // 16, w // 16
    pad = oracle.pad_image(prev, 16).astype(np.int64)
    cur = cur.astype(np.int64)
    flag, xflag, yflag = 0, 1, -1
    mv = np.zeros((mbh, mbw, 2), np.int64)
    for n in range(mbh * mbw):
        by, bx = (n // mbw) * 16, (n % mbw) * 16
        x0 = y0 = 0
        xcnt = ycnt = 0
        mn, temp, cnt = None, (0, 0), 0
        while cnt < 64:
            if not flag:
                x0 += xcnt if xflag <= 0 else -xcnt
                flag, xcnt, xflag = 1, xcnt + 1, -xflag
            else:
                y0 += ycnt if yflag < 0 else -ycnt
                flag, ycnt, yflag = 0, ycnt + 1, -yflag
            win = pad[16 + by + y0: 32 + by + y0, 16 + bx + x0: 32 + bx + x0]
            sad = np.abs(cur[by: by + 16, bx: bx + 16] - win).sum()
            if mn is None or sad < mn:
                mn, temp = sad, (x0, y0)
            elif sad == 0:
                temp = (x0, y0)
                break
            cnt += 1
        mv[n // mbw, n % mbw] = (-temp[0], -temp[1])
    return mv


def test_spiral_zero_sad_break_stateful_exact():
    """The zero-SAD early-break state carry-over is modeled exactly: the
    oracle AND every JAX ME path reproduce the C++ state machine on the
    content class that triggers it (static MBs -> mirrored spirals).

    1. Break-free content: stateful == fixed table (the round-1 property).
    2. Trigger content: a static MB(0,0) breaks at the second zero-SAD
       step and mirrors the flags; MB(0,1) holds an exact match at a
       spiral offset whose mirror is NOT in the canonical table, so the
       fixed table and the true machine provably differ — and the oracle +
       engines must side with the machine."""
    from icspcodec.ops.me import spiral_search_fixed, spiral_search_union

    r = np.random.default_rng(7)
    h, w = 32, 48

    # 1. generic content: no zero SADs -> identical
    prev = r.integers(0, 256, (h, w)).astype(np.uint8)
    cur = r.integers(0, 256, (h, w)).astype(np.uint8)
    assert np.array_equal(_ref_me_with_state(cur, prev),
                          oracle.motion_estimation(cur, prev))

    # 2. trigger: MB(0,0) static; MB(0,1) matches prev exactly at an
    # offset whose mirror image is NOT in the canonical spiral table
    asym = [tuple(o) for o in SPIRAL
            if tuple(-np.asarray(o)) not in {tuple(s) for s in SPIRAL}]
    ox, oy = asym[0]
    padn = oracle.pad_image(prev, 16)
    cur2 = r.integers(0, 256, (h, w)).astype(np.uint8)
    cur2[0:16, 0:16] = prev[0:16, 0:16]                      # static MB0
    # planted MB1 = the padded-prev window at spiral offset (ox, oy)
    cur2[0:16, 16:32] = padn[16 + oy: 32 + oy, 32 + ox: 48 + ox]

    machine = _ref_me_with_state(cur2, prev)
    assert tuple(machine[0, 0]) == (0, 0)         # break itself picks (0,0)
    fixed = np.asarray(
        spiral_search_fixed(jnp.asarray(cur2), pad_image(jnp.asarray(prev), 16))
    )
    assert tuple(fixed[0, 1]) == (-ox, -oy)       # fixed table finds the plant
    # mirrored spiral cannot reach (ox, oy): fixed provably diverges here
    assert tuple(machine[0, 1]) != (-ox, -oy)

    # the oracle and both JAX paths must equal the machine, not the table
    assert np.array_equal(oracle.motion_estimation(cur2, prev), machine)
    padj = pad_image(jnp.asarray(prev), 16)
    assert np.array_equal(np.asarray(spiral_search(jnp.asarray(cur2), padj)), machine)
    mv_u, _ = spiral_search_union(jnp.asarray(cur2), padj)
    assert np.array_equal(np.asarray(mv_u), machine)


def test_stateful_me_fuzz_vs_machine():
    """Randomized cross-check of oracle.motion_estimation (the hybrid
    dense/composed formulation) against the direct C++ transliteration on
    break-heavy content: static MBs + planted exact matches."""
    r = np.random.default_rng(23)
    h, w = 64, 96
    prev = r.integers(0, 256, (h, w)).astype(np.uint8)
    padn = oracle.pad_image(prev, 16)
    for trial in range(8):
        cur = r.integers(0, 256, (h, w)).astype(np.uint8)
        for _ in range(int(r.integers(1, 6))):
            by, bx = int(r.integers(0, h // 16)) * 16, int(r.integers(0, w // 16)) * 16
            cur[by:by + 16, bx:bx + 16] = prev[by:by + 16, bx:bx + 16]
        for _ in range(2):
            by, bx = int(r.integers(0, h // 16)) * 16, int(r.integers(0, w // 16)) * 16
            ox, oy = SPIRAL[int(r.integers(0, 64))]
            cur[by:by + 16, bx:bx + 16] = padn[16 + by + oy:32 + by + oy,
                                               16 + bx + ox:32 + bx + ox]
        want = _ref_me_with_state(cur, prev)
        assert np.array_equal(oracle.motion_estimation(cur, prev), want), trial
        got = np.asarray(spiral_search(jnp.asarray(cur), pad_image(jnp.asarray(prev), 16)))
        assert np.array_equal(got, want), trial


def test_io_and_header_validation():
    """Invalid dims / truncated input / corrupt headers error clearly
    instead of silently truncating or crashing later."""
    from icspcodec.io import load_yuv420
    from icspcodec.oracle import pack_header, parse_header

    good = bytes(2 * (32 * 32 + 2 * 16 * 16))  # two 32x32 frames
    y, cb, cr = load_yuv420(good, 32, 32, 2)
    assert y.shape == (2, 32, 32)

    with pytest.raises(ValueError, match="multiples of 16"):
        load_yuv420(good, 24, 32, 1)
    with pytest.raises(ValueError, match="complete"):
        load_yuv420(good[:-1], 32, 32, 2)   # truncated file
    with pytest.raises(ValueError, match="at least one"):
        load_yuv420(good, 32, 32, 0)

    hdr = pack_header(288, 352, 16, 16, 10)
    assert parse_header(hdr) == (288, 352, 16, 16, 10)
    with pytest.raises(ValueError, match="magic"):
        parse_header(b"XICSP" + hdr[5:])
    with pytest.raises(ValueError, match="14 bytes"):
        parse_header(hdr[:10])
    bad = bytearray(hdr)
    bad[5:7] = (17).to_bytes(2, "little")  # height not MB-aligned
    with pytest.raises(ValueError, match="dimensions"):
        parse_header(bytes(bad))


def test_device_entropy_pack_matches_host():
    """entropy='device' (on-accelerator VLC items + expand-pack,
    bitstream_device.py) must emit the identical bytes to the host
    numpy/C writer, across periods and precisions, on stateful-trigger
    content (SURVEY section 7 M4)."""
    from icspcodec.codec import encode
    from icspcodec.config import CodecConfig
    from icspcodec.io import load_yuv420
    from tools.make_content import synth_sequence

    nf = 7
    raw = synth_sequence("synthStatic", nf).tobytes()
    y, cb, cr = load_yuv420(raw, 352, 288, nf)
    for period, prec in ((0, "fast"), (5, "fast"), (5, "exact")):
        base = dict(qp_dc=16, qp_ac=16, intra_period=period, precision=prec)
        bh, rh = encode(y, cb, cr, CodecConfig(**base, entropy="host"))
        bd, rd = encode(y, cb, cr, CodecConfig(**base, entropy="device"))
        assert bh == bd, (period, prec)
        for k in rh:
            assert np.array_equal(rh[k], rd[k]), (period, prec, k)
    b2, r2 = encode(
        y, cb, cr, CodecConfig(qp_dc=16, qp_ac=16, intra_period=5), return_recon=False
    )
    assert b2 == bh and r2 is None


def test_device_vlc_matches_host_vlc():
    """Elementwise device VLC == the host vlc_encode over the codec's
    symbol domain (|v| <= ~3.1k: DC residual at QP 1; codes <= 24 bits,
    within the device path's uint32), both signs, exp>=5 long codes."""
    from icspcodec.bitstream_device import vlc_encode_dev

    vals = np.concatenate(
        [np.arange(-4100, 4100), rng.integers(-8192, 8192, size=512)]
    )
    hc, hl = bs.vlc_encode(vals)
    dc, dl = jax.jit(vlc_encode_dev)(jnp.asarray(vals))
    assert np.array_equal(np.asarray(dl), hl)
    assert np.array_equal(np.asarray(dc).astype(np.uint64), hc)


@pytest.mark.parametrize("f,gh,gw,qdc,qac,dt", [
    (3, 9, 12, 16, 16, jnp.float32),    # small grid
    (2, 36, 44, 8, 16, jnp.float64),    # CIF grid, exact regime
    (4, 6, 6, 10, 12, jnp.float32),     # non-pow2 qp: C division
    (1, 4, 18, 16, 16, jnp.float32),    # wide: diagonals capped by gh
    (5, 18, 4, 16, 16, jnp.float32),    # tall: short diagonals
    (2, 6, 22, 16, 16, jnp.float32),    # 48x176
])
def test_intra_packed_scan_equals_grid_scan(f, gh, gw, qdc, qac, dt):
    """The packed-diagonal intra wavefront (production) must be
    bit-identical to the reference-shaped grid formulation, both
    precisions, non-CIF shapes included."""
    from icspcodec.engine.wavefront import intra_luma_scan, intra_luma_scan_packed

    r = np.random.default_rng(gh * 100 + gw)
    orig = jnp.asarray(r.integers(0, 256, (f, gh, gw, 8, 8)).astype(np.int32))
    a = jax.jit(lambda o: intra_luma_scan(o, qdc, qac, dtype=dt))(orig)
    b = jax.jit(lambda o: intra_luma_scan_packed(o, qdc, qac, dtype=dt))(orig)
    for k in ("recon", "scan", "mpm", "mode_bit"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("f,gh,gw", [(3, 9, 12), (2, 36, 44), (4, 6, 6)])
def test_intra_packed_decode_equals_grid_decode(f, gh, gw):
    from icspcodec.engine.wavefront import (
        intra_luma_decode_scan,
        intra_luma_decode_scan_packed,
    )

    r = np.random.default_rng(gh * 10 + gw)
    rr = r.uniform(-80, 300, (f, gh, gw, 8, 8))
    mpm = r.integers(0, 2, (f, gh, gw)).astype(np.int32)
    bit = r.integers(0, 2, (f, gh, gw)).astype(np.int32)
    a = jax.jit(lambda x, f, b: intra_luma_decode_scan(x, f, b, dtype=jnp.float64))(rr, mpm, bit)
    b = jax.jit(lambda x, f, b: intra_luma_decode_scan_packed(x, f, b, dtype=jnp.float64))(rr, mpm, bit)
    assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("f,gh,gw,qstep,chroma", [
    (4, 18, 22, 16, True),    # CIF chroma grid
    (3, 9, 11, 10, True),     # odd-width chroma grid (QCIF), non-pow2 qp
    (2, 36, 44, 8, False),    # CIF luma grid (the inter DC chain)
    (5, 4, 6, 1, True),       # qstep 1
])
def test_dc_chains_vs_oracle(f, gh, gw, qstep, chroma):
    """The packed-diagonal DC-DPCM chains against the oracle's raster
    decoder chain (oracle._decode_dc_chain) and quantizers.

    Forward: dc_dpcm_scan gives (q, dq); the oracle decoder, fed q, must
    rebuild dq (so the predictor follows the reference's neighbour rule),
    and q must be the oracle's quantization of (dc - that predictor).
    Inverse: idc_dpcm_scan == the oracle decoder chain."""
    from icspcodec.engine.wavefront import (
        chroma_dc_kind, dc_dpcm_scan, idc_dpcm_scan, luma_dc_kind,
    )

    r = np.random.default_rng(f * 10 + gh)
    kind = (chroma_dc_kind if chroma else luma_dc_kind)(gh, gw)
    quant = oracle.quant_chroma if chroma else oracle.quant_luma

    dc = r.uniform(-2000, 2000, (f, gh, gw))
    q, dq = (np.asarray(a) for a in dc_dpcm_scan(jnp.asarray(dc), kind, qstep, chroma=chroma))
    assert np.array_equal(_oracle_dc_chain(q, qstep, gw, chroma), dq)
    blocks = np.zeros((f, gh, gw, 8, 8))
    blocks[..., 0, 0] = dc - (dq - q * qstep)     # dc minus its predictor
    assert np.array_equal(quant(blocks, qstep, 1)[..., 0, 0], q)

    iq = r.integers(-2000, 2000, (f, gh, gw)).astype(np.int32)
    got = np.asarray(idc_dpcm_scan(jnp.asarray(iq), kind))
    # QP 1: the oracle's dequantization leaves the residuals as they are
    assert np.array_equal(got, _oracle_dc_chain(iq, 1, gw, chroma))


def _oracle_dc_chain(q_dc: np.ndarray, qstep: int, gw: int, chroma: bool) -> np.ndarray:
    """Dequantized DC field (F, gh, gw) that the oracle's decoder chain
    rebuilds from quantized DC residuals q_dc."""
    out = []
    for n in range(q_dc.shape[0]):
        scan = np.zeros(q_dc.shape[1:] + (64,), np.int64)
        scan[..., 0] = q_dc[n]
        out.append(oracle._decode_dc_chain(scan, qstep, 1, gw, luma=not chroma)[..., 0, 0])
    return np.stack(out)


def _inter_content(static: bool):
    """One 64x96 P-frame and its previous recon; `static` copies MBs
    unchanged so their SAD at (0, 0) is zero, which fires the reference's
    early break and the stateful spiral."""
    r = np.random.default_rng(31 if static else 30)
    h, w = 64, 96
    prev = oracle.Recon(
        r.integers(0, 256, (h, w)).astype(np.uint8),
        r.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
        r.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
    )
    y = np.roll(prev.y, (2, -3), axis=(0, 1)).copy()
    y[10:30, 40:70] ^= 0x33
    if static:
        y[16:48, 16:48] = prev.y[16:48, 16:48]
    cb = np.roll(prev.cb, (1, -1), axis=(0, 1)).copy()
    cr = r.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return y, cb, cr, prev


@pytest.mark.parametrize("static", [False, True])
def test_inter_frame_encode_vs_oracle(static):
    """The XLA inter frame (ME/MC, luma and chroma chains) at float64
    against oracle.encode_frame_inter, symbols and recon."""
    from icspcodec.engine.inter import encode_inter_frame

    y, cb, cr, prev = _inter_content(static)
    want_rec, want = oracle.encode_frame_inter(y, cb, cr, prev, 16, 16)
    got = jax.jit(lambda *a: encode_inter_frame(*a, 16, 16, dtype=jnp.float64))(
        y[None], cb[None], cr[None], prev.y[None], prev.cb[None], prev.cr[None])
    got = {k: np.asarray(v)[0] for k, v in got.items()}
    for k in ("y", "cb", "cr"):
        assert np.array_equal(got[f"recon_{k}"], getattr(want_rec, k)), k
    for k in ("y_scan", "y_acflag", "cb_scan", "cb_acflag", "cr_scan", "cr_acflag",
              "mv_diff"):
        assert np.array_equal(got[k], getattr(want, k)), k


@pytest.mark.parametrize("static", [False, True])
def test_inter_frame_decode_vs_oracle(static):
    """decode_inter_frame at float64 against oracle.decode_frame_inter on
    the oracle encoder's symbols."""
    from icspcodec.constants import COS_DEC
    from icspcodec.engine.inter import decode_inter_frame

    y, cb, cr, prev = _inter_content(static)
    _, sym = oracle.encode_frame_inter(y, cb, cr, prev, 16, 16)
    want = oracle.decode_frame_inter(sym, prev, 16, 16, *y.shape)
    syms = {k: jnp.asarray(getattr(sym, k)[None].astype(np.int32))
            for k in ("y_scan", "mv_diff", "cb_scan", "cr_scan")}
    got = jax.jit(lambda s, *p: decode_inter_frame(s, *p, 16, 16, COS_DEC, dtype=jnp.float64))(
        syms, prev.y[None], prev.cb[None], prev.cr[None])
    for k in ("y", "cb", "cr"):
        assert np.array_equal(np.asarray(got[k])[0], getattr(want, k)), k


@pytest.mark.parametrize("fn", [fdct, idct])
def test_fast_transforms_run_no_matmul_and_ignore_batch_size(fn):
    """The float32 transforms are elementwise with every product rounded
    on its own: no dot_general (whose precision and algorithm a GPU picks
    by shape), and a batch gives the same bits as its slices."""
    jaxpr = jax.make_jaxpr(lambda x: fn(x, table=COS_ENC, dtype=jnp.float32))(
        jnp.zeros((2, 8, 8), jnp.int32))
    assert not [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    x = rng.integers(-255, 256, size=(600, 8, 8)).astype(np.int32)
    run = jax.jit(lambda v: fn(v, table=COS_ENC, dtype=jnp.float32))
    whole = np.asarray(run(x))
    assert np.array_equal(whole[:7], np.asarray(run(x[:7])))
    assert np.array_equal(whole[100:400], np.asarray(run(x[100:400])))
