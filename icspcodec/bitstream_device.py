"""Device-side entropy coding + bit packing (SURVEY section 7 M4).

The host writer (bitstream.py) needs every symbol array pulled to the
host first — ~150 MB per CIF300.  This module keeps entropy coding ON
the device: the encoder jits emit
per-frame (code, length) item arrays, bit offsets come from a prefix
sum, and a vectorized expand-gather packs MSB-first bytes — so only the
packed frames (~the bitstream size) ever cross to the host.

Pipeline (codec.encode's device-entropy path):
  1. engine outputs (still device-resident) -> frame_items_dev inside
     the same jit: (codes uint32, lengths int32) of shape (F, nitems)
     — nitems is constant per frame type, exactly like the host writer
     (the acflag==1 case writes 63 literal zero bits, one item per AC
     coefficient, so the layout is static; bitstream.py docstring).
  2. pull only per-frame bit counts (F int32s), pick a static byte
     bucket, and run pack_frames_dev: per-frame packed bytes
     (F, maxbytes) uint8 + bit counts.
  3. host splices the display-ordered frames at bit granularity
     (assemble_frames) and applies the reference's tail convention.

Equality with the host writer is byte-exact and pinned by
tests/test_ops.py::test_device_entropy_pack_*.

The packing itself is the classic expand-by-prefix-sum: scatter a 1 at
every item's start bit (offsets strictly increase — every item is >= 1
bit), cumsum to recover the item id owning each output bit position,
then gather (code, length, offset) per position and extract the bit.
No serial loop anywhere; the reference's byte-shift loop
(makebitstream, enc src:4849-4900) becomes three vectorized passes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# VLC (device): mirrors bitstream.vlc_encode / DCentropy enc src:5417-5602
# ---------------------------------------------------------------------------


def vlc_encode_dev(values: jnp.ndarray):
    """Elementwise 13-category VLC: (codes uint32, lengths int32).

    Code bits are right-aligned.  DOMAIN: |v| < 2**15 (code <= 32 bits);
    the codec's symbols are far inside it — the longest real code is 22
    bits (VLC_MAX_BITS; DC residual at QP 1).  Integer-only: the exponent
    comes from threshold counting, not a float log."""
    x = values.astype(jnp.int32)
    v = jnp.abs(x)
    sign = (x >= 0).astype(jnp.uint32)
    # floor(log2(v)) for v >= 2, else 0 — one count-leading-zeros pass
    # (the threshold-counting loop this replaces cost 21 full passes
    # over the coefficient array, ~2.5 GB of HBM traffic per CIF300)
    exp = jnp.where(v >= 2, 31 - jax.lax.clz(jnp.maximum(v, 1)), 0)
    expu = exp.astype(jnp.uint32)
    payload = v.astype(jnp.uint32) - (jnp.uint32(1) << expu)

    # categories exp 1..4: 3-bit prefix + sign + exp payload bits
    prefix_tab = jnp.asarray(
        np.array([0, 0b011, 0b100, 0b101, 0b110] + [0] * 17, np.uint32)
    )
    pre = prefix_tab[exp]
    code_small = (((pre << 1) | sign) << expu) | payload
    len_small = 4 + exp
    # exp >= 5: (exp-2) ones, 0, sign, exp payload bits == 2*exp bits
    ones = ((jnp.uint32(1) << jnp.maximum(exp - 2, 0).astype(jnp.uint32)) - 1) << 1
    code_big = (((ones << 1) | sign) << expu) | payload
    len_big = 2 * exp
    code1 = (jnp.uint32(0b010) << 1) | sign

    codes = jnp.where(
        v == 0,
        jnp.uint32(0),
        jnp.where(v == 1, code1, jnp.where(exp <= 4, code_small, code_big)),
    )
    lengths = jnp.where(
        v == 0, 2, jnp.where(v == 1, 4, jnp.where(exp <= 4, len_small, len_big))
    )
    return codes.astype(jnp.uint32), lengths.astype(jnp.int32)


# ---------------------------------------------------------------------------
# frame item assembly (device): mirrors bitstream.frame_items
# ---------------------------------------------------------------------------


def _coeff_block_items(scan, acflag):
    """(..., 64) scan + (...,) acflag -> (..., 65) (codes, lengths)."""
    dc_c, dc_l = vlc_encode_dev(scan[..., 0])
    ac_c, ac_l = vlc_encode_dev(scan[..., 1:])
    flag = acflag.astype(jnp.uint32)
    empty = (acflag == 1)[..., None]
    ac_c = jnp.where(empty, jnp.uint32(0), ac_c)
    ac_l = jnp.where(empty, 1, ac_l)
    codes = jnp.concatenate([dc_c[..., None], flag[..., None], ac_c], axis=-1)
    lengths = jnp.concatenate(
        [dc_l[..., None], jnp.ones(flag.shape + (1,), jnp.int32), ac_l], axis=-1
    )
    return codes, lengths


def _y_subblocks(arr, lead: int):
    """(..., gh, gw, *rest) -> (..., nmb, 4, *rest) in MB/sub-block order."""
    gh, gw = arr.shape[lead], arr.shape[lead + 1]
    head = arr.shape[:lead]
    rest = arr.shape[lead + 2:]
    x = arr.reshape(head + (gh // 2, 2, gw // 2, 2) + rest)
    x = jnp.moveaxis(x, lead + 2, lead + 1)
    return x.reshape(head + ((gh // 2) * (gw // 2), 4) + rest)


def frame_items_dev(syms: dict, is_intra: bool):
    """Device mirror of bitstream.frame_items: (codes, lengths) (F, N)."""
    f = syms["y_scan"].shape[0]
    ysc = _y_subblocks(syms["y_scan"], 1)
    yac = _y_subblocks(syms["y_acflag"], 1)
    nmb = ysc.shape[1]
    yc, yl = _coeff_block_items(ysc, yac)

    if is_intra:
        mpm = _y_subblocks(syms["mpm"], 1).astype(jnp.uint32)
        bit = _y_subblocks(syms["mode_bit"], 1).astype(jnp.uint32)
        yc = jnp.concatenate([mpm[..., None], bit[..., None], yc], axis=3)
        yl = jnp.concatenate([jnp.ones((f, nmb, 4, 2), jnp.int32), yl], axis=3)
        head_c = jnp.zeros((f, nmb, 0), jnp.uint32)
        head_l = jnp.zeros((f, nmb, 0), jnp.int32)
    else:
        mvd = syms["mv_diff"].reshape(f, nmb, 2)
        mvx_c, mvx_l = vlc_encode_dev(mvd[..., 0])
        mvy_c, mvy_l = vlc_encode_dev(mvd[..., 1])
        one = jnp.ones((f, nmb), jnp.uint32)
        head_c = jnp.stack([one, mvx_c, mvy_c], axis=2)
        head_l = jnp.stack([jnp.ones((f, nmb), jnp.int32), mvx_l, mvy_l], axis=2)

    cbc, cbl = _coeff_block_items(
        syms["cb_scan"].reshape(f, nmb, 64), syms["cb_acflag"].reshape(f, nmb)
    )
    crc, crl = _coeff_block_items(
        syms["cr_scan"].reshape(f, nmb, 64), syms["cr_acflag"].reshape(f, nmb)
    )
    all_c = jnp.concatenate(
        [head_c, yc.reshape(f, nmb, -1), cbc, crc], axis=2
    ).reshape(f, -1)
    all_l = jnp.concatenate(
        [head_l, yl.reshape(f, nmb, -1), cbl, crl], axis=2
    ).reshape(f, -1)
    return all_c, all_l


# ---------------------------------------------------------------------------
# bit packing (device)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("maxbytes",))
def pack_frames_dev(codes: jnp.ndarray, lengths: jnp.ndarray, maxbytes: int):
    """Pack per-frame items into MSB-first bytes.

    codes: (F, N) uint32 right-aligned; lengths: (F, N) int32 >= 1.
    Returns (packed (F, maxbytes) uint8, nbits (F,) int32).  maxbytes*8
    must cover the largest frame (the caller buckets it from the pulled
    bit counts); bits past a frame's end are zero.

    Expand-by-prefix-sum formulation: scatter a mark at each item start,
    cumsum to recover the item id owning each bit position, gather
    (code, length, offset) per position and extract the bit."""
    f, n = codes.shape
    nbits_pad = maxbytes * 8
    off = jnp.cumsum(lengths, axis=1) - lengths           # exclusive
    nbits = (off[:, -1] + lengths[:, -1]).astype(jnp.int32)

    # item id per bit position: scatter 1 at each item start, cumsum
    rows = jnp.arange(f)[:, None]
    mark = jnp.zeros((f, nbits_pad), jnp.int32).at[rows, off].add(1, mode="drop")
    itemid = jnp.cumsum(mark, axis=1) - 1                 # (F, nbits_pad)

    o = jnp.take_along_axis(off, itemid, axis=1)
    l = jnp.take_along_axis(lengths, itemid, axis=1)
    c = jnp.take_along_axis(codes, itemid, axis=1)
    pos = jnp.arange(nbits_pad, dtype=jnp.int32)[None, :]
    j = pos - o
    valid = (j >= 0) & (j < l)
    shift = jnp.clip(l - 1 - j, 0, 31).astype(jnp.uint32)
    bit = ((c >> shift) & 1).astype(jnp.int32)
    bits = jnp.where(valid, bit, 0)

    weights = jnp.asarray((1 << np.arange(7, -1, -1)).astype(np.int32))
    packed = (bits.reshape(f, maxbytes, 8) * weights).sum(-1).astype(jnp.uint8)
    return packed, nbits


# ---------------------------------------------------------------------------
# host assembly: splice display-ordered packed frames at bit granularity
# ---------------------------------------------------------------------------


def assemble_frames(rows, nbits) -> bytes:
    """rows: iterable of (maxbytes,) uint8 numpy arrays (MSB-first packed,
    zero-padded), display order; nbits: matching bit counts.  Returns the
    reference byte stream: bits concatenated MSB-first, final partial
    byte moved to the LOW positions, one extra zero byte appended when
    the stream ends byte-aligned (pack_items convention, enc
    src:4849-4900)."""
    total = int(sum(int(b) for b in nbits))
    out = np.zeros(total // 8 + 2, np.uint8)
    bitpos = 0
    for row, nb in zip(rows, nbits):
        nb = int(nb)
        nbytes = (nb + 7) // 8
        src = np.asarray(row[:nbytes], np.uint8)
        base, k = bitpos >> 3, bitpos & 7
        if k == 0:
            out[base:base + nbytes] |= src
        else:
            out[base:base + nbytes] |= src >> k
            out[base + 1:base + 1 + nbytes] |= (src << (8 - k)).astype(np.uint8)
        bitpos += nb
    rem = total & 7
    nfull = total >> 3
    if rem == 0:
        return out[:nfull].tobytes() + b"\x00"
    tail = out[nfull] >> (8 - rem)  # partial byte: bits in LOW positions
    return out[:nfull].tobytes() + bytes([tail])
