"""Intra frame engine: batched whole-frame encode/decode.

Everything embarrassingly parallel (chroma DCT, AC quantization, IDCT,
plane assembly) runs as one batched op over all blocks of all frames;
only the DC chain and the luma pixel wavefront are lax.scans
(engine/wavefront.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import COS_ENC
from ..ops.quant import ac_flag, c_trunc, dequant_block, quant_block
from ..ops.scanorder import izigzag, zigzag
from ..ops.transforms import fdct, idct
from .wavefront import (
    chroma_dc_kind,
    dc_dpcm_scan,
    idc_dpcm_scan,
    intra_luma_decode_scan_packed,
    intra_luma_scan_packed,
    luma_dc_kind,
)


# symbol keys the decoder consumes per intra / inter frame
DEC_I_KEYS = ("y_scan", "mpm", "mode_bit", "cb_scan", "cr_scan")
DEC_P_KEYS = ("y_scan", "mv_diff", "cb_scan", "cr_scan")


def to_blocks(plane: jnp.ndarray, bs: int = 8) -> jnp.ndarray:
    """(..., H, W) -> (..., H//bs, W//bs, bs, bs)"""
    h, w = plane.shape[-2:]
    lead = plane.shape[:-2]
    x = plane.reshape(lead + (h // bs, bs, w // bs, bs))
    return jnp.moveaxis(x, -3, -2)


def from_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    gh, gw, bs = blocks.shape[-4], blocks.shape[-3], blocks.shape[-1]
    x = jnp.moveaxis(blocks, -2, -3)
    return x.reshape(blocks.shape[:-4] + (gh * bs, gw * bs))


def encode_chroma_batch(planes: jnp.ndarray, qdc: int, qac: int, table=COS_ENC, dtype=jnp.float64):
    """Forward chroma chain for (F, H, W) pixel planes (intra: raw pixels)
    or (F, gh, gw, 8, 8) residual blocks (inter).

    Returns dict(scan, acflag, idct) — idct is the float inverse-DCT
    output; callers finish reconstruction their own way."""
    if planes.ndim == 3:
        blocks = to_blocks(planes).astype(jnp.int32)
    else:
        blocks = planes
    fdim, ch, cw = blocks.shape[:3]
    d = fdct(blocks, table=table, dtype=dtype)
    q_dc, dq_dc = dc_dpcm_scan(d[..., 0, 0], chroma_dc_kind(ch, cw), qdc, chroma=True)
    q = quant_block(d, qdc, qac, chroma=True)
    q = q.at[..., 0, 0].set(q_dc)
    sc = zigzag(q)
    acf = ac_flag(q)
    iq = dequant_block(q, qdc, qac)
    iq = iq.at[..., 0, 0].set(dq_dc)
    r = idct(iq, table=table, dtype=dtype)
    return dict(scan=sc, acflag=acf, idct=r)


def encode_intra_frames(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray, qdc: int, qac: int, table=COS_ENC, dtype=jnp.float64, return_recon: bool = True):
    """Encode a batch of intra frames.

    y: (F, H, W) uint8; cb/cr: (F, H/2, W/2) uint8.
    Returns dict of all bitstream symbols, plus the recon planes when
    return_recon=True (the bitstream path doesn't need them; skipping
    drops the recon relayout/output work entirely).
    """
    orig = to_blocks(y).astype(jnp.int32)
    # packed-diagonal wavefront: bit-identical to intra_luma_scan, reads
    # only constant-shifted boundary rows per step instead of gathering
    # the full block grid (see wavefront.py)
    with jax.named_scope("intra_wavefront"):
        lum = intra_luma_scan_packed(orig, qdc, qac, table=table, dtype=dtype)
    # symbols travel device->host: narrow dtypes halve the transfer
    out = dict(
        y_scan=lum["scan"].astype(jnp.int16),
        y_acflag=_acflag_from_scan(lum["scan"]).astype(jnp.int8),
        mpm=lum["mpm"].astype(jnp.int8),
        mode_bit=lum["mode_bit"].astype(jnp.int8),
    )
    if return_recon:
        out["recon_y"] = from_blocks(lum["recon"]).astype(jnp.uint8)
    # Cb and Cr share the chain; stack them into one batch (one DC scan)
    f = cb.shape[0]
    with jax.named_scope("chroma_chain"):
        c = encode_chroma_batch(
            jnp.concatenate([cb, cr]), qdc, qac, table=table, dtype=dtype
        )
    if return_recon:
        # intra chroma recon = clamp((int)idct) (intraImgReconstruct
        # enc src:1944-1960: truncation toward zero, then clamp)
        rec = jnp.clip(c_trunc(c["idct"]), 0, 255).astype(jnp.uint8)
        rec = from_blocks(rec)
    for i, name in enumerate(("cb", "cr")):
        sl = slice(i * f, (i + 1) * f)
        if return_recon:
            out[f"recon_{name}"] = rec[sl]
        out[f"{name}_scan"] = c["scan"][sl].astype(jnp.int16)
        out[f"{name}_acflag"] = c["acflag"][sl].astype(jnp.int8)
    return out


def _acflag_from_scan(scan: jnp.ndarray) -> jnp.ndarray:
    return (jnp.count_nonzero(scan[..., 1:], axis=-1) == 0).astype(jnp.int32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_intra_frames(y_scan, mpm, mode_bit, cb_scan, cr_scan, qdc, qac, table, dtype=jnp.float64):
    """Inverse pipeline for a batch of intra frames (symbols -> planes)."""
    with jax.named_scope("luma_inverse"):
        q = izigzag(y_scan)
        iq = dequant_block(q, qdc, qac)
        gh, gw = q.shape[1:3]
        dq_dc = idc_dpcm_scan(iq[..., 0, 0], luma_dc_kind(gh, gw))
        iq = iq.at[..., 0, 0].set(dq_dc)
        r = idct(iq, table=table, dtype=dtype)
    with jax.named_scope("intra_wavefront"):
        recon = intra_luma_decode_scan_packed(r, mpm, mode_bit, dtype=dtype)
    out = dict(y=from_blocks(recon).astype(jnp.uint8))
    # Cb and Cr share the inverse chain: one batch, one DC scan
    f = cb_scan.shape[0]
    with jax.named_scope("chroma_inverse"):
        qc = izigzag(jnp.concatenate([cb_scan, cr_scan]))
        iqc = dequant_block(qc, qdc, qac)
        ch, cw = qc.shape[1:3]
        dqc = idc_dpcm_scan(iqc[..., 0, 0], chroma_dc_kind(ch, cw))
        iqc = iqc.at[..., 0, 0].set(dqc)
        rinv = idct(iqc, table=table, dtype=dtype)
        rc = from_blocks(jnp.clip(c_trunc(rinv), 0, 255).astype(jnp.uint8))
    out["cb"], out["cr"] = rc[:f], rc[f:]
    return out
