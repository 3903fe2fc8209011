"""Inter frame engine: ME/MC + residual chain + GOP frame scan.

Structure (vs. the reference's per-MB loops, interPrediction
enc src:1986-2072):

* motion estimation: all 64 spiral candidates x all MBs as one dense
  batched SAD computation (ops/me.py)
* residual DCT / AC quantization / IDCT: one batched op over all 1584
  8x8 blocks of the frame
* only the transform-domain DC chain is sequential -> dc_dpcm_scan
  wavefront (114 steps for CIF)
* differential MVs are computed fully in parallel (the reconstructed MV
  field equals the original field; see ops.me.mv_diff_field)
* frames inside a GOP run under lax.scan carrying the reconstructed
  planes; GOPs batch/shard independently (closed-GOP rule)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import COS_ENC
from ..ops.me import gather_pred, mv_diff_field, spiral_search
from ..ops.medians import median3, median3_mv_y
from ..ops.pad import pad_image
from ..ops.quant import c_trunc, dequant_block, quant_block
from ..ops.scanorder import izigzag, zigzag
from ..ops.transforms import fdct, idct
from .intra import (
    DEC_I_KEYS,
    _acflag_from_scan,
    decode_intra_frames,
    encode_chroma_batch,
    encode_intra_frames,
    from_blocks,
    to_blocks,
)
from .wavefront import chroma_dc_kind, dc_dpcm_scan, idc_dpcm_scan, luma_dc_kind


def _perm(lead_n: int) -> list[int]:
    # both conversions share the same 6-axis permutation [0,2,1,4,3,5]
    return list(range(lead_n)) + [lead_n + i for i in (0, 2, 1, 4, 3, 5)]


def mb_to_grid8(resid16: jnp.ndarray) -> jnp.ndarray:
    """(..., mbh, mbw, 16, 16) -> (..., 2*mbh, 2*mbw, 8, 8) global grid."""
    lead = resid16.shape[:-4]
    mbh, mbw = resid16.shape[-4], resid16.shape[-3]
    # (..., mbh, mbw, sy, py, sx, px) -> (..., mbh, sy, mbw, sx, py, px)
    x = resid16.reshape(lead + (mbh, mbw, 2, 8, 2, 8))
    x = jnp.transpose(x, _perm(len(lead)))
    return x.reshape(lead + (2 * mbh, 2 * mbw, 8, 8))


def grid8_to_mb(blocks: jnp.ndarray) -> jnp.ndarray:
    """(..., 2*mbh, 2*mbw, 8, 8) -> (..., mbh, mbw, 16, 16)."""
    lead = blocks.shape[:-4]
    gh, gw = blocks.shape[-4], blocks.shape[-3]
    # (..., mbh, sy, mbw, sx, py, px) -> (..., mbh, mbw, sy, py, sx, px)
    x = blocks.reshape(lead + (gh // 2, 2, gw // 2, 2, 8, 8))
    x = jnp.transpose(x, _perm(len(lead)))
    return x.reshape(lead + (gh // 2, gw // 2, 16, 16))


def encode_inter_frame(cur_y, cur_cb, cur_cr, prev_y, prev_cb, prev_cr, qdc, qac, table=COS_ENC, dtype=jnp.float64):
    """Encode one inter frame, batched over a leading axis (GOPs).

    cur_*: (..., H, W) uint8; prev_*: reconstructed previous planes.
    Returns dict(recon_y/cb/cr, y_scan, y_acflag, cb/cr_scan+acflag, mv_diff).
    """
    h, w = cur_y.shape[-2], cur_y.shape[-1]
    gh, gw = h // 8, w // 8
    f = cur_cb.shape[0]
    with jax.named_scope("me_mc"):
        pad = pad_image(prev_y, 16)
        padc = pad_image(jnp.concatenate([prev_cb, prev_cr]), 8)
        mv = spiral_search(cur_y, pad)  # stateful-exact hybrid (ops/me.py)
        predb = gather_pred(pad.astype(jnp.int32), mv, 16)
        # frame-layout predictor: elementwise ops commute with the
        # block<->plane transposes, so downstream math is layout-agnostic
        predf = from_blocks(mb_to_grid8(predb))
        mvc = jnp.sign(mv) * (jnp.abs(mv) // 2)
        predcf = from_blocks(gather_pred(padc.astype(jnp.int32), jnp.concatenate([mvc, mvc]), 8))

    with jax.named_scope("luma_chain"):
        resid8 = to_blocks(cur_y.astype(jnp.int32) - predf)
        d = fdct(resid8, table=table, dtype=dtype)
        q_dc, dq_dc = dc_dpcm_scan(
            d[..., 0, 0], luma_dc_kind(gh, gw), qdc, chroma=False
        )
        q = quant_block(d, qdc, qac, chroma=False)
        q = q.at[..., 0, 0].set(q_dc)
        sc = zigzag(q)
        acf = _acflag_from_scan(sc)
        iq = dequant_block(q, qdc, qac)
        iq = iq.at[..., 0, 0].set(dq_dc)
        r = idct(iq, table=table, dtype=dtype)
        # mergeBlock INTER casts the double IDCT to int (enc src:4812)
        recon_y = jnp.clip(predf + from_blocks(c_trunc(r)), 0, 255).astype(jnp.uint8)

    mv_diff = mv_diff_field(mv)
    out = dict(
        recon_y=recon_y,
        y_scan=sc.astype(jnp.int16),
        y_acflag=acf.astype(jnp.int8),
        mv_diff=mv_diff.astype(jnp.int16),
    )

    # chroma: mv/2 with C division (CmotionCompensation enc src:2538);
    # Cb and Cr stacked into one batch so the DC scan runs once
    # (predcf computed above alongside the luma predictor)
    with jax.named_scope("chroma_chain"):
        planes = jnp.concatenate([cur_cb, cur_cr])
        err = to_blocks(planes).astype(jnp.int32) - to_blocks(predcf)
        c = encode_chroma_batch(err, qdc, qac, table=table, dtype=dtype)
        # recon = clamp((int)(pad_pixel + idct)): double sum, trunc to zero
        rec = jnp.clip(c_trunc(predcf.astype(dtype) + from_blocks(c["idct"])), 0, 255)
    for i, name in enumerate(("cb", "cr")):
        sl = slice(i * f, (i + 1) * f)
        out[f"recon_{name}"] = rec[sl].astype(jnp.uint8)
        out[f"{name}_scan"] = c["scan"][sl].astype(jnp.int16)
        out[f"{name}_acflag"] = c["acflag"][sl].astype(jnp.int8)
    return out


# ---------------------------------------------------------------------------
# GOP scan: I-frame + P-frames under lax.scan, batched over GOPs
# ---------------------------------------------------------------------------


def encode_gop(y, cb, cr, qdc, qac, table=COS_ENC, dtype=jnp.float64):
    """Encode closed GOPs: frame 0 intra, the rest P-frames.

    y: (G, P, H, W) uint8 — G independent GOPs of P frames each.
    Returns per-frame symbol arrays stacked on axis 1 plus recon planes.
    """
    g, p = y.shape[0], y.shape[1]
    intra = encode_intra_frames(y[:, 0], cb[:, 0], cr[:, 0], qdc, qac, table=table, dtype=dtype)

    if p == 1:
        return intra, None

    def step(carry, xs):
        py, pcb, pcr = carry
        cy, ccb, ccr = xs
        o = encode_inter_frame(cy, ccb, ccr, py, pcb, pcr, qdc, qac, table=table, dtype=dtype)
        carry = (o["recon_y"], o["recon_cb"], o["recon_cr"])
        return carry, o

    xs = (
        jnp.moveaxis(y[:, 1:], 1, 0),
        jnp.moveaxis(cb[:, 1:], 1, 0),
        jnp.moveaxis(cr[:, 1:], 1, 0),
    )
    init = (intra["recon_y"], intra["recon_cb"], intra["recon_cr"])
    _, inter = jax.lax.scan(step, init, xs)
    # inter[*] has shape (P-1, G, ...) -> (G, P-1, ...)
    inter = {k: jnp.moveaxis(v, 0, 1) for k, v in inter.items()}
    return intra, inter


# ---------------------------------------------------------------------------
# decode side
# ---------------------------------------------------------------------------


def mv_reconstruct_scan(mv_diff: jnp.ndarray):
    """Sequential MV reconstruction on the MB grid (ImvPrediction).

    mv_diff: (F, mbh, mbw, 2) int32.  Wavefront over the MB grid; kinds
    match chroma_dc_kind (same first-row/col/right-edge topology), with
    the const predictor (8,8) and the y-median typo."""
    fdim, mbh, mbw = mv_diff.shape[:3]
    from .wavefront import wavefront_schedule

    gys, gxs, valid = wavefront_schedule(mbh, mbw)
    kindg = jnp.asarray(chroma_dc_kind(mbh, mbw))

    def body(mv, step):
        gy, gx, v = step
        gyc = jnp.minimum(gy, mbh - 1)
        gxc = jnp.minimum(gx, mbw - 1)
        gyu = jnp.maximum(gyc - 1, 0)
        gxl = jnp.maximum(gxc - 1, 0)
        gxr = jnp.minimum(gxc + 1, mbw - 1)
        l = mv[:, gyc, gxl]
        u = mv[:, gyu, gxc]
        ul = mv[:, gyu, gxl]
        ur = mv[:, gyu, gxr]
        kv = kindg[gyc, gxc][None, :]
        # median triples: kind 3 -> (l, ul, u); kind 4 -> (l, u, ur)
        bx = jnp.where(kv == 3, ul[..., 0], u[..., 0])
        by = jnp.where(kv == 3, ul[..., 1], u[..., 1])
        cx = jnp.where(kv == 3, u[..., 0], ur[..., 0])
        cy = jnp.where(kv == 3, u[..., 1], ur[..., 1])
        medx = median3(l[..., 0], bx, cx)
        medy = median3_mv_y(l[..., 1], by, cy, cx)
        px = jnp.select(
            [kv == 0, kv == 1, kv == 2], [jnp.full_like(medx, 8), l[..., 0], u[..., 0]], medx
        )
        py = jnp.select(
            [kv == 0, kv == 1, kv == 2], [jnp.full_like(medy, 8), l[..., 1], u[..., 1]], medy
        )
        new = mv_diff[:, gyc, gxc] + jnp.stack([px, py], axis=-1)
        gy_s = jnp.where(v, gy, mbh)
        return mv.at[:, gy_s, gx].set(new, mode="drop"), None

    # derive the zero carry from the input so it inherits the input's
    # varying-manual-axes type under shard_map (a plain jnp.zeros would be
    # replicated and trip the scan carry vma check when called from
    # parallel.tiles.decode_inter_frame_tiled) — wavefront._dc_chain_scan
    # uses the same pattern
    init = (mv_diff * 0).astype(jnp.int32)
    mv, _ = jax.lax.scan(body, init, (jnp.asarray(gys), jnp.asarray(gxs), jnp.asarray(valid)))
    return mv


def decode_gop_mvs(mv_diff: jnp.ndarray):
    """Reconstruct MVs for a whole (G, P-1, mbh, mbw, 2) symbol batch in
    ONE wavefront scan (frames are independent given their mv_diff).

    Returns mv (G, P-1, mbh, mbw, 2) int32."""
    g, pm1, mbh, mbw = mv_diff.shape[:4]
    with jax.named_scope("mv_chain"):
        mv = mv_reconstruct_scan(
            mv_diff.reshape(g * pm1, mbh, mbw, 2).astype(jnp.int32)
        )
    return mv.reshape(g, pm1, mbh, mbw, 2)


def decode_inter_frame(sym: dict, prev_y, prev_cb, prev_cr, qdc, qac, table, dtype=jnp.float64):
    """Inverse inter pipeline for a batch of frames (symbols -> planes).

    sym may carry a precomputed "mv" field (see decode_gop_mvs): MV
    reconstruction depends only on the mv_diff symbols, so GOP decoders
    hoist the per-frame 56-step wavefront out of their frame scan and
    run ONE batched scan over all frames instead."""
    gh, gw = sym["y_scan"].shape[1:3]
    f = prev_cb.shape[0]
    mv = sym["mv"] if "mv" in sym else mv_reconstruct_scan(sym["mv_diff"])
    with jax.named_scope("luma_inverse"):
        q = izigzag(sym["y_scan"])
        iq = dequant_block(q, qdc, qac)
        dq_dc = idc_dpcm_scan(iq[..., 0, 0], luma_dc_kind(gh, gw))
        iq = iq.at[..., 0, 0].set(dq_dc)
        inv_f = from_blocks(c_trunc(idct(iq, table=table, dtype=dtype)))
    with jax.named_scope("mc"):
        pad = pad_image(prev_y, 16)
        padc = pad_image(jnp.concatenate([prev_cb, prev_cr]), 8)
        predf = from_blocks(mb_to_grid8(gather_pred(pad.astype(jnp.int32), mv, 16)))
        mvc = jnp.sign(mv) * (jnp.abs(mv) // 2)
        predcf = from_blocks(
            gather_pred(padc.astype(jnp.int32), jnp.concatenate([mvc, mvc]), 8)
        )
    recon_y = jnp.clip(predf + inv_f, 0, 255).astype(jnp.uint8)

    out = dict(y=recon_y)
    # Cb and Cr share the inverse chain: one batch, one DC scan
    with jax.named_scope("chroma_inverse"):
        qc = izigzag(jnp.concatenate([sym["cb_scan"], sym["cr_scan"]]))
        iqc = dequant_block(qc, qdc, qac)
        ch, cw = qc.shape[1:3]
        dqc = idc_dpcm_scan(iqc[..., 0, 0], chroma_dc_kind(ch, cw))
        iqc = iqc.at[..., 0, 0].set(dqc)
        rc = from_blocks(idct(iqc, table=table, dtype=dtype))
        # the predictor is added BEFORE the (int) cast (the reference sums
        # in double, then casts)
        rec = jnp.clip(c_trunc(predcf.astype(dtype) + rc), 0, 255).astype(jnp.uint8)
    out["cb"], out["cr"] = rec[:f], rec[f:]
    return out


def decode_gop(sym_i: dict, sym_p: dict, qdc, qac, table, dtype=jnp.float64):
    """Decode closed GOPs: sym_i intra symbols (G, ...) keyed DEC_I_KEYS;
    sym_p inter symbols (G, P-1, ...).  Returns (first, rest) plane dicts,
    rest with leading (G, P-1).

    MV reconstruction is hoisted out of the frame scan (decode_gop_mvs):
    one batched wavefront over all G*(P-1) frames instead of P-1
    sequential ones."""
    first = decode_intra_frames(
        *(sym_i[k] for k in DEC_I_KEYS), qdc, qac, table=table, dtype=dtype
    )
    sym_p = dict(sym_p, mv=decode_gop_mvs(sym_p["mv_diff"]))

    def step(carry, xs):
        out = decode_inter_frame(
            xs, carry["y"], carry["cb"], carry["cr"], qdc, qac,
            table=table, dtype=dtype,
        )
        return out, out

    xs = {k: jnp.moveaxis(sym_p[k], 1, 0) for k in sym_p}
    _, rest = jax.lax.scan(step, first, xs)
    rest = {k: jnp.moveaxis(v, 0, 1) for k, v in rest.items()}
    return first, rest
