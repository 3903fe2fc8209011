"""Spatial (macroblock-tile) parallelism with halo exchange.

The reference has no intra-frame parallelism — its raster wavefront is
strictly sequential (SURVEY.md section 2.3).  This module shards the MB
grid of a frame across a `tile` mesh axis (columns of 8x8 blocks) and
keeps *bit-exact* codec semantics at the seams:

* the anti-diagonal wavefront advances in global lockstep on every tile;
* after each step a tile sends its just-computed last-column state
  (reconstructed pixel column, intra mode, dequantized DC) one tile to
  the right via lax.ppermute, and its first-column dequantized DC one
  tile to the left (the DC predictor's upper-right neighbor is the only
  leftward dependency);
* each tile keeps per-row boundary buffers of everything received, so
  first-column cells read their left/upper-left neighbors exactly as the
  single-device engine would.

This is the codec analog of context/sequence parallelism: the "sequence"
is the MB raster, halos are one block column deep, and the collectives
ride the `tile` axis.

Equality with the single-device engine is pinned by tests/test_tiles.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import COS_ENC
from ..ops.medians import median3
from ..ops.quant import c_div, c_trunc, dequant_block, quant_block
from ..ops.scanorder import zigzag
from ..ops.transforms import fdct, idct
from ..engine.intra import DEC_I_KEYS, DEC_P_KEYS
from ..engine.wavefront import luma_dc_kind


def tile_mesh_for(shards: int, devices=None) -> Mesh:
    """Build the `tile` mesh for a production tiled encode/decode over
    the first `shards` devices of the default backend.  A flat list is
    right where every device reaches every other at the same rate: the
    halos only pass between neighbouring tiles."""
    devices = jax.devices() if devices is None else devices
    if len(devices) < shards:
        raise ValueError(
            f"tile_shards={shards} but only {len(devices)} devices are available"
        )
    return Mesh(np.asarray(devices[:shards]), axis_names=("tile",))


# ---------------------------------------------------------------------------
# per-tile schedules
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def tiled_schedule(gh: int, gw: int, ntiles: int):
    """Global-lockstep wavefront schedule split into column tiles.

    Returns numpy arrays indexed [tile, step, lane]:
      gy, gxl (local column), valid — plus per [tile, step]:
      send_r_gy  (row of the last-column cell computed this step, -1 if none)
      send_l_gy  (row of the first-column cell computed this step, -1 if none)
    """
    assert gw % ntiles == 0
    gwl = gw // ntiles
    nsteps = 2 * (gh - 1) + gw
    nmax = min(gh, (gwl + 1) // 2 + 1)
    gys = np.full((ntiles, nsteps, nmax), gh, dtype=np.int32)
    gxs = np.full((ntiles, nsteps, nmax), gwl, dtype=np.int32)
    valid = np.zeros((ntiles, nsteps, nmax), dtype=bool)
    send_r = np.full((ntiles, nsteps), -1, dtype=np.int32)
    send_l = np.full((ntiles, nsteps), -1, dtype=np.int32)
    for t in range(ntiles):
        x0 = t * gwl
        for d in range(nsteps):
            lane = 0
            for gy in range(gh):
                gx = d - 2 * gy
                if x0 <= gx < x0 + gwl:
                    gys[t, d, lane] = gy
                    gxs[t, d, lane] = gx - x0
                    valid[t, d, lane] = True
                    if gx - x0 == gwl - 1:
                        send_r[t, d] = gy
                    if gx - x0 == 0:
                        send_l[t, d] = gy
                    lane += 1
    return gys, gxs, valid, send_r, send_l


# ---------------------------------------------------------------------------
# tiled intra luma wavefront (inside shard_map, axis name "tile")
# ---------------------------------------------------------------------------


def intra_luma_scan_tiled(orig_local: jnp.ndarray, qdc: int, qac: int, gw: int, ntiles: int, axis: str = "tile", table=COS_ENC, dtype=jnp.float32):
    """Per-shard body of the tiled intra luma encoder.

    orig_local: (F, gh, gwl, 8, 8) int32 — this tile's block columns.
    Must run inside shard_map with mesh axis `axis` of size ntiles.
    Semantics identical to engine.wavefront.intra_luma_scan.
    """
    fdim, gh, gwl = orig_local.shape[:3]
    t_idx = jax.lax.axis_index(axis)
    right = [(i, (i + 1) % ntiles) for i in range(ntiles)]
    left = [(i, (i - 1) % ntiles) for i in range(ntiles)]

    gys_all, gxs_all, valid_all, send_r_all, send_l_all = tiled_schedule(gh, gw, ntiles)
    gys = jnp.asarray(gys_all)[t_idx]
    gxs = jnp.asarray(gxs_all)[t_idx]
    valid = jnp.asarray(valid_all)[t_idx]
    send_r = jnp.asarray(send_r_all)[t_idx]
    send_l = jnp.asarray(send_l_all)[t_idx]

    kind_full = luma_dc_kind(gh, gw)
    gwl_ = gw // ntiles
    kindg = jnp.asarray(
        np.stack([kind_full[:, t * gwl_:(t + 1) * gwl_] for t in range(ntiles)])
    )[t_idx]
    ct = np.asarray(table, dtype=dtype)
    is_first_tile = t_idx == 0
    is_last_tile = t_idx == ntiles - 1

    def body(carry, step):
        (recon, modes, dqdc, scanq, mpmf, mbit,
         lb_col, lb_mode, lb_dqdc, rb_dqdc,
         send_r_payload, send_l_payload) = carry
        gy, gxl, v, sr_gy, sl_gy = step

        # --- exchange: deliver last step's boundary state ---
        recv_r = jax.lax.ppermute(send_r_payload, axis, right)   # from left
        recv_l = jax.lax.ppermute(send_l_payload, axis, left)    # from right
        rc, rm, rd, rgy, rvalid = recv_r
        lb_gy = jnp.maximum(rgy, 0)
        upd = rvalid & ~is_first_tile
        lb_col = jnp.where(upd, lb_col.at[:, lb_gy].set(rc), lb_col)
        lb_mode = jnp.where(upd, lb_mode.at[:, lb_gy].set(rm), lb_mode)
        lb_dqdc = jnp.where(upd, lb_dqdc.at[:, lb_gy].set(rd), lb_dqdc)
        ld, lgy, lvalid = recv_l
        rb_gy = jnp.maximum(lgy, 0)
        updl = lvalid & ~is_last_tile
        rb_dqdc = jnp.where(updl, rb_dqdc.at[:, rb_gy].set(ld), rb_dqdc)

        # --- gather cell context ---
        gyc = jnp.minimum(gy, gh - 1)
        gxc = jnp.minimum(gxl, gwl - 1)
        gyu = jnp.maximum(gyc - 1, 0)
        gxleft = jnp.maximum(gxc - 1, 0)
        gxr = jnp.minimum(gxc + 1, gwl - 1)
        first_col = gxc == 0                       # (N,) local first column
        gx_global = gxc + t_idx * gwl
        has_up = (gyc > 0)[None, :]
        has_left = (gx_global > 0)[None, :]
        first = ~has_up & ~has_left

        cur = orig_local[:, gyc, gxc]
        up_row = recon[:, gyu, gxc][..., 7, :]
        left_local = recon[:, gyc, gxleft][..., :, 7]
        left_col = jnp.where(
            first_col[None, :, None], lb_col[:, gyc], left_local
        )

        # --- mode search (identical math to the single-device engine) ---
        e0 = cur - up_row[..., None, :]
        e1 = cur - left_col[..., :, None]
        lsum = jnp.where(has_left, left_col.sum(-1), 1024)
        usum = jnp.where(has_up, up_row.sum(-1), 1024)
        d16 = 16 * cur - (lsum + usum)[..., None, None]
        e2 = jnp.sign(d16) * (jnp.abs(d16) // 16)
        sae0 = jnp.abs(e0).sum((-2, -1))
        sae1 = jnp.abs(e1).sum((-2, -1))
        sae2 = jnp.abs(e2).sum((-2, -1))
        mode_both = jnp.where(
            (sae0 <= sae1) & (sae0 <= sae2), 0, jnp.where(sae1 <= sae2, 1, 2)
        )
        mode = jnp.where(
            first,
            2,
            jnp.where(
                has_up & has_left,
                mode_both,
                jnp.where(has_left, jnp.where(sae2 > sae1, 1, 2), jnp.where(sae2 > sae0, 0, 2)),
            ),
        )
        m = mode[..., None, None]
        err = jnp.where(m == 0, e0, jnp.where(m == 1, e1, e2))

        lm_local = modes[:, gyc, gxleft]
        lm = jnp.where(first_col[None, :], lb_mode[:, gyc], lm_local)
        um = modes[:, gyu, gxc]
        ulm_local = modes[:, gyu, gxleft]
        ulm = jnp.where(first_col[None, :], lb_mode[:, gyu], ulm_local)
        pred_mode = jnp.where(
            has_up & has_left, median3(lm, ulm, um), jnp.where(has_left, lm, um)
        )
        flag = (mode == pred_mode) & ~first
        bit = jnp.where(
            flag | first, 0, jnp.where(pred_mode == 2, (mode == 1), (mode == 2))
        ).astype(jnp.int32)

        # --- transform chain ---
        dct = fdct(err, table=ct, dtype=dtype)
        l_dc = jnp.where(first_col[None, :], lb_dqdc[:, gyc], dqdc[:, gyc, gxleft])
        ul_dc = jnp.where(first_col[None, :], lb_dqdc[:, gyu], dqdc[:, gyu, gxleft])
        u_dc = dqdc[:, gyu, gxc]
        last_col = gxc == gwl - 1
        ur_dc = jnp.where(last_col[None, :], rb_dqdc[:, gyu], dqdc[:, gyu, gxr])
        kv = kindg[gyc, gxc]
        from ..engine.wavefront import _dc_pred

        dc_pred = _dc_pred(kv[None, :], l_dc, ul_dc, u_dc, ur_dc)
        dct = dct.at[..., 0, 0].set(dct[..., 0, 0] - dc_pred.astype(dtype))
        q = quant_block(dct, qdc, qac, chroma=False)
        sc = zigzag(q)
        iq = dequant_block(q, qdc, qac)
        iq = iq.at[..., 0, 0].add(dc_pred)
        new_dqdc = iq[..., 0, 0]
        r = idct(iq, table=ct, dtype=dtype)

        pred0 = jnp.where(
            has_up[..., None, None], up_row[..., None, :].astype(dtype), dtype(128.0)
        ) * jnp.ones((1, 1, 8, 1), dtype)
        pred1 = jnp.where(
            has_left[..., None, None], left_col[..., :, None].astype(dtype), dtype(128.0)
        ) * jnp.ones((1, 1, 1, 8), dtype)
        pv = ((lsum + usum).astype(dtype) / dtype(16.0))[..., None, None]
        predsel = jnp.where(m == 0, pred0, jnp.where(m == 1, pred1, pv))
        rec = jnp.clip(c_trunc(r + predsel), 0, 255)

        gy_s = jnp.where(v, gy, gh)
        recon = recon.at[:, gy_s, gxl].set(rec, mode="drop")
        modes = modes.at[:, gy_s, gxl].set(mode, mode="drop")
        dqdc = dqdc.at[:, gy_s, gxl].set(new_dqdc, mode="drop")
        scanq = scanq.at[:, gy_s, gxl].set(sc, mode="drop")
        mpmf = mpmf.at[:, gy_s, gxl].set(flag.astype(jnp.int32), mode="drop")
        mbit = mbit.at[:, gy_s, gxl].set(bit, mode="drop")

        # --- prepare boundary payloads for the next step ---
        sr = jnp.maximum(sr_gy, 0)
        send_r_payload = (
            recon[:, sr, gwl - 1][..., :, 7],   # (F, 8) pixel column
            modes[:, sr, gwl - 1],
            dqdc[:, sr, gwl - 1],
            sr_gy,
            sr_gy >= 0,
        )
        sl = jnp.maximum(sl_gy, 0)
        send_l_payload = (dqdc[:, sl, 0], sl_gy, sl_gy >= 0)

        carry = (recon, modes, dqdc, scanq, mpmf, mbit,
                 lb_col, lb_mode, lb_dqdc, rb_dqdc,
                 send_r_payload, send_l_payload)
        return carry, None

    zeros_i = lambda *s: jnp.zeros(s, jnp.int32)
    init = (
        zeros_i(fdim, gh, gwl, 8, 8),
        zeros_i(fdim, gh, gwl),
        zeros_i(fdim, gh, gwl),
        zeros_i(fdim, gh, gwl, 64),
        zeros_i(fdim, gh, gwl),
        zeros_i(fdim, gh, gwl),
        zeros_i(fdim, gh, 8),      # lb_col: left-boundary pixel columns
        zeros_i(fdim, gh),         # lb_mode
        zeros_i(fdim, gh),         # lb_dqdc
        zeros_i(fdim, gh),         # rb_dqdc: right-boundary DCs
        (zeros_i(fdim, 8), zeros_i(fdim), zeros_i(fdim),
         jnp.int32(-1), jnp.bool_(False)),
        (zeros_i(fdim), jnp.int32(-1), jnp.bool_(False)),
    )
    # carries become device-varying through ppermute; mark the (replicated)
    # initial values accordingly for shard_map's vma typing
    init = jax.tree.map(lambda x: jax.lax.pcast(x, (axis,), to="varying"), init)
    carry, _ = jax.lax.scan(body, init, (gys, gxs, valid, send_r, send_l))
    recon, modes, dqdc, scanq, mpmf, mbit = carry[:6]
    return dict(recon=recon, scan=scanq, mpm=mpmf, mode_bit=mbit)


def encode_intra_luma_tiled(y: np.ndarray, qdc: int, qac: int, mesh: Mesh, axis: str = "tile", dtype=jnp.float32):
    """Driver: shard (F, H, W) luma frames column-wise over `axis` and run
    the tiled wavefront.  Returns the same outputs as the single-device
    engine, gathered."""
    from ..engine.intra import from_blocks, to_blocks

    ntiles = mesh.shape[axis]
    fdim, h, w = y.shape
    gh, gw = h // 8, w // 8
    blocks = np.asarray(to_blocks(jnp.asarray(y))).astype(np.int32)

    spec = P(None, None, axis)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=dict(recon=spec, scan=spec, mpm=spec, mode_bit=spec),
    )
    def run(blk):
        return intra_luma_scan_tiled(blk, qdc, qac, gw, ntiles, axis=axis, dtype=dtype)

    out = run(jnp.asarray(blocks))
    return dict(
        recon_y=np.asarray(from_blocks(out["recon"].astype(jnp.uint8))),
        y_scan=np.asarray(out["scan"]),
        mpm=np.asarray(out["mpm"]),
        mode_bit=np.asarray(out["mode_bit"]),
    )


# ---------------------------------------------------------------------------
# tiled inter frame (pixel halos for ME/MC; small sequential chains
# replicated via all-gather)
# ---------------------------------------------------------------------------


def _pad_tiled(prev_local: jnp.ndarray, padlen: int, ntiles: int, axis: str):
    """Reference-exact padding for a column tile of the previous recon.

    Exchanges `padlen`-pixel halo columns with the tile neighbors via
    ppermute; outer tiles apply the reference's replicate padding with its
    off-by-one (pad_image quirk: final padded row/column zero).
    prev_local: (..., H, Wl) -> (..., H+2p, Wl+2p)."""
    p = padlen
    t_idx = jax.lax.axis_index(axis)
    right = [(i, (i + 1) % ntiles) for i in range(ntiles)]
    left = [(i, (i - 1) % ntiles) for i in range(ntiles)]
    # halos travel with the top/bottom padding already applied so corners
    # are correct without a second exchange
    core = jnp.pad(prev_local, [(0, 0)] * (prev_local.ndim - 2) + [(p, p), (0, 0)], mode="edge")
    core = core.at[..., -1, :].set(0)  # bottom zero row (reference quirk)
    from_left = jax.lax.ppermute(core[..., -p:], axis, right)
    from_right = jax.lax.ppermute(core[..., :p], axis, left)
    # outer-edge replication for the boundary tiles
    rep_l = jnp.repeat(core[..., :1], p, axis=-1)
    rep_r = jnp.repeat(core[..., -1:], p, axis=-1).at[..., -1].set(0)
    first = t_idx == 0
    last = t_idx == ntiles - 1
    lhalo = jnp.where(first, rep_l, from_left)
    rhalo = jnp.where(last, rep_r, from_right)
    out = jnp.concatenate([lhalo, core, rhalo], axis=-1)
    return out


def encode_inter_frame_tiled(cur_y, cur_cb, cur_cr, prev_y, prev_cb, prev_cr, qdc, qac, gw: int, ntiles: int, axis: str = "tile", table=COS_ENC, dtype=jnp.float32):
    """Per-shard inter frame encode on a column tile (inside shard_map).

    cur_*/prev_*: (F, H, Wl) local tiles.  The heavy work (SAD sweep,
    MC, transforms, reconstruction) is tile-local with ppermute pixel
    halos; the tiny sequential fields (MB motion vectors, transform-DC
    chains) are all-gathered and computed replicated — they are a few KB,
    and replicating a 100-step scalar chain is cheaper than per-step
    boundary traffic.  Semantics identical to engine.inter.encode_inter_frame.
    """
    from ..constants import SPIRAL_UNION
    from ..engine.inter import grid8_to_mb, mb_to_grid8
    from ..engine.intra import from_blocks, to_blocks, _acflag_from_scan
    from ..engine.wavefront import chroma_dc_kind, dc_dpcm_scan
    from ..ops.me import compose_select, gather_pred, mv_diff_field, sad_dense, state_tables
    from ..ops.quant import ac_flag

    f, h, wl = cur_y.shape
    ghl, gwl = h // 8, wl // 8
    t_idx = jax.lax.axis_index(axis)

    pad = _pad_tiled(prev_y, 16, ntiles, axis)
    # stateful-exact ME: the flag/xflag/yflag walk state carries across
    # the GLOBAL MB raster (crossing every tile seam 18x per CIF frame).
    # SADs are tile-local (union offsets span +-16 px = exactly the halo);
    # the per-state selection tables are tiny (F, 4, mbh, mbw_l) ints —
    # all-gather them and run the log-depth raster composition replicated,
    # the same recipe as the MV-prediction and DC chains below.
    sads_u = sad_dense(cur_y, pad, SPIRAL_UNION)
    best_t, steps_t = state_tables(sads_u)            # (F, S, mbh, mbw_l)
    best_full = jax.lax.all_gather(best_t, axis, axis=3, tiled=True)
    steps_full = jax.lax.all_gather(steps_t, axis, axis=3, tiled=True)
    best_u_full = compose_select(best_full, steps_full)
    mv_full = jnp.take(-np.asarray(SPIRAL_UNION), best_u_full, axis=0)
    mv_diff_full = mv_diff_field(mv_full)
    mbw_l = wl // 16
    mv_local = jax.lax.dynamic_slice_in_dim(mv_full, t_idx * mbw_l, mbw_l, axis=2)
    mv_diff = jax.lax.dynamic_slice_in_dim(
        mv_diff_full, t_idx * mbw_l, mbw_l, axis=2
    )

    pred = gather_pred(pad.astype(jnp.int32), mv_local, 16)
    cur16 = grid8_to_mb(to_blocks(cur_y).astype(jnp.int32))
    resid8 = mb_to_grid8(cur16 - pred)
    d = fdct(resid8, table=table, dtype=dtype)

    # DC chain: all-gather the (F, gh, gw) DC plane, run the diagonal scan
    # replicated, slice the local columns back
    d_dc_full = jax.lax.all_gather(d[..., 0, 0], axis, axis=2, tiled=True)
    q_dc_full, dq_dc_full = dc_dpcm_scan(
        d_dc_full, luma_dc_kind(ghl, gw), qdc, chroma=False
    )
    q_dc = jax.lax.dynamic_slice_in_dim(q_dc_full, t_idx * gwl, gwl, axis=2)
    dq_dc = jax.lax.dynamic_slice_in_dim(dq_dc_full, t_idx * gwl, gwl, axis=2)

    q = quant_block(d, qdc, qac, chroma=False)
    q = q.at[..., 0, 0].set(q_dc)
    sc = zigzag(q)
    iq = dequant_block(q, qdc, qac)
    iq = iq.at[..., 0, 0].set(dq_dc)
    r = idct(iq, table=table, dtype=dtype)
    inv16 = grid8_to_mb(c_trunc(r))
    recon16 = jnp.clip(pred + inv16, 0, 255)
    recon_y = from_blocks(mb_to_grid8(recon16)).astype(jnp.uint8)

    out = dict(
        recon_y=recon_y,
        y_scan=sc.astype(jnp.int16),
        y_acflag=_acflag_from_scan(sc).astype(jnp.int8),
        mv_diff=mv_diff.astype(jnp.int16),
    )

    mvc = jnp.sign(mv_local) * (jnp.abs(mv_local) // 2)
    cgw = gw // 2
    for name, plane, prev_plane in (("cb", cur_cb, prev_cb), ("cr", cur_cr, prev_cr)):
        padc = _pad_tiled(prev_plane, 8, ntiles, axis)
        predc = gather_pred(padc.astype(jnp.int32), mvc, 8)
        err = to_blocks(plane).astype(jnp.int32) - predc
        dc_ = fdct(err, table=table, dtype=dtype)
        dcf = jax.lax.all_gather(dc_[..., 0, 0], axis, axis=2, tiled=True)
        qdcf, dqdcf = dc_dpcm_scan(dcf, chroma_dc_kind(h // 16, cgw), qdc, chroma=True)
        cgwl = cgw // ntiles
        q_dcc = jax.lax.dynamic_slice_in_dim(qdcf, t_idx * cgwl, cgwl, axis=2)
        dq_dcc = jax.lax.dynamic_slice_in_dim(dqdcf, t_idx * cgwl, cgwl, axis=2)
        qc = quant_block(dc_, qdc, qac, chroma=True)
        qc = qc.at[..., 0, 0].set(q_dcc)
        scc = zigzag(qc)
        iqc = dequant_block(qc, qdc, qac)
        iqc = iqc.at[..., 0, 0].set(dq_dcc)
        rc = idct(iqc, table=table, dtype=dtype)
        rec = jnp.clip(c_trunc(predc.astype(dtype) + rc), 0, 255)
        out[f"recon_{name}"] = from_blocks(rec).astype(jnp.uint8)
        out[f"{name}_scan"] = scc.astype(jnp.int16)
        out[f"{name}_acflag"] = ac_flag(qc).astype(jnp.int8)
    return out


# ---------------------------------------------------------------------------
# tiled intra chroma + full tiled intra frame (symbols -> bitstream-ready)
# ---------------------------------------------------------------------------


def encode_chroma_tiled(planes_local, qdc: int, qac: int, cgw: int, ntiles: int, axis: str = "tile", table=COS_ENC, dtype=jnp.float32):
    """Per-shard intra/inter chroma chain on a column tile (inside
    shard_map).  planes_local: (F2, Hc, Wcl) pixel planes (intra) or
    (F2, ch, cwl, 8, 8) residual blocks (inter).  Only the DC DPCM chain
    crosses seams: the (F2, ch, cgw) DC plane is all-gathered (a few KB),
    the diagonal scan runs replicated, and the local columns are sliced
    back — same recipe as the tiled inter luma DC chain.
    Semantics identical to engine.intra.encode_chroma_batch
    (reference intraCbCr enc src:1876-1903).

    Replicate-vs-exchange tradeoff: replicating the
    diagonal scan costs every tile O(nsteps(W_global) * F * nmax) scalar
    work + ONE all-gather of the (F, ch, cgw) int plane; per-step
    boundary exchange would cost nsteps ppermutes of (F,) scalars — i.e.
    ~nsteps collective latencies (~1 us ICI each) against a per-step
    vector body that is itself only a few us wide.  The replicated form
    trades negligible compute (the DC scan is sub-ms at CIF and grows
    only linearly in W while per-step latency count grows the same way)
    for nsteps-1 fewer collectives, so it wins whenever per-collective
    latency exceeds the per-step lane work — true for every width this
    codec targets (tiles shrink as W grows, but the scan stays a tiny
    fraction of the per-tile DCT/quant/ME work, which scales with
    W_local * H).  Revisit only if profiling ever shows the replicated
    scan as a top-3 cost at some future resolution."""
    from ..engine.intra import to_blocks
    from ..engine.wavefront import chroma_dc_kind, dc_dpcm_scan
    from ..ops.quant import ac_flag

    if planes_local.ndim == 3:
        blocks = to_blocks(planes_local).astype(jnp.int32)
    else:
        blocks = planes_local
    ch, cwl = blocks.shape[1:3]
    t_idx = jax.lax.axis_index(axis)
    d = fdct(blocks, table=table, dtype=dtype)
    dcf = jax.lax.all_gather(d[..., 0, 0], axis, axis=2, tiled=True)
    q_dcf, dq_dcf = dc_dpcm_scan(dcf, chroma_dc_kind(ch, cgw), qdc, chroma=True)
    q_dc = jax.lax.dynamic_slice_in_dim(q_dcf, t_idx * cwl, cwl, axis=2)
    dq_dc = jax.lax.dynamic_slice_in_dim(dq_dcf, t_idx * cwl, cwl, axis=2)
    q = quant_block(d, qdc, qac, chroma=True)
    q = q.at[..., 0, 0].set(q_dc)
    sc = zigzag(q)
    acf = ac_flag(q)
    iq = dequant_block(q, qdc, qac)
    iq = iq.at[..., 0, 0].set(dq_dc)
    r = idct(iq, table=table, dtype=dtype)
    return dict(scan=sc, acflag=acf, idct=r)


def encode_intra_frame_tiled(y_local, cb_local, cr_local, qdc: int, qac: int, gw: int, ntiles: int, axis: str = "tile", table=COS_ENC, dtype=jnp.float32):
    """Per-shard full intra frame encode (luma wavefront + chroma) on a
    column tile.  Returns the same dict as engine.intra.encode_intra_frames
    (all bitstream symbols + recon planes), tile-local slices."""
    from ..engine.intra import _acflag_from_scan, from_blocks, to_blocks

    orig = to_blocks(y_local).astype(jnp.int32)
    lum = intra_luma_scan_tiled(
        orig, qdc, qac, gw, ntiles, axis=axis, table=table, dtype=dtype
    )
    out = dict(
        recon_y=from_blocks(lum["recon"]).astype(jnp.uint8),
        y_scan=lum["scan"].astype(jnp.int16),
        y_acflag=_acflag_from_scan(lum["scan"]).astype(jnp.int8),
        mpm=lum["mpm"].astype(jnp.int8),
        mode_bit=lum["mode_bit"].astype(jnp.int8),
    )
    f = cb_local.shape[0]
    c = encode_chroma_tiled(
        jnp.concatenate([cb_local, cr_local]), qdc, qac, gw // 2, ntiles,
        axis=axis, table=table, dtype=dtype,
    )
    rec = from_blocks(jnp.clip(c_trunc(c["idct"]), 0, 255).astype(jnp.uint8))
    for i, name in enumerate(("cb", "cr")):
        sl = slice(i * f, (i + 1) * f)
        out[f"recon_{name}"] = rec[sl]
        out[f"{name}_scan"] = c["scan"][sl].astype(jnp.int16)
        out[f"{name}_acflag"] = c["acflag"][sl].astype(jnp.int8)
    return out


def _intra_specs(axis: str):
    """Out specs for the intra output dict: every array is sharded on its
    width-like axis (pixel W for planes, block column for symbol grids)."""
    plane = P(None, None, axis)
    grid3 = P(None, None, axis)           # (F, gh, gw)
    grid4 = P(None, None, axis, None)     # (F, gh, gw, 64)
    return dict(
        recon_y=plane, y_scan=grid4, y_acflag=grid3, mpm=grid3, mode_bit=grid3,
        recon_cb=plane, cb_scan=grid4, cb_acflag=grid3,
        recon_cr=plane, cr_scan=grid4, cr_acflag=grid3,
    )


def encode_intra_frames_tiled(y, cb, cr, qdc: int, qac: int, mesh: Mesh, axis: str = "tile", dtype=jnp.float32):
    """Driver: full tiled intra encode of (F, H, W) frames, width sharded
    over `axis`.  Returns the engine.intra.encode_intra_frames dict —
    symbols feed the bitstream writer directly (bit-exact at seams)."""
    ntiles = mesh.shape[axis]
    h, w = y.shape[-2:]
    if (w // 16) % ntiles:
        raise ValueError(f"ntiles={ntiles} must divide {w // 16} MB columns")
    run = _encode_intra_fn(mesh, axis, qdc, qac, w // 8, dtype)
    return run(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))


@functools.lru_cache(maxsize=None)
def _encode_intra_fn(mesh: Mesh, axis: str, qdc: int, qac: int, gw: int, dtype):
    ntiles = mesh.shape[axis]
    spec = P(None, None, axis)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec,) * 3,
        out_specs=_intra_specs(axis),
    )
    def run(yl, cbl, crl):
        return encode_intra_frame_tiled(
            yl, cbl, crl, qdc, qac, gw, ntiles, axis=axis, dtype=dtype
        )

    return run


def encode_gop_tiled(y, cb, cr, qdc: int, qac: int, mesh: Mesh, axis: str = "tile", dtype=jnp.float32):
    """Driver: tiled encode of (G, P, H, W) closed GOPs — the tile-parallel
    analog of engine.inter.encode_gop.  The per-GOP frame scan runs inside
    shard_map so the recon carry stays tile-local; only halos/DC chains
    cross seams each step.  Returns (intra, inter) like encode_gop."""
    g, p = y.shape[:2]
    ntiles = mesh.shape[axis]
    h, w = y.shape[-2:]
    if (w // 16) % ntiles:
        raise ValueError(f"ntiles={ntiles} must divide {w // 16} MB columns")
    run = _encode_gop_fn(mesh, axis, qdc, qac, w // 8, dtype, p > 1)
    if p == 1:
        return run(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)), None
    intra, inter = run(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
    # scan stacks inter on a leading (P-1) axis -> (G, P-1, ...)
    inter = {k: jnp.moveaxis(v, 0, 1) for k, v in inter.items()}
    return intra, inter


@functools.lru_cache(maxsize=None)
def _encode_gop_fn(mesh: Mesh, axis: str, qdc: int, qac: int, gw: int, dtype, has_inter: bool):
    ntiles = mesh.shape[axis]
    spec = P(None, None, None, axis)
    ispecs = _intra_specs(axis)
    # inter outputs carry an extra leading (P-1) scan axis
    inter_specs = {
        k: P(*((None,) + tuple(ispecs[k])))
        for k in ("recon_y", "y_scan", "y_acflag",
                  "recon_cb", "cb_scan", "cb_acflag",
                  "recon_cr", "cr_scan", "cr_acflag")
    }
    inter_specs["mv_diff"] = P(None, None, None, axis, None)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec,) * 3,
        out_specs=(ispecs, inter_specs) if has_inter else ispecs,
    )
    def run(yl, cbl, crl):
        intra = encode_intra_frame_tiled(
            yl[:, 0], cbl[:, 0], crl[:, 0], qdc, qac, gw, ntiles,
            axis=axis, dtype=dtype,
        )
        if not has_inter:
            return intra

        def step(carry, xs):
            py, pcb, pcr = carry
            cy, ccb, ccr = xs
            o = encode_inter_frame_tiled(
                cy, ccb, ccr, py, pcb, pcr, qdc, qac, gw, ntiles,
                axis=axis, dtype=dtype,
            )
            return (o["recon_y"], o["recon_cb"], o["recon_cr"]), o

        xs = (
            jnp.moveaxis(yl[:, 1:], 1, 0),
            jnp.moveaxis(cbl[:, 1:], 1, 0),
            jnp.moveaxis(crl[:, 1:], 1, 0),
        )
        init = (intra["recon_y"], intra["recon_cb"], intra["recon_cr"])
        _, inter = jax.lax.scan(step, init, xs)
        return intra, inter

    return run


def encode_inter_frames_tiled(cur, prev, qdc: int, qac: int, mesh: Mesh, axis: str = "tile", dtype=jnp.float32):
    """Driver: encode a batch of inter frames with width sharded over
    `axis`.  cur/prev: dicts of (F, H, W) y/cb/cr planes.  Tiles must be
    macroblock-aligned: ntiles has to divide W/16 (22 for CIF)."""
    ntiles = mesh.shape[axis]
    h, w = cur["y"].shape[-2:]
    if (w // 16) % ntiles:
        raise ValueError(f"ntiles={ntiles} must divide {w // 16} MB columns")
    gw = w // 8
    spec = P(None, None, axis)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec,) * 6,
        out_specs=dict(
            recon_y=spec, y_scan=spec, y_acflag=spec, mv_diff=spec,
            recon_cb=spec, cb_scan=spec, cb_acflag=spec,
            recon_cr=spec, cr_scan=spec, cr_acflag=spec,
        ),
    )
    def run(cy, ccb, ccr, py, pcb, pcr):
        return encode_inter_frame_tiled(
            cy, ccb, ccr, py, pcb, pcr, qdc, qac, gw, ntiles, axis=axis, dtype=dtype
        )

    return run(
        jnp.asarray(cur["y"]), jnp.asarray(cur["cb"]), jnp.asarray(cur["cr"]),
        jnp.asarray(prev["y"]), jnp.asarray(prev["cb"]), jnp.asarray(prev["cr"]),
    )


# ---------------------------------------------------------------------------
# tiled decode: intra wavefront with recon/mode halos, inter MC with pixel
# halos.  The reference decoder is serial (decoder src:2083-2272); seam
# semantics mirror the encode-side tiling exactly.
# ---------------------------------------------------------------------------


def intra_luma_decode_scan_tiled(r_local, mpm_local, mbit_local, gw: int, ntiles: int, axis: str = "tile", dtype=jnp.float32):
    """Per-shard tiled intra luma decode wavefront (inside shard_map).

    r_local: (F, gh, gwl, 8, 8) float inverse-DCT blocks (DC chain already
    applied); mpm/mbit: (F, gh, gwl) int32.  Only the reconstructed pixel
    column and the intra mode cross seams (rightward) — the decode
    wavefront has no leftward dependency.  Semantics identical to
    engine.wavefront.intra_luma_decode_scan."""
    fdim, gh, gwl = r_local.shape[:3]
    t_idx = jax.lax.axis_index(axis)
    right = [(i, (i + 1) % ntiles) for i in range(ntiles)]

    gys_all, gxs_all, valid_all, send_r_all, _ = tiled_schedule(gh, gw, ntiles)
    gys = jnp.asarray(gys_all)[t_idx]
    gxs = jnp.asarray(gxs_all)[t_idx]
    valid = jnp.asarray(valid_all)[t_idx]
    send_r = jnp.asarray(send_r_all)[t_idx]
    is_first_tile = t_idx == 0

    def body(carry, step):
        recon, modes, lb_col, lb_mode, send_r_payload = carry
        gy, gxl, v, sr_gy = step

        rc, rm, rgy, rvalid = jax.lax.ppermute(send_r_payload, axis, right)
        lb_gy = jnp.maximum(rgy, 0)
        upd = rvalid & ~is_first_tile
        lb_col = jnp.where(upd, lb_col.at[:, lb_gy].set(rc), lb_col)
        lb_mode = jnp.where(upd, lb_mode.at[:, lb_gy].set(rm), lb_mode)

        gyc = jnp.minimum(gy, gh - 1)
        gxc = jnp.minimum(gxl, gwl - 1)
        gyu = jnp.maximum(gyc - 1, 0)
        gxleft = jnp.maximum(gxc - 1, 0)
        first_col = gxc == 0
        gx_global = gxc + t_idx * gwl
        has_up = (gyc > 0)[None, :]
        has_left = (gx_global > 0)[None, :]
        first = ~has_up & ~has_left

        lm = jnp.where(first_col[None, :], lb_mode[:, gyc], modes[:, gyc, gxleft])
        um = modes[:, gyu, gxc]
        ulm = jnp.where(first_col[None, :], lb_mode[:, gyu], modes[:, gyu, gxleft])
        pred_mode = jnp.where(
            has_up & has_left, median3(lm, ulm, um), jnp.where(has_left, lm, um)
        )
        fl = mpm_local[:, gyc, gxc]
        bt = mbit_local[:, gyc, gxc]
        lo = jnp.where(pred_mode == 0, 1, 0)
        hi = jnp.where(pred_mode == 2, 1, 2)
        mode = jnp.where(
            first, 2, jnp.where(fl == 1, pred_mode, jnp.where(bt == 0, lo, hi))
        )

        up_row = recon[:, gyu, gxc][..., 7, :]
        left_col = jnp.where(
            first_col[None, :, None], lb_col[:, gyc], recon[:, gyc, gxleft][..., :, 7]
        )
        lsum = jnp.where(has_left, left_col.sum(-1), 1024)
        usum = jnp.where(has_up, up_row.sum(-1), 1024)
        m = mode[..., None, None]
        pred0 = jnp.where(
            has_up[..., None, None], up_row[..., None, :].astype(dtype), dtype(128.0)
        ) * jnp.ones((1, 1, 8, 1), dtype)
        pred1 = jnp.where(
            has_left[..., None, None], left_col[..., :, None].astype(dtype), dtype(128.0)
        ) * jnp.ones((1, 1, 1, 8), dtype)
        pv = ((lsum + usum).astype(dtype) / dtype(16.0))[..., None, None]
        predsel = jnp.where(m == 0, pred0, jnp.where(m == 1, pred1, pv))
        rec = jnp.clip(c_trunc(r_local[:, gyc, gxc] + predsel), 0, 255)

        gy_s = jnp.where(v, gy, gh)
        recon = recon.at[:, gy_s, gxl].set(rec, mode="drop")
        modes = modes.at[:, gy_s, gxl].set(mode, mode="drop")

        sr = jnp.maximum(sr_gy, 0)
        send_r_payload = (
            recon[:, sr, gwl - 1][..., :, 7],
            modes[:, sr, gwl - 1],
            sr_gy,
            sr_gy >= 0,
        )
        return (recon, modes, lb_col, lb_mode, send_r_payload), None

    zeros_i = lambda *s: jnp.zeros(s, jnp.int32)
    init = (
        zeros_i(fdim, gh, gwl, 8, 8),
        zeros_i(fdim, gh, gwl),
        zeros_i(fdim, gh, 8),
        zeros_i(fdim, gh),
        (zeros_i(fdim, 8), zeros_i(fdim), jnp.int32(-1), jnp.bool_(False)),
    )
    init = jax.tree.map(lambda x: jax.lax.pcast(x, (axis,), to="varying"), init)
    (recon, _, _, _, _), _ = jax.lax.scan(body, init, (gys, gxs, valid, send_r))
    return recon


def _dc_unchain_tiled(iq_dc_local, kind_full, t_idx, axis: str):
    """All-gather the dequantized DC residual plane, run the inverse DC
    chain replicated, slice the local columns back."""
    from ..engine.wavefront import idc_dpcm_scan

    gwl = iq_dc_local.shape[2]
    full = jax.lax.all_gather(iq_dc_local, axis, axis=2, tiled=True)
    dq = idc_dpcm_scan(full, kind_full)
    return jax.lax.dynamic_slice_in_dim(dq, t_idx * gwl, gwl, axis=2)


def _decode_chroma_tiled(scan_local, qdc: int, qac: int, cgw: int, ntiles: int, axis: str, table, dtype):
    from ..engine.intra import from_blocks
    from ..engine.wavefront import chroma_dc_kind
    from ..ops.scanorder import izigzag

    t_idx = jax.lax.axis_index(axis)
    qc = izigzag(scan_local)
    iqc = dequant_block(qc, qdc, qac)
    ch = qc.shape[1]
    dqc = _dc_unchain_tiled(iqc[..., 0, 0], chroma_dc_kind(ch, cgw), t_idx, axis)
    iqc = iqc.at[..., 0, 0].set(dqc)
    return idct(iqc, table=table, dtype=dtype)


def decode_intra_frame_tiled(sym_local: dict, qdc: int, qac: int, gw: int, ntiles: int, axis: str = "tile", table=None, dtype=jnp.float32):
    """Per-shard intra decode on a column tile: symbols -> planes.
    Semantics identical to engine.intra.decode_intra_frames."""
    from ..constants import COS_DEC
    from ..engine.intra import from_blocks
    from ..ops.scanorder import izigzag

    table = COS_DEC if table is None else table
    t_idx = jax.lax.axis_index(axis)
    q = izigzag(sym_local["y_scan"])
    iq = dequant_block(q, qdc, qac)
    gh = q.shape[1]
    dq_dc = _dc_unchain_tiled(iq[..., 0, 0], luma_dc_kind(gh, gw), t_idx, axis)
    iq = iq.at[..., 0, 0].set(dq_dc)
    r = idct(iq, table=table, dtype=dtype)
    recon = intra_luma_decode_scan_tiled(
        r, sym_local["mpm"].astype(jnp.int32), sym_local["mode_bit"].astype(jnp.int32),
        gw, ntiles, axis=axis, dtype=dtype,
    )
    out = dict(y=from_blocks(recon).astype(jnp.uint8))
    for name in ("cb", "cr"):
        rc = _decode_chroma_tiled(
            sym_local[f"{name}_scan"], qdc, qac, gw // 2, ntiles, axis, table, dtype
        )
        out[name] = from_blocks(
            jnp.clip(c_trunc(rc), 0, 255).astype(jnp.uint8)
        )
    return out


def decode_inter_frame_tiled(sym_local: dict, prev_y, prev_cb, prev_cr, qdc: int, qac: int, gw: int, ntiles: int, axis: str = "tile", table=None, dtype=jnp.float32):
    """Per-shard inter decode on a column tile.  MC reads the previous
    recon through ppermute pixel halos; the MV reconstruction wavefront
    (tiny MB-grid ints) is all-gathered and computed replicated.
    Semantics identical to engine.inter.decode_inter_frame."""
    from ..constants import COS_DEC
    from ..engine.inter import grid8_to_mb, mb_to_grid8, mv_reconstruct_scan
    from ..engine.intra import from_blocks
    from ..ops.me import gather_pred
    from ..ops.scanorder import izigzag

    table = COS_DEC if table is None else table
    t_idx = jax.lax.axis_index(axis)
    if "mv" in sym_local:
        mv = sym_local["mv"]  # precomputed by decode_gop_tiled's hoist
    else:
        mbw_l = sym_local["mv_diff"].shape[2]
        mvd_full = jax.lax.all_gather(sym_local["mv_diff"].astype(jnp.int32), axis, axis=2, tiled=True)
        mv_full = mv_reconstruct_scan(mvd_full)
        mv = jax.lax.dynamic_slice_in_dim(mv_full, t_idx * mbw_l, mbw_l, axis=2)

    q = izigzag(sym_local["y_scan"])
    iq = dequant_block(q, qdc, qac)
    gh = q.shape[1]
    dq_dc = _dc_unchain_tiled(iq[..., 0, 0], luma_dc_kind(gh, gw), t_idx, axis)
    iq = iq.at[..., 0, 0].set(dq_dc)
    inv_f = from_blocks(c_trunc(idct(iq, table=table, dtype=dtype)))

    pad = _pad_tiled(prev_y, 16, ntiles, axis)
    predf = from_blocks(mb_to_grid8(gather_pred(pad.astype(jnp.int32), mv, 16)))
    out = dict(y=jnp.clip(predf + inv_f, 0, 255).astype(jnp.uint8))

    mvc = jnp.sign(mv) * (jnp.abs(mv) // 2)
    for name, prev_plane in (("cb", prev_cb), ("cr", prev_cr)):
        rc = _decode_chroma_tiled(
            sym_local[f"{name}_scan"], qdc, qac, gw // 2, ntiles, axis, table, dtype
        )
        padc = _pad_tiled(prev_plane, 8, ntiles, axis)
        predcf = from_blocks(gather_pred(padc.astype(jnp.int32), mvc, 8))
        rec = jnp.clip(c_trunc(predcf.astype(dtype) + from_blocks(rc)), 0, 255)
        out[name] = rec.astype(jnp.uint8)
    return out


def decode_intra_frames_tiled(sym: dict, qdc: int, qac: int, mesh: Mesh, axis: str = "tile", dtype=jnp.float32):
    """Driver: tiled decode of F intra frames.  sym keys: y_scan, mpm,
    mode_bit, cb_scan, cr_scan (full-frame arrays)."""
    run = _decode_intra_fn(mesh, axis, qdc, qac, sym["y_scan"].shape[2], dtype)
    return run({k: jnp.asarray(sym[k]) for k in DEC_I_KEYS})


def _dec_i_specs(axis: str) -> dict:
    grid3 = P(None, None, axis)
    grid4 = P(None, None, axis, None)
    return dict(y_scan=grid4, mpm=grid3, mode_bit=grid3, cb_scan=grid4, cr_scan=grid4)


@functools.lru_cache(maxsize=None)
def _decode_intra_fn(mesh: Mesh, axis: str, qdc: int, qac: int, gw: int, dtype):
    ntiles = mesh.shape[axis]
    plane = P(None, None, axis)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(_dec_i_specs(axis),),
        out_specs=dict(y=plane, cb=plane, cr=plane),
    )
    def run(s):
        return decode_intra_frame_tiled(s, qdc, qac, gw, ntiles, axis=axis, dtype=dtype)

    return run


def decode_gop_tiled(sym_i: dict, sym_p: dict, qdc: int, qac: int, mesh: Mesh, axis: str = "tile", dtype=jnp.float32):
    """Driver: tiled decode of G GOPs — intra first frame + scanned inter
    frames, recon carry tile-local.  sym_i: (G, ...) intra symbols;
    sym_p: (G, P-1, ...) inter symbols.  Returns (first, rest) plane dicts
    like engine.inter.decode_gop."""
    run = _decode_gop_fn(mesh, axis, qdc, qac, sym_i["y_scan"].shape[2], dtype)
    first, rest = run(
        {k: jnp.asarray(sym_i[k]) for k in DEC_I_KEYS},
        {k: jnp.asarray(sym_p[k]) for k in DEC_P_KEYS},
    )
    rest = {k: jnp.moveaxis(v, 0, 1) for k, v in rest.items()}
    return first, rest


@functools.lru_cache(maxsize=None)
def _decode_gop_fn(mesh: Mesh, axis: str, qdc: int, qac: int, gw: int, dtype):
    ntiles = mesh.shape[axis]
    i_specs = _dec_i_specs(axis)
    p_specs = dict(
        y_scan=P(None, None, None, axis, None),
        mv_diff=P(None, None, None, axis, None),
        cb_scan=P(None, None, None, axis, None),
        cr_scan=P(None, None, None, axis, None),
    )
    plane = P(None, None, axis)
    plane_p = P(None, None, None, axis)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(i_specs, p_specs),
        out_specs=(dict(y=plane, cb=plane, cr=plane),
                   dict(y=plane_p, cb=plane_p, cr=plane_p)),
    )
    def run(si, sp):
        from ..engine.inter import mv_reconstruct_scan

        first = decode_intra_frame_tiled(si, qdc, qac, gw, ntiles, axis=axis, dtype=dtype)
        # hoist MV reconstruction out of the frame scan: all frames'
        # wavefronts run as ONE batched scan on the gathered MB grid,
        # then each tile keeps its local columns
        t_idx = jax.lax.axis_index(axis)
        g, pm1, mbh, mbw_l = sp["mv_diff"].shape[:4]
        mvd_full = jax.lax.all_gather(
            sp["mv_diff"].astype(jnp.int32), axis, axis=3, tiled=True
        )
        mv_full = mv_reconstruct_scan(
            mvd_full.reshape(g * pm1, mbh, mbw_l * ntiles, 2)
        ).reshape(g, pm1, mbh, mbw_l * ntiles, 2)
        mv = jax.lax.dynamic_slice_in_dim(mv_full, t_idx * mbw_l, mbw_l, axis=3)
        sp = dict(sp, mv=mv)

        def step(carry, xs):
            out = decode_inter_frame_tiled(
                xs, carry["y"], carry["cb"], carry["cr"], qdc, qac, gw, ntiles,
                axis=axis, dtype=dtype,
            )
            return out, out

        xs = {k: jnp.moveaxis(sp[k], 1, 0) for k in sp}
        _, rest = jax.lax.scan(step, first, xs)
        return first, rest

    return run
