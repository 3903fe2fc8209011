"""Wavefront engines for the sequentially-dependent codec stages.

The reference walks macroblocks in raster order, sub-blocks 0..3
(allintraPrediction enc src:446-555).  Every sequential dependency —
intra pixel prediction from reconstructed neighbors, the transform-domain
DC DPCM chain, MPM mode prediction — reads only the left / upper-left /
upper / upper-right neighbors on the global 8x8-block grid.  Any
topological order of that DAG yields identical values, so this build
replaces the 396-step raster with the classic 2*gy+gx anti-diagonal
wavefront: ~114 lax.scan steps for CIF, each processing up to 22 blocks
x all frames in the batch as one vectorized step.

Neighbor topology (derived from the reference's 16-way switch blocks,
enc src:851-1499 / 3643-3990; see SURVEY.md section 2):

* sub-block k of MB (by,bx) is global block (gy,gx) = (2by + k//2, 2bx + k%2)
* availability: upper iff gy>0, left iff gx>0
* intra-mode MPM: both -> median(left, upper-left, upper) modes; one
  neighbor -> that mode; (0,0) forced DC with flag=0,bit=0
* DC predictor kinds (luma): (0,0)->1024; gy==0 -> left; gx==0 -> upper;
  (gy odd & gx odd) or (gx odd & right grid edge) -> median(l,ul,u);
  else -> median(l,u,ur)
* DC predictor kinds (chroma, flat grid): (0,0)->1024; first row -> left;
  first col -> upper; right edge -> median(l,ul,u); else median(l,u,ur)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import COS_ENC, IRT2
from ..ops.medians import median3
from ..ops.quant import c_div, c_trunc, quant_block, dequant_block
from ..ops.scanorder import zigzag
from ..ops.transforms import fdct, idct


# ---------------------------------------------------------------------------
# schedules and kind grids (host-side, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def wavefront_schedule(gh: int, gw: int):
    """Anti-diagonal schedule: returns (gy, gx, valid) arrays of shape
    (nsteps, nmax) covering every cell with 2*gy+gx == step."""
    diags: list[list[tuple[int, int]]] = [[] for _ in range(2 * (gh - 1) + gw)]
    for gy in range(gh):
        for gx in range(gw):
            diags[2 * gy + gx].append((gy, gx))
    nmax = max(len(d) for d in diags)
    gys = np.full((len(diags), nmax), gh, dtype=np.int32)  # gh = OOB sentinel
    gxs = np.full((len(diags), nmax), gw, dtype=np.int32)
    valid = np.zeros((len(diags), nmax), dtype=bool)
    for i, cells in enumerate(diags):
        for j, (gy, gx) in enumerate(cells):
            gys[i, j], gxs[i, j], valid[i, j] = gy, gx, True
    return gys, gxs, valid


@functools.lru_cache(maxsize=None)
def luma_dc_kind(gh: int, gw: int) -> np.ndarray:
    """0=const1024 1=left 2=upper 3=med(l,ul,u) 4=med(l,u,ur)."""
    k = np.zeros((gh, gw), dtype=np.int32)
    for gy in range(gh):
        for gx in range(gw):
            if gy == 0 and gx == 0:
                k[gy, gx] = 0
            elif gy == 0:
                k[gy, gx] = 1
            elif gx == 0:
                k[gy, gx] = 2
            elif (gy % 2 == 1 and gx % 2 == 1) or (gx % 2 == 1 and gx == gw - 1):
                k[gy, gx] = 3
            else:
                k[gy, gx] = 4
    return k


@functools.lru_cache(maxsize=None)
def chroma_dc_kind(gh: int, gw: int) -> np.ndarray:
    k = np.zeros((gh, gw), dtype=np.int32)
    for gy in range(gh):
        for gx in range(gw):
            if gy == 0 and gx == 0:
                k[gy, gx] = 0
            elif gy == 0:
                k[gy, gx] = 1
            elif gx == 0:
                k[gy, gx] = 2
            elif gx == gw - 1:
                k[gy, gx] = 3
            else:
                k[gy, gx] = 4
    return k


def _dc_pred(kind, l, ul, u, ur):
    """Select the DC predictor per kind code (all args int32 arrays)."""
    med_lulu = median3(l, ul, u)
    med_luur = median3(l, u, ur)
    return jnp.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [jnp.full_like(l, 1024), l, u, med_lulu],
        med_luur,
    )


# ---------------------------------------------------------------------------
# generic DC DPCM chains (inter luma, chroma, and the decoder inverses)
#
# Diagonal-packed layout: the grid is re-packed to (nsteps, F, nmax) with
# lane = gy - gy_min(step) BEFORE the scan, so each scan step only reads
# shifted lanes of the previous three step-rows (tiny (F, nmax) arrays)
# instead of gathering/scattering the full (F, gh, gw) grid.  All
# neighbor lanes are `lane + per-step-constant`:
#   left  (gy, gx-1)  in step d-1 at lane + gy_min(d)   - gy_min(d-1)
#   up    (gy-1, gx)  in step d-2 at lane + gy_min(d)-1 - gy_min(d-2)
#   ul    (gy-1,gx-1) in step d-3 at lane + gy_min(d)-1 - gy_min(d-3)
#   ur    (gy-1,gx+1) in step d-1 at lane + gy_min(d)-1 - gy_min(d-1)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def diag_layout(gh: int, gw: int):
    """Packed-diagonal layout tables for a (gh, gw) grid."""
    nsteps = 2 * (gh - 1) + gw
    gy_min = np.zeros(nsteps + 3, dtype=np.int64)  # +3: safe d-3 lookups
    counts = np.zeros(nsteps, dtype=np.int64)
    for d in range(nsteps):
        lo = max(0, -((gw - 1 - d) // 2)) if d >= gw else 0
        lo = max(0, (d - (gw - 1) + 1) // 2)
        hi = min(gh - 1, d // 2)
        gy_min[d] = lo
        counts[d] = max(0, hi - lo + 1)
    nmax = int(counts.max())
    # pack/unpack index maps
    pack_idx = np.full((nsteps, nmax), gh * gw, dtype=np.int64)  # OOB sentinel
    cell_step = np.zeros((gh, gw), dtype=np.int64)
    cell_lane = np.zeros((gh, gw), dtype=np.int64)
    for gy in range(gh):
        for gx in range(gw):
            d = 2 * gy + gx
            lane = gy - gy_min[d]
            pack_idx[d, lane] = gy * gw + gx
            cell_step[gy, gx] = d
            cell_lane[gy, gx] = lane
    shifts = np.zeros((nsteps, 4), dtype=np.int64)  # l, u, ul, ur lane shifts
    for d in range(nsteps):
        shifts[d, 0] = gy_min[d] - gy_min[d - 1] if d >= 1 else 0
        shifts[d, 1] = gy_min[d] - 1 - gy_min[d - 2] if d >= 2 else 0
        shifts[d, 2] = gy_min[d] - 1 - gy_min[d - 3] if d >= 3 else 0
        shifts[d, 3] = gy_min[d] - 1 - gy_min[d - 1] if d >= 1 else 0
    return nsteps, nmax, pack_idx, cell_step, cell_lane, shifts


def _pack_diag(x: jnp.ndarray, gh: int, gw: int):
    """(F, gh, gw) -> (nsteps, F, nmax), OOB lanes zero-filled."""
    nsteps, nmax, pack_idx, _, _, _ = diag_layout(gh, gw)
    flat = jnp.asarray(x).reshape(x.shape[0], gh * gw)
    padded = jnp.concatenate(
        [flat, jnp.zeros((x.shape[0], 1), flat.dtype)], axis=1
    )
    out = padded[:, pack_idx]                     # (F, nsteps, nmax)
    return jnp.moveaxis(out, 0, 1)


def _unpack_diag(rows: jnp.ndarray, gh: int, gw: int):
    """(nsteps, F, nmax) -> (F, gh, gw)."""
    _, _, _, cell_step, cell_lane, _ = diag_layout(gh, gw)
    return rows[cell_step, :, cell_lane].transpose(
        2, 0, 1
    )


def _lane_take(row: jnp.ndarray, shift, nmax: int):
    """row: (F, nmax, ...); out[:, lane, ...] = row[:, lane+shift, ...]."""
    idx = jnp.clip(jnp.arange(nmax) + shift, 0, nmax - 1)
    return row[:, idx]


def _pack_diag_nd(x: jnp.ndarray, gh: int, gw: int):
    """(F, gh, gw, *rest) -> (nsteps, F, nmax, *rest), OOB lanes zero."""
    nsteps, nmax, pack_idx, _, _, _ = diag_layout(gh, gw)
    rest = x.shape[3:]
    flat = x.reshape((x.shape[0], gh * gw) + rest)
    padded = jnp.concatenate(
        [flat, jnp.zeros((x.shape[0], 1) + rest, flat.dtype)], axis=1
    )
    out = padded[:, pack_idx]                     # (F, nsteps, nmax, *rest)
    return jnp.moveaxis(out, 0, 1)


def _unpack_diag_nd(rows: jnp.ndarray, gh: int, gw: int):
    """(nsteps, F, nmax, *rest) -> (F, gh, gw, *rest)."""
    _, _, _, cell_step, cell_lane, _ = diag_layout(gh, gw)
    out = rows[cell_step, :, cell_lane]           # (gh, gw, F, *rest)
    return jnp.moveaxis(out, 2, 0)


@functools.lru_cache(maxsize=None)
def _intra_lane_tables(gh: int, gw: int):
    """Per-(step, lane) cell metadata for the packed intra wavefront:
    valid, has_up, has_left (bool) and the luma DC kind, all (nsteps, nmax)."""
    nsteps, nmax, pack_idx, _, _, _ = diag_layout(gh, gw)
    valid = pack_idx != gh * gw
    gy = np.where(valid, pack_idx // gw, 0)
    gx = np.where(valid, pack_idx % gw, 0)
    has_up = valid & (gy > 0)
    has_left = valid & (gx > 0)
    kind = luma_dc_kind(gh, gw)[gy, gx]
    return valid, has_up, has_left, kind.astype(np.int32)


def _dc_chain_scan(vals, kind, gh, gw, step_fn, out_dtypes):
    """Shared machinery: scan over packed diagonals with 3-row history.

    step_fn(val_row, pred) -> (dq_row, extra_row or None)."""
    fdim = vals.shape[0]
    nsteps, nmax, _, _, _, shifts = diag_layout(gh, gw)
    kind_rows = _pack_diag(np.asarray(kind)[None], gh, gw)[:, 0]
    val_rows = _pack_diag(vals, gh, gw)

    def body(carry, xs):
        r1, r2, r3 = carry  # dq rows of steps d-1, d-2, d-3
        vrow, krow, sh = xs
        l = _lane_take(r1, sh[0], nmax)
        u = _lane_take(r2, sh[1], nmax)
        ul = _lane_take(r3, sh[2], nmax)
        ur = _lane_take(r1, sh[3], nmax)
        pred = _dc_pred(krow[None, :], l, ul, u, ur)
        dq, extra = step_fn(vrow, pred)
        return (dq, r1, r2), (dq, extra)

    # derive the zero carry from the input so it inherits the input's
    # varying-manual-axes type under shard_map (a plain jnp.zeros would be
    # replicated and trip the scan carry vma check on tile-sharded runs)
    zero = (val_rows[0] * 0).astype(jnp.int32)
    with jax.named_scope("dc_chain"):
        (_, _, _), (dq_rows, extra_rows) = jax.lax.scan(
            body,
            (zero, zero, zero),
            (val_rows, kind_rows, shifts),
        )
    return dq_rows, extra_rows


def dc_dpcm_scan(dc: jnp.ndarray, kind: np.ndarray, qstep: int, chroma: bool):
    """Forward DC chain: per block, subtract the predictor (from already
    *dequantized* neighbor DCs), quantize, dequantize.

    dc: (F, gh, gw) float DCT DC values.  Returns (q_dc, dq_dc) int32.
    """
    fdim, gh, gw = dc.shape

    def step(vrow, pred):
        resid = vrow - pred.astype(vrow.dtype)
        half = resid + 0.5
        t = jnp.floor(half).astype(jnp.int32) if chroma else c_trunc(half)
        q = c_div(t, qstep)
        dq = q * qstep + pred
        return dq, q

    dq_rows, q_rows = _dc_chain_scan(dc, kind, gh, gw, step, None)
    return _unpack_diag(q_rows, gh, gw), _unpack_diag(dq_rows, gh, gw)


def idc_dpcm_scan(iq_dc: jnp.ndarray, kind: np.ndarray):
    """Inverse DC chain (decoder): dq_dc = iq_dc + predictor, sequential.

    iq_dc: (F, gh, gw) int32 dequantized DC *residuals*.  Returns the
    reconstructed dequantized DC field (F, gh, gw) int32.
    """
    fdim, gh, gw = iq_dc.shape

    def step(vrow, pred):
        dq = vrow + pred
        return dq, dq

    dq_rows, _ = _dc_chain_scan(iq_dc, kind, gh, gw, step, None)
    return _unpack_diag(dq_rows, gh, gw)


# ---------------------------------------------------------------------------
# intra luma: the full wavefront (mode search + transform chain + recon)
# ---------------------------------------------------------------------------


def intra_luma_scan(orig: jnp.ndarray, qdc: int, qac: int, table=COS_ENC, dtype=jnp.float64):
    """Encode one batch of intra luma planes.

    orig: (F, gh, gw, 8, 8) int32 original blocks.
    Returns dict with recon (F,gh,gw,8,8) int32, scan (F,gh,gw,64) int32,
    mpm/mode_bit (F,gh,gw) int32.
    """
    fdim, gh, gw = orig.shape[:3]
    gys, gxs, valid = wavefront_schedule(gh, gw)
    kindg = jnp.asarray(luma_dc_kind(gh, gw))
    ct = np.asarray(table, dtype=dtype)

    def body(carry, step):
        recon, modes, dqdc, scanq, mpmf, mbit = carry
        gy, gx, v = step
        n = gy.shape[0]
        gyc = jnp.minimum(gy, gh - 1)
        gxc = jnp.minimum(gx, gw - 1)
        gyu = jnp.maximum(gyc - 1, 0)
        gxl = jnp.maximum(gxc - 1, 0)
        gxr = jnp.minimum(gxc + 1, gw - 1)
        has_up = (gyc > 0)[None, :]           # (1, N)
        has_left = (gxc > 0)[None, :]
        first = ~has_up & ~has_left

        cur = orig[:, gyc, gxc]                # (F, N, 8, 8)
        up_row = recon[:, gyu, gxc][..., 7, :]     # (F, N, 8)
        left_col = recon[:, gyc, gxl][..., :, 7]   # (F, N, 8)

        # --- candidate residuals and SAEs ---
        e0 = cur - up_row[..., None, :]
        e1 = cur - left_col[..., :, None]
        lsum = jnp.where(has_left, left_col.sum(-1), 1024)   # (F, N)
        usum = jnp.where(has_up, up_row.sum(-1), 1024)
        d16 = 16 * cur - (lsum + usum)[..., None, None]
        e2 = jnp.sign(d16) * (jnp.abs(d16) // 16)
        sae0 = jnp.abs(e0).sum((-2, -1))
        sae1 = jnp.abs(e1).sum((-2, -1))
        sae2 = jnp.abs(e2).sum((-2, -1))

        mode_both = jnp.where(
            (sae0 <= sae1) & (sae0 <= sae2), 0, jnp.where(sae1 <= sae2, 1, 2)
        )
        mode_left = jnp.where(sae2 > sae1, 1, 2)
        mode_up = jnp.where(sae2 > sae0, 0, 2)
        mode = jnp.where(
            first,
            2,
            jnp.where(
                has_up & has_left,
                mode_both,
                jnp.where(has_left, mode_left, mode_up),
            ),
        )
        m = mode[..., None, None]
        err = jnp.where(m == 0, e0, jnp.where(m == 1, e1, e2))

        # --- MPM flag / remainder bit ---
        lm = modes[:, gyc, gxl]
        um = modes[:, gyu, gxc]
        ulm = modes[:, gyu, gxl]
        pred_mode = jnp.where(
            has_up & has_left,
            median3(lm, ulm, um),
            jnp.where(has_left, lm, um),
        )
        flag = (mode == pred_mode) & ~first
        bit = jnp.where(
            flag | first, 0, jnp.where(pred_mode == 2, (mode == 1), (mode == 2))
        ).astype(jnp.int32)

        # --- transform chain ---
        d = fdct(err, table=ct, dtype=dtype)
        l = dqdc[:, gyc, gxl]
        u = dqdc[:, gyu, gxc]
        ul = dqdc[:, gyu, gxl]
        ur = dqdc[:, gyu, gxr]
        kv = kindg[gyc, gxc]
        dc_pred = _dc_pred(kv[None, :], l, ul, u, ur)
        # scatter-SET of the precomputed difference: a float scatter-add
        # here gets contracted by XLA with the quantizer's +0.5, flipping
        # half-ulp rounding ties vs. the C order (d - pred) + 0.5
        d = d.at[..., 0, 0].set(d[..., 0, 0] - dc_pred.astype(dtype))
        q = quant_block(d, qdc, qac, chroma=False)
        sc = zigzag(q)
        iq = dequant_block(q, qdc, qac)
        iq = iq.at[..., 0, 0].add(dc_pred)
        new_dqdc = iq[..., 0, 0]
        r = idct(iq, table=ct, dtype=dtype)

        # --- pixel reconstruction ---
        pred0 = jnp.where(
            has_up[..., None, None],
            up_row[..., None, :].astype(dtype),
            dtype(128.0),
        ) * jnp.ones((1, 1, 8, 1), dtype)
        pred1 = jnp.where(
            has_left[..., None, None],
            left_col[..., :, None].astype(dtype),
            dtype(128.0),
        ) * jnp.ones((1, 1, 1, 8), dtype)
        pv = ((lsum + usum).astype(dtype) / dtype(16.0))[..., None, None]
        predsel = jnp.where(m == 0, pred0, jnp.where(m == 1, pred1, pv))
        rec = jnp.clip(c_trunc(r + predsel), 0, 255)

        # --- scatter (invalid lanes dropped via OOB row index) ---
        gy_s = jnp.where(v, gy, gh)
        recon = recon.at[:, gy_s, gx].set(rec, mode="drop")
        modes = modes.at[:, gy_s, gx].set(mode, mode="drop")
        dqdc = dqdc.at[:, gy_s, gx].set(new_dqdc, mode="drop")
        scanq = scanq.at[:, gy_s, gx].set(sc, mode="drop")
        mpmf = mpmf.at[:, gy_s, gx].set(flag.astype(jnp.int32), mode="drop")
        mbit = mbit.at[:, gy_s, gx].set(bit, mode="drop")
        return (recon, modes, dqdc, scanq, mpmf, mbit), None

    init = (
        jnp.zeros((fdim, gh, gw, 8, 8), jnp.int32),
        jnp.zeros((fdim, gh, gw), jnp.int32),
        jnp.zeros((fdim, gh, gw), jnp.int32),
        jnp.zeros((fdim, gh, gw, 64), jnp.int32),
        jnp.zeros((fdim, gh, gw), jnp.int32),
        jnp.zeros((fdim, gh, gw), jnp.int32),
    )
    (recon, modes, dqdc, scanq, mpmf, mbit), _ = jax.lax.scan(
        body, init, (gys, gxs, valid)
    )
    return dict(recon=recon, modes=modes, scan=scanq, mpm=mpmf, mode_bit=mbit)


# ---------------------------------------------------------------------------
# packed-diagonal intra luma wavefront: the throughput formulation.
#
# intra_luma_scan above scatters/gathers the full (F, gh, gw, 8, 8) grid
# every step — correct but latency-bound (114 dynamic gathers + scatters
# of ~120 MB carries for CIF).  This variant applies the DC chains'
# packed-diagonal recipe to the WHOLE wavefront: inputs are pre-packed to
# (nsteps, F, nmax, ...) rows, each step reads only constant-shifted
# lanes of the previous three steps' boundary state (right pixel column,
# bottom pixel row, mode, dequantized DC — a few hundred KB), and all
# grid-shaped outputs are emitted as scan ys and unpacked once at the
# end.  Math is identical expression-for-expression to intra_luma_scan
# (bit-exactness pinned by tests/test_engine equality + goldens).
# ---------------------------------------------------------------------------


def intra_luma_scan_packed(orig: jnp.ndarray, qdc: int, qac: int, table=COS_ENC, dtype=jnp.float64):
    """Packed-diagonal intra luma encoder; same contract as
    intra_luma_scan: orig (F, gh, gw, 8, 8) int32 -> dict(recon, scan,
    mpm, mode_bit) on the (F, gh, gw, ...) grid."""
    fdim, gh, gw = orig.shape[:3]
    nsteps, nmax, _, _, _, shifts = diag_layout(gh, gw)
    valid, has_up_t, has_left_t, kind_t = _intra_lane_tables(gh, gw)
    ct = np.asarray(table, dtype=dtype)

    orows = _pack_diag_nd(orig, gh, gw)           # (nsteps, F, nmax, 8, 8)
    xs = (
        orows,
        jnp.asarray(kind_t),
        jnp.asarray(shifts),
        jnp.asarray(has_up_t),
        jnp.asarray(has_left_t),
    )

    def body(carry, step):
        h1, h2, h3 = carry  # boundary rows of steps d-1, d-2, d-3
        cur, krow, sh, hu, hl = step
        has_up = hu[None, :]
        has_left = hl[None, :]
        first = ~has_up & ~has_left

        l_rc, l_md, l_dq = (_lane_take(h1[i], sh[0], nmax) for i in (0, 2, 3))
        ur_dq = _lane_take(h1[3], sh[3], nmax)
        u_br, u_md, u_dq = (_lane_take(h2[i], sh[1], nmax) for i in (1, 2, 3))
        ul_md = _lane_take(h3[2], sh[2], nmax)
        ul_dq = _lane_take(h3[3], sh[2], nmax)

        up_row = u_br                               # (F, nmax, 8)
        left_col = l_rc

        # --- candidate residuals and SAEs (identical to intra_luma_scan) ---
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
                jnp.where(
                    has_left, jnp.where(sae2 > sae1, 1, 2), jnp.where(sae2 > sae0, 0, 2)
                ),
            ),
        )
        m = mode[..., None, None]
        err = jnp.where(m == 0, e0, jnp.where(m == 1, e1, e2))

        # --- MPM flag / remainder bit ---
        pred_mode = jnp.where(
            has_up & has_left, median3(l_md, ul_md, u_md), jnp.where(has_left, l_md, u_md)
        )
        flag = (mode == pred_mode) & ~first
        bit = jnp.where(
            flag | first, 0, jnp.where(pred_mode == 2, (mode == 1), (mode == 2))
        ).astype(jnp.int32)

        # --- transform chain ---
        d = fdct(err, table=ct, dtype=dtype)
        dc_pred = _dc_pred(krow[None, :], l_dq, ul_dq, u_dq, ur_dq)
        # scatter-SET of the precomputed difference (anti-FMA; see
        # intra_luma_scan)
        d = d.at[..., 0, 0].set(d[..., 0, 0] - dc_pred.astype(dtype))
        q = quant_block(d, qdc, qac, chroma=False)
        sc = zigzag(q)
        iq = dequant_block(q, qdc, qac)
        iq = iq.at[..., 0, 0].add(dc_pred)
        new_dq = iq[..., 0, 0]
        r = idct(iq, table=ct, dtype=dtype)

        # --- pixel reconstruction ---
        pred0 = jnp.where(
            has_up[..., None, None], up_row[..., None, :].astype(dtype), dtype(128.0)
        ) * jnp.ones((1, 1, 8, 1), dtype)
        pred1 = jnp.where(
            has_left[..., None, None], left_col[..., :, None].astype(dtype), dtype(128.0)
        ) * jnp.ones((1, 1, 1, 8), dtype)
        pv = ((lsum + usum).astype(dtype) / dtype(16.0))[..., None, None]
        predsel = jnp.where(m == 0, pred0, jnp.where(m == 1, pred1, pv))
        rec = jnp.clip(c_trunc(r + predsel), 0, 255)

        new = (
            rec[..., :, 7].astype(jnp.int32),
            rec[..., 7, :].astype(jnp.int32),
            mode.astype(jnp.int32),
            new_dq.astype(jnp.int32),
        )
        return (new, h1, h2), (
            rec.astype(jnp.int32),
            sc.astype(jnp.int32),
            flag.astype(jnp.int32),
            bit.astype(jnp.int32),
        )

    zrow8 = jnp.zeros((fdim, nmax, 8), jnp.int32)
    zrow = jnp.zeros((fdim, nmax), jnp.int32)
    hinit = (zrow8, zrow8, zrow, zrow)
    _, (rec_rows, sc_rows, mpm_rows, bit_rows) = jax.lax.scan(
        body, (hinit, hinit, hinit), xs
    )
    return dict(
        recon=_unpack_diag_nd(rec_rows, gh, gw),
        scan=_unpack_diag_nd(sc_rows, gh, gw),
        mpm=_unpack_diag_nd(mpm_rows, gh, gw),
        mode_bit=_unpack_diag_nd(bit_rows, gh, gw),
    )


# ---------------------------------------------------------------------------
# intra luma decode wavefront (no mode search; modes from MPM bits)
# ---------------------------------------------------------------------------


def intra_luma_decode_scan_packed(r: jnp.ndarray, mpmf: jnp.ndarray, mbit: jnp.ndarray, dtype=jnp.float64):
    """Packed-diagonal decode wavefront; same contract as
    intra_luma_decode_scan (bit-identical, throughput formulation)."""
    fdim, gh, gw = r.shape[:3]
    nsteps, nmax, _, _, _, shifts = diag_layout(gh, gw)
    _, has_up_t, has_left_t, _ = _intra_lane_tables(gh, gw)

    xs = (
        _pack_diag_nd(r, gh, gw),
        _pack_diag(mpmf, gh, gw),
        _pack_diag(mbit, gh, gw),
        jnp.asarray(shifts),
        jnp.asarray(has_up_t),
        jnp.asarray(has_left_t),
    )

    def body(carry, step):
        h1, h2, h3 = carry  # (right col, bottom row, mode) of d-1, d-2, d-3
        rrow, fl, bt, sh, hu, hl = step
        has_up = hu[None, :]
        has_left = hl[None, :]
        first = ~has_up & ~has_left

        left_col = _lane_take(h1[0], sh[0], nmax)
        l_md = _lane_take(h1[2], sh[0], nmax)
        up_row = _lane_take(h2[1], sh[1], nmax)
        u_md = _lane_take(h2[2], sh[1], nmax)
        ul_md = _lane_take(h3[2], sh[2], nmax)

        pred_mode = jnp.where(
            has_up & has_left, median3(l_md, ul_md, u_md), jnp.where(has_left, l_md, u_md)
        )
        lo = jnp.where(pred_mode == 0, 1, 0)
        hi = jnp.where(pred_mode == 2, 1, 2)
        mode = jnp.where(first, 2, jnp.where(fl == 1, pred_mode, jnp.where(bt == 0, lo, hi)))

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
        rec = jnp.clip(c_trunc(rrow + predsel), 0, 255)

        new = (
            rec[..., :, 7].astype(jnp.int32),
            rec[..., 7, :].astype(jnp.int32),
            mode.astype(jnp.int32),
        )
        return (new, h1, h2), rec.astype(jnp.int32)

    zrow8 = jnp.zeros((fdim, nmax, 8), jnp.int32)
    zrow = jnp.zeros((fdim, nmax), jnp.int32)
    hinit = (zrow8, zrow8, zrow)
    _, rec_rows = jax.lax.scan(body, (hinit, hinit, hinit), xs)
    return _unpack_diag_nd(rec_rows, gh, gw)


def intra_luma_decode_scan(r: jnp.ndarray, mpmf: jnp.ndarray, mbit: jnp.ndarray, dtype=jnp.float64):
    """Reconstruct intra luma pixels from inverse-DCT blocks + mode bits.

    r: (F, gh, gw, 8, 8) float inverse-DCT output (DC chain already
    applied).  Returns recon blocks (F, gh, gw, 8, 8) int32.
    """
    fdim, gh, gw = r.shape[:3]
    gys, gxs, valid = wavefront_schedule(gh, gw)

    def body(carry, step):
        recon, modes = carry
        gy, gx, v = step
        gyc = jnp.minimum(gy, gh - 1)
        gxc = jnp.minimum(gx, gw - 1)
        gyu = jnp.maximum(gyc - 1, 0)
        gxl = jnp.maximum(gxc - 1, 0)
        has_up = (gyc > 0)[None, :]
        has_left = (gxc > 0)[None, :]
        first = ~has_up & ~has_left

        lm = modes[:, gyc, gxl]
        um = modes[:, gyu, gxc]
        ulm = modes[:, gyu, gxl]
        pred_mode = jnp.where(
            has_up & has_left, median3(lm, ulm, um), jnp.where(has_left, lm, um)
        )
        fl = mpmf[:, gyc, gxc]
        bt = mbit[:, gyc, gxc]
        lo = jnp.where(pred_mode == 0, 1, 0)
        hi = jnp.where(pred_mode == 2, 1, 2)
        mode = jnp.where(first, 2, jnp.where(fl == 1, pred_mode, jnp.where(bt == 0, lo, hi)))

        up_row = recon[:, gyu, gxc][..., 7, :]
        left_col = recon[:, gyc, gxl][..., :, 7]
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
        rec = jnp.clip(c_trunc(r[:, gyc, gxc] + predsel), 0, 255)

        gy_s = jnp.where(v, gy, gh)
        recon = recon.at[:, gy_s, gx].set(rec, mode="drop")
        modes = modes.at[:, gy_s, gx].set(mode, mode="drop")
        return (recon, modes), None

    init = (
        jnp.zeros((fdim, gh, gw, 8, 8), jnp.int32),
        jnp.zeros((fdim, gh, gw), jnp.int32),
    )
    (recon, _), _ = jax.lax.scan(
        body, init, (gys, gxs, valid)
    )
    return recon
