"""Top-level encode/decode API.

encode(): device-side engines produce whole-sequence symbol + recon
arrays (intra batches + per-GOP lax.scans); the host packs the bitstream
with the vectorized numpy writer.

decode(): the native C parser (runtime/) produces fixed-shape symbol
arrays; the device runs the batched inverse pipelines.

Two precision regimes (config.precision):
  exact — float64 with the encoder's float-rounded cosine table on the
          forward path: bit-exact vs. the C++ reference encoder.
  fast  — float32: the throughput path; identical structure, results
          may differ by +-1 quantization level at rounding ties.
The decode side always uses the decoder-regime double table (COS_DEC),
matching the C++ reference decoder bit-for-bit in exact mode.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .config import CodecConfig
from .constants import COS_DEC, COS_ENC
from .bitstream import write_bitstream_grouped
from .engine.inter import decode_gop, encode_gop
from .engine.intra import DEC_I_KEYS, DEC_P_KEYS, decode_intra_frames, encode_intra_frames
from .oracle import parse_header
from .runtime import parse_body

_INTRA_KEYS = (
    "y_scan", "mpm", "mode_bit", "cb_scan", "cb_acflag", "cr_scan", "cr_acflag",
)
_INTER_KEYS = (
    "y_scan", "mv_diff", "cb_scan", "cb_acflag", "cr_scan", "cr_acflag",
)


def _dt(exact: bool):
    return jnp.float64 if exact else jnp.float32


def _acflag(scan: np.ndarray) -> np.ndarray:
    return (np.count_nonzero(scan[..., 1:], axis=-1) == 0).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("qdc", "qac", "exact"))
def _encode_intra_jit(y, cb, cr, qdc, qac, exact):
    return encode_intra_frames(y, cb, cr, qdc, qac, table=COS_ENC, dtype=_dt(exact))


@functools.partial(jax.jit, static_argnames=("qdc", "qac", "exact"))
def _encode_gop_jit(y, cb, cr, qdc, qac, exact):
    return encode_gop(y, cb, cr, qdc, qac, table=COS_ENC, dtype=_dt(exact))


# ---------------------------------------------------------------------------
# device-entropy encode path (SURVEY section 7 M4): the engine output stays
# on the device; frame items + bit packing run there too, and only packed
# frames (~the bitstream size instead of ~150 MB of symbols) reach the host
# ---------------------------------------------------------------------------


def _items(sym, is_intra):
    from .bitstream_device import frame_items_dev

    # materialize the engine outputs once: without the barrier XLA
    # duplicates the diagonal-row unpack gathers into every item consumer
    sym = jax.lax.optimization_barrier(sym)
    with jax.named_scope("entropy_items"):
        return frame_items_dev(sym, is_intra)


@functools.partial(jax.jit, static_argnames=("qdc", "qac", "exact", "want_recon"))
def _encode_intra_items_jit(y, cb, cr, qdc, qac, exact, want_recon=True):
    out = encode_intra_frames(y, cb, cr, qdc, qac, table=COS_ENC, dtype=_dt(exact),
                              return_recon=want_recon)
    codes, lengths = _items({k: out[k] for k in _INTRA_KEYS + ("y_acflag",)}, True)
    recons = (
        (out["recon_y"], out["recon_cb"], out["recon_cr"])
        if want_recon else None
    )
    return codes, lengths, recons


@functools.partial(jax.jit, static_argnames=("qdc", "qac", "exact"))
def _encode_gop_items_jit(y, cb, cr, qdc, qac, exact):
    intra, inter = encode_gop(y, cb, cr, qdc, qac, table=COS_ENC, dtype=_dt(exact))
    ci, li = _items({k: intra[k] for k in _INTRA_KEYS + ("y_acflag",)}, True)
    psym = {
        k: inter[k].reshape((-1,) + inter[k].shape[2:])
        for k in _INTER_KEYS + ("y_acflag",)
    }
    cp, lp = _items(psym, False)
    recons = (
        (intra["recon_y"], intra["recon_cb"], intra["recon_cr"]),
        (inter["recon_y"], inter["recon_cb"], inter["recon_cr"]),
    )
    return (ci, li), (cp, lp), recons


def _pack_bucketed(codes, lengths, slab: int = 32):
    """Pack (F, N) device items into per-frame byte rows.

    Pulls only the per-frame bit counts to size a static byte bucket
    (8 KB granularity keeps the jit cache warm across runs), then packs
    `slab` frames per dispatch to bound the expand buffer.  All slabs
    are dispatched before any row is pulled, so the async queue overlaps
    each slab's device pack with the previous slab's host readback."""
    from .bitstream_device import pack_frames_dev

    nb = np.asarray(jnp.sum(lengths, axis=1))
    maxbytes = int(-(-int(nb.max()) // (8 * 8192)) * 8192)
    f = codes.shape[0]
    outs = [
        pack_frames_dev(codes[s:s + slab], lengths[s:s + slab], maxbytes)
        for s in range(0, f, slab)
    ]
    rows, bits = [], []
    for p, n in outs:
        rows += list(np.asarray(p))
        bits += [int(v) for v in np.asarray(n)]
    return rows, bits


def _gop_batches(nf: int, eff: int):
    """Frame indices of the closed GOPs as (G, P) index arrays: one batch
    of full GOPs, then the shorter tail GOP on its own."""
    nfull, rem = divmod(nf, eff)
    batches = []
    if nfull:
        batches.append(np.arange(nfull * eff).reshape(nfull, eff))
    if rem:
        batches.append(np.arange(nfull * eff, nf).reshape(1, rem))
    return batches


def _check_x64(exact: bool, what: str):
    if exact and not jax.config.jax_enable_x64:
        raise RuntimeError(
            f"precision='exact' needs float64: call "
            f"jax.config.update('jax_enable_x64', True) before {what}, "
            "or use precision='fast'"
        )


def _encode_device_entropy(y, cb, cr, cfg: CodecConfig, return_recon: bool):
    """encode() body for the device-entropy path (no mesh, any precision).
    Returns (bits, recon-or-None); bytes identical to the host writer."""
    from .bitstream_device import assemble_frames
    from .oracle import pack_header

    nf = y.shape[0]
    exact = cfg.precision == "exact"
    rows: list = [None] * nf
    bits_per: list = [None] * nf
    rec = (
        dict(y=np.zeros_like(y), cb=np.zeros_like(cb), cr=np.zeros_like(cr))
        if return_recon else None
    )

    def put(codes, lengths, idxs):
        r, b = _pack_bucketed(codes, lengths)
        for j, n in enumerate(idxs):
            rows[n], bits_per[n] = r[j], b[j]

    def pull_recon(tree, idxs):
        if rec is None:
            return
        ry, rcb, rcr = tree
        rec["y"][idxs] = np.asarray(ry).reshape((-1,) + y.shape[1:])
        rec["cb"][idxs] = np.asarray(rcb).reshape((-1,) + cb.shape[1:])
        rec["cr"][idxs] = np.asarray(rcr).reshape((-1,) + cr.shape[1:])

    for idx in _gop_batches(nf, cfg.eff_period):
        g, p = idx.shape
        yb = y[idx.ravel()].reshape(g, p, *y.shape[1:])
        cbb = cb[idx.ravel()].reshape(g, p, *cb.shape[1:])
        crb = cr[idx.ravel()].reshape(g, p, *cr.shape[1:])
        if p == 1:
            ci, li, recon_t = _encode_intra_items_jit(
                yb[:, 0], cbb[:, 0], crb[:, 0], cfg.qp_dc, cfg.qp_ac, exact,
                want_recon=return_recon,
            )
            put(ci, li, idx[:, 0])
            pull_recon(recon_t, idx[:, 0])
            continue
        (ci, li), (cp, lp), recons = _encode_gop_items_jit(
            yb, cbb, crb, cfg.qp_dc, cfg.qp_ac, exact
        )
        put(ci, li, idx[:, 0])
        put(cp, lp, idx[:, 1:].ravel())
        pull_recon(recons[0], idx[:, 0])
        pull_recon(recons[1], idx[:, 1:].ravel())

    body = assemble_frames(rows, bits_per)
    bits = pack_header(
        cfg.height, cfg.width, cfg.qp_dc, cfg.qp_ac, cfg.intra_period
    ) + body
    return bits, rec


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def encode(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, cfg: CodecConfig,
           return_recon: bool = True):
    """y: (F, H, W) uint8; cb/cr: (F, H/2, W/2).  Returns (bitstream bytes,
    recon dict of (F, ...) uint8 planes — or None with return_recon=False,
    which skips the recon readback entirely).

    cfg.gop_shards > 1 runs the GOP batches SPMD over a `gop` device mesh
    (the --EnMultiThread analog, reference enc src:150-157 +
    ICSP_thread.cpp:39-77); the bitstream is byte-identical at any shard
    count because closed GOPs share no state and the host writer orders
    items by frame index, exactly like the reference's per-GOP job queue.

    cfg.entropy selects where entropy coding runs: "device" (or "auto" on
    the plain unsharded path) keeps symbols on the accelerator and pulls
    only packed frames (bitstream_device.py); "host" pulls symbol arrays
    and packs with the numpy/C writer.  Output bytes are identical.
    """
    nf = y.shape[0]
    exact = cfg.precision == "exact"
    _check_x64(exact, "encoding")
    plain = cfg.gop_shards == 1 and cfg.tile_shards == 1
    if cfg.entropy == "device" and not plain:
        raise ValueError(
            "entropy='device' requires the unsharded path "
            "(gop_shards == tile_shards == 1); use entropy='auto'"
        )
    if plain and cfg.entropy != "host":
        return _encode_device_entropy(y, cb, cr, cfg, return_recon)
    mesh = None
    if cfg.gop_shards > 1:
        from .parallel.gop import mesh_for

        mesh = mesh_for(cfg.gop_shards)
    tmesh = None
    if cfg.tile_shards > 1:
        from .parallel.tiles import tile_mesh_for

        tmesh = tile_mesh_for(cfg.tile_shards)
    dt = _dt(exact)

    rec_y = np.zeros_like(y)
    rec_cb = np.zeros_like(cb)
    rec_cr = np.zeros_like(cr)
    intra_groups: list = []   # (syms dict, frame indices)
    inter_groups: list = []

    def encode_intra(yi, cbi, cri):
        if tmesh is not None:
            from .parallel.tiles import encode_intra_frames_tiled

            return _np(encode_intra_frames_tiled(
                yi, cbi, cri, cfg.qp_dc, cfg.qp_ac, tmesh, dtype=dt
            ))
        if mesh is not None:
            from .parallel.gop import encode_intra_padded

            return encode_intra_padded(yi, cbi, cri, cfg.qp_dc, cfg.qp_ac, mesh, dtype=dt)
        return _np(_encode_intra_jit(yi, cbi, cri, cfg.qp_dc, cfg.qp_ac, exact))

    def encode_gops(yb, cbb, crb):
        if tmesh is not None:
            from .parallel.tiles import encode_gop_tiled

            intra, inter = encode_gop_tiled(
                yb, cbb, crb, cfg.qp_dc, cfg.qp_ac, tmesh, dtype=dt
            )
            return _np(intra), _np(inter)
        if mesh is not None:
            from .parallel.gop import encode_gops_padded

            return encode_gops_padded(yb, cbb, crb, cfg.qp_dc, cfg.qp_ac, mesh, dtype=dt)
        return _np(_encode_gop_jit(yb, cbb, crb, cfg.qp_dc, cfg.qp_ac, exact))

    for idx in _gop_batches(nf, cfg.eff_period):
        g, p = idx.shape
        yb = y[idx.ravel()].reshape(g, p, *y.shape[1:])
        cbb = cb[idx.ravel()].reshape(g, p, *cb.shape[1:])
        crb = cr[idx.ravel()].reshape(g, p, *cr.shape[1:])
        if p == 1:
            intra, inter = encode_intra(yb[:, 0], cbb[:, 0], crb[:, 0]), None
        else:
            intra, inter = encode_gops(yb, cbb, crb)
        iidx = idx[:, 0]
        sym = {k: intra[k] for k in _INTRA_KEYS}
        sym["y_acflag"] = _acflag(sym["y_scan"])
        intra_groups.append((sym, iidx))
        rec_y[iidx] = intra["recon_y"]
        rec_cb[iidx] = intra["recon_cb"]
        rec_cr[iidx] = intra["recon_cr"]
        if inter is not None:
            pidx = idx[:, 1:].ravel()
            sym = {
                k: inter[k].reshape(-1, *inter[k].shape[2:]) for k in _INTER_KEYS
            }
            sym["y_acflag"] = _acflag(sym["y_scan"])
            inter_groups.append((sym, pidx))
            rec_y[pidx] = inter["recon_y"].reshape(-1, *y.shape[1:])
            rec_cb[pidx] = inter["recon_cb"].reshape(-1, *cb.shape[1:])
            rec_cr[pidx] = inter["recon_cr"].reshape(-1, *cr.shape[1:])

    def merge(groups):
        if not groups:
            return None, None
        syms = {
            k: np.concatenate([g[0][k] for g in groups]) for k in groups[0][0]
        }
        idxs = np.concatenate([g[1] for g in groups])
        return syms, idxs

    i_syms, i_idx = merge(intra_groups)
    p_syms, p_idx = merge(inter_groups)
    bits = write_bitstream_grouped(
        i_syms, i_idx, p_syms, p_idx, nf,
        cfg.height, cfg.width, cfg.qp_dc, cfg.qp_ac, cfg.intra_period,
    )
    return bits, (dict(y=rec_y, cb=rec_cb, cr=rec_cr) if return_recon else None)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------



@functools.partial(jax.jit, static_argnames=("qdc", "qac", "exact"))
def _decode_intra_jit(sym, qdc, qac, exact):
    return decode_intra_frames(
        *(sym[k] for k in DEC_I_KEYS), qdc, qac, table=COS_DEC, dtype=_dt(exact)
    )


@functools.partial(jax.jit, static_argnames=("qdc", "qac", "exact"))
def _decode_gop_jit(sym_i, sym_p, qdc, qac, exact):
    return decode_gop(sym_i, sym_p, qdc, qac, table=COS_DEC, dtype=_dt(exact))


def decode(data: bytes, nframes: int, precision: str = "exact", gop_shards: int = 1,
           tile_shards: int = 1):
    """Decode a bitstream; returns dict of (F, ...) uint8 planes.

    gop_shards > 1 decodes GOP batches SPMD over a `gop` device mesh
    (planes identical at any shard count; the reference decoder is serial,
    so this has no referent — it mirrors the encode-side sharding).
    tile_shards > 1 shards each frame's width over a `tile` mesh with halo
    exchange instead (mutually exclusive with gop_shards)."""
    if gop_shards > 1 and tile_shards > 1:
        raise ValueError("gop_shards and tile_shards are mutually exclusive")
    height, width, qdc, qac, period = parse_header(data[:14])
    syms = parse_body(data[14:], nframes, height, width, period)
    exact = precision == "exact"
    _check_x64(exact, "decoding")
    mesh = None
    if gop_shards > 1:
        from .parallel.gop import mesh_for

        mesh = mesh_for(gop_shards)
    tmesh = None
    if tile_shards > 1:
        from .parallel.tiles import tile_mesh_for

        tmesh = tile_mesh_for(tile_shards)
    dt = _dt(exact)

    def decode_intra(sym_i):
        if tmesh is not None:
            from .parallel.tiles import decode_intra_frames_tiled

            return _np(decode_intra_frames_tiled(sym_i, qdc, qac, tmesh, dtype=dt))
        if mesh is not None:
            from .parallel.gop import decode_intra_padded

            return decode_intra_padded(sym_i, qdc, qac, mesh, dtype=dt)
        return _np(_decode_intra_jit(sym_i, qdc, qac, exact))

    def decode_gop_batch(sym_i, sym_p):
        if tmesh is not None:
            from .parallel.tiles import decode_gop_tiled

            first, rest = decode_gop_tiled(sym_i, sym_p, qdc, qac, tmesh, dtype=dt)
            return _np(first), _np(rest)
        if mesh is not None:
            from .parallel.gop import decode_gops_padded

            return decode_gops_padded(sym_i, sym_p, qdc, qac, mesh, dtype=dt)
        return _np(_decode_gop_jit(sym_i, sym_p, qdc, qac, exact))

    y = np.zeros((nframes, height, width), np.uint8)
    cb = np.zeros((nframes, height // 2, width // 2), np.uint8)
    cr = np.zeros((nframes, height // 2, width // 2), np.uint8)
    for idx in _gop_batches(nframes, 1 if period == 0 else period):
        g, p = idx.shape
        iidx = idx[:, 0]
        sym_i = {k: syms[k][iidx] for k in DEC_I_KEYS}
        if p == 1:
            first = decode_intra(sym_i)
        else:
            pidx = idx[:, 1:].ravel()
            sym_p = {
                k: syms[k][pidx].reshape(g, p - 1, *syms[k].shape[1:])
                for k in DEC_P_KEYS
            }
            first, rest = decode_gop_batch(sym_i, sym_p)
            y[pidx] = rest["y"].reshape(-1, *y.shape[1:])
            cb[pidx] = rest["cb"].reshape(-1, *cb.shape[1:])
            cr[pidx] = rest["cr"].reshape(-1, *cr.shape[1:])
        y[iidx], cb[iidx], cr[iidx] = first["y"], first["cb"], first["cr"]
    return dict(y=y, cb=cb, cr=cr)
