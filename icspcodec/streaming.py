"""Streaming / resumable encoding: per-GOP incremental output.

The reference's nearest checkpoint analog is "the bitstream is a
restartable artifact per GOP" (SURVEY.md section 5): closed GOPs are
independent, so encoded GOPs are durable units.  This driver encodes GOP
batches one at a time, appends each GOP's packed body bits to a sidecar
directory, and can resume after interruption by skipping GOPs whose
output already exists.  GOP jobs are idempotent — re-dispatch after a
failure is safe (the reference's pthread pool had the same property by
disjointness; SURVEY.md section 2.3).

The final container is byte-identical to codec.encode()'s output: the
header plus the concatenation of per-GOP bodies is only byte-aligned per
GOP *chunk*, so chunks store (nbits, bytes) and finalize() re-packs the
bit remainders exactly like the single-shot writer.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import time

import numpy as np

from .bitstream import frame_items, pack_header
from .codec import (
    _acflag, _dt, _encode_gop_items_jit, _encode_gop_jit, _encode_intra_items_jit,
    _encode_intra_jit, _np, _pack_bucketed,
)
from .config import CodecConfig
from .metrics import GopRecord, MetricsLog, psnr_y

# Bump when the encoder's output for identical (config, content) changes;
# stale chunks from an older format version are rejected on resume.
FORMAT_VERSION = 1


def _gop_fingerprint(y, cb, cr, cfg: CodecConfig) -> str:
    """Content+config fingerprint of one GOP job.

    Resume must never splice a chunk produced from different input frames,
    a different QP/period/precision, or an older encoder format into the
    bitstream (the chunk filename only encodes the GOP index)."""
    h = hashlib.sha256()
    h.update(
        json.dumps(
            [FORMAT_VERSION, cfg.width, cfg.height, cfg.qp_dc, cfg.qp_ac,
             cfg.intra_period, cfg.precision],
        ).encode()
    )
    for arr in (y, cb, cr):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _pack_row(codes, lengths):
    """Host MSB-first bit pack of VLC items into ONE row: (bytes, nbits).

    The per-GOP analog of bitstream_device.pack_frames_dev (no tail
    convention — that is applied once by assemble_frames at finalize).
    Used to splice legacy/host-entropy "items" chunks together with
    device-packed chunks at bit granularity."""
    L = np.asarray(lengths, np.int64).ravel()
    c = np.asarray(codes, np.uint64).ravel()
    total = int(L.sum())
    if total == 0:
        return np.zeros(0, np.uint8), 0
    j = np.arange(int(L.max()), dtype=np.int64)
    shift = L[:, None] - 1 - j                     # (n, maxlen)
    bits = ((c[:, None] >> np.maximum(shift, 0).astype(np.uint64)) & 1).astype(np.uint8)
    return np.packbits(bits[shift >= 0]), total    # row-major: MSB-first per item


def _stack_rows(rows):
    """Stack packed byte rows of unequal bucket widths (intra vs inter
    packs bucket separately) into one zero-padded (F, maxbytes) array."""
    m = max(r.shape[0] for r in rows)
    out = np.zeros((len(rows), m), np.uint8)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


def _encode_gop_batch_dev(y, cb, cr, cfg: CodecConfig):
    """Device-entropy variant of _encode_gop_batch: symbols stay on the
    device — frame items + bit packing run on the accelerator
    (bitstream_device) and only packed frames plus per-frame MSE scalars
    are pulled.  Returns per-GOP (rows (P, maxbytes) uint8,
    nbits (P,) int64, psnr_y float)."""
    import jax.numpy as jnp

    exact = cfg.precision == "exact"
    g, p = y.shape[:2]

    def frame_mse(recon, orig):
        # per-frame MSE on device; only (F,) scalars reach the host
        d = jnp.asarray(recon).astype(jnp.float32) - jnp.asarray(orig).astype(jnp.float32)
        return np.asarray(jnp.mean(d * d, axis=(-2, -1)), np.float64)

    if p == 1:
        ci, li, recon_t = _encode_intra_items_jit(
            y[:, 0], cb[:, 0], cr[:, 0], cfg.qp_dc, cfg.qp_ac, exact
        )
        rows, bits = _pack_bucketed(ci, li)
        mse = frame_mse(recon_t[0], y[:, 0]).reshape(g, 1)
        return [
            (np.stack(rows[gi:gi + 1]), np.asarray(bits[gi:gi + 1], np.int64),
             _psnr_from_mse(mse[gi]))
            for gi in range(g)
        ]
    (ci, li), (cp, lp), recons = _encode_gop_items_jit(
        y, cb, cr, cfg.qp_dc, cfg.qp_ac, exact
    )
    ri, bi = _pack_bucketed(ci, li)
    rp, bp = _pack_bucketed(cp, lp)
    mse_i = frame_mse(recons[0][0], y[:, 0])                 # (G,)
    mse_p = frame_mse(recons[1][0], y[:, 1:]).reshape(g, p - 1)
    out = []
    for gi in range(g):
        sl = slice(gi * (p - 1), (gi + 1) * (p - 1))
        rows = _stack_rows([ri[gi]] + rp[sl])
        bits = np.asarray([bi[gi]] + bp[sl], np.int64)
        psnr = _psnr_from_mse(np.concatenate([[mse_i[gi]], mse_p[gi]]))
        out.append((rows, bits, psnr))
    return out


def _psnr_from_mse(mse: np.ndarray) -> float:
    """metrics.psnr_y convention: mean over frames of per-frame PSNR."""
    mse = np.maximum(np.asarray(mse, np.float64), 1e-12)
    return float((20 * np.log10(255.0 / np.sqrt(mse))).mean())


def _encode_gop_batch(y, cb, cr, cfg: CodecConfig, mesh):
    """Encode a (G, P, H, W) batch of equal-length GOPs — SPMD over the
    `gop` mesh when cfg.gop_shards > 1 (the chunk-batched analog of
    codec.encode's sharded path; bitstreams stay byte-identical because
    closed GOPs are independent and items are assembled per GOP) — and
    return a list of per-GOP (codes, lengths, recon) triples."""
    exact = cfg.precision == "exact"
    g, p = y.shape[:2]
    if p == 1:
        if mesh is not None:
            from .parallel.gop import encode_intra_padded

            intra = encode_intra_padded(
                y[:, 0], cb[:, 0], cr[:, 0], cfg.qp_dc, cfg.qp_ac, mesh,
                dtype=_dt(exact),
            )
        else:
            intra = _np(_encode_intra_jit(
                y[:, 0], cb[:, 0], cr[:, 0], cfg.qp_dc, cfg.qp_ac, exact
            ))
        inter = None
    else:
        if mesh is not None:
            from .parallel.gop import encode_gops_padded

            intra, inter = encode_gops_padded(
                y, cb, cr, cfg.qp_dc, cfg.qp_ac, mesh, dtype=_dt(exact),
            )
        else:
            intra, inter = _np(_encode_gop_jit(
                y, cb, cr, cfg.qp_dc, cfg.qp_ac, exact
            ))
    out = []
    for gi in range(g):
        isym = {k: np.asarray(v)[gi:gi + 1] for k, v in intra.items()}
        isym["y_acflag"] = _acflag(isym["y_scan"])
        codes, lengths = frame_items(isym, True)
        cs, ls = [codes], [lengths]
        recon = dict(
            y=[np.asarray(intra["recon_y"][gi])],
            cb=[np.asarray(intra["recon_cb"][gi])],
            cr=[np.asarray(intra["recon_cr"][gi])],
        )
        if inter is not None:
            psym = {
                k: np.asarray(v)[gi]
                for k, v in inter.items() if not k.startswith("recon")
            }
            psym["y_acflag"] = _acflag(psym["y_scan"])
            c2, l2 = frame_items(psym, False)
            cs.append(c2)
            ls.append(l2)
            for i in range(p - 1):
                recon["y"].append(np.asarray(inter["recon_y"][gi, i]))
                recon["cb"].append(np.asarray(inter["recon_cb"][gi, i]))
                recon["cr"].append(np.asarray(inter["recon_cr"][gi, i]))
        out.append((
            np.concatenate([c.ravel() for c in cs]),
            np.concatenate([l.ravel() for l in ls]),
            recon,
        ))
    return out


def encode_streaming(y, cb, cr, cfg: CodecConfig, workdir: str, seq_name: str = "seq", metrics: MetricsLog | None = None) -> bytes:
    """Encode with per-GOP durability; resumes from `workdir` if partial
    results exist.  Returns the complete bitstream.

    cfg.gop_shards > 1 encodes pending GOPs in SPMD rounds of gop_shards
    over the `gop` mesh; each round still writes one
    durable chunk per GOP, so resume granularity and the bitstream bytes
    are unchanged.  tile_shards is not supported here (the tiled engines
    shard single frames, not GOP batches) and raises."""
    if cfg.tile_shards > 1:
        raise ValueError(
            "encode_streaming does not support tile_shards > 1; use "
            "gop_shards for sharded streaming or codec.encode for tiling"
        )
    wd = pathlib.Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    nf = y.shape[0]
    eff = cfg.eff_period
    gops = [
        (g, list(range(g * eff, min((g + 1) * eff, nf))))
        for g in range((nf + eff - 1) // eff)
    ]
    metrics = metrics or MetricsLog(str(wd / "metrics.jsonl"))

    import jax

    proc = jax.process_index()
    mesh = None
    if cfg.gop_shards > 1:
        from .parallel.gop import mesh_for

        mesh = mesh_for(cfg.gop_shards)

    fps = {g: _gop_fingerprint(y[idxs], cb[idxs], cr[idxs], cfg) for g, idxs in gops}
    # done[g] = (rows list of uint8 arrays, nbits list) — the unified
    # bit-row representation both chunk kinds reduce to (see finalize)
    done: dict = {}
    pending = []
    for g, idxs in gops:
        chunk = wd / f"gop_{g:05d}.npz"
        if chunk.exists():
            data = np.load(chunk)
            stored = str(data["fingerprint"]) if "fingerprint" in data else None
            if stored != fps[g]:
                raise ValueError(
                    f"{chunk} was produced from different input/config "
                    f"(fingerprint {stored} != {fps[g]}); refusing to resume — "
                    "use a fresh workdir or delete the stale chunks"
                )
            if "packed" in data:       # device-entropy chunk: per-frame rows
                done[g] = (list(data["packed"]), list(data["nbits"]))
            else:                      # items chunk: one row for the GOP
                row, nb = _pack_row(data["codes"], data["lengths"])
                done[g] = ([row], [nb])
        else:
            pending.append((g, idxs))

    # batch pending GOPs of equal length into rounds (the tail GOP, when
    # shorter, forms its own round).  Sharded: round size = mesh width
    # (SPMD).  Plain: rounds of 16 GOPs per dispatch — durability is
    # per-GOP either way (each round writes one chunk per GOP), and one
    # dispatch per GOP would pay the per-dispatch host round trip once per
    # GOP.  The round size has not been tuned on the GPU.
    rsize = cfg.gop_shards if cfg.gop_shards > 1 else 16
    rounds: list[list] = []
    for g, idxs in pending:
        if rounds and len(rounds[-1]) < rsize and len(rounds[-1][0][1]) == len(idxs):
            rounds[-1].append((g, idxs))
        else:
            rounds.append([(g, idxs)])
    # device entropy mirrors codec.encode's gating: the plain (unsharded)
    # path keeps symbols on the accelerator and pulls only packed frames
    # instead of ~150 MB of symbols per CIF300
    dev_entropy = mesh is None and cfg.entropy != "host"
    for batch in rounds:
        t0 = time.time()
        stack = lambda a: np.stack([a[idxs] for _, idxs in batch])
        if dev_entropy:
            items = _encode_gop_batch_dev(stack(y), stack(cb), stack(cr), cfg)
        else:
            items = _encode_gop_batch(stack(y), stack(cb), stack(cr), cfg, mesh)
        wall = (time.time() - t0) / len(batch)
        for (g, idxs), res in zip(batch, items):
            chunk = wd / f"gop_{g:05d}.npz"
            tmp = chunk.with_suffix(".tmp.npz")
            if dev_entropy:
                rows, nbits, psnr = res
                np.savez(  # uncompressed: chunks are ephemeral workdir artifacts
                    tmp, packed=rows, nbits=nbits, fingerprint=fps[g]
                )
                bits_total = int(nbits.sum())
                done[g] = (list(rows), list(nbits))
            else:
                codes, lengths, recon = res
                np.savez(  # uncompressed: chunks are ephemeral workdir artifacts
                    tmp, codes=codes, lengths=lengths, fingerprint=fps[g]
                )
                bits_total = int(lengths.sum())
                psnr = psnr_y(np.stack(recon["y"]), y[idxs])
                row, nb = _pack_row(codes, lengths)
                done[g] = ([row], [nb])
            os.replace(tmp, chunk)  # atomic: a crash never leaves a bad chunk
            metrics.add(
                GopRecord(
                    seq=seq_name,
                    gop_index=g,
                    frames=len(idxs),
                    bits=bits_total,
                    wall_s=wall,
                    psnr_y_db=psnr,
                    process_index=proc,
                )
            )

    from .bitstream_device import assemble_frames

    rows_all: list = []
    nbits_all: list = []
    for g, _ in gops:
        r, n = done[g]
        rows_all += r
        nbits_all += n
    body = assemble_frames(rows_all, nbits_all)
    return (
        pack_header(cfg.height, cfg.width, cfg.qp_dc, cfg.qp_ac, cfg.intra_period)
        + body
    )
