"""Motion estimation / compensation as dense batched computation.

The reference walks a 64-step spiral per macroblock with early exits
(motionEstimation, enc src:2073-2155).  Rebuilt as a dense batched
computation: all candidate SADs for all MBs of a frame at once, followed
by a selection that reproduces the reference's rule exactly:

* first *strict* minimum in walk order wins (comparison is `min > SAD`)
* except when two or more evaluations have SAD == 0: the loop breaks at
  the *second* zero (the `else if (SAD==0)` branch only fires once min
  is already 0), so that candidate wins — AND the walk state
  (flag/xflag/yflag, which persist across MBs, enc src:2094-2109) is
  left mid-cycle, mirroring the spiral every subsequent MB of the frame
  walks.  The sequential state propagation is rebuilt as an associative
  prefix composition of per-MB 4-state transition maps (log-depth on
  the raster, no 396-step scan), with per-state selections computed
  densely in parallel from the 129-offset union SAD tensor.

spiral_search() is the production hybrid: it computes the canonical
64-step selection, and only when some MB breaks early (data-dependent
lax.cond) pays for the extra union offsets + state composition — so
break-free content (no exact static MBs) runs at fixed-table cost.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    N_SPIRAL_STATES,
    SPIRAL,
    SPIRAL_STATE_IDX,
    SPIRAL_TRANS,
    SPIRAL_UNION,
)
from .medians import median3, median3_mv_y

# number of canonical-unique union rows (the canonical walk's offsets are
# the union prefix by construction)
N_CANON = int(SPIRAL_STATE_IDX[0].max()) + 1


def sad_dense(cur_y: jnp.ndarray, pad_prev: jnp.ndarray, offsets: np.ndarray, bs: int = 16) -> jnp.ndarray:
    """Dense SADs at `offsets` for every MB: (..., n, mbh, mbw) int32.

    cur_y: (..., H, W) uint8; pad_prev: (..., H+2b, W+2b) uint8 padded
    previous reconstruction.  Static slices, unrolled at trace time; the
    absolute difference runs in u8 (max-min) — the loop is HBM-bandwidth
    bound — and only the reduction widens to int32."""
    h, w = cur_y.shape[-2], cur_y.shape[-1]
    mbh, mbw = h // bs, w // bs
    lead = cur_y.shape[:-2]
    cur = cur_y.reshape(lead + (mbh, bs, mbw, bs))
    sads = []
    for (ox, oy) in np.asarray(offsets):
        win = jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(pad_prev, bs + int(oy), bs + int(oy) + h, axis=-2),
            bs + int(ox),
            bs + int(ox) + w,
            axis=-1,
        )
        win = win.reshape(lead + (mbh, bs, mbw, bs))
        diff = jnp.maximum(cur, win) - jnp.minimum(cur, win)  # |a-b| in u8
        sads.append(diff.astype(jnp.int32).sum(axis=(-3, -1)))
    return jnp.stack(sads, axis=-3)  # (..., n, mbh, mbw)


def _select_from_seq(seq: jnp.ndarray):
    """Reference selection over a (..., 64, mbh, mbw) SAD sequence.

    Returns (best_step, steps_taken): the walk step whose offset wins
    (first strict minimum, overridden by the second zero-SAD evaluation,
    enc src:2128-2141) and how many steps the walk ran (64 when no
    break)."""
    best = jnp.argmin(seq, axis=-3).astype(jnp.int32)  # first min occurrence
    zeros = seq == 0
    nz = jnp.cumsum(zeros, axis=-3)
    is2 = zeros & (nz == 2)
    has2 = is2.any(axis=-3)
    second = jnp.argmax(is2, axis=-3).astype(jnp.int32)
    best = jnp.where(has2, second, best)
    steps = jnp.where(has2, second + 1, 64)
    return best, steps


def state_tables(sads_u: jnp.ndarray):
    """Per-entry-state selection tables from union SADs
    (..., N_UNION, mbh, mbw): returns (best_u, steps), each
    (..., S, mbh, mbw) int32 — the winning union offset and walk length
    for every possible entry state.  Fully parallel over MBs; the
    sequential part lives in compose_select."""
    seq = jnp.take(sads_u, jnp.asarray(SPIRAL_STATE_IDX), axis=-3)
    best_step, steps = _select_from_seq(seq)        # (..., S, mbh, mbw)
    s_ix = np.arange(N_SPIRAL_STATES)[:, None, None]
    best_u = jnp.asarray(SPIRAL_STATE_IDX)[s_ix, best_step]
    return best_u.astype(jnp.int32), steps.astype(jnp.int32)


def compose_select(best_u: jnp.ndarray, steps: jnp.ndarray) -> jnp.ndarray:
    """Raster state composition: (..., S, mbh, mbw) per-state tables ->
    chosen union offset index (..., mbh, mbw) int32.

    The per-MB state transitions compose associatively (each MB is a tiny
    map {0..3} -> {0..3}), so the raster-sequential C++ loop (nblck, enc
    src:2104) becomes a log-depth prefix scan over mbh*mbw elements."""
    lead = best_u.shape[:-3]
    mbh, mbw = best_u.shape[-2], best_u.shape[-1]
    n = mbh * mbw
    s_ix = np.arange(N_SPIRAL_STATES)[:, None, None]
    trans = jnp.asarray(SPIRAL_TRANS)[s_ix, steps]  # (..., S, mbh, mbw)

    # raster-flatten with the state axis last: (..., N, S)
    flat = lambda a: jnp.moveaxis(
        a.reshape(lead + (N_SPIRAL_STATES, n)), -2, -1
    )
    g = flat(trans)

    def compose(a, b):  # apply a (earlier MBs) then b
        return jnp.take_along_axis(b, a, axis=-1)

    prefix = jax.lax.associative_scan(compose, g, axis=-2)
    entry = jnp.concatenate(
        [jnp.zeros(lead + (1,), prefix.dtype), prefix[..., :-1, 0]], axis=-1
    )  # (..., N): state entering each MB, MB 0 starts canonical
    best = jnp.take_along_axis(flat(best_u), entry[..., None], axis=-1)[..., 0]
    return best.reshape(lead + (mbh, mbw)).astype(jnp.int32)


def stateful_select(sads_u: jnp.ndarray) -> jnp.ndarray:
    """Full stateful selection from union SADs (..., N_UNION, mbh, mbw).
    Returns best union-offset index (..., mbh, mbw) int32."""
    return compose_select(*state_tables(sads_u))


def spiral_search_fixed(cur_y: jnp.ndarray, pad_prev: jnp.ndarray, bs: int = 16) -> jnp.ndarray:
    """Fixed-table search (every MB walks the canonical spiral): exact on
    break-free content; kept for tests and as the hybrid's fast branch."""
    sads = sad_dense(cur_y, pad_prev, SPIRAL, bs)
    best, _ = _select_from_seq(sads)
    # numpy constant (a trace-time jnp constant would force a slow
    # device->host readback at lowering); mv = -(chosen offset)
    return jnp.take(-np.asarray(SPIRAL), best, axis=0)


def spiral_search_union(cur_y: jnp.ndarray, pad_prev: jnp.ndarray, bs: int = 16):
    """Stateful-exact search; returns (mv (..., mbh, mbw, 2) int32,
    best union-offset index (..., mbh, mbw) int32).  Always computes the
    full union SAD tensor — see spiral_search for the gated hybrid."""
    sads_u = sad_dense(cur_y, pad_prev, SPIRAL_UNION, bs)
    best = stateful_select(sads_u)
    return jnp.take(-np.asarray(SPIRAL_UNION), best, axis=0), best


def spiral_search(cur_y: jnp.ndarray, pad_prev: jnp.ndarray, bs: int = 16) -> jnp.ndarray:
    """Stateful-exact hybrid search: mv (..., mbh, mbw, 2) int32 in the
    reference sign convention mv = -(chosen offset), (x, y).

    Computes the canonical selection densely; iff some MB would break
    early (>= 2 zero-SAD evaluations in its canonical walk — the only
    event that perturbs the cross-MB state), a lax.cond pays for the
    remaining union offsets + the stateful composition.  Break-free
    frames cost exactly the round-1 fixed-table search."""
    sads_c = sad_dense(cur_y, pad_prev, SPIRAL_UNION[:N_CANON], bs)
    seq0 = jnp.take(sads_c, jnp.asarray(SPIRAL_STATE_IDX[0]), axis=-3)
    best0, steps0 = _select_from_seq(seq0)
    any_break = (steps0 < 64).any()

    def fixed_branch(_):
        idx = jnp.take(jnp.asarray(SPIRAL_STATE_IDX[0]), best0, axis=0)
        return jnp.take(-np.asarray(SPIRAL_UNION), idx, axis=0)

    def stateful_branch(_):
        extra = sad_dense(cur_y, pad_prev, SPIRAL_UNION[N_CANON:], bs)
        best = stateful_select(jnp.concatenate([sads_c, extra], axis=-3))
        return jnp.take(-np.asarray(SPIRAL_UNION), best, axis=0)

    return jax.lax.cond(any_break, stateful_branch, fixed_branch, None)


def gather_pred(pad: jnp.ndarray, mv: jnp.ndarray, bs: int) -> jnp.ndarray:
    """Fetch per-MB (bs x bs) predictor blocks at origin - mv + pad.

    pad: (..., PH, PW); mv: (..., mbh, mbw, 2).  A flat gather — XLA turns
    it into a vectorized dynamic-gather; no per-block loop.
    """
    mbh, mbw = mv.shape[-3], mv.shape[-2]
    by = jnp.arange(mbh, dtype=jnp.int32) * bs
    bx = jnp.arange(mbw, dtype=jnp.int32) * bs
    ry = (by[:, None] - mv[..., 1] + bs).reshape(mv.shape[:-3] + (mbh * mbw,))
    rx = (bx[None, :] - mv[..., 0] + bs).reshape(mv.shape[:-3] + (mbh * mbw,))

    # vmapped dynamic_slice lowers to a gather of whole (bs, bs) tiles
    # instead of per-pixel flat gathers
    def slice_one(img, y0, x0):
        return jax.lax.dynamic_slice(img, (y0, x0), (bs, bs))

    per_mb = jax.vmap(slice_one, in_axes=(None, 0, 0))
    if pad.ndim == 2:
        out = per_mb(pad, ry, rx)
        return out.reshape(mbh, mbw, bs, bs)
    per_batch = jax.vmap(per_mb, in_axes=(0, 0, 0))
    out = per_batch(pad, ry, rx)
    return out.reshape(pad.shape[:-2] + (mbh, mbw, bs, bs))


def mv_diff_field(mv: jnp.ndarray) -> jnp.ndarray:
    """Differential MVs, fully parallel (mvPrediction enc src:2353-2425).

    The predictors use neighbors' *reconstructed* MVs, which equal the
    original MVs (ImvPrediction adds the identical predictor back), so the
    whole field vectorizes.  Includes the right-edge (l,ul,u) variant and
    the y-median typo.
    """
    mbh, mbw = mv.shape[-3], mv.shape[-2]
    x = mv[..., 0]
    y = mv[..., 1]

    def shift(a, dy, dx):
        return jnp.roll(jnp.roll(a, dy, axis=-2), dx, axis=-1)

    lx, ly = shift(x, 0, 1), shift(y, 0, 1)
    ux, uy = shift(x, 1, 0), shift(y, 1, 0)
    ulx, uly = shift(x, 1, 1), shift(y, 1, 1)
    urx, ury = shift(x, 1, -1), shift(y, 1, -1)

    col = jnp.arange(mbw)
    row = jnp.arange(mbh)
    is_right = col == mbw - 1
    # interior: right edge -> median(l, ul, u); else median(l, u, ur)
    bx = jnp.where(is_right, ulx, ux)
    by_ = jnp.where(is_right, uly, uy)
    cx = jnp.where(is_right, ux, urx)
    cy = jnp.where(is_right, uy, ury)
    px = median3(lx, bx, cx)
    py = median3_mv_y(ly, by_, cy, cx)

    px = jnp.where(row[:, None] == 0, lx, jnp.where(col[None, :] == 0, ux, px))
    py = jnp.where(row[:, None] == 0, ly, jnp.where(col[None, :] == 0, uy, py))
    px = px.at[..., 0, 0].set(8)
    py = py.at[..., 0, 0].set(8)
    return jnp.stack([x - px, y - py], axis=-1)
