"""Batched 8x8 DCT/IDCT.

Both precisions run the reference C++ arithmetic: the separable
transform accumulates in index order with every product rounded on its
own, matching the C loops of DCT_block (enc src:2685-2749) / IDCT_block
(:2825-2893).  In float64 (exact) that is bit-exact with the compiled
reference.  In float32 (fast) the same expression makes the result
independent of batch size and of how XLA fuses the program: a 64x64
matrix product per block, run through the GPU's GEMM, gave encoder
reconstructions that changed with the number of GOPs per call (so with
the shard count), at the same speed.

Two cosine-table regimes exist (constants.COS_ENC float-rounded /
COS_DEC double) — see constants.py for why.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import COS_ENC, IRT2


def _mulr(a, b):
    """Correctly-rounded multiply that XLA cannot contract into an FMA.

    The exact (float64) path must reproduce the C code's per-operation
    IEEE rounding, and the fast path must not depend on fusion.  XLA CPU
    contracts add(mul(a,b), c) into a single-rounding FMA — even across
    jax.lax.optimization_barrier — which flips half-ulp quantization ties
    vs. the reference.  Routing the product through a data-dependent
    select breaks the contraction pattern while keeping the exact rounded
    product (verified compiler-invariant on the CPU, including under
    --xla_force_host_platform_device_count, and on the H100).
    """
    p = a * b
    return jnp.where(p == p, p, jnp.zeros_like(p))


def _mm_exact(a: jnp.ndarray, rowsel, ct_cols) -> jnp.ndarray:
    """sum_k a[..., sel(k)] * ct_cols[k] accumulated in k order, with each
    product rounded separately (no FMA), matching the C loops."""
    acc = None
    for k in range(8):
        p = _mulr(rowsel(a, k), ct_cols(k))
        acc = p if acc is None else acc + p
    return acc


def fdct(err: jnp.ndarray, table: np.ndarray = COS_ENC, dtype=jnp.float64) -> jnp.ndarray:
    """Forward DCT of (..., 8, 8) integer residuals.

    out[v,u] = irt2^([v==0]+[u==0]) / 4 * sum_y ct[v,y] * (sum_x e[v,x]*ct[u,x])
    in the reference's stage order and summation order (DCT_block enc
    src:2685-2749), in `dtype`.
    """
    e = err.astype(dtype)
    ct = np.asarray(table, dtype=dtype)
    # t1[..., v, u] = sum_x e[..., v, x] * ct[u, x]
    t1 = _mm_exact(e, lambda a, x: a[..., :, x, None], lambda x: ct[:, x])
    # out[..., v, u] = sum_y t1[..., y, u] * ct[v, y]
    out = _mm_exact(
        t1, lambda a, y: a[..., y, None, :], lambda y: ct[:, y][:, None]
    )
    out = out.at[..., 0, :].set(_mulr(out[..., 0, :], dtype(IRT2)))
    out = out.at[..., :, 0].set(_mulr(out[..., :, 0], dtype(IRT2)))
    return _mulr(out, dtype(0.25))


def idct(iq: jnp.ndarray, table: np.ndarray, dtype=jnp.float64) -> jnp.ndarray:
    """Inverse DCT of (..., 8, 8) dequantized integers.

    Per-term order matches the C code: Cu[u]*(double)iq[y][u] is rounded
    first (the elementwise premultiply), then multiplied by the cosine and
    accumulated (IDCT_block enc src:2857-2878).
    """
    q = iq.astype(dtype)
    ct = np.asarray(table, dtype=dtype)
    cu = np.ones((8,), dtype=np.dtype(dtype))
    cu[0] = IRT2
    m = _mulr(q, cu[None, :])
    t1 = _mm_exact(m, lambda a, u: a[..., :, u, None], lambda u: ct[u, :])
    n = _mulr(t1, cu[:, None])
    out = _mm_exact(
        n, lambda a, v: a[..., v, None, :], lambda v: ct[v, :][:, None]
    )
    return _mulr(out, dtype(0.25))
