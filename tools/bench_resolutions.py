#!/usr/bin/env python3
"""Device throughput across resolutions on one GPU (the reference is
hardcoded to CIF 352x288; this framework is shape-generic — generality
pinned by tests/test_generality.py).  Same carry-serialized method as
bench.py.  Exits non-zero where JAX finds no GPU.

    python tools/bench_resolutions.py
"""
import functools
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from chip_smoke import card_info, require_gpu  # noqa: E402


def synth(w, h, nf, seed=0):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 37.0) + 32 * np.sin(yy / 23.0)
    base += r.normal(0, 3.0, size=(h, w)).astype(np.float32)
    y = np.stack([
        np.clip(np.roll(base, t, axis=1), 0, 255).astype(np.uint8)
        for t in range(nf)
    ])
    cb = r.integers(0, 256, (nf, h // 2, w // 2), np.uint8)
    cr = r.integers(0, 256, (nf, h // 2, w // 2), np.uint8)
    return y, cb, cr


def main():
    require_gpu()
    import jax
    import jax.numpy as jnp

    from icspcodec.compile_cache import enable_compile_cache
    from icspcodec.constants import COS_ENC
    from icspcodec.engine.inter import encode_gop
    from icspcodec.engine.intra import encode_intra_frames

    enable_compile_cache()
    print(f"card: {card_info()}", flush=True)

    def per_call(body, k=7):
        @functools.partial(jax.jit, static_argnames="k")
        def run(k):
            def step(i, st):
                acc, d = st
                r = body(d)
                return acc + r, (r % 2).astype(jnp.uint8)
            return jax.lax.fori_loop(0, k, step, (jnp.int32(0), jnp.uint8(0)))[0]

        def timed(kk):
            np.asarray(run(k=kk))
            t0 = time.time()
            np.asarray(run(k=kk))
            return time.time() - t0

        t1, tk = timed(1), timed(k)
        return max((tk - t1) / (k - 1), 1e-9)

    # (name, w, h, frames): QCIF, CIF, 4CIF, 720p-class (multiple of 16)
    cases = [("qcif 176x144", 176, 144, 60), ("cif 352x288", 352, 288, 60),
             ("4cif 704x576", 704, 576, 60), ("720p 1280x720", 1280, 720, 30)]
    for name, w, h, nf in cases:
        y, cb, cr = synth(w, h, nf)
        yj, cbj, crj = jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)

        def intra_body(d):
            out = encode_intra_frames(yj + d, cbj, crj, 16, 16,
                                      table=COS_ENC, dtype=jnp.float32)
            return sum(jnp.sum(v.astype(jnp.int32)) for v in out.values())

        t_i = per_call(intra_body)

        g, p = nf // 10, 10
        yg = jnp.asarray(y[:g * p].reshape(g, p, h, w))
        cbg = jnp.asarray(cb[:g * p].reshape(g, p, h // 2, w // 2))
        crg = jnp.asarray(cr[:g * p].reshape(g, p, h // 2, w // 2))

        def gop_body(d):
            intra, inter = encode_gop(yg + d, cbg, crg, 16, 16,
                                      table=COS_ENC, dtype=jnp.float32)
            return (sum(jnp.sum(v.astype(jnp.int32)) for v in intra.values())
                    + sum(jnp.sum(v.astype(jnp.int32)) for v in inter.values()))

        t_p = per_call(gop_body)
        mpx = w * h / 1e6
        print(f"{name}: all-intra {nf/t_i:7.0f} fps ({nf/t_i*mpx:6.0f} Mpx/s)  "
              f"inter p10 {g*p/t_p:7.0f} fps ({g*p/t_p*mpx:6.0f} Mpx/s)", flush=True)


if __name__ == "__main__":
    main()
