"""Persistent XLA compile cache at one fixed place.

JAX reads JAX_COMPILATION_CACHE_DIR by itself; when that is set, nothing
here overrides it.  Otherwise the cache lives in `.jax_cache/` at the root
of the checkout that holds this package, a path that does not change from
run to run (the path is part of what a later run must find again).
"""
from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
