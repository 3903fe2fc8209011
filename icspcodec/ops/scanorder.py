"""Zig-zag scan as a constant-index gather (zigzagScanning enc src:3014-3096)."""
from __future__ import annotations

import jax.numpy as jnp

from ..constants import IZIGZAG, ZIGZAG

# numpy constants: trace-time jnp constants land on the default device and
# force a device->host readback at lowering; numpy arrays lower directly
_ZZ = ZIGZAG
_IZZ = IZIGZAG


def zigzag(q: jnp.ndarray) -> jnp.ndarray:
    """(..., 8, 8) -> (..., 64) in scan order."""
    return q.reshape(q.shape[:-2] + (64,))[..., _ZZ]


def izigzag(scan: jnp.ndarray) -> jnp.ndarray:
    """(..., 64) scan order -> (..., 8, 8)."""
    return scan[..., _IZZ].reshape(scan.shape[:-1] + (8, 8))
