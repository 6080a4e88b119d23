"""SSIM structural-similarity term for the photometric loss.

Reference parity: the DAVO/GeoNet-family loss mixes L1 with SSIM
(`<ref>/davo.py`, SURVEY.md R4 [H]). Implemented with 3x3 average
pooling (the SfMLearner-family convention) as pure `lax.reduce_window`
ops, which XLA fuses tightly.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_C1 = 0.01**2
_C2 = 0.03**2


def _avg_pool3(x: jnp.ndarray) -> jnp.ndarray:
    """3x3/1 VALID average pool over (B, H, W, C)."""
    out = lax.reduce_window(
        x, 0.0, lax.add, (1, 3, 3, 1), (1, 1, 1, 1), "VALID"
    )
    return out / 9.0


def ssim(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel SSIM distance map, range [0, 1] (0 = identical).

    x, y: (B, H, W, C) in [0, 1]. Returns (B, H-2, W-2, C) of
    ``(1 - SSIM)/2`` as used in the photometric loss mix.
    """
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y

    num = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    den = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    s = num / den
    return jnp.clip((1.0 - s) * 0.5, 0.0, 1.0)
