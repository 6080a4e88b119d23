"""Dense-weight bilinear sampling for small grids (matmul formulation).

out[b, p, c] = sum_{v, u} hat(v_p - v) hat(u_p - u) img[b, v, u, c]

Expresses arbitrary-coordinate sampling as two small einsum
contractions instead of a gather. Only worthwhile for coarse
grids (P = H*W up to a few thousand): FLOPs scale as P*(H + W)*C.
Kept as an alternative backend for the warp ops, selected explicitly,
not by default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def bilinear_sample_matmul(
    img: jnp.ndarray, coords: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """img: (B, H, W, C); coords: (B, Ho, Wo, 2) as (u, v).

    Returns (sampled (B, Ho, Wo, C), valid (B, Ho, Wo, 1)); matches
    `core.warp.bilinear_sample` semantics (zero + invalid out of
    bounds).
    """
    B, H, W, C = img.shape
    _, Ho, Wo, _ = coords.shape
    P = Ho * Wo
    u = coords[..., 0].reshape(B, P)
    v = coords[..., 1].reshape(B, P)
    valid = (
        (u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0)
    ).astype(img.dtype)

    qu = jnp.arange(W, dtype=img.dtype)
    qv = jnp.arange(H, dtype=img.dtype)
    wu = jnp.maximum(0.0, 1.0 - jnp.abs(u[..., None] - qu))  # (B, P, W)
    wv = jnp.maximum(0.0, 1.0 - jnp.abs(v[..., None] - qv))  # (B, P, H)
    t = jnp.einsum("bpv,bvuc->bpuc", wv, img)
    out = jnp.einsum("bpu,bpuc->bpc", wu, t)
    out = out * valid[..., None]
    return (
        out.reshape(B, Ho, Wo, C),
        valid.reshape(B, Ho, Wo, 1),
    )
