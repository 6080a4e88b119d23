"""Gather-free bilinear upsampling (integer scale factors).

`jax.image.resize` lowers to XLA gathers. For the x2 / x4 upsamples in the PWC decoder, bilinear interpolation with
half-pixel centers needs only the previous/next neighbor per axis, so
it is expressible entirely with shifts (slice+concat), elementwise
lerps, and an interleave (stack+reshape) — no gather anywhere.
Matches `jax.image.resize(..., method="bilinear")` for integer factors.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _upsample_axis(x: jnp.ndarray, axis: int, factor: int) -> jnp.ndarray:
    """Bilinear x`factor` upsample along `axis`, half-pixel centers."""
    n = x.shape[axis]

    def shift(arr, delta):
        # arr shifted by delta with edge clamp, along `axis`.
        if delta == 0:
            return arr
        idx = [slice(None)] * arr.ndim
        edge = [slice(None)] * arr.ndim
        if delta < 0:  # previous neighbor
            idx[axis] = slice(0, n - 1)
            edge[axis] = slice(0, 1)
            return jnp.concatenate([arr[tuple(edge)], arr[tuple(idx)]], axis)
        idx[axis] = slice(1, n)
        edge[axis] = slice(n - 1, n)
        return jnp.concatenate([arr[tuple(idx)], arr[tuple(edge)]], axis)

    prev = shift(x, -1)
    nxt = shift(x, +1)
    phases = []
    for j in range(factor):
        frac = (j + 0.5) / factor - 0.5
        if frac < 0:
            phases.append((-frac) * prev + (1.0 + frac) * x)
        else:
            phases.append((1.0 - frac) * x + frac * nxt)
    # Interleave: stack phases right after `axis`, then merge.
    stacked = jnp.stack(phases, axis=axis + 1)
    shape = list(x.shape)
    shape[axis] = n * factor
    return stacked.reshape(shape)


@partial(jax.jit, static_argnames=("factor",))
def upsample2x_bilinear(x: jnp.ndarray, factor: int = 2) -> jnp.ndarray:
    """(B, H, W, C) -> (B, f*H, f*W, C) bilinear, half-pixel centers."""
    x = _upsample_axis(x, 1, factor)
    return _upsample_axis(x, 2, factor)


def resize_bilinear_aligned(x: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """Integer-factor fast path, else jax.image.resize."""
    B, H, W, C = x.shape
    if height % H == 0 and width % W == 0 and height // H == width // W:
        return upsample2x_bilinear(x, factor=height // H)
    return jax.image.resize(x, (B, height, width, C), method="bilinear")
