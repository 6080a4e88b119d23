"""Shared building blocks for the model zoo."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from davo_tpu.models import layers


def dtype_of(name: str):
    return {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[name]


def conv_same_stride2_s2d(x, kernel, bias, dtype):
    """Evaluate `Conv(O, (k, k), strides=2, padding='SAME')` via
    space-to-depth: EXACTLY the same math, a deeper contraction.

    The first convs of the pose/flow encoders contract over 3-9 input
    channels. Folding each 2x2 input phase block into channels
    (C -> 4C, H,W -> H/2,W/2) and running the algebraically-equivalent
    stride-1 conv with the rearranged kernel quadruples the
    contraction depth for the same FLOPs.

    Derivation: pad the input with SAME's (k-2) total padding and the
    kernel with zeros to even K2 = 2*ceil(k/2); split kernel taps
    dy = 2a + py. Then
      out[y, x] = sum_{a,b,py,px,c} S[y+a, x+b, (py,px,c)]
                  * w8[2a+py, 2b+px, c]
    i.e. a VALID stride-1 (K2/2 x K2/2) conv over the s2d input S.
    Requires even H, W (all model resolutions are).
    """
    k, _, C, O = kernel.shape
    B, H, W, _ = x.shape
    assert H % 2 == 0 and W % 2 == 0, (H, W)
    K2 = 2 * ((k + 1) // 2)
    pad_lo = (k - 2) // 2
    # SAME total pad is k-2 (stride 2, even H); grow hi to reach the
    # even K2 decomposition grid — the extra rows meet zero kernel taps.
    pad_hi = (k - 2) - pad_lo + (K2 - k)
    xp = jnp.pad(
        x, ((0, 0), (pad_lo, pad_hi), (pad_lo, pad_hi), (0, 0))
    )
    Hp, Wp = H + K2 - 2, W + K2 - 2
    s = xp.reshape(B, Hp // 2, 2, Wp // 2, 2, C)
    s = s.transpose(0, 1, 3, 2, 4, 5).reshape(B, Hp // 2, Wp // 2, 4 * C)
    w8 = jnp.pad(kernel, ((0, K2 - k), (0, K2 - k), (0, 0), (0, 0)))
    wn = w8.reshape(K2 // 2, 2, K2 // 2, 2, C, O)
    wn = wn.transpose(0, 2, 1, 3, 4, 5).reshape(K2 // 2, K2 // 2, 4 * C, O)
    out = lax.conv_general_dilated(
        s.astype(dtype),
        wn.astype(dtype),
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return out + bias.astype(dtype)


class ConvBlock(layers.Module):
    """Conv + ReLU in compute dtype (params f32, cast at the conv).

    s2d=True (stride-2 only): evaluate through the exact
    space-to-depth rewrite above, reading the SAME `Conv_0` params —
    init always builds the plain conv so the param tree is identical
    and checkpoints are interchangeable.
    """

    features: int
    kernel: int = 3
    stride: int = 1
    dtype: jnp.dtype = jnp.bfloat16
    s2d: bool = False

    @layers.compact
    def __call__(self, x):
        conv = layers.Conv(
            self.features,
            (self.kernel, self.kernel),
            strides=(self.stride, self.stride),
            padding="SAME",
            dtype=self.dtype,
            param_dtype=jnp.float32,
            name="Conv_0",
        )
        if (
            self.s2d
            and self.stride == 2
            and not self.is_initializing()
            and x.shape[1] % 2 == 0
            and x.shape[2] % 2 == 0
        ):
            p = self.variables["params"]["Conv_0"]
            y = conv_same_stride2_s2d(
                x, p["kernel"], p["bias"], self.dtype
            )
        else:
            y = conv(x)
        return jax.nn.relu(y)


def upsample2(x: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor 2x upsample of NHWC (cheap, fuses into the next
    conv; avoids transposed-conv checkerboarding and lowers cleanly)."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :]
    x = jnp.broadcast_to(x, (B, H, 2, W, 2, C))
    return x.reshape(B, 2 * H, 2 * W, C)


def resize_nearest(x: jnp.ndarray, hw: tuple[int, int]) -> jnp.ndarray:
    """Nearest 2x upsample + crop to an exact (H, W).

    Gather-free (broadcast-reshape + slice). Handles the odd sizes a stride-2 SAME
    encoder produces at 416-wide inputs: every decoder target is
    ceil(2x_source/2), so 2x-then-crop reaches it exactly.
    """
    H, W = x.shape[1], x.shape[2]
    h, w = hw
    assert h <= 2 * H and w <= 2 * W, (x.shape, hw)
    return upsample2(x)[:, :h, :w]
