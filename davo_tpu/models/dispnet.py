"""DispNet: encoder-decoder monocular disparity network.

Reference parity: `disp_net` in `<ref>/nets.py` (SURVEY.md R5 [H]) —
7-level conv encoder, skip-connected decoder, multi-scale sigmoid
disparity heads, depth = 1/(DISP_SCALING * sigmoid + MIN_DISP).

NHWC, bf16 compute, nearest-upsample+conv decoder.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from davo_tpu.config import ModelConfig
from davo_tpu.models import layers
from davo_tpu.models.common import (
    ConvBlock,
    dtype_of,
    resize_nearest as _resize_nearest,
)

DISP_SCALING = 10.0
MIN_DISP = 0.01
MIN_DEPTH = 0.5
MAX_DEPTH = 100.0


def disp_to_depth(
    disp: jnp.ndarray,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
) -> jnp.ndarray:
    """Sigmoid disparity in (0,1) -> depth, log-space parametrization:

        depth = min_depth * (max_depth / min_depth)^disp

    The reference convention (`disp_to_depth_ref`, SfMLearner lineage)
    is linear in INVERSE depth, so depths beyond ~10 m live in the
    sigmoid's saturated tail (60 m needs sigmoid ~ 7e-4, pre-activation
    -7.3) — measured r1: the head pinned at the 1/MIN_DISP=100 m cap
    and photometric gradients vanished (depth_med=100 vs GT 60). In
    log space d(depth)/d(logit) ~ depth: every relative depth change
    is equally trainable across [min_depth, max_depth], and the
    sigmoid midpoint sits at the geometric mid-scene (~7 m), not 0.2 m.
    """
    return min_depth * jnp.power(max_depth / min_depth, disp)


def depth_to_disp(
    depth: jnp.ndarray,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
) -> jnp.ndarray:
    """Inverse of `disp_to_depth` (tests feed GT depth as disparity)."""
    return jnp.log(depth / min_depth) / jnp.log(max_depth / min_depth)


def disp_to_depth_ref(disp: jnp.ndarray) -> jnp.ndarray:
    """Reference-convention depth (SURVEY.md R5: `<ref>/nets.py`
    `DISP_SCALING * sigmoid + MIN_DISP`, inverted). Kept for parity
    documentation; the training path uses the log parametrization."""
    return 1.0 / (DISP_SCALING * disp + MIN_DISP)


class ResBlock(layers.Module):
    """Pre-ReLU residual basic block (two 3x3 convs + projection
    shortcut on stride/width change). No norm layers, matching the
    conv encoder's norm-free design."""

    features: int
    stride: int = 1
    dtype: jnp.dtype = jnp.bfloat16

    @layers.compact
    def __call__(self, x):
        h = layers.Conv(
            self.features, (3, 3), strides=(self.stride, self.stride),
            padding="SAME", dtype=self.dtype, param_dtype=jnp.float32,
            name="conv1",
        )(x)
        h = jax.nn.relu(h)
        h = layers.Conv(
            self.features, (3, 3), padding="SAME", dtype=self.dtype,
            param_dtype=jnp.float32, name="conv2",
        )(h)
        if self.stride != 1 or x.shape[-1] != self.features:
            x = layers.Conv(
                self.features, (1, 1), strides=(self.stride, self.stride),
                dtype=self.dtype, param_dtype=jnp.float32, name="proj",
            )(x)
        return jax.nn.relu(x + h)


class DispNet(layers.Module):
    """Multi-scale disparity: returns `num_scales` maps, full-res first.

    Each output is a sigmoid in (0, 1); callers use `disp_to_depth`.
    Encoder selected by `cfg.disp_encoder` ("conv" | "resnet" —
    SURVEY.md R5: the reference ships `disp_net` and a ResNet variant
    behind --version); both produce identical skip shapes, so the
    decoder is shared.
    """

    cfg: ModelConfig

    @layers.compact
    def __call__(self, img: jnp.ndarray) -> list[jnp.ndarray]:
        dt = dtype_of(self.cfg.compute_dtype)
        x = img.astype(dt)

        # Encoder: one stride-2 level per configured width.
        skips = []
        for i, ch in enumerate(self.cfg.disp_channels):
            if self.cfg.disp_encoder == "resnet":
                if i == 0:  # stem: large receptive field, like the 7x7
                    x = ConvBlock(ch, 7, 2, dt, name=f"enc{i}")(x)
                    x = ResBlock(ch, 1, dt, name=f"enc{i}b")(x)
                else:
                    x = ResBlock(ch, 2, dt, name=f"enc{i}")(x)
                    x = ResBlock(ch, 1, dt, name=f"enc{i}b")(x)
            else:
                k = 7 if i == 0 else (5 if i == 1 else 3)
                x = ConvBlock(ch, k, 2, dt, name=f"enc{i}")(x)
                x = ConvBlock(ch, 3, 1, dt, name=f"enc{i}b")(x)
            skips.append(x)

        # Decoder with skips; disparity heads on the last num_scales levels.
        disps = []
        full_hw = (img.shape[1], img.shape[2])
        up_channels = list(self.cfg.disp_channels[::-1][1:]) + [16]
        for i, ch in enumerate(up_channels):
            skip_idx = len(self.cfg.disp_channels) - 2 - i
            target_hw = (
                (skips[skip_idx].shape[1], skips[skip_idx].shape[2])
                if skip_idx >= 0
                else full_hw
            )
            x = _resize_nearest(x, target_hw)
            x = ConvBlock(ch, 3, 1, dt, name=f"dec{i}")(x)
            if skip_idx >= 0:
                x = jnp.concatenate([x, skips[skip_idx]], axis=-1)
            x = ConvBlock(ch, 3, 1, dt, name=f"dec{i}b")(x)
            level = len(up_channels) - 1 - i  # 0 = full res
            if level < self.cfg.num_scales:
                disp = layers.Conv(
                    1, (3, 3), padding="SAME", dtype=dt,
                    param_dtype=jnp.float32, name=f"disp{level}",
                )(x)
                disps.append(jax.nn.sigmoid(disp.astype(jnp.float32)))
        # Built coarse->fine; return fine->coarse (scale 0 first).
        return disps[::-1]
