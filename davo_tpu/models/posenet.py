"""PoseNet: frame-pair 6-DoF egomotion regression.

Reference parity: `pose_net`/`pose_exp_net` in `<ref>/nets.py`
(SURVEY.md R5 [H]): stride-2 conv stack on the concatenated frame pair,
1x1 conv head, global average pool, output scaled by 0.01. The DAVO
variant injects region attention between the encoder and the head
(SURVEY.md R6, §3.5); here that is an optional `region_weight` map
multiplied into the features pre-head, so one module serves both the
plain and the attention configurations.
"""

from __future__ import annotations

import jax.numpy as jnp

from davo_tpu.config import ModelConfig
from davo_tpu.models import layers
from davo_tpu.models.common import ConvBlock, dtype_of


class PoseEncoder(layers.Module):
    cfg: ModelConfig

    @layers.compact
    def __call__(self, pair: jnp.ndarray) -> jnp.ndarray:
        dt = dtype_of(self.cfg.compute_dtype)
        x = pair.astype(dt)
        ks = [
            7 if i == 0 else (5 if i == 1 else 3)
            for i in range(len(self.cfg.pose_channels))
        ]
        for i in range(len(ks)):
            x = ConvBlock(
                self.cfg.pose_channels[i], ks[i], 2, dt, name=f"enc{i}",
                s2d=(i == 0 and self.cfg.s2d_first_conv),
            )(x)
        return x


class PoseHead(layers.Module):
    cfg: ModelConfig

    @layers.compact
    def __call__(self, features: jnp.ndarray) -> jnp.ndarray:
        dt = dtype_of(self.cfg.compute_dtype)
        x = layers.Conv(
            6, (1, 1), dtype=dt, param_dtype=jnp.float32, name="pose_head"
        )(features)
        pose = jnp.mean(x.astype(jnp.float32), axis=(1, 2))
        return pose * self.cfg.pose_scale


class PoseNet(layers.Module):
    """6-DoF pose of source w.r.t. target from a concatenated pair.

    Output convention: `[tx, ty, tz, rx, ry, rz] * pose_scale`, the
    transform mapping target-cam points to source-cam points (matches
    `core.warp.projective_inverse_warp` and the reference).
    """

    cfg: ModelConfig

    def setup(self):
        self.encoder = PoseEncoder(self.cfg)
        self.head = PoseHead(self.cfg)

    def __call__(
        self,
        target: jnp.ndarray,
        source: jnp.ndarray,
        extra: jnp.ndarray | None = None,
        region_weight_fn=None,
    ) -> jnp.ndarray:
        """target/source: (B, H, W, 3); extra: (B, H, W, E) cue channels
        (e.g. flow). `region_weight_fn`, if given, maps the encoder
        feature shape (h, w) -> a (B, h, w, 1) attention map (from
        `attention.region_weight_map`) multiplied into the features."""
        parts = [target, source] + ([extra] if extra is not None else [])
        features = self.encoder(jnp.concatenate(parts, axis=-1))
        if region_weight_fn is not None:
            wmap = region_weight_fn((features.shape[1], features.shape[2]))
            features = features * wmap.astype(features.dtype)
        return self.head(features)
