"""FlowNetLite: PWC-style coarse-to-fine optical flow.

Reference parity: the vendored PWC-Net TF implementation the reference
uses as its frozen flow cue (SURVEY.md R7 [M]): feature pyramids,
correlation cost volume, per-level flow estimation with warping.
Re-designed small ("lite") and trained in-repo — there are no
importable pretrained weights in a fresh framework (SURVEY.md §7.2).

The cost volume is computed at the coarse levels only (<= /4), so it
stays small. `ModelConfig.costvol_impl` selects its lowering; "pallas"
is the fused kernel of `kernels/costvol.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from davo_tpu.config import ModelConfig
from davo_tpu.core.warp import flow_warp_separable
from davo_tpu.kernels import costvol
from davo_tpu.kernels.resize import resize_bilinear_aligned
from davo_tpu.models import layers
from davo_tpu.models.common import ConvBlock, dtype_of

_LEVEL_CHANNELS = (16, 32, 64, 96)


cost_volume = costvol.cost_volume_xla


def cost_volume_scan(
    f1: jnp.ndarray, f2: jnp.ndarray, search: int
) -> jnp.ndarray:
    """`cost_volume` as ONE `lax.scan` over shift indices (identical
    output). The unrolled form emits (2s+1)^2 slice+reduce kernels per
    level (243 at search=4 over 3 levels); the scan compiles the body
    once and loops on-device."""
    B, H, W, C = f1.shape
    d = 2 * search + 1
    f2p = jnp.pad(f2, ((0, 0), (search, search), (search, search), (0, 0)))

    def body(_, k):
        slab = jax.lax.dynamic_slice(
            f2p, (0, k // d, k % d, 0), (B, H, W, C)
        )
        return None, jnp.mean(f1 * slab, axis=-1)

    _, cv = jax.lax.scan(body, None, jnp.arange(d * d))
    return jnp.moveaxis(cv, 0, -1)


def cost_volume_gram(
    f1: jnp.ndarray, f2: jnp.ndarray, search: int
) -> jnp.ndarray:
    """Matmul formulation of `cost_volume` (identical output).

    For each of the 2s+1 row shifts dy, one batched Gram matmul over the channel
    axis computes ALL column correlations at once —
    ``G[b,y,x,v] = sum_c f1[b,y,x,c] * f2p[b,y+dy,v,c]`` — and the
    (2s+1) needed diagonals ``out[...,dx] = G[b,y,x,x+dx]`` come out as
    STRIDED slices of the flattened last two axes (stride W'+1; no
    gather — the same trick as `core.warp.flow_warp_separable`). The
    off-band Gram entries are wasted FLOPs (~11x at /4), spent on the
    matrix units. bf16 operands, f32 accumulation.
    """
    B, H, W, C = f1.shape
    d = 2 * search + 1
    Wp = W + 2 * search
    f2p = jnp.pad(f2, ((0, 0), (search, search), (search, search), (0, 0)))
    a = f1.astype(jnp.bfloat16)
    slices = []
    for dy in range(d):
        rows = jax.lax.dynamic_slice(f2p, (0, dy, 0, 0), (B, H, Wp, C))
        G = jax.lax.dot_general(
            a,
            rows.astype(jnp.bfloat16),
            (((3,), (3,)), ((0, 1), (0, 1))),
            preferred_element_type=jnp.float32,
        )  # (B, H, W, Wp)
        Gf = G.reshape(B, H, W * Wp)
        for dx in range(d):
            # out[x] = Gf[x*(Wp+1) + dx]; (W-1)*(Wp+1)+d == W*Wp exactly.
            slices.append(
                jax.lax.slice(
                    Gf,
                    (0, 0, dx),
                    (B, H, dx + (W - 1) * (Wp + 1) + 1),
                    (1, 1, Wp + 1),
                )
            )
    return jnp.stack(slices, axis=-1) / C


def cost_volume_patches(
    f1: jnp.ndarray, f2: jnp.ndarray, search: int
) -> jnp.ndarray:
    """`cost_volume` as ONE patches op + ONE contraction (identical
    output, verified to 2e-7). `conv_general_dilated_patches` extracts
    all (2s+1)^2 shifted views of f2 in a single XLA op (feature order
    (C, ky, kx), ky-major — matching the slice loop's dy-major order),
    and the correlation is a single batched einsum over C. The risk is
    materializing the (B,H,W,C*(2s+1)^2) patches tensor if XLA does not
    fuse it into the contraction.
    """
    B, H, W, C = f1.shape
    d = 2 * search + 1
    p = jax.lax.conv_general_dilated_patches(
        f2,
        filter_shape=(d, d),
        window_strides=(1, 1),
        padding=((search, search), (search, search)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    p = p.reshape(B, H, W, C, d * d)
    return jnp.einsum("bhwc,bhwck->bhwk", f1, p) / C


_COSTVOL = {
    "slices": cost_volume,
    "scan": cost_volume_scan,
    "gram": cost_volume_gram,
    "patches": cost_volume_patches,
    "pallas": costvol.cost_volume,
}


class FeaturePyramid(layers.Module):
    cfg: ModelConfig

    @layers.compact
    def __call__(self, img: jnp.ndarray) -> list[jnp.ndarray]:
        dt = dtype_of(self.cfg.compute_dtype)
        x = img.astype(dt)
        chans = _LEVEL_CHANNELS[: self.cfg.flow_levels]
        pyr = []
        for i, ch in enumerate(chans):
            x = ConvBlock(
                ch, 3, 2, dt, name=f"feat{i}a",
                s2d=(i == 0 and self.cfg.s2d_first_conv),
            )(x)
            x = ConvBlock(ch, 3, 1, dt, name=f"feat{i}b")(x)
            pyr.append(x)
        return pyr  # fine (/2) -> coarse


class FlowEstimator(layers.Module):
    cfg: ModelConfig

    @layers.compact
    def __call__(self, cv, feat, flow_up):
        dt = dtype_of(self.cfg.compute_dtype)
        x = jnp.concatenate([cv.astype(dt), feat, flow_up.astype(dt)], axis=-1)
        if self.cfg.flow_est_bottleneck > 0:
            # 1x1 channel reduction: the 3x3 stack below dominates the
            # flagship's FLOPs; feeding it `bottleneck` instead of the
            # ~115-145-ch concat halves the estimator cost.
            x = ConvBlock(
                self.cfg.flow_est_bottleneck, 1, 1, dt, name="est_in"
            )(x)
        for i, ch in enumerate((96, 64, 32)):
            x = ConvBlock(ch, 3, 1, dt, name=f"est{i}")(x)
        delta = layers.Conv(
            2, (3, 3), padding="SAME", dtype=dt,
            param_dtype=jnp.float32, name="flow",
        )(x)
        return flow_up + delta.astype(jnp.float32)


class FlowNetLite(layers.Module):
    """Returns flow pyramid fine->coarse: [(B, H/4, W/4, 2), ...].

    Flows are in pixels at each level's own resolution. Finest level is
    /4 (PWC convention); `full_res_flow` upsamples to image resolution.
    """

    cfg: ModelConfig

    def setup(self):
        self.pyramid = FeaturePyramid(self.cfg)
        # One estimator per refined level (coarsest .. /4).
        self.estimators = [
            FlowEstimator(self.cfg, name=f"estimator{lv}")
            for lv in range(1, self.cfg.flow_levels)
        ]
        if self.cfg.costvol_feat_channels > 0:
            dt = dtype_of(self.cfg.compute_dtype)
            self.cv_projs = [
                layers.Conv(
                    self.cfg.costvol_feat_channels, (1, 1), dtype=dt,
                    param_dtype=jnp.float32, name=f"cv_proj{lv}",
                )
                for lv in range(1, self.cfg.flow_levels)
            ]

    def __call__(self, img1: jnp.ndarray, img2: jnp.ndarray) -> list[jnp.ndarray]:
        # One batched pyramid pass for both images: halves the dispatch
        # count and doubles the effective batch for the small convs.
        B = img1.shape[0]
        pboth = self.pyramid(jnp.concatenate([img1, img2], axis=0))
        p1 = [p[:B] for p in pboth]
        p2 = [p[B:] for p in pboth]
        search = self.cfg.flow_search_range

        flows: list[jnp.ndarray] = []
        flow = None
        # Coarse -> fine, skipping the /2 level (stop at index 1 == /4).
        for level in range(len(p1) - 1, 0, -1):
            f1, f2 = p1[level], p2[level]
            B, H, W, _ = f1.shape
            if flow is None:
                flow_up = jnp.zeros((B, H, W, 2), jnp.float32)
                f2w = f2
            else:
                flow_up = 2.0 * resize_bilinear_aligned(flow, H, W)
                # Separable matmul warp: the smooth upsampled field
                # makes the two-pass form near-exact.
                f2w, _ = flow_warp_separable(f2, flow_up)
            cv_fn = _COSTVOL[self.cfg.costvol_impl]
            f1c, f2c = f1, f2w
            if self.cfg.costvol_feat_channels > 0:
                # One linear 1x1 applied to BOTH maps (shared weights
                # keep the correlation a dot product in a learned
                # subspace).
                proj = self.cv_projs[level - 1]
                f1c, f2c = proj(f1), proj(f2w)
            cv = jax.nn.relu(
                cv_fn(
                    f1c.astype(jnp.float32),
                    f2c.astype(jnp.float32),
                    search,
                )
            )
            flow = self.estimators[level - 1](cv, f1, flow_up)
            flows.append(flow)
        return flows[::-1]  # fine (/4) first

    @staticmethod
    def full_res_flow(flow: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
        """Upsample a /k-level flow to full resolution (values rescaled).

        du and dv scale independently (width/w and height/h): the ratios
        differ whenever a pyramid level's stride does not divide the input
        evenly, and a shared factor would mis-scale dv.
        """
        _, h, w, _ = flow.shape
        scale = jnp.asarray([width / w, height / h], flow.dtype)
        return resize_bilinear_aligned(flow, height, width) * scale
