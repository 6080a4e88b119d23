"""Dynamic region attention — the DAVO paper's core contribution.

Mechanism (SURVEY.md R6 / §3.5 [H]): optical flow between the frame
pair drives a small network producing one weight per semantic region
(19 Cityscapes classes); the per-pixel segmentation one-hot turns those
into a spatial weight map that rescales pose features region-by-region,
so dynamic-object regions can be down-weighted when estimating
egomotion.

Design here: `RegionAttention` maps flow -> 19 softmax weights
(x num_classes so the mean weight is ~1 and the no-attention model is
a fixed point), then `region_weight_map` projects them through the
one-hot segmentation at feature resolution. The masked-fuse is an
elementwise multiply.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from davo_tpu.config import ModelConfig
from davo_tpu.models import layers
from davo_tpu.models.common import ConvBlock, dtype_of


class RegionAttention(layers.Module):
    """Flow -> per-region attention weights (B, num_seg_classes)."""

    cfg: ModelConfig

    @layers.compact
    def __call__(self, flow: jnp.ndarray) -> jnp.ndarray:
        """flow: (B, H, W, F) flow/cue stack (e.g. fwd+bwd = 4 chans)."""
        dt = dtype_of(self.cfg.compute_dtype)
        x = flow.astype(dt)
        chans = (16, 32, 64)
        for i in range(len(chans)):
            x = ConvBlock(chans[i], 3, 2, dt, name=f"conv{i}")(x)
        x = jnp.mean(x, axis=(1, 2)).astype(jnp.float32)  # (B, 64)
        x = jax.nn.relu(layers.Dense(64, name="fc0")(x))
        logits = layers.Dense(self.cfg.num_seg_classes, name="fc1")(x)
        # Softmax * K: sums to K, mean 1 -> uniform weights == identity.
        return jax.nn.softmax(logits, axis=-1) * self.cfg.num_seg_classes


def seg_to_onehot(seg: jnp.ndarray, num_classes: int) -> jnp.ndarray:
    """(B, H, W) int labels -> (B, H, W, K) float one-hot."""
    return jax.nn.one_hot(seg, num_classes, dtype=jnp.float32)


def region_weight_map(
    weights: jnp.ndarray, seg_onehot: jnp.ndarray, hw: tuple[int, int]
) -> jnp.ndarray:
    """Per-region weights + segmentation -> spatial weight map.

    weights: (B, K); seg_onehot: (B, H, W, K) at any resolution;
    returns (B, h, w, 1) at the feature resolution `hw`. When hw
    divides (H, W) exactly the one-hot is average-pooled first (soft
    per-cell class fractions — gather-free, and semantically the
    receptive-field class mix); otherwise falls back to resize.
    """
    B, H, W, K = seg_onehot.shape
    h, w = hw
    if (H, W) != (h, w) and H % h == 0 and W % w == 0:
        win = (1, H // h, W // w, 1)
        pooled = jax.lax.reduce_window(
            seg_onehot, 0.0, jax.lax.add, win, win, "VALID"
        ) / float(win[1] * win[2])
        return jnp.einsum("bhwk,bk->bhw", pooled, weights)[..., None]
    wmap = jnp.einsum("bhwk,bk->bhw", seg_onehot, weights)[..., None]
    if (H, W) != (h, w):
        wmap = jax.image.resize(wmap, (B, h, w, 1), method="bilinear")
    return wmap


def make_region_weight_map_ep(mesh, axis: str = "model"):
    """Expert-parallel region fusion (SURVEY.md §2.2 P5) — factory.

    The 19 semantic-region branches are the natural expert axis: each
    device owns a contiguous region chunk, computes its partial
    weight-map contribution sum_k a_k * onehot_k, and a psum over the
    region axis fuses them. Semantically identical to
    `region_weight_map` (tests pin equality); the K axis is padded to
    the axis size.

    Returns a JITTED (weights, seg_onehot, hw) -> (B, h, w, 1) closure:
    the region-axis resharding is part of the compiled program (GSPMD
    inserts the layout change), not a per-call host `device_put`.
    """
    from functools import partial

    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis]

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, None, None, axis)),
        out_specs=P(),
        check_vma=False,
    )
    def fuse(w_local, oh_local):
        partial_map = jnp.einsum("bhwk,bk->bhw", oh_local, w_local)
        return jax.lax.psum(partial_map, axis)

    @partial(jax.jit, static_argnames=("hw",))
    def apply(weights, seg_onehot, hw):
        B, H, W, K = seg_onehot.shape
        h, w = hw
        pad = (-K) % n
        if pad:
            seg_onehot = jnp.pad(seg_onehot, ((0, 0),) * 3 + ((0, pad),))
            weights = jnp.pad(weights, ((0, 0), (0, pad)))
        wmap = fuse(weights, seg_onehot)[..., None]
        if (H, W) != (h, w):
            if H % h == 0 and W % w == 0:
                win = (1, H // h, W // w, 1)
                wmap = jax.lax.reduce_window(
                    wmap, 0.0, jax.lax.add, win, win, "VALID"
                ) / float(win[1] * win[2])
            else:
                # Same non-divisible fallback as region_weight_map —
                # without it the promised (B, h, w, 1) shape breaks.
                wmap = jax.image.resize(
                    wmap, (B, h, w, 1), method="bilinear"
                )
        return wmap

    return apply


_EP_CACHE: dict = {}


def region_weight_map_ep(
    weights: jnp.ndarray,
    seg_onehot: jnp.ndarray,
    hw: tuple[int, int],
    mesh,
    axis: str = "model",
):
    """One-shot convenience over `make_region_weight_map_ep`.

    The factory result is memoized per (mesh, axis) — rebuilding it
    per call would hand every invocation a fresh empty jit cache and
    recompile the GSPMD program each time.
    """
    key = (mesh, axis)
    if key not in _EP_CACHE:
        _EP_CACHE[key] = make_region_weight_map_ep(mesh, axis)
    return _EP_CACHE[key](weights, seg_onehot, hw)
