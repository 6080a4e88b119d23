"""Differentiable image warping: bilinear sampling + projective inverse warp.

The hot op of the photometric training loss (reference:
`<ref>/utils.py` `projective_inverse_warp` + `bilinear_sampler`,
SURVEY.md §3.1 HOT LOOP).

* Images are NHWC.
* Out-of-bounds handling is branch-free: coordinates are clamped for
  the gather and a validity mask is returned alongside. `fill`
  selects whether invalid samples are zeroed ("zeros") or keep the
  edge-clamped value ("border", the loss path — see
  `bilinear_sample` on the empty-mask degeneracy).
* The gather is four flat `take_along_axis` taps ("take4", exact) or
  one (2, 2, C) `lax.gather` per pixel ("block", same values). The
  "banded" method clamps each sample's displacement into a band
  before the take4 gather (see `bilinear_sample`).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import lax

from davo_tpu.core import geometry as geo

# Module default: "take4", the exact gather, used by every
# non-training context. TRAINING resolves its own policy from
# TrainConfig.warp_gather (train/loop.warp_policy) while its step is
# traced. DAVO_WARP_GATHER / DAVO_WARP_BAND="rv,rh" override the
# process default.
_DEFAULT_GATHER = os.environ.get("DAVO_WARP_GATHER", "take4")
_BAND = tuple(
    int(t) for t in os.environ.get("DAVO_WARP_BAND", "4,16").split(",")
)


def configure(gather: str | None = None,
              band: tuple[int, int] | None = None) -> None:
    """Set the process-wide default gather method / clamp band.

    The training loop applies `TrainConfig.warp_gather` through this
    while its step is traced (resolution order: explicit config >
    DAVO_WARP_GATHER env > "auto" = "banded"); harnesses may call it
    directly. `None` leaves the current value untouched.
    """
    global _DEFAULT_GATHER, _BAND
    if gather is not None:
        _DEFAULT_GATHER = gather
    if band is not None:
        _BAND = tuple(band)


def bilinear_sample(
    img: jnp.ndarray,
    coords: jnp.ndarray,
    fill: str = "zeros",
    method: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sample `img` at continuous pixel coordinates.

    img:    (B, H, W, C)
    coords: (B, Ho, Wo, 2) — (u, v) pixel coordinates in img's frame
    fill:   out-of-frame value policy — "zeros" zeroes invalid samples;
            "border" returns the edge-clamped sample (the reference
            family's padding mode). Losses use "border": a masked mean
            normalized by the valid count has a degenerate optimum at
            an EMPTY mask (warp everything out of frame -> loss 0 —
            observed collapsing a training run), while border
            samples keep out-of-frame pixels penalized.
    method: "take4" (four flat take_along_axis taps), "block" (one
            (2,2,C) lax.gather per pixel; same values), or "banded"
            (take4 after clamping each sample's displacement from its
            own pixel into the configured band (rv, rh): exact where
            |du| <= rh and |dv| <= rv, the band edge beyond — VO loss
            path only). The process default is "take4" unless
            `configure` or DAVO_WARP_GATHER set another.
    Returns (sampled (B, Ho, Wo, C), valid (B, Ho, Wo, 1) in {0., 1.}).
    """
    m = method or _DEFAULT_GATHER
    if m == "block":
        return _bilinear_sample_block(img, coords, fill)
    if m == "banded":
        return _bilinear_sample_take4(
            img, coords, fill, band=(_BAND[0], _BAND[1])
        )
    return _bilinear_sample_take4(img, coords, fill)


def band_clamp(
    coords: jnp.ndarray, rv: int, rh: int, height: int, width: int
) -> jnp.ndarray:
    """Clamp each (u, v) sample to within (rh, rv) pixels of its own
    output pixel, then into the frame:
    uc = clip(clip(u - x, -rh, rh) + x, 0, W - 1), likewise v.

    A value exactly on a bound passes through with gradient 1 (where
    `jnp.clip` would split it), so gradients equal take4's everywhere
    inside the band, the band's edge and the frame's edge included."""
    Ho, Wo = coords.shape[-3], coords.shape[-2]
    x = jnp.arange(Wo, dtype=coords.dtype)[None, :]
    y = jnp.arange(Ho, dtype=coords.dtype)[:, None]
    u = _clamp(_clamp(coords[..., 0] - x, -rh, rh) + x, 0.0, width - 1.0)
    v = _clamp(_clamp(coords[..., 1] - y, -rv, rv) + y, 0.0, height - 1.0)
    return jnp.stack([u, v], axis=-1)


def _clamp(a: jnp.ndarray, lo: float, hi: float) -> jnp.ndarray:
    return jnp.where(a < lo, lo, jnp.where(a > hi, hi, a))


def _bilinear_sample_block(
    img: jnp.ndarray, coords: jnp.ndarray, fill: str
) -> tuple[jnp.ndarray, jnp.ndarray]:
    B, H, W, C = img.shape
    u = coords[..., 0]
    v = coords[..., 1]
    valid = (
        (u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0)
    )[..., None].astype(img.dtype)

    # Clamp-then-floor: for coords past the top edge, fu/fv saturate at
    # 1.0 with the start pinned to the last valid 2-window, reproducing
    # take4's independently clamped taps exactly (both read the border
    # pixel with total weight 1).
    uc = jnp.clip(u, 0.0, W - 1.0)
    vc = jnp.clip(v, 0.0, H - 1.0)
    u0 = jnp.clip(jnp.floor(uc), 0, W - 2).astype(jnp.int32)
    v0 = jnp.clip(jnp.floor(vc), 0, H - 2).astype(jnp.int32)
    fu = (uc - u0.astype(uc.dtype))[..., None]
    fv = (vc - v0.astype(vc.dtype))[..., None]

    dn = lax.GatherDimensionNumbers(
        offset_dims=(1, 2, 3),
        collapsed_slice_dims=(),
        start_index_map=(0, 1),
    )

    def per_image(im, vv, uu):
        idx = jnp.stack([vv.reshape(-1), uu.reshape(-1)], axis=-1)
        blk = lax.gather(
            im, idx, dn, slice_sizes=(2, 2, C),
            indices_are_sorted=False, unique_indices=False,
            mode=lax.GatherScatterMode.CLIP,
        )  # (Ho*Wo, 2, 2, C)
        return blk.reshape(vv.shape + (2, 2, C))

    blk = jax.vmap(per_image)(img, v0, u0)  # (B, Ho, Wo, 2, 2, C)
    top = blk[..., 0, 0, :] * (1.0 - fu) + blk[..., 0, 1, :] * fu
    bot = blk[..., 1, 0, :] * (1.0 - fu) + blk[..., 1, 1, :] * fu
    out = top * (1.0 - fv) + bot * fv
    if fill == "border":
        return out, valid
    return out * valid, valid


def _bilinear_sample_take4(
    img: jnp.ndarray, coords: jnp.ndarray, fill: str,
    band: tuple[int, int] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    B, H, W, C = img.shape
    u = coords[..., 0]
    v = coords[..., 1]
    valid = (
        (u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0)
    )[..., None].astype(img.dtype)
    if band is not None:
        # `valid` stays the in-frame test of the ORIGINAL coordinates.
        clamped = band_clamp(coords, band[0], band[1], H, W)
        u, v = clamped[..., 0], clamped[..., 1]

    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]

    u0c = jnp.clip(u0, 0, W - 1).astype(jnp.int32)
    v0c = jnp.clip(v0, 0, H - 1).astype(jnp.int32)
    u1c = jnp.clip(u0 + 1, 0, W - 1).astype(jnp.int32)
    v1c = jnp.clip(v0 + 1, 0, H - 1).astype(jnp.int32)

    flat = img.reshape(B, H * W, C)

    def gather(vi, ui):
        idx = vi * W + ui  # (B, Ho, Wo)
        return jnp.take_along_axis(
            flat, idx.reshape(B, -1, 1), axis=1
        ).reshape(idx.shape + (C,))

    p00 = gather(v0c, u0c)
    p01 = gather(v0c, u1c)
    p10 = gather(v1c, u0c)
    p11 = gather(v1c, u1c)

    top = p00 * (1.0 - du) + p01 * du
    bot = p10 * (1.0 - du) + p11 * du
    out = top * (1.0 - dv) + bot * dv
    if fill == "border":
        return out, valid
    return out * valid, valid


def projective_inverse_warp(
    src: jnp.ndarray,
    depth: jnp.ndarray,
    pose: jnp.ndarray,
    K: jnp.ndarray,
    rotation: str = "euler",
    fill: str = "zeros",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reconstruct the target view by sampling `src` through depth + pose.

    src:   (B, H, W, C) source image
    depth: (B, H, W) target-view depth
    pose:  (B, 6) target->source 6-DoF vector ([t, r]) or (B, 4, 4) matrix
    K:     (B, 3, 3) intrinsics
    Returns (warped (B, H, W, C), valid (B, H, W, 1)).

    Equivalent of the reference's `projective_inverse_warp`
    (`<ref>/utils.py`, SURVEY.md R10): target pixel -> cam point (depth)
    -> transform by pose -> project -> bilinear-sample source.
    """
    if pose.ndim == 2:
        T = geo.pose_vec_to_mat(pose, rotation=rotation)
    else:
        T = pose
    cam = geo.pixel_to_cam(depth, K)  # (B, 3, H, W)
    uv, z = geo.cam_to_pixel(cam, K, T)  # (B, 2, H, W), (B, H, W)
    coords = jnp.moveaxis(uv, -3, -1)  # (B, H, W, 2)
    warped, valid = bilinear_sample(src, coords, fill=fill)
    # Points that project behind the source camera are invalid.
    valid = valid * (z > 0.0)[..., None].astype(valid.dtype)
    if fill == "border":
        return warped, valid
    return warped * valid, valid


def flow_warp(
    src: jnp.ndarray, flow: jnp.ndarray, fill: str = "zeros"
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Warp `src` by a dense flow field (exact bilinear gather).

    src:  (B, H, W, C); flow: (B, H, W, 2) with flow[..., 0] = du,
    flow[..., 1] = dv (sample src at (u + du, v + dv)).
    Used by the PWC-style flow net's pyramid warping (SURVEY.md R7).
    """
    B, H, W, _ = src.shape
    grid = geo.pixel_grid(H, W, src.dtype)[:2]  # (2, H, W)
    coords = jnp.moveaxis(grid, 0, -1)[None] + flow  # (B, H, W, 2)
    return bilinear_sample(src, coords, fill=fill)


def flow_warp_separable(
    src: jnp.ndarray, flow: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather-free flow warp: two banded one-hot MATMUL passes.

      pass 1 (exact):  mid[b,y,x]  = sum_w  Wx[b,y,x,w] src[b,y,w]
      pass 2:          out[b,y,x]  = sum_h  Wy[b,y,x,h] mid[b,h,x]

    where Wx/Wy are bilinear hat weights relu(1 - |i - coord|). The
    horizontal pass is exact; the vertical pass evaluates du at row h
    instead of row y, an O(|d du/dy| * |dv|) approximation that is
    negligible for the SMOOTH fields warped inside a PWC pyramid
    (upsampled coarse flow). Use only at pyramid resolution: weight
    tensors are (B,H,W,W)/(B,H,W,H).

    Returns (warped, valid) with the same contract as `flow_warp`.
    """
    B, H, W, C = src.shape
    dt = src.dtype
    grid = geo.pixel_grid(H, W, jnp.float32)[:2]
    u = grid[0][None] + flow[..., 0]  # (B, H, W)
    v = grid[1][None] + flow[..., 1]
    valid = (
        (u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0)
    )[..., None].astype(dt)
    uc = jnp.clip(u, 0.0, W - 1.0)
    vc = jnp.clip(v, 0.0, H - 1.0)

    xs = jnp.arange(W, dtype=jnp.float32)
    Wx = jax.nn.relu(1.0 - jnp.abs(xs - uc[..., None])).astype(dt)
    mid = jnp.einsum("byxw,bywc->byxc", Wx, src)

    hs = jnp.arange(H, dtype=jnp.float32)
    Wy = jax.nn.relu(1.0 - jnp.abs(hs - vc[..., None])).astype(dt)
    out = jnp.einsum("byxh,bhxc->byxc", Wy, mid)
    return out * valid, valid
