"""Loss functions for photometric VO training.

All losses are pure functions of (model outputs, batch) -> scalar,
fused by XLA inside the jitted train step. Reference semantics
(`<ref>/davo.py`, SURVEY.md R4 [H]):

* view-synthesis: for each scale s, warp each source frame into the
  target view through DispNet depth + PoseNet pose; mix L1 and SSIM;
  per-pixel MIN over sources (Monodepth2-style min-reprojection),
  mean over all pixels with edge-clamped sampling. Two failure modes
  pinned by tests shaped this: the r1 valid-masked mean has a
  degenerate optimum at an empty mask (everything warped out of
  frame -> loss 0; collapsed a training run; kept for ablation behind
  `photo_masking="valid"`), and a per-source border-filled mean
  biases depth toward infinity (border charge on large parallax;
  saturated depth at the 100 m cap in e2e) — the min over symmetric
  sources removes the border charge while keeping collapse repulsive.
* smoothness: edge-aware disparity gradient penalty, weight decayed
  by scale (reference: smooth_weight / 2^s).
* optional pose supervision (GT-relative-pose L2) — the supervised
  pretraining tier of SURVEY.md §7.2.
* flow losses: photometric warp loss per pyramid level for
  FlowNetLite (+ optional supervised EPE on synthetic data).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from davo_tpu.config import ModelConfig, TrainConfig
from davo_tpu.core import geometry as geo
from davo_tpu.core.pyramid import image_pyramid
from davo_tpu.core.ssim import ssim
from davo_tpu.core.warp import (
    bilinear_sample,
    flow_warp,
    projective_inverse_warp,
)
from davo_tpu.kernels.resize import resize_bilinear_aligned
from davo_tpu.models.dispnet import disp_to_depth
from davo_tpu.models.flownet import FlowNetLite

_EPS = 1e-6


def photometric_loss(
    disps: list[jnp.ndarray],
    poses: jnp.ndarray,
    target: jnp.ndarray,
    sources: jnp.ndarray,
    K: jnp.ndarray,
    ssim_weight: float,
    masking: str = "border",
    depth_grad_scale: jnp.ndarray | float = 1.0,
    fullres: bool = False,
    depth_norm: bool = False,
) -> jnp.ndarray:
    """Multi-scale view-synthesis loss.

    disps: num_scales x (B, H/2^s, W/2^s, 1) sigmoid disparities
    poses: (B, S, 6); target: (B, H, W, 3); sources: (B, S, H, W, 3);
    K: (B, 3, 3) full-res intrinsics.
    masking: see `TrainConfig.photo_masking` — "border" (edge-clamped
    samples, unmasked mean; no empty-mask degeneracy), "automin"
    ("border" plus Monodepth2-style automasking expressed as min with
    the UNWARPED-source residual: pixels whose appearance is already
    static across frames — dynamic objects moving with the camera,
    static-camera frames — hit the identity floor and send no gradient
    into depth/pose; the floor is the static frame-difference, not 0,
    so no empty-mask optimum appears), or "valid" (masked mean,
    ablation only).
    depth_grad_scale: multiplier on the gradient flowing into depth
    (warm-up schedule; value and pose gradients are unaffected).
    fullres: Monodepth2-style full-resolution sampling — upsample each
    scale's disparity to input resolution and evaluate every scale's
    photometric term on the FULL-RES images (one shared full-res
    warp/compare path; the scale pyramid survives only through the
    disparity heads). See `TrainConfig.photo_fullres`.
    depth_norm: SC-SfMLearner-style per-image mean normalization of
    depth before warping. In the UNSUPERVISED regime nothing ties the
    depth scale across snippets (r2 tier B drifted to eval scale
    0.09); dividing by the batch-image mean pins every frame's depth
    to mean 1 so pose translation carries the (single, global) scale
    instead of per-snippet products depth_scale x pose_scale. Never
    use with pose supervision — GT translation then fights the
    normalization. See `TrainConfig.depth_norm`.
    """
    num_scales = len(disps)
    H, W = target.shape[1], target.shape[2]
    if fullres:
        tgt_pyr = [target] * num_scales
        src_pyrs = [
            [sources[:, s]] * num_scales for s in range(sources.shape[1])
        ]
        Ks = [K] * num_scales
    else:
        tgt_pyr = image_pyramid(target, num_scales)
        src_pyrs = [
            image_pyramid(sources[:, s], num_scales)
            for s in range(sources.shape[1])
        ]
        Ks = geo.intrinsics_pyramid(K, num_scales)
    fill = "zeros" if masking == "valid" else "border"

    total = 0.0
    for s_idx in range(num_scales):
        disp_s = disps[s_idx]
        if fullres and disp_s.shape[1:3] != (H, W):
            disp_s = resize_bilinear_aligned(disp_s, H, W)
        depth = disp_to_depth(disp_s[..., 0])  # (B, h, w)
        if depth_norm:
            depth = depth / (
                jnp.mean(depth, axis=(1, 2), keepdims=True) + _EPS
            )
        if not (isinstance(depth_grad_scale, float) and depth_grad_scale == 1.0):
            # value == depth; d/d(disp) scaled by depth_grad_scale.
            dsg = jax.lax.stop_gradient(depth)
            depth = dsg + depth_grad_scale * (depth - dsg)
        tgt = tgt_pyr[s_idx]
        mixed_per_src = []
        for src_i, src_pyr in enumerate(src_pyrs):
            warped, valid = projective_inverse_warp(
                src_pyr[s_idx], depth, poses[:, src_i], Ks[s_idx],
                fill=fill,
            )
            l1 = jnp.abs(warped - tgt)
            # SSIM output is VALID-cropped by 1px; crop l1+valid to match.
            sm = ssim(warped, tgt)
            l1c = l1[:, 1:-1, 1:-1]
            mixed = ssim_weight * sm + (1.0 - ssim_weight) * l1c
            if masking in ("border", "automin"):
                mixed_per_src.append(mixed)
                if masking == "automin":
                    # Identity (unwarped) residual: the Monodepth2
                    # automask as a min term. Slightly upweighted so
                    # ties (e.g. warp == identity at zero pose) keep
                    # gradient flowing through the WARP branch.
                    src_s = src_pyr[s_idx]
                    id_l1 = jnp.abs(src_s - tgt)[:, 1:-1, 1:-1]
                    id_sm = ssim(src_s, tgt)
                    mixed_per_src.append(
                        1.00001
                        * (ssim_weight * id_sm + (1.0 - ssim_weight) * id_l1)
                    )
            else:
                vc = valid[:, 1:-1, 1:-1]
                total = total + (mixed * vc).sum() / (
                    vc.sum() * 3.0 + _EPS
                ) / len(src_pyrs)
        if masking in ("border", "automin"):
            # Per-pixel MIN over sources (Monodepth2-style): a pixel
            # out of frame in the past source is in frame in the
            # future source, so the min drops the border charge that
            # otherwise biases depth toward infinity (measured: e2e
            # depth saturated at the 100 m cap under per-source border
            # means), while a collapse that exits BOTH sources still
            # pays full border error (no empty-mask optimum).
            mn = jnp.min(jnp.stack(mixed_per_src, 0), axis=0)
            # Edge-margin crop (~5 %): early in training poses are
            # ~zero and the ONLY depth gradient is the edge strip's
            # border charge ("shrink the warp" -> depth rails to the
            # cap before poses converge — measured; the landscape at
            # converged poses has its minimum exactly at GT depth).
            # Small legit parallax at the frame edge goes uncharged;
            # a runaway warp still pays through the whole interior.
            m = max(1, round(0.05 * min(mn.shape[1], mn.shape[2])))
            total = total + mn[:, m:-m, m:-m].mean()
    return total / num_scales


def smoothness_loss(disps: list[jnp.ndarray], target: jnp.ndarray) -> jnp.ndarray:
    """Edge-aware disparity smoothness, scale-decayed (ref: w / 2^s)."""
    tgt_pyr = image_pyramid(target, len(disps))
    total = 0.0
    for s, disp in enumerate(disps):
        # Normalize by mean disparity (scale-invariance trick).
        d = disp[..., 0]
        d = d / (jnp.mean(d, axis=(1, 2), keepdims=True) + _EPS)
        img = tgt_pyr[s]
        dx = jnp.abs(d[:, :, 1:] - d[:, :, :-1])
        dy = jnp.abs(d[:, 1:, :] - d[:, :-1, :])
        ix = jnp.mean(jnp.abs(img[:, :, 1:] - img[:, :, :-1]), axis=-1)
        iy = jnp.mean(jnp.abs(img[:, 1:, :] - img[:, :-1, :]), axis=-1)
        total = total + (
            (dx * jnp.exp(-ix)).mean() + (dy * jnp.exp(-iy)).mean()
        ) / (2.0**s)
    return total / len(disps)


def geometry_consistency_loss(
    disp_tgt: jnp.ndarray,
    disp_src_flat: jnp.ndarray,
    poses: jnp.ndarray,
    K: jnp.ndarray,
    depth_grad_scale: jnp.ndarray | float = 1.0,
    depth_norm: bool = False,
) -> jnp.ndarray:
    """SC-SfMLearner depth scale-consistency (Bian et al., 2019).

    Project every target pixel into each source frame through
    (depth, pose); the projected point's z in the source frame must
    agree with the source's own predicted depth sampled at the
    projected pixel. The normalized residual
    |d_proj - d_samp| / (d_proj + d_samp) is scale-balanced (equally
    harsh at 5 m and 50 m), so minimizing it locks the per-frame
    depth SCALES together — the drift that dominates long-sequence
    t_err in the unsupervised regime.

    disp_tgt: (B, H, W, 1) full-res target disparity;
    disp_src_flat: (S*B, H, W, 1) source disparities (source s at rows
    [s*B, (s+1)*B)); poses: (B, S, 6); K: (B, 3, 3).
    Masked mean over pixels that land in-frame with positive z; the
    empty-mask optimum is not reachable here because this term only
    ever rides on top of the photometric loss, whose border charge
    already repels warp-everything-out collapses.
    """
    B, S = poses.shape[0], poses.shape[1]
    depth_t = disp_to_depth(disp_tgt[..., 0])          # (B, H, W)
    depth_s_all = disp_to_depth(disp_src_flat[..., 0])  # (S*B, H, W)
    if depth_norm:
        # Must match photometric_loss's normalization: the poses were
        # trained against mean-1 depths, so project with the same.
        depth_t = depth_t / (
            jnp.mean(depth_t, axis=(1, 2), keepdims=True) + _EPS
        )
        depth_s_all = depth_s_all / (
            jnp.mean(depth_s_all, axis=(1, 2), keepdims=True) + _EPS
        )
    if not (
        isinstance(depth_grad_scale, float) and depth_grad_scale == 1.0
    ):
        # Honor the SAME depth warm-up gate as photometric_loss: a
        # spatially-flat depth is a global optimum of this term alone,
        # so ungated it would actively reward the rail-to-cap collapse
        # the warm-up exists to prevent (r2 training bistability).
        sg_t = jax.lax.stop_gradient(depth_t)
        depth_t = sg_t + depth_grad_scale * (depth_t - sg_t)
        sg_s = jax.lax.stop_gradient(depth_s_all)
        depth_s_all = sg_s + depth_grad_scale * (depth_s_all - sg_s)
    total = 0.0
    for s in range(S):
        T = geo.pose_vec_to_mat(poses[:, s])
        cam = geo.pixel_to_cam(depth_t, K)              # (B, 3, H, W)
        uv, z = geo.cam_to_pixel(cam, K, T)             # (B,2,H,W), (B,H,W)
        coords = jnp.moveaxis(uv, -3, -1)               # (B, H, W, 2)
        d_s = depth_s_all[s * B : (s + 1) * B]
        d_samp, valid = bilinear_sample(d_s[..., None], coords, fill="zeros")
        d_samp = d_samp[..., 0]
        v = valid[..., 0] * (z > 0.0).astype(valid.dtype)
        diff = jnp.abs(z - d_samp) / (z + d_samp + _EPS)
        total = total + (diff * v).sum() / (v.sum() + _EPS)
    return total / S


def pose_vec_l2(
    poses: jnp.ndarray, gt_vec: jnp.ndarray, rot_weight: float = 10.0
) -> jnp.ndarray:
    """L2 between predicted and GT pose VECTORS ([t, r_euler]) with
    rotation weighted up (radians are small vs meters). Shared by the
    supervised loss and the pipeline-parallel train step.

    rot_weight: at KITTI-scale motions (~0.8 m, ~0.01 rad per frame)
    the SQUARED terms differ by ~10^4, so the historical 10.0 leaves
    rotation ~600x under-trained — the r2 e2e runs showed r_err
    33 deg/100m and an attention ablation that inverted on rotation.
    Configurable via TrainConfig.rot_weight so the quality ladder can
    balance the terms per regime.
    """
    t_err = jnp.sum((poses[..., :3] - gt_vec[..., :3]) ** 2, axis=-1)
    r_err = jnp.sum((poses[..., 3:] - gt_vec[..., 3:]) ** 2, axis=-1)
    return jnp.mean(t_err + rot_weight * r_err)


def pose_supervision_loss(
    poses: jnp.ndarray, gt_pose: jnp.ndarray, rot_weight: float = 10.0
) -> jnp.ndarray:
    """L2 between predicted pose vectors and GT warp transforms.

    poses: (B, S, 6) predicted [t, r_euler]; gt_pose: (B, S, 4, 4).
    """
    return pose_vec_l2(poses, geo.mat_to_pose_vec(gt_pose), rot_weight)


def flow_losses(
    flow_pyrs: list[list[jnp.ndarray]],
    target: jnp.ndarray,
    sources: jnp.ndarray,
    ssim_weight: float,
    masking: str = "border",
    res_mode: str = "full",
) -> jnp.ndarray:
    """Unsupervised photometric loss for the flow net, per level.

    flow_pyrs[s] is the fine->coarse pyramid for source s; flow maps
    target pixels to source pixels, so warping the source by the flow
    must reconstruct the target. Same out-of-frame policy as
    `photometric_loss` (empty-mask degeneracy applies equally here).

    res_mode: where each level's photometric term is evaluated.
      "full"  — upsample every level's flow to input resolution and
                warp the FULL-RES source (the r1-r3 behavior).
      "level" — warp an avg-pooled source pyramid at each level's own
                resolution (the PWC-family convention). Flow values
                are already in level-pixel units, so no upsample or
                rescale is needed. This exists for PERFORMANCE: it
                replaces 2 sources x 3 levels of full-res bilinear
                gather warps with warps 16-64x smaller per level.
    """
    H, W = target.shape[1], target.shape[2]
    if res_mode == "level":
        # /2 avg-pool chains deep enough to reach the coarsest flow
        # level (PWC levels live at /4, /8, ... of input res).
        min_h = min(
            min(f.shape[1] for f in pyr) for pyr in flow_pyrs
        )
        depth, h_ = 1, H
        while h_ > min_h:
            h_ = (h_ + 1) // 2
            depth += 1
        tgt_pyr = image_pyramid(target, depth)
        src_pyrs_lv = [
            image_pyramid(sources[:, s], depth)
            for s in range(sources.shape[1])
        ]

        def at_res(pyr, h, w):
            for im in pyr:
                if im.shape[1] == h and im.shape[2] == w:
                    return im
            raise ValueError(
                f"no pyramid level at {h}x{w}; have "
                f"{[tuple(i.shape[1:3]) for i in pyr]}"
            )
    # Only the explicit "valid" ablation uses the masked mean; automin
    # takes the border-clamped path like "border" — mapping it to the
    # zero-filled masked mean would hand the flow net the empty-mask
    # optimum (warp everything out of frame, vc.sum() -> 0) that the
    # automin photometric path exists to remove.
    fill = "zeros" if masking == "valid" else "border"
    total = 0.0
    count = 0
    for s_i, pyr in enumerate(flow_pyrs):
        src = sources[:, s_i]
        for flow in pyr:
            if res_mode == "level":
                h, w = flow.shape[1], flow.shape[2]
                tgt_l = at_res(tgt_pyr, h, w)
                src_l = at_res(src_pyrs_lv[s_i], h, w)
                warped, valid = flow_warp(src_l, flow, fill=fill)
                tgt_cmp = tgt_l
            else:
                flow_full = FlowNetLite.full_res_flow(flow, H, W)
                warped, valid = flow_warp(src, flow_full, fill=fill)
                tgt_cmp = target
            l1 = jnp.abs(warped - tgt_cmp)[:, 1:-1, 1:-1]
            sm = ssim(warped, tgt_cmp)
            mixed = ssim_weight * sm + (1.0 - ssim_weight) * l1
            if masking == "valid":
                vc = valid[:, 1:-1, 1:-1]
                total = total + (mixed * vc).sum() / (vc.sum() * 3.0 + _EPS)
            else:
                total = total + mixed.mean()
            count += 1
    return total / max(count, 1)


def flow_supervision_loss(
    flow_pyrs: list[list[jnp.ndarray]],
    gt_flow: jnp.ndarray,
) -> jnp.ndarray:
    """Supervised end-point error vs exact GT flow, per pyramid level.

    gt_flow: (B, S, H, W, 2) target->source displacement in FULL-RES
    pixel units (data/snippets.py with_flow; the synthetic worlds
    render it exactly). Each level's predicted flow lives in
    LEVEL-pixel units on the strided level grid (models/flownet.py),
    so GT is strided down and rescaled per axis — the same sampling
    convention as the geometric pose solve
    (models/geopose.pose_from_flow_pyramid).

    Motivation (r5, VERDICT r4 #2): held-out rotation corr is ~0 in
    every photometric-trained arm while the GT-flow oracle solves pose
    exactly (results_r5_geo_oracle.json at cf6389d) — the flow net, not the
    geometry, is the generalization bottleneck. Charbonnier-EPE keeps
    gradients bounded near zero error.
    """
    B, S, H, W, _ = gt_flow.shape
    total = 0.0
    count = 0
    for s_i, pyr in enumerate(flow_pyrs):
        g_full = gt_flow[:, s_i]
        for flow in pyr:
            h, w = flow.shape[1], flow.shape[2]
            if H % h or W % w:
                raise ValueError(
                    f"level {h}x{w} does not stride-divide {H}x{W}"
                )
            sy, sx = H // h, W // w
            g = g_full[:, ::sy, ::sx]
            g = jnp.stack([g[..., 0] / sx, g[..., 1] / sy], -1)
            d2 = jnp.sum((flow.astype(jnp.float32) - g) ** 2, axis=-1)
            total = total + jnp.mean(jnp.sqrt(d2 + 1e-6))
            count += 1
    return total / max(count, 1)


def total_loss(
    outputs: dict,
    batch: dict,
    mcfg: ModelConfig,
    tcfg: TrainConfig,
    step: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, dict]:
    """Combine all loss terms; returns (scalar, metrics dict).

    step: current optimizer step (traced scalar) — drives the depth
    warm-up ramp (`TrainConfig.depth_warmup_steps`). None = no ramp.
    """
    target = batch["target"]
    sources = batch["sources"]
    K = batch["K"]
    metrics: dict = {}

    dgs: jnp.ndarray | float = 1.0
    if step is not None and tcfg.depth_warmup_steps > 0:
        dgs = jnp.clip(
            step.astype(jnp.float32) / float(tcfg.depth_warmup_steps),
            0.0, 1.0,
        )
    photo = photometric_loss(
        outputs["disp"], outputs["poses"], target, sources, K,
        tcfg.ssim_weight, masking=tcfg.photo_masking,
        depth_grad_scale=dgs, fullres=tcfg.photo_fullres,
        depth_norm=tcfg.depth_norm,
    )
    smooth = smoothness_loss(outputs["disp"], target)
    loss = photo + tcfg.smooth_weight * smooth
    metrics["photo"] = photo
    metrics["smooth"] = smooth

    if tcfg.geo_consistency_weight > 0.0 and "disp_src" in outputs:
        gc = geometry_consistency_loss(
            outputs["disp"][0], outputs["disp_src"][0], outputs["poses"], K,
            depth_grad_scale=dgs, depth_norm=tcfg.depth_norm,
        )
        loss = loss + tcfg.geo_consistency_weight * gc
        metrics["geo_consistency"] = gc

    if "flows" in outputs:
        fl = flow_losses(
            outputs["flows"], target, sources, tcfg.ssim_weight,
            masking=tcfg.photo_masking, res_mode=tcfg.flow_loss_res,
        )
        loss = loss + fl
        metrics["flow"] = fl

    if (
        tcfg.flow_supervision_weight > 0.0
        and "gt_flow" in batch
        and "flows" in outputs
    ):
        fs = flow_supervision_loss(outputs["flows"], batch["gt_flow"])
        loss = loss + tcfg.flow_supervision_weight * fs
        metrics["flow_sup"] = fs

    if tcfg.pose_supervision_weight > 0.0 and "gt_pose" in batch:
        sup = pose_supervision_loss(
            outputs["poses"], batch["gt_pose"], tcfg.rot_weight
        )
        loss = loss + tcfg.pose_supervision_weight * sup
        metrics["pose_sup"] = sup

    metrics["total"] = loss
    return loss, metrics
