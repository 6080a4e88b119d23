"""DavoModel: the full DAVO-equivalent forward pass.

Wires the subnets per the reference pipeline (SURVEY.md §3.5):

    (I_src, I_tgt) -> FlowNetLite -> flow pyramid
    flow (+seg one-hot) -> RegionAttention -> 19 region weights
    (I_tgt, I_src, flow) -> PoseNet encoder -> features
    features x region-weight-map -> pose head -> 6-DoF xi * 0.01
    I_tgt -> DispNet -> multi-scale disparity           (training only)

`attention` config: "none" (plain PoseNet, BASELINE config #1/#2),
"flow" (flow cue channels, no region weighting), "flow_seg" (full
paper model, BASELINE config #3).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from davo_tpu.config import ModelConfig
from davo_tpu.kernels.resize import resize_bilinear_aligned
from davo_tpu.models import layers
from davo_tpu.models.attention import (
    RegionAttention,
    region_weight_map,
    seg_to_onehot,
)
from davo_tpu.models.dispnet import DispNet
from davo_tpu.models.flownet import FlowNetLite
from davo_tpu.models.posenet import PoseNet


class DavoModel(layers.Module):
    cfg: ModelConfig

    def setup(self):
        self.posenet = PoseNet(self.cfg)
        if self.cfg.attention != "none":
            self.flownet = FlowNetLite(self.cfg)
        if self.cfg.attention == "flow_seg":
            self.attn = RegionAttention(self.cfg)
        self.dispnet = DispNet(self.cfg)

    def __call__(
        self,
        target: jnp.ndarray,
        sources: jnp.ndarray,
        seg: jnp.ndarray | None = None,
        train: bool = True,
        source_disp: bool = False,
        K: jnp.ndarray | None = None,
    ) -> dict[str, Any]:
        """target: (B, H, W, 3); sources: (B, S, H, W, 3);
        seg: (B, H, W) int labels (required for attention="flow_seg").
        source_disp: also predict source-frame disparities (one
        batch-folded DispNet pass over target+sources) — required by
        the geometry-consistency loss (TrainConfig
        geo_consistency_weight > 0).
        K: (3, 3) or (B, 3, 3) intrinsics — required when
        cfg.pose_head == "geo_hybrid" (the dense GN solve needs the
        camera; models/geopose.py).

        Returns dict with:
          poses:      (B, S, 6) target->source pose vectors
          disp:       list of (B, H/2^s, W/2^s, 1), train only
          disp_src:   list of (S*B, ..., 1) (train + source_disp only;
                      source s at rows [s*B, (s+1)*B))
          flows:      per-source flow pyramids (attention != none)
          attn:       (B, S, K) region weights (attention == "flow_seg")
        """
        B, S = sources.shape[0], sources.shape[1]
        H, W = target.shape[1], target.shape[2]
        out: dict[str, Any] = {}

        # Batch-fold the source axis: every subnet runs ONCE on a
        # (S*B)-batch instead of S times — on this stack per-kernel
        # launch overhead dominates small convs, so halving the kernel
        # count halves the step time (measured; see kernels/__init__).
        # Layout: source s occupies rows [s*B, (s+1)*B).
        flat_src = jnp.moveaxis(sources, 1, 0).reshape(S * B, H, W, 3)
        rep_tgt = jnp.tile(target, (S, 1, 1, 1))

        # Temporal-direction plane: the reference disambiguates motion
        # direction POSITIONALLY (triplet concat -> per-slot outputs,
        # `pose_exp_net`); with batch-folded pairs that information
        # must ride as an input channel, else the net faces the
        # zero-pose plateau (must infer direction from parallax before
        # any pose gradient flows — measured: no learning in 1.5k
        # steps without this, immediate with it).
        # Sources are ordered [t-k..t-1, t+1..t+k]; offset in [-1, 1].
        k = S // 2 if S > 1 else 1
        offsets = [
            (i - k if i < k else i - k + 1) / k if S > 1 else -1.0
            for i in range(S)
        ]
        dir_plane = jnp.concatenate(
            [
                jnp.full((B, H, W, 1), o, target.dtype)
                for o in offsets
            ],
            axis=0,
        )

        extra = dir_plane
        region_weight_fn = None
        if self.cfg.attention != "none":
            pyr = self.flownet(rep_tgt, flat_src)  # levels of (S*B, h, w, 2)
            out["flows"] = [
                [level[s * B : (s + 1) * B] for level in pyr]
                for s in range(S)
            ]
            flow_full = FlowNetLite.full_res_flow(pyr[0], H, W)
            extra = jnp.concatenate([dir_plane, flow_full], axis=-1)
            if self.cfg.attention == "flow_seg":
                attn_in = flow_full
                if self.cfg.attention_cue == "flow_fb":
                    # Occlusion-aware gating channel: backward flow
                    # (source->target, same net/params — the pair is
                    # just swapped) sampled at the forward-warped
                    # position; |fwd(x) + bwd(x + fwd(x))| ~ 0 iff the
                    # point is rigid and co-visible. Computed at the
                    # finest PYRAMID level (/4) — flow_warp_separable's
                    # own contract (its one-hot weight tensors scale
                    # with resolution^2: full-res at the reference
                    # preset would be GBs), then the 1-ch magnitude is
                    # upsampled. eps under the sqrt: |.| has a NaN
                    # gradient at exactly-zero residuals, which a
                    # converged bf16 flow pair reaches in flat regions.
                    from davo_tpu.core.warp import flow_warp_separable

                    pyr_b = self.flownet(flat_src, rep_tgt)
                    fwd4, bwd4 = pyr[0], pyr_b[0]
                    bwd_at_fwd, _ = flow_warp_separable(bwd4, fwd4)
                    # Rescale per axis BEFORE the norm: du scales by
                    # W/w4 and dv by H/h4, and the ratios differ when
                    # the /4 stride does not divide the input evenly
                    # (same hazard full_res_flow documents).
                    resid = (fwd4 + bwd_at_fwd) * jnp.asarray(
                        [W / fwd4.shape[2], H / fwd4.shape[1]],
                        jnp.float32,
                    )
                    fb4 = jnp.sqrt(
                        jnp.sum(resid * resid, axis=-1, keepdims=True)
                        + 1e-8
                    )
                    fb_mag = resize_bilinear_aligned(fb4, H, W)
                    attn_in = jnp.concatenate([flow_full, fb_mag], axis=-1)
                weights = self.attn(attn_in)  # (S*B, K)
                out["attn"] = jnp.moveaxis(
                    weights.reshape(S, B, -1), 0, 1
                )
                if seg is not None:
                    seg_oh = seg_to_onehot(
                        jnp.tile(seg, (S, 1, 1)), self.cfg.num_seg_classes
                    )
                    region_weight_fn = (
                        lambda hw, w=weights: region_weight_map(w, seg_oh, hw)
                    )
        need_geo = self.cfg.pose_head == "geo_hybrid"
        disps_t = None
        if train:
            if source_disp:
                # One folded pass: rows [0, B) = target, then source
                # blocks — a single DispNet dispatch instead of S+1.
                disps_all = self.dispnet(
                    jnp.concatenate([target, flat_src], axis=0)
                )
                out["disp"] = [d[:B] for d in disps_all]
                out["disp_src"] = [d[B:] for d in disps_all]
            else:
                out["disp"] = self.dispnet(target)
            disps_t = out["disp"]
        elif need_geo:
            disps_t = self.dispnet(target)

        pose_flat = self.posenet(
            rep_tgt, flat_src, extra=extra, region_weight_fn=region_weight_fn
        )  # (S*B, 6)
        if need_geo:
            # Geometry-grounded pose: dense GN on the finest pyramid
            # flow + DispNet depth (models/geopose.py). The conv head
            # above becomes a learned RESIDUAL on the geometric
            # estimate (it initializes near zero via pose_scale).
            # CANDIDATE, not validated: the first chip arms lost to
            # the conv head (results_r4_quality_geo.json at cf6389d, rot corr
            # ~0); the r5 oracle proves the solve exact on GT flow at
            # the (step-clipped) defaults, so predicted-flow quality
            # is the open bottleneck (flow_supervision_weight).
            if self.cfg.attention == "none":
                raise ValueError(
                    "pose_head='geo_hybrid' needs the flow net "
                    "(attention != 'none')"
                )
            if K is None:
                raise ValueError("pose_head='geo_hybrid' requires K")
            from davo_tpu.models.dispnet import disp_to_depth
            from davo_tpu.models.geopose import pose_from_flow_pyramid

            depth_t = disp_to_depth(disps_t[0][..., 0].astype(jnp.float32))
            depth_rep = jnp.tile(depth_t, (S, 1, 1))
            Kr = (
                jnp.tile(K, (S, 1, 1))
                if K is not None and K.ndim == 3
                else K
            )
            geo_vec = pose_from_flow_pyramid(
                pyr[0].astype(jnp.float32),
                depth_rep,
                Kr,
                (H, W),
                iters=self.cfg.geo_pose_iters,
                damping=self.cfg.geo_pose_damping,
                robust_delta=self.cfg.geo_pose_robust,
                step_clip=self.cfg.geo_pose_step_clip,
            )
            out["pose_geo"] = jnp.moveaxis(
                geo_vec.reshape(S, B, 6), 0, 1
            )
            pose_flat = pose_flat + geo_vec.astype(pose_flat.dtype)
        out["poses"] = jnp.moveaxis(pose_flat.reshape(S, B, 6), 0, 1)
        return out
