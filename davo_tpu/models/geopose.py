"""Geometry-grounded pose estimation: dense flow + depth -> 6-DoF.

The learned conv pose head regresses pose from image features — the
r4 quality ladders measured that this does NOT generalize rotation
across held-out worlds (pred-vs-GT rot corr ~0 on wander AND drive
worlds while the overfit micro-test reaches 0.96, R4_RESULTS.md at cf6389d): the
head memorizes textures instead of reading the motion field. Rotation
is, however, a GEOMETRIC functional of the flow field — depth enters
only through translation — so solving for the pose that best explains
the predicted flow CAN generalize across textures. STATUS: candidate,
not validated — the first trained arms LOST to the conv head (rot corr
~0, t_err 26.1 vs 22.6 %, results_r4_quality_geo.json at cf6389d). The r5
GT-flow oracle (results_r5_geo_oracle.json at cf6389d) splits the blame: the
solve itself is exact on GT flow once step-clipped (see
`pose_from_flow`), so the open bottleneck is PREDICTED-flow quality —
attacked via flow supervision (TrainConfig.flow_supervision_weight).

`pose_from_flow` is a differentiable dense Gauss-Newton solve of

    min_T  sum_x w(x) || pi(K (R X(x) + t)) - (x + u(x)) ||^2

with X(x) = Z(x) K^-1 x_h, run a fixed number of iterations (static
control flow, jit-friendly: each iteration is two einsum contractions
to a (B, 6, 6) system + a batched 6x6 solve — dense work, no
scatter/gather). Gradients flow to `flow`, `depth` and `weight`, so
training through this head supervises the flow net geometrically.

Conventions match the package (core/geometry.py, data/synthetic.py):
flow maps target pixel x to its source-frame position x + u, and the
returned pose vec [tx ty tz rx ry rz] (Euler, reference layout) is
the target-cam -> source-cam transform — the same object the conv
head regresses (models/davo.py `poses`).

Reference anchor: this replaces nothing in `<ref>` (the reference is
pure-learned); it is the davo_tpu-native composition of the package's
BA machinery (ba/schur.py lineage) with the flow/attention cues.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from davo_tpu.core import geometry as geo


def _skew(v: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], -1),
            jnp.stack([z, o, -x], -1),
            jnp.stack([-y, x, o], -1),
        ],
        -2,
    )


def pose_from_flow(
    flow: jnp.ndarray,
    depth: jnp.ndarray,
    K: jnp.ndarray,
    weight: jnp.ndarray | None = None,
    iters: int = 3,
    damping: float = 1e-3,
    min_depth: float = 0.1,
    robust_delta: float = 0.0,
    step_clip: float = 0.0,
) -> jnp.ndarray:
    """Dense GN solve for the target->source pose explaining `flow`.

    flow:   (B, H, W, 2) pixel displacement (du, dv), x_src = x + u
    depth:  (B, H, W) target-frame depth (any consistent scale)
    K:      (3, 3) or (B, 3, 3) intrinsics AT flow resolution
    weight: optional (B, H, W) per-pixel confidence (>= 0); in-frame
            validity of x + u is always applied on top
    step_clip: >0 caps each GN update's 6-vector norm (trust region).
            Measured (results_r5_geo_oracle.json at cf6389d): on drive worlds a
            few % of GT-flow pairs DIVERGE under unclipped GN from
            identity (overshoot; max err 9 deg at iters=4-16) and only
            re-converge by ~20 iterations; with step_clip=0.5 every
            pair is exact by 6 iterations (max 0.014 deg). 0 = off.
    Returns (B, 6) pose vec [t, euler] in the model convention.
    """
    B, H, W, _ = flow.shape
    f32 = jnp.float32
    flow = flow.astype(f32)
    depth = jnp.maximum(depth.astype(f32), min_depth)
    if K.ndim == 2:
        K = jnp.broadcast_to(K, (B, 3, 3))
    K = K.astype(f32)

    grid = geo.pixel_grid(H, W, f32)  # (3, H, W)
    X = geo.pixel_to_cam(depth, K)  # (B, 3, H, W)
    Xf = X.reshape(B, 3, H * W)
    target_px = (grid[None, :2] + jnp.moveaxis(flow, -1, 1)).reshape(
        B, 2, H * W
    )

    # Validity: the matched position must land in frame.
    u_t, v_t = target_px[:, 0], target_px[:, 1]
    valid = (
        (u_t >= 0.0) & (u_t <= W - 1.0) & (v_t >= 0.0) & (v_t <= H - 1.0)
    ).astype(f32)
    w = valid
    if weight is not None:
        w = w * jnp.maximum(weight.astype(f32), 0.0).reshape(B, H * W)
    # Normalize so the damping term has a stable relative magnitude.
    w = w / (jnp.mean(w, axis=1, keepdims=True) + 1e-8)

    R = jnp.broadcast_to(jnp.eye(3, dtype=f32), (B, 3, 3))
    t = jnp.zeros((B, 3), f32)

    for _ in range(iters):
        P = jnp.einsum("bij,bjn->bin", R, Xf) + t[:, :, None]
        q = jnp.einsum("bij,bjn->bin", K, P)
        qz = jnp.maximum(q[:, 2], min_depth)
        px = q[:, 0] / qz
        py = q[:, 1] / qz
        r = jnp.stack([px, py], 1) - target_px  # (B, 2, N)
        wi = w
        if robust_delta > 0.0:
            # IRLS Huber: down-weight residuals beyond `robust_delta`
            # level-pixels — flow outliers and dynamic objects stop
            # steering the solve (the geometric analog of DAVO's
            # dynamic-region attention).
            rn = jnp.sqrt(jnp.sum(r * r, axis=1) + 1e-12)
            wi = w * (robust_delta / jnp.maximum(rn, robust_delta))

        # d(px)/dP = (K_row0 - px * K_row2) / qz (K_row2 = [0,0,1]).
        Jp = (
            jnp.stack(
                [
                    K[:, 0, :, None] - px[:, None, :] * K[:, 2, :, None],
                    K[:, 1, :, None] - py[:, None, :] * K[:, 2, :, None],
                ],
                1,
            )
            / qz[:, None, None, :]
        )  # (B, 2, 3, N)
        # Left SE(3) perturbation: dP/d(dt) = I, dP/d(dw) = -[P]x.
        Pn = jnp.moveaxis(P, 1, -1)  # (B, N, 3)
        dPdw = -_skew(Pn)  # (B, N, 3, 3)
        Jw = jnp.einsum("bpcn,bncw->bpwn", Jp, dPdw)  # (B, 2, 3, N)
        J = jnp.concatenate([Jp, Jw], axis=2)  # (B, 2, 6, N)

        Hm = jnp.einsum("bpin,bpjn,bn->bij", J, J, wi)
        g = jnp.einsum("bpin,bpn,bn->bi", J, r, wi)
        lam = damping * (
            jnp.trace(Hm, axis1=-2, axis2=-1)[:, None, None] / 6.0 + 1e-6
        )
        delta = -jnp.linalg.solve(
            Hm + lam * jnp.eye(6, dtype=f32), g[..., None]
        )[..., 0]  # (B, 6) = [dt, dw]
        if step_clip > 0.0:
            nrm = jnp.linalg.norm(delta, axis=-1, keepdims=True)
            delta = delta * jnp.minimum(
                1.0, step_clip / jnp.maximum(nrm, 1e-12)
            )

        Rd = geo.so3_exp(delta[:, 3:])
        R = jnp.einsum("bij,bjk->bik", Rd, R)
        t = jnp.einsum("bij,bj->bi", Rd, t) + delta[:, :3]

    return geo.mat_to_pose_vec(geo.rt_to_mat(R, t), "euler")


def pose_from_flow_pyramid(
    flow_level: jnp.ndarray,
    depth_full: jnp.ndarray,
    K_full: jnp.ndarray,
    full_hw: tuple[int, int],
    weight: jnp.ndarray | None = None,
    iters: int = 3,
    damping: float = 1e-3,
    robust_delta: float = 0.0,
    step_clip: float = 0.0,
) -> jnp.ndarray:
    """Solve at a pyramid level's own resolution.

    flow_level: (B, h, w, 2) in LEVEL-pixel units (the flownet's
    native output, models/flownet.py); depth_full: (B, H, W) resized
    here by striding (exact for the synthetic worlds' smooth depth,
    cheap everywhere); K_full is rescaled to the level grid.
    """
    B, h, wd, _ = flow_level.shape
    H, W = full_hw
    # The strided depth sample and the diagonal K rescale below are
    # only aligned when the stride is exact (ADVICE r4 #3); current
    # presets satisfy this (PWC levels at /4 of 48x64 / 128x416).
    assert H % h == 0 and W % wd == 0, (
        f"pyramid stride must divide the full res: {(H, W)} vs {(h, wd)}"
    )
    sy, sx = H // h, W // wd
    depth = depth_full[:, ::sy, ::sx][:, :h, :wd]
    if K_full.ndim == 2:
        K_full = K_full[None]
    scale = jnp.asarray(
        [[W and wd / W, 0, 0], [0, H and h / H, 0], [0, 0, 1]],
        jnp.float32,
    )
    Kl = jnp.einsum("ij,bjk->bik", scale, K_full.astype(jnp.float32))
    # Rescale the principal point exactly: K' = S K with S diagonal
    # only scales fx, fy, cx, cy together, which is the right
    # transform for a pure resolution change.
    return pose_from_flow(
        flow_level, depth, Kl, weight=weight, iters=iters,
        damping=damping, robust_delta=robust_delta,
        step_clip=step_clip,
    )
