"""Damped Gauss-Newton driver for one BA window.

Fixed-iteration loop (XLA-friendly; no data-dependent termination) with
Huber IRLS reweighting each iteration. Poses update left-multiplicatively
(T <- exp(dx) T), landmarks additively.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from davo_tpu.config import BAConfig
from davo_tpu.core import geometry as geo
from davo_tpu.ba import residuals as res
from davo_tpu.ba import schur


class BAProblem(NamedTuple):
    """One fixed-shape BA window.

    poses_cw:     (M, 4, 4) world->camera
    points_w:     (N, 3)
    K:            (3, 3)
    observations: (M, N, 2) pixels
    mask:         (M, N) 1 where observed
    """

    poses_cw: jnp.ndarray
    points_w: jnp.ndarray
    K: jnp.ndarray
    observations: jnp.ndarray
    mask: jnp.ndarray


def ba_cost(problem: BAProblem, delta: float) -> jnp.ndarray:
    """Total Huber cost (for monitoring/tests)."""
    r = res.reprojection_residuals(
        problem.poses_cw, problem.points_w, problem.K,
        problem.observations, problem.mask,
    )
    norm = jnp.linalg.norm(r, axis=-1)
    quad = 0.5 * norm**2
    lin = delta * (norm - 0.5 * delta)
    return jnp.where(norm <= delta, quad, lin).sum()


def ba_iteration(problem: BAProblem, cfg: BAConfig) -> BAProblem:
    """One damped GN step: linearize, Schur-reduce, solve, update."""
    r = res.reprojection_residuals(
        problem.poses_cw, problem.points_w, problem.K,
        problem.observations, problem.mask,
    )
    w = res.huber_weights(r, cfg.huber_delta, cfg.outlier_px) * problem.mask
    J_pose, J_point = res.reprojection_jacobians(
        problem.poses_cw, problem.points_w, problem.K, problem.mask
    )
    B, C, E, rhs_p, rhs_l = schur.gauss_newton_system(J_pose, J_point, r, w)
    S, rhs, C_inv = schur.schur_reduce(B, C, E, rhs_p, rhs_l, cfg.damping)
    dx_pose = schur.solve_window(S, rhs, n_fixed=2)
    dx_point = schur.backsubstitute(C_inv, E, rhs_l, dx_pose)

    new_poses = geo.se3_exp(dx_pose) @ problem.poses_cw
    new_points = problem.points_w + dx_point
    return problem._replace(poses_cw=new_poses, points_w=new_points)


@partial(jax.jit, static_argnames=("cfg",))
def ba_refine(problem: BAProblem, cfg: BAConfig) -> BAProblem:
    """Run cfg.max_iterations damped-GN steps (one compiled program)."""

    def body(_, p):
        return ba_iteration(p, cfg)

    return jax.lax.fori_loop(0, cfg.max_iterations, body, problem)


def synthetic_problem(
    seed: int, M: int = 4, N: int = 64, noise: float = 0.3,
    pose_noise: float = 0.02, point_noise: float = 0.05,
) -> BAProblem:
    """A BA window with known structure, made from `seed`: M cameras
    on a line (small random rotations) looking at N landmarks at
    z ~ 6-10 through a 128x96 pinhole; observations with pixel noise,
    poses (all but the two gauge anchors) and landmarks perturbed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    pts = rng.uniform([-4, -3, 6], [4, 3, 10], size=(N, 3))
    xi = np.concatenate(
        [
            np.stack([np.arange(M) * 0.5 - M * 0.25] + [np.zeros(M)] * 2, 1),
            rng.normal(0, 0.02, (M, 3)),
        ],
        axis=1,
    )
    poses_cw = np.linalg.inv(np.asarray(geo.se3_exp(jnp.asarray(xi))))
    pix, z = res.project_points(
        jnp.asarray(poses_cw, jnp.float32),
        jnp.asarray(pts, jnp.float32),
        jnp.asarray(K, jnp.float32),
    )
    pix = np.asarray(pix)
    mask = (
        (np.asarray(z) > 0.1)
        & (pix[..., 0] >= 0) & (pix[..., 0] <= 127)
        & (pix[..., 1] >= 0) & (pix[..., 1] <= 95)
    )
    kick = np.array(geo.se3_exp(jnp.asarray(rng.normal(0, pose_noise, (M, 6)))))
    kick[:2] = np.eye(4)  # the first two poses are gauge anchors
    return BAProblem(
        poses_cw=jnp.asarray(kick @ poses_cw, jnp.float32),
        points_w=jnp.asarray(
            pts + rng.normal(0, point_noise, pts.shape), jnp.float32
        ),
        K=jnp.asarray(K, jnp.float32),
        observations=jnp.asarray(
            pix + rng.normal(0, noise, pix.shape), jnp.float32
        ),
        mask=jnp.asarray(mask, jnp.float32),
    )
