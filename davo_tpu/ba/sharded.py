"""Distributed sliding-window BA: landmark/map-block partitioning.

BASELINE config #5 and SURVEY.md §2.2 P6: the landmark axis (the map)
is sharded over the mesh's 'window' axis. Per shard_map rank:

  * residuals/Jacobians for the local landmark block — embarrassingly
    parallel, as is C^-1 (per-landmark 3x3);
  * partial B, E C^-1 E^T, and rhs contributions — reduced with a
    single psum of the tiny (M, M, 6, 6) S and (M, 6) rhs (the only
    communication per iteration);
  * the reduced pose solve (<= 6M x 6M) is computed identically on
    every device (cheaper than solve-on-one + broadcast at this size);
  * landmark back-substitution stays local.

On a multi-host cluster the 'window' axis spans hosts: the psum
crosses the host network once per GN iteration with O(M^2) payload — independent of the
number of landmarks, which is what makes the partitioning scale.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from davo_tpu.config import BAConfig
from davo_tpu.ba.gn import BAProblem
from davo_tpu.ba import residuals as res
from davo_tpu.ba import schur
from davo_tpu.core import geometry as geo


def pad_problem(problem: BAProblem, multiple: int) -> BAProblem:
    """Pad the landmark axis to a device-count multiple (masked out)."""
    N = problem.points_w.shape[0]
    pad = (-N) % multiple
    if pad == 0:
        return problem
    return problem._replace(
        points_w=jnp.pad(problem.points_w, ((0, pad), (0, 0))),
        observations=jnp.pad(
            problem.observations, ((0, 0), (0, pad), (0, 0))
        ),
        mask=jnp.pad(problem.mask, ((0, 0), (0, pad))),
    )


def make_sharded_ba_refine(cfg: BAConfig, mesh: Mesh, axis: str = "window"):
    """Build a jitted sharded refine: BAProblem -> BAProblem.

    The problem's landmark-axis leaves must be sharded over `axis`
    (see `shard_problem`).
    """

    def local_iteration(poses_cw, points, K, obs, mask):
        r = res.reprojection_residuals(poses_cw, points, K, obs, mask)
        w = res.huber_weights(r, cfg.huber_delta, cfg.outlier_px) * mask
        J_pose, J_point = res.reprojection_jacobians(
            poses_cw, points, K, mask
        )
        B_l, C_l, E_l, rhs_p_l, rhs_l = schur.gauss_newton_system(
            J_pose, J_point, r, w
        )
        M = poses_cw.shape[0]
        eye3 = jnp.eye(3)
        C_inv = jnp.linalg.inv(C_l + cfg.damping * eye3)
        ECi = jnp.einsum("mnij,njk->mnik", E_l, C_inv)
        S_off = jnp.einsum("mnik,pnlk->mpil", ECi, E_l)
        rhs_partial = rhs_p_l - jnp.einsum("mnik,nk->mi", ECi, rhs_l)

        # The only cross-shard communication: tiny psums.
        B = jax.lax.psum(B_l, axis)
        S_off = jax.lax.psum(S_off, axis)
        rhs = jax.lax.psum(rhs_partial, axis)

        S = -S_off
        diag = B + cfg.damping * jnp.eye(6) - S_off[jnp.arange(M), jnp.arange(M)]
        S = S.at[jnp.arange(M), jnp.arange(M)].set(diag)
        dx_pose = schur.solve_window(S, rhs, n_fixed=2)
        dx_point = schur.backsubstitute(C_inv, E_l, rhs_l, dx_pose)
        new_poses = geo.se3_exp(dx_pose) @ poses_cw
        return new_poses, points + dx_point

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(), P(None, axis), P(None, axis)),
        out_specs=(P(), P(axis)),
        check_vma=False,
    )
    def refine_local(poses_cw, points, K, obs, mask):
        def body(_, carry):
            poses, pts = carry
            return local_iteration(poses, pts, K, obs, mask)

        poses, pts = jax.lax.fori_loop(
            0, cfg.max_iterations, body, (poses_cw, points)
        )
        return poses, pts

    @jax.jit
    def refine(problem: BAProblem) -> BAProblem:
        poses, points = refine_local(
            problem.poses_cw,
            problem.points_w,
            problem.K,
            problem.observations,
            problem.mask,
        )
        return problem._replace(poses_cw=poses, points_w=points)

    return refine


def shard_problem(problem: BAProblem, mesh: Mesh, axis: str = "window") -> BAProblem:
    """Pad + place: landmark-axis leaves sharded, the rest replicated."""
    n = mesh.shape[axis]
    problem = pad_problem(problem, n)
    shard_n = NamedSharding(mesh, P(axis))
    shard_obs = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())
    return BAProblem(
        poses_cw=jax.device_put(problem.poses_cw, rep),
        points_w=jax.device_put(problem.points_w, shard_n),
        K=jax.device_put(problem.K, rep),
        observations=jax.device_put(problem.observations, shard_obs),
        mask=jax.device_put(problem.mask, shard_obs),
    )
