"""Gauss-Newton normal equations with Schur-complement reduction.

Structure exploited (see ba/__init__ docstring): each observation
couples one pose and one landmark, so

    H = [[B, E], [E^T, C]],   B: (M, 6, 6) blkdiag, C: (N, 3, 3) blkdiag,
    E: (M, N, 6, 3)

Reduced camera system: S = B - E C^-1 E^T  (6M x 6M dense),
  rhs_p' = rhs_p - E C^-1 rhs_l;  solve S dx_p = rhs_p';
  dx_l = C^-1 (rhs_l - E^T dx_p)   (parallel per landmark).

All contractions are einsums (matrix units). The landmark dimension N is the
axis `ba/sharded.py` distributes; every reduction over N below becomes
a psum there.
"""

from __future__ import annotations

import jax.numpy as jnp


def gauss_newton_system(
    J_pose: jnp.ndarray,
    J_point: jnp.ndarray,
    residuals: jnp.ndarray,
    weights: jnp.ndarray,
):
    """Assemble (B, C, E, rhs_pose, rhs_point) from Jacobians.

    J_pose: (M, N, 2, 6); J_point: (M, N, 2, 3); residuals: (M, N, 2);
    weights: (M, N) IRLS weights.
    """
    w = weights[..., None, None]
    JtJp = jnp.einsum("mnri,mnrj->mnij", J_pose * w, J_pose)
    B = JtJp.sum(axis=1)  # (M, 6, 6)
    JtJl = jnp.einsum("mnri,mnrj->mnij", J_point * w, J_point)
    C = JtJl.sum(axis=0)  # (N, 3, 3)
    E = jnp.einsum("mnri,mnrj->mnij", J_pose * w, J_point)  # (M, N, 6, 3)
    wr = residuals * weights[..., None]
    rhs_pose = -jnp.einsum("mnri,mnr->mi", J_pose, wr)  # (M, 6)
    rhs_point = -jnp.einsum("mnri,mnr->ni", J_point, wr)  # (N, 3)
    return B, C, E, rhs_pose, rhs_point


def schur_reduce(B, C, E, rhs_pose, rhs_point, damping: float):
    """Form the reduced camera system (S, rhs) with LM damping.

    Returns (S (M, M, 6, 6), rhs (M, 6), C_inv (N, 3, 3)).
    """
    M = B.shape[0]
    eye3 = jnp.eye(3)
    C_damped = C + damping * eye3
    C_inv = jnp.linalg.inv(C_damped)  # batched 3x3 (N, 3, 3)

    # S_off[m, m'] = sum_n E[m, n] C_inv[n] E[m', n]^T
    ECi = jnp.einsum("mnij,njk->mnik", E, C_inv)  # (M, N, 6, 3)
    S_off = jnp.einsum("mnik,pnlk->mpil", ECi, E)  # (M, M, 6, 6)
    S = -S_off
    diag = B + damping * jnp.eye(6) - S_off[jnp.arange(M), jnp.arange(M)]
    S = S.at[jnp.arange(M), jnp.arange(M)].set(diag)

    rhs = rhs_pose - jnp.einsum("mnik,nk->mi", ECi, rhs_point)
    return S, rhs, C_inv


def solve_window(S, rhs, n_fixed: int = 2):
    """Solve the reduced system for pose updates (M, 6).

    Gauge: clamp the first `n_fixed` poses (delta = 0) by zeroing their
    rows/cols and placing identity on their diagonal blocks. Monocular
    BA has a 7-DoF gauge (SE(3) + scale); anchoring TWO poses pins the
    scale through their baseline, which is also what chains sliding
    windows consistently to the already-refined past.
    """
    M = S.shape[0]
    dense = jnp.transpose(S, (0, 2, 1, 3)).reshape(6 * M, 6 * M)
    b = rhs.reshape(6 * M)
    if n_fixed:
        mask = jnp.concatenate(
            [jnp.zeros(6 * n_fixed), jnp.ones(6 * (M - n_fixed))]
        )
        dense = dense * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        b = b * mask
    # 6M <= ~100: direct LU solve (f32 Cholesky NaNs on the ill-
    # conditioned windows sparse visibility produces; LU is robust and
    # equally cheap at this size). PCG variant in pcg.py.
    dx = jnp.linalg.solve(dense, b)
    return dx.reshape(M, 6)


def backsubstitute(C_inv, E, rhs_point, dx_pose):
    """Landmark updates (N, 3), parallel per landmark."""
    Et_dx = jnp.einsum("mnij,mi->nj", E, dx_pose)  # (N, 3)
    return jnp.einsum("nij,nj->ni", C_inv, rhs_point - Et_dx)


def solve_windows_batched(J_pose, J_point, residuals, weights,
                          damping: float = 1e-4, n_fixed: int = 2):
    """Solve K independent windows in one program via vmap.

    Inputs carry a leading window axis: J_pose (K, M, N, 2, 6),
    J_point (K, M, N, 2, 3), residuals (K, M, N, 2), weights
    (K, M, N). Returns (dx_pose (K, M, 6), dx_point (K, N, 3)).

    Rationale: a single window solve at sliding-window sizes is bound
    by fixed overhead — little arithmetic through a chain of tiny ops,
    each paying a per-kernel launch floor. vmap amortizes that floor
    across windows: the op count stays constant while every op's
    batch grows K-fold, so K-window throughput approaches
    K / (single-window time) until the device fills — the honest scaling lever for multi-window
    refinement (e.g. the sliding-window eval over a long sequence).
    """
    import jax

    def one(Jp, Jl, r, w):
        B, C, E, rp, rl = gauss_newton_system(Jp, Jl, r, w)
        S, rhs, C_inv = schur_reduce(B, C, E, rp, rl, damping)
        dxp = solve_window(S, rhs, n_fixed=n_fixed)
        dxl = backsubstitute(C_inv, E, rl, dxp)
        return dxp, dxl

    return jax.vmap(one)(J_pose, J_point, residuals, weights)
