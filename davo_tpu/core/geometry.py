"""SE(3)/SO(3) geometry, camera models, and trajectory algebra.

Design notes
------------
* Everything is a pure function on `jnp` arrays with static shapes; all
  functions broadcast over arbitrary leading batch dimensions so they can
  be `vmap`-ped / sharded freely.
* Rotations near the identity use Taylor-guarded closed forms (no
  data-dependent branching — `jnp.where` keeps XLA control-flow free).
* Trajectory chaining uses `jax.lax.associative_scan` over 4x4 matmul so
  a 4.5k-frame KITTI sequence composes in O(log N) depth as batched matmuls and
  can later be distributed with a ring scan (SURVEY.md §2.2 P4).

Reference parity (behavior, not code): `<ref>/utils.py` `euler2mat`,
`pose_vec2mat`, `pixel2cam`, `cam2pixel` (SURVEY.md §2.1 R10 [H]).
The reference's 6-vector convention is ``[tx, ty, tz, rx, ry, rz]`` with
Euler angles and R = Rz @ Ry @ Rx; `pose_vec_to_mat` reproduces that.
The BA backend additionally gets a proper Lie exp/log (axis-angle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


# ---------------------------------------------------------------------------
# Euler-angle rotations (reference convention)
# ---------------------------------------------------------------------------

def euler_to_mat(angles: jnp.ndarray) -> jnp.ndarray:
    """Euler angles ``[rx, ry, rz]`` (radians) -> rotation matrix (..., 3, 3).

    Convention: ``R = Rz(rz) @ Ry(ry) @ Rx(rx)`` (extrinsic x-y-z).
    NOTE: the SfMLearner family's `euler2mat(z, y, x)` composes
    ``xmat @ ymat @ zmat`` — the TRANSPOSED order. This repo is
    internally self-consistent (mat_to_pose_vec inverts this exact
    composition and all pose round-trips are golden-tested vs scipy),
    so nothing depends on the reference's order; re-verify only if
    reference checkpoints/pose files are ever ingested directly.
    """
    rx, ry, rz = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = jnp.cos(rx), jnp.sin(rx)
    cy, sy = jnp.cos(ry), jnp.sin(ry)
    cz, sz = jnp.cos(rz), jnp.sin(rz)

    # Closed-form product Rz @ Ry @ Rx (avoids three batched matmuls).
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    rows = jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )
    return rows


def mat_to_euler(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> Euler ``[rx, ry, rz]`` (R = Rz Ry Rx).

    Gimbal-safe via clipping; valid for |ry| < pi/2 - eps which holds for
    frame-to-frame VO increments.
    """
    sy = -rot[..., 2, 0]
    sy = jnp.clip(sy, -1.0 + 1e-7, 1.0 - 1e-7)
    ry = jnp.arcsin(sy)
    rx = jnp.arctan2(rot[..., 2, 1], rot[..., 2, 2])
    rz = jnp.arctan2(rot[..., 1, 0], rot[..., 0, 0])
    return jnp.stack([rx, ry, rz], axis=-1)


def pose_vec_to_mat(vec: jnp.ndarray, rotation: str = "euler") -> jnp.ndarray:
    """6-DoF pose vector -> homogeneous 4x4 transform (..., 4, 4).

    ``vec = [tx, ty, tz, rx, ry, rz]`` — the reference's `pose_vec2mat`
    layout (`<ref>/utils.py`, SURVEY.md R10). ``rotation`` selects the
    Euler parameterization (reference parity) or the axis-angle Lie
    parameterization (BA backend).
    """
    t = vec[..., :3]
    r = vec[..., 3:6]
    if rotation == "euler":
        rot = euler_to_mat(r)
    elif rotation == "axis_angle":
        rot = so3_exp(r)
    else:
        raise ValueError(f"unknown rotation parameterization: {rotation}")
    return rt_to_mat(rot, t)


def mat_to_pose_vec(mat: jnp.ndarray, rotation: str = "euler") -> jnp.ndarray:
    """Homogeneous 4x4 -> 6-DoF ``[tx, ty, tz, r...]`` (inverse of above)."""
    t = mat[..., :3, 3]
    rot = mat[..., :3, :3]
    if rotation == "euler":
        r = mat_to_euler(rot)
    elif rotation == "axis_angle":
        r = so3_log(rot)
    else:
        raise ValueError(f"unknown rotation parameterization: {rotation}")
    return jnp.concatenate([t, r], axis=-1)


def rt_to_mat(rot: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = jnp.broadcast_to(rot, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([rot, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# SO(3) Lie group
# ---------------------------------------------------------------------------

def so3_hat(w: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> skew-symmetric (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_vee(W: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


# Taylor guards: for theta < 0.1 the 2-term series is exact to f32
# (truncation ~1e-8 rel) while the closed forms suffer catastrophic
# cancellation — (1-cos t) loses ~half the mantissa below t~1e-2, and
# (t - sin t) is pure noise below t~1e-3 in f32. The double-`where`
# keeps gradients finite at theta == 0.
_SMALL_SQ = 1e-2  # theta < 0.1


def _safe_theta(theta_sq: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    small = theta_sq < _SMALL_SQ
    theta = jnp.sqrt(jnp.where(small, 1.0, theta_sq))
    return small, theta


def _sinc(theta_sq: jnp.ndarray) -> jnp.ndarray:
    """sin(t)/t, t = sqrt(theta_sq)."""
    small, theta = _safe_theta(theta_sq)
    taylor = 1.0 - theta_sq / 6.0 + theta_sq * theta_sq / 120.0
    return jnp.where(small, taylor, jnp.sin(theta) / theta)


def _cosc(theta_sq: jnp.ndarray) -> jnp.ndarray:
    """(1 - cos t)/t^2 via the cancellation-free 2 sin^2(t/2)/t^2 form."""
    small, theta = _safe_theta(theta_sq)
    taylor = 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0
    half_sinc = jnp.sin(0.5 * theta) / theta  # sin(t/2)/t = sinc(t/2)/2
    return jnp.where(small, taylor, 2.0 * half_sinc * half_sinc)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle (..., 3) -> rotation matrix via Rodrigues."""
    theta_sq = jnp.sum(w * w, axis=-1)[..., None, None]
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + _sinc(theta_sq) * W + _cosc(theta_sq) * W2


def so3_log(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle (..., 3); principal branch |w| <= pi.

    Uses the trace formula with a Taylor-guarded small-angle path. For
    angles near pi the (R - R^T)/2 extraction degenerates; we recover the
    axis from the diagonal of (R + I)/2 there.
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # vee(R - R^T) = 2 sin(theta) * axis. Recover theta via atan2, which
    # stays well-conditioned near theta=0 where arccos(trace) loses
    # ~half the float32 digits (the sin term dominates there).
    vee = so3_vee(rot - jnp.swapaxes(rot, -1, -2))
    # Grad-safe norm: d|v|/dv is NaN at v=0 (identity rotation — hit by
    # pose-graph edges with exactly-consistent measurements); the
    # double-where keeps both value and tangent finite there.
    nsq = jnp.sum(vee * vee, axis=-1)
    tiny = nsq < 1e-24
    sin_theta = jnp.where(
        tiny, 0.0, 0.5 * jnp.sqrt(jnp.where(tiny, 1.0, nsq))
    )
    theta = jnp.arctan2(sin_theta, cos_theta)
    scale = jnp.where(
        theta[..., None] < 1e-4,
        0.5 + theta[..., None] ** 2 / 12.0,  # Taylor of theta/(2 sin theta)
        theta[..., None] / (2.0 * sin_theta[..., None] + _EPS),
    )
    w_generic = scale * vee
    # Near-pi branch: axis from diagonal of (R + I)/2 = aa^T + cos-ish terms.
    diag = jnp.stack(
        [rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], axis=-1
    )
    axis_sq = jnp.maximum((diag + 1.0) * 0.5, 0.0)
    axis = jnp.sqrt(axis_sq + _EPS)
    # Fix signs using off-diagonal sums (a_i a_j = (R_ij + R_ji)/4 near pi).
    # Shepperd-style: the reference component (taken positive) must be the
    # LARGEST one — anchoring on x unconditionally breaks when axis_x ~ 0
    # (then s_xy, s_xz ~ 0 carry no sign information and e.g. a pi-rotation
    # about [0, 1, -1]/sqrt(2) comes back as a wholly wrong rotation).
    # Global sign is immaterial this close to pi (w and -w at theta=pi are
    # the same rotation); only the relative signs matter.
    s_xy = rot[..., 0, 1] + rot[..., 1, 0]
    s_xz = rot[..., 0, 2] + rot[..., 2, 0]
    s_yz = rot[..., 1, 2] + rot[..., 2, 1]
    sgn = lambda x: jnp.where(x >= 0, 1.0, -1.0)
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    cand_x = jnp.stack([ax, sgn(s_xy) * ay, sgn(s_xz) * az], axis=-1)
    cand_y = jnp.stack([sgn(s_xy) * ax, ay, sgn(s_yz) * az], axis=-1)
    cand_z = jnp.stack([sgn(s_xz) * ax, sgn(s_yz) * ay, az], axis=-1)
    ref = jnp.argmax(axis_sq, axis=-1)[..., None]
    axis = jnp.where(ref == 0, cand_x, jnp.where(ref == 1, cand_y, cand_z))
    axis = axis / (jnp.linalg.norm(axis, axis=-1, keepdims=True) + _EPS)
    w_near_pi = axis * theta[..., None]
    near_pi = (jnp.pi - theta)[..., None] < 1e-4
    return jnp.where(near_pi, w_near_pi, w_generic)


# ---------------------------------------------------------------------------
# SE(3) Lie group
# ---------------------------------------------------------------------------

def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Twist ``[v(3), w(3)]`` -> 4x4 transform. Exact left-Jacobian form."""
    v = xi[..., :3]
    w = xi[..., 3:6]
    theta_sq = jnp.sum(w * w, axis=-1)[..., None, None]
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.eye(3, dtype=xi.dtype)
    rot = eye + _sinc(theta_sq) * W + _cosc(theta_sq) * W2
    # Left Jacobian V = I + (1-cos)/t^2 W + (t - sin t)/t^3 W^2.
    # (t - sin t) = t(1 - sinc(t)) — reuse the guarded sinc so the
    # cancellation lives in 1 - sinc ~ t^2/6 which is exact via Taylor.
    small, theta = _safe_theta(theta_sq)
    taylor = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    c2 = jnp.where(
        small, taylor, (theta - jnp.sin(theta)) / jnp.where(small, 1.0, theta_sq * theta)
    )
    V = eye + _cosc(theta_sq) * W + c2 * W2
    t = jnp.einsum("...ij,...j->...i", V, v)
    return rt_to_mat(rot, t)


def se3_log(mat: jnp.ndarray) -> jnp.ndarray:
    """4x4 transform -> twist ``[v, w]`` (inverse of `se3_exp`)."""
    rot = mat[..., :3, :3]
    t = mat[..., :3, 3]
    w = so3_log(rot)
    theta_sq = jnp.sum(w * w, axis=-1)[..., None, None]
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.eye(3, dtype=mat.dtype)
    # V^{-1} = I - W/2 + coef W^2 with
    # coef = (1 - (t/2) cot(t/2)) / t^2  (cot form avoids the 1-cos
    # cancellation; Taylor below t=0.1 for the remaining 1-(1-...) one).
    small, theta = _safe_theta(theta_sq)
    taylor = 1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0
    half = 0.5 * theta
    cot_term = half * jnp.cos(half) / jnp.where(small, 1.0, jnp.sin(half))
    coef = jnp.where(
        small, taylor, (1.0 - cot_term) / jnp.where(small, 1.0, theta_sq)
    )
    V_inv = eye - 0.5 * W + coef * W2
    v = jnp.einsum("...ij,...j->...i", V_inv, t)
    return jnp.concatenate([v, w], axis=-1)


def se3_inverse(mat: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    rot = mat[..., :3, :3]
    t = mat[..., :3, 3]
    rot_T = jnp.swapaxes(rot, -1, -2)
    return rt_to_mat(rot_T, -jnp.einsum("...ij,...j->...i", rot_T, t))


def se3_compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a @ b for (..., 4, 4) transforms (kept explicit for readability)."""
    return a @ b


def se3_adjoint(mat: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of a rigid transform: (..., 6, 6) acting on twists [v, w]."""
    rot = mat[..., :3, :3]
    t = mat[..., :3, 3]
    tR = so3_hat(t) @ rot
    top = jnp.concatenate([rot, tR], axis=-1)
    bottom = jnp.concatenate([jnp.zeros_like(rot), rot], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# Quaternions (TUM interchange: [qx, qy, qz, qw])
# ---------------------------------------------------------------------------

def mat_to_quat(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [x,y,z,w].

    Shepperd-style branch-free form: compute all four candidate
    magnitudes from the diagonal, pick signs from the off-diagonals
    using the largest component as reference (stable for all inputs,
    matches scipy's convention up to global sign).
    """
    m00, m11, m22 = rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22
    # No eps under the sqrt: it biases near-zero components by sqrt(eps)
    # (~1e-4). IO/eval path — gradients at exact component zeros are
    # not required here.
    qw = 0.5 * jnp.sqrt(jnp.maximum(1.0 + tr, 0.0))
    qx = 0.5 * jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0))
    qy = 0.5 * jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0))
    qz = 0.5 * jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0))
    # Off-diagonal sums/differences fix the signs relative to qw >= 0.
    qx = jnp.copysign(qx, rot[..., 2, 1] - rot[..., 1, 2])
    qy = jnp.copysign(qy, rot[..., 0, 2] - rot[..., 2, 0])
    qz = jnp.copysign(qz, rot[..., 1, 0] - rot[..., 0, 1])
    q = jnp.stack([qx, qy, qz, qw], axis=-1)
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (..., 4) [x,y,z,w] -> rotation matrix (..., 3, 3)."""
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )
    return rows


# ---------------------------------------------------------------------------
# Camera intrinsics
# ---------------------------------------------------------------------------

def make_intrinsics(fx, fy, cx, cy, dtype=jnp.float32) -> jnp.ndarray:
    """Scalars / batched scalars -> (..., 3, 3) intrinsics matrix."""
    fx = jnp.asarray(fx, dtype)
    fy = jnp.asarray(fy, dtype)
    cx = jnp.asarray(cx, dtype)
    cy = jnp.asarray(cy, dtype)
    zero = jnp.zeros_like(fx)
    one = jnp.ones_like(fx)
    return jnp.stack(
        [
            jnp.stack([fx, zero, cx], axis=-1),
            jnp.stack([zero, fy, cy], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )


def scale_intrinsics(K: jnp.ndarray, sx: float, sy: float) -> jnp.ndarray:
    """Rescale intrinsics for an image resized by (sx, sy)."""
    scale = jnp.array(
        [[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]], dtype=K.dtype
    )
    return K * scale


def intrinsics_pyramid(K: jnp.ndarray, num_scales: int) -> list[jnp.ndarray]:
    """Per-scale intrinsics for a /2 image pyramid (scale 0 = full res).

    Mirrors the reference's per-scale intrinsics stack fed to the
    multi-scale warp loss (`<ref>/data_loader.py`, SURVEY.md R9).
    """
    return [scale_intrinsics(K, 0.5**s, 0.5**s) for s in range(num_scales)]


# ---------------------------------------------------------------------------
# Projective camera ops
# ---------------------------------------------------------------------------

def pixel_grid(height: int, width: int, dtype=jnp.float32) -> jnp.ndarray:
    """Homogeneous pixel coordinates, shape (3, H, W): rows (u, v, 1)."""
    u = jnp.arange(width, dtype=dtype)[None, :].repeat(height, axis=0)
    v = jnp.arange(height, dtype=dtype)[:, None].repeat(width, axis=1)
    ones = jnp.ones((height, width), dtype=dtype)
    return jnp.stack([u, v, ones], axis=0)


def pixel_to_cam(depth: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Back-project depth to camera-frame points.

    depth: (..., H, W); K: (..., 3, 3)  ->  points (..., 3, H, W).
    Equivalent of the reference's `pixel2cam` (`<ref>/utils.py`).
    """
    h, w = depth.shape[-2], depth.shape[-1]
    grid = pixel_grid(h, w, depth.dtype)  # (3, H, W)
    K_inv = jnp.linalg.inv(K)
    rays = jnp.einsum("...ij,jhw->...ihw", K_inv, grid)
    return rays * depth[..., None, :, :]


def cam_to_pixel(points: jnp.ndarray, K: jnp.ndarray, T: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Transform cam points by T and project with K.

    points: (..., 3, H, W); K: (..., 3, 3); T: (..., 4, 4)
    Returns (pixel_uv (..., 2, H, W), depth (..., H, W)) in the target view.
    Equivalent of the reference's `cam2pixel` (`<ref>/utils.py`).
    """
    rot = T[..., :3, :3]
    t = T[..., :3, 3]
    p = jnp.einsum("...ij,...jhw->...ihw", rot, points) + t[..., :, None, None]
    proj = jnp.einsum("...ij,...jhw->...ihw", K, p)
    z = proj[..., 2, :, :]
    z_safe = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    uv = proj[..., :2, :, :] / z_safe[..., None, :, :]
    return uv, z


# ---------------------------------------------------------------------------
# Trajectory algebra
# ---------------------------------------------------------------------------

def trajectory_from_relatives(rel_mats: jnp.ndarray, T0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Chain relative transforms into a global trajectory.

    rel_mats: (N, 4, 4) where rel_mats[i] = T_{world_i -> world_{i+1}}
    expressed as the pose increment (cam_{i} -> cam_{i+1} motion in cam_i
    frame, i.e. T_i^{i+1}). Returns (N+1, 4, 4) absolute poses with
    poses[0] = T0 (identity by default) and
    ``poses[k+1] = poses[k] @ rel_mats[k]``.

    Uses `lax.associative_scan` (matmul is associative) => O(log N) depth,
    matmul-friendly; reference does a sequential Python loop
    (`<ref>/kitti_eval`, SURVEY.md R14).
    """
    if T0 is None:
        T0 = jnp.eye(4, dtype=rel_mats.dtype)
    chained = jax.lax.associative_scan(jnp.matmul, rel_mats, axis=0)
    poses = jnp.concatenate([jnp.eye(4, dtype=rel_mats.dtype)[None], chained], axis=0)
    return T0[None] @ poses


def relative_from_trajectory(poses: jnp.ndarray) -> jnp.ndarray:
    """Absolute poses (N, 4, 4) -> relatives (N-1, 4, 4): inv(P_i) P_{i+1}."""
    return se3_inverse(poses[:-1]) @ poses[1:]
