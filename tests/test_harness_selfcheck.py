"""Measurement-harness self-checks (r5, VERDICT r4 next-#7).

Round 4 retracted two measurement results in one round: a train-step
table that timed elided compute, and ladder4's scalar rot-corr column
(np.trace over the BATCH axes of an (N, 3, 3) stack). This tier runs each diagnostic on
synthetic streams with KNOWN answers so that elision/axis bugs fail
loudly in CI instead of in a retraction.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from davo_tpu.core import geometry as geo
from davo_tpu.eval.metrics import mat_to_euler_np, rot_angle
from davo_tpu.eval.runner import assemble_trajectory, evaluate_sequence
from davo_tpu.utils.profiling import timed


def _random_rel_poses(n, seed=0, rot_scale=0.05, t_scale=0.5):
    rng = np.random.default_rng(seed)
    vecs = np.concatenate(
        [
            rng.normal(scale=t_scale, size=(n, 3)),
            rng.normal(scale=rot_scale, size=(n, 3)),
        ],
        axis=1,
    ).astype(np.float32)
    return np.array(geo.pose_vec_to_mat(jnp.asarray(vecs)))


class TestRotationDiagnostics:
    def test_corr_is_one_on_identical_streams(self):
        """The ladder per-axis corr pipeline must read EXACTLY 1.0
        when a pose stream is compared with itself."""
        rels = _random_rel_poses(200)
        eul_a = mat_to_euler_np(rels[:, :3, :3])
        eul_b = mat_to_euler_np(rels[:, :3, :3].copy())
        for k in range(3):
            c = np.corrcoef(eul_a[:, k], eul_b[:, k])[0, 1]
            assert abs(c - 1.0) < 1e-12

    def test_corr_is_low_on_independent_streams(self):
        a = mat_to_euler_np(_random_rel_poses(500, seed=1)[:, :3, :3])
        b = mat_to_euler_np(_random_rel_poses(500, seed=2)[:, :3, :3])
        for k in range(3):
            assert abs(np.corrcoef(a[:, k], b[:, k])[0, 1]) < 0.15

    def test_rot_angle_is_per_element(self):
        """Regression for the retracted ladder4 scalar: rot_angle on
        an (N, 3, 3) stack must return N per-rotation angles (the bug
        traced over the BATCH axes with np.trace's default axes)."""
        angles_deg = np.array([1.0, 5.0, 20.0, 90.0])
        mats = np.stack(
            [
                np.asarray(geo.so3_exp(jnp.asarray(
                    [0.0, np.radians(a), 0.0], jnp.float32
                )))
                for a in angles_deg
            ]
        )
        got = rot_angle(mats)
        assert got.shape == (4,)
        np.testing.assert_allclose(got, angles_deg, atol=1e-3)

    def test_euler_roundtrip(self):
        vec = np.array([[0.1, -0.2, 0.3, 0.04, -0.03, 0.02]], np.float32)
        mat = np.asarray(geo.pose_vec_to_mat(jnp.asarray(vec)))
        eul = mat_to_euler_np(mat[:, :3, :3])
        np.testing.assert_allclose(eul[0], vec[0, 3:], atol=1e-5)


class TestTimingHarness:
    def test_measures_known_host_duration(self):
        """timed() must report >= the true duration of a known-cost
        function (min-over-loops cannot go below physics)."""

        def sleepy():
            time.sleep(0.02)
            return jnp.zeros(())

        r = timed(sleepy, iters=2, loops=2)
        assert 20.0 <= r["ms"] < 200.0

    def test_known_flops_not_elided(self):
        """A 2048^3 matmul is ~17.2 GFLOP; any wall time below 1 ms
        implies >17 PFLOPS — i.e. the compute was elided. This is the
        CI analog of the r4 elision class (a matmul whose result
        nothing consumed)."""
        x = jnp.asarray(
            np.random.default_rng(0).normal(size=(2048, 2048)),
            jnp.float32,
        )

        @jax.jit
        def mm(a):
            return a @ a

        r = timed(mm, x, iters=3, loops=2)
        assert r["ms"] > 1.0, f"elided? {r}"


class TestMetricOracles:
    def test_zero_error_on_identical_trajectories(self):
        rels = _random_rel_poses(300, rot_scale=0.01, t_scale=0.9)
        # Forward-dominant motion so KITTI segment lengths accumulate.
        rels[:, 0, 3] += 1.0
        traj = assemble_trajectory(rels)
        ev = evaluate_sequence(traj, traj.copy())
        assert ev["snippet_ate_mean"] < 1e-6
        assert ev["t_err_pct"] < 1e-4
        assert ev["r_err_deg_per_100m"] < 1e-4

    def test_known_translation_scale_error(self):
        """Scaling every relative translation by 1.1 must read ~10 %
        t_err in the KITTI segment metric."""
        rels = _random_rel_poses(400, rot_scale=0.0, t_scale=0.0)
        rels[:, 0, 3] = 1.0  # straight 1 m/frame line
        gt = assemble_trajectory(rels)
        scaled = rels.copy()
        scaled[:, 0, 3] *= 1.1
        pred = assemble_trajectory(scaled)
        ev = evaluate_sequence(pred, gt)
        assert 8.0 < ev["t_err_pct"] < 12.0, ev["t_err_pct"]
