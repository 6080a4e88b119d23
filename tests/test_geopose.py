"""Geometry-grounded pose head (models/geopose.py).

The dense GN solve is validated against the synthetic worlds' EXACT
ground truth: with GT flow + GT depth the recovered pose must equal
the GT warp pose to solver precision — this pins every convention
(flow direction, pose direction, intrinsics, Euler layout) at once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from davo_tpu.core import geometry as geo
from davo_tpu.data.synthetic import SyntheticSequence
from davo_tpu.models.geopose import pose_from_flow, pose_from_flow_pyramid

WANDER = dict(
    trajectory="wander", rot_amp=0.06, n_static=8,
    texture_mode="procedural", plane_z=30.0,
)


@pytest.fixture(scope="module")
def seq():
    try:
        return SyntheticSequence(
            n_frames=8, height=48, width=64, seed=3, **WANDER
        )
    except TypeError:  # kwargs drifted — plain world still validates
        return SyntheticSequence(n_frames=8, height=48, width=64, seed=3)


class TestPoseFromFlow:
    def test_exact_on_gt_flow_depth(self, seq):
        flows, depths, gts = [], [], []
        for i in (1, 3, 5):
            flows.append(seq.gt_flow(i, i - 1))
            depths.append(seq.depth(i))
            gts.append(seq.warp_pose(i, i - 1))
        pred = np.asarray(
            pose_from_flow(
                jnp.asarray(np.stack(flows)),
                jnp.asarray(np.stack(depths)),
                jnp.asarray(seq.K, jnp.float32),
                iters=10,
                damping=1e-6,
            )
        )
        gtv = np.asarray(
            geo.mat_to_pose_vec(
                jnp.asarray(np.stack(gts), jnp.float32), "euler"
            )
        )
        np.testing.assert_allclose(pred, gtv, atol=1e-4)

    def test_production_defaults_on_drive_world(self):
        """The ModelConfig DEFAULTS (not hand-picked solver knobs)
        must recover pose from GT flow on the drive world class —
        ADVICE r4 #2. The pair set includes seed-99 indices 108-118
        and 186-192, which contain the pairs where the r4 config
        (iters=4, no step clip) DIVERGED to ~9 deg
        (results_r5_geo_oracle.json at cf6389d drive_tiny_r4cfg)."""
        from davo_tpu.config import ModelConfig
        from davo_tpu.data.synthetic import DriveSequence

        mcfg = ModelConfig()
        dseq = DriveSequence(
            n_frames=194, height=48, width=64, seed=99,
            forward_speed=0.8, yaw_amp=0.02, n_static=12,
        )
        pairs = list(range(108, 118)) + list(range(186, 192))
        lvl, depths, gts = [], [], []
        for i in pairs:
            f = dseq.gt_flow(i, i + 1)[::4, ::4]
            lvl.append(np.stack([f[..., 0] / 4, f[..., 1] / 4], -1))
            depths.append(dseq.depth(i))
            gts.append(dseq.warp_pose(i, i + 1))
        pred = np.asarray(
            pose_from_flow_pyramid(
                jnp.asarray(np.stack(lvl), jnp.float32),
                jnp.asarray(np.stack(depths)),
                jnp.asarray(dseq.K, jnp.float32),
                (48, 64),
                iters=mcfg.geo_pose_iters,
                damping=mcfg.geo_pose_damping,
                robust_delta=mcfg.geo_pose_robust,
                step_clip=mcfg.geo_pose_step_clip,
            )
        )
        gtv = np.asarray(
            geo.mat_to_pose_vec(
                jnp.asarray(np.stack(gts), jnp.float32), "euler"
            )
        )
        rot_err_deg = np.degrees(
            np.linalg.norm(pred[:, 3:] - gtv[:, 3:], axis=1)
        )
        assert rot_err_deg.max() < 0.05, rot_err_deg
        np.testing.assert_allclose(pred[:, :3], gtv[:, :3], atol=0.02)

    def test_robust_to_outlier_region(self, seq):
        """A corrupted flow block must not break the IRLS solve."""
        i = 2
        flow = seq.gt_flow(i, i - 1).copy()
        flow[5:15, 5:25] += 7.0  # dynamic-object-like outliers
        pred = np.asarray(
            pose_from_flow(
                jnp.asarray(flow[None]),
                jnp.asarray(seq.depth(i)[None]),
                jnp.asarray(seq.K, jnp.float32),
                iters=10,
                damping=1e-6,
                robust_delta=0.5,
            )
        )[0]
        gtv = np.asarray(
            geo.mat_to_pose_vec(
                jnp.asarray(seq.warp_pose(i, i - 1), jnp.float32), "euler"
            )
        )
        assert np.abs(pred[3:] - gtv[3:]).max() < 5e-3  # rotation holds
        assert np.abs(pred[:3] - gtv[:3]).max() < 0.1

    def test_differentiable(self, seq):
        i = 1
        flow = jnp.asarray(seq.gt_flow(i, i - 1)[None])
        depth = jnp.asarray(seq.depth(i)[None])
        K = jnp.asarray(seq.K, jnp.float32)

        def loss(f):
            return jnp.sum(pose_from_flow(f, depth, K, iters=3) ** 2)

        g = jax.grad(loss)(flow)
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0.0

    def test_pyramid_level_solve(self, seq):
        """Quarter-res flow in level-pixel units recovers the pose."""
        i = 3
        full = seq.gt_flow(i, i - 1)
        h, w = 12, 16  # /4 of 48x64
        lvl = full[::4, ::4] * np.asarray([w / 64.0, h / 48.0])
        pred = np.asarray(
            pose_from_flow_pyramid(
                jnp.asarray(lvl[None], jnp.float32),
                jnp.asarray(seq.depth(i)[None]),
                jnp.asarray(seq.K, jnp.float32),
                (48, 64),
                iters=10,
                damping=1e-6,
            )
        )[0]
        gtv = np.asarray(
            geo.mat_to_pose_vec(
                jnp.asarray(seq.warp_pose(i, i - 1), jnp.float32), "euler"
            )
        )
        np.testing.assert_allclose(pred, gtv, atol=2e-3)


class TestGeoHybridModel:
    def test_forward_and_grads(self):
        from davo_tpu.models import presets
        from davo_tpu.models.davo import DavoModel

        cfg = dataclasses.replace(
            presets.get("tiny").model,
            pose_head="geo_hybrid",
            compute_dtype="float32",
        )
        model = DavoModel(cfg)
        rng = np.random.default_rng(0)
        tgt = jnp.asarray(rng.uniform(size=(2, 48, 64, 3)), jnp.float32)
        src = jnp.asarray(
            rng.uniform(size=(2, 2, 48, 64, 3)), jnp.float32
        )
        seg = jnp.asarray(rng.integers(0, 19, (2, 48, 64)), jnp.int32)
        K = jnp.asarray(
            [[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]], jnp.float32
        )
        params = model.init(
            jax.random.PRNGKey(0), tgt, src, seg=seg, K=K
        )
        out = model.apply(params, tgt, src, seg=seg, train=False, K=K)
        assert out["poses"].shape == (2, 2, 6)
        assert out["pose_geo"].shape == (2, 2, 6)
        assert np.isfinite(np.asarray(out["poses"])).all()

        def loss(p):
            o = model.apply(p, tgt, src, seg=seg, train=False, K=K)
            return jnp.sum(o["poses"].astype(jnp.float32) ** 2)

        g = jax.grad(loss)(params)
        leaves = jax.tree_util.tree_leaves(g)
        assert all(np.isfinite(np.asarray(x)).all() for x in leaves)

    def test_requires_K(self):
        from davo_tpu.models import presets
        from davo_tpu.models.davo import DavoModel

        cfg = dataclasses.replace(
            presets.get("tiny").model, pose_head="geo_hybrid"
        )
        model = DavoModel(cfg)
        rng = np.random.default_rng(0)
        tgt = jnp.asarray(rng.uniform(size=(1, 48, 64, 3)), jnp.float32)
        src = jnp.asarray(
            rng.uniform(size=(1, 1, 48, 64, 3)), jnp.float32
        )
        seg = jnp.asarray(rng.integers(0, 19, (1, 48, 64)), jnp.int32)
        with pytest.raises(ValueError, match="requires K"):
            model.init(jax.random.PRNGKey(0), tgt, src, seg=seg)
