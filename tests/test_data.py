"""Data layer tests: synthetic GT self-consistency (the convention
cross-check for the whole stack), KITTI IO round-trips, snippet
batching, prefetch."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from davo_tpu.core import warp
from davo_tpu.data.kitti import (
    KittiOdometry,
    format_poses_kitti,
    parse_calib,
    parse_poses,
)
from davo_tpu.data.snippets import SnippetDataset, snippet_indices
from davo_tpu.data.synthetic import NUM_SEG_CLASSES, SyntheticSequence
from davo_tpu.data.prefetch import device_prefetch


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=6, height=48, width=64, seed=3)


class TestSyntheticGT:
    def test_shapes_and_ranges(self, seq):
        img = seq.frame(0)
        assert img.shape == (48, 64, 3)
        assert 0.0 <= img.min() and img.max() <= 1.0
        assert img.std() > 0.02  # textured, not flat
        d = seq.depth(0)
        assert d.shape == (48, 64)
        assert np.all(d > 1.0)
        s = seq.seg(0)
        assert s.min() >= 0 and s.max() < NUM_SEG_CLASSES

    def test_warp_consistency(self, seq):
        """THE convention cross-check: warping frame j through depth_i and
        warp_pose(i, j) must reconstruct frame i (exact world, smooth
        texture => small photometric error)."""
        i, j = 2, 3
        tgt = jnp.asarray(seq.frame(i))[None]
        src = jnp.asarray(seq.frame(j))[None]
        depth = jnp.asarray(seq.depth(i))[None]
        K = jnp.asarray(seq.K, jnp.float32)[None]
        pose = jnp.asarray(seq.warp_pose(i, j), jnp.float32)[None]
        recon, valid = warp.projective_inverse_warp(src, depth, pose, K)
        err = float((jnp.abs(recon - tgt) * valid).sum() / (valid.sum() * 3))
        assert float(valid.mean()) > 0.9
        assert err < 0.01, f"photometric err {err}"

    def test_warp_consistency_backward(self, seq):
        i, j = 3, 2  # source is the earlier frame
        tgt = jnp.asarray(seq.frame(i))[None]
        src = jnp.asarray(seq.frame(j))[None]
        depth = jnp.asarray(seq.depth(i))[None]
        K = jnp.asarray(seq.K, jnp.float32)[None]
        pose = jnp.asarray(seq.warp_pose(i, j), jnp.float32)[None]
        recon, valid = warp.projective_inverse_warp(src, depth, pose, K)
        err = float((jnp.abs(recon - tgt) * valid).sum() / (valid.sum() * 3))
        assert err < 0.01

    def test_gt_flow_matches_flow_warp(self, seq):
        i, j = 1, 2
        tgt = jnp.asarray(seq.frame(i))[None]
        src = jnp.asarray(seq.frame(j))[None]
        flow = jnp.asarray(seq.gt_flow(i, j))[None]
        recon, valid = warp.flow_warp(src, flow)
        err = float((jnp.abs(recon - tgt) * valid).sum() / (valid.sum() * 3))
        assert err < 0.01

    def test_rel_compose_to_absolute(self, seq):
        acc = np.eye(4)
        for i in range(seq.n_frames - 1):
            acc = acc @ seq.gt_rel(i)
        np.testing.assert_allclose(acc, seq.pose(seq.n_frames - 1), atol=1e-9)

    def test_seg_static_across_views(self, seq):
        """Labels are world-anchored: the seg of frame i warped via GT
        must mostly agree with the seg of frame j (nearest-neighbor)."""
        s0 = seq.seg(0)
        s1 = seq.seg(1)
        flow = seq.gt_flow(0, 1)
        h, w = s0.shape
        u, v = np.meshgrid(np.arange(w), np.arange(h))
        u2 = np.clip(np.round(u + flow[..., 0]), 0, w - 1).astype(int)
        v2 = np.clip(np.round(v + flow[..., 1]), 0, h - 1).astype(int)
        agree = (s1[v2, u2] == s0).mean()
        assert agree > 0.9


KITTI_CALIB = """P0: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 0.000000000000e+00 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 0.000000000000e+00
P2: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 4.538225000000e+01 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 -1.130887000000e-01 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 3.779761000000e-03
"""


class TestKittiIO:
    def test_parse_calib(self):
        calib = parse_calib(KITTI_CALIB)
        assert calib["P2"].shape == (3, 4)
        assert calib["P2"][0, 0] == pytest.approx(718.856)

    def test_parse_calib_tolerates_non_numeric_lines(self):
        """Regression: kitti-raw calib_cam_to_cam.txt opens with
        'calib_time: 09-Jan-2012 13:57:47' — parse_calib must skip
        such lines (np.fromstring used to truncate them silently; the
        strict replacement raised ValueError and broke KittiRaw)."""
        calib = parse_calib(
            "calib_time: 09-Jan-2012 13:57:47\n" + KITTI_CALIB
        )
        assert "calib_time" not in calib
        assert calib["P2"][0, 0] == pytest.approx(718.856)

    def test_poses_roundtrip(self, rng):
        from davo_tpu.core import geometry as geo

        rel = np.asarray(geo.se3_exp(jnp.asarray(rng.normal(size=(5, 6)) * 0.1)))
        poses = np.asarray(geo.trajectory_from_relatives(jnp.asarray(rel)))
        text = format_poses_kitti(poses)
        back = parse_poses(text)
        np.testing.assert_allclose(back, poses, atol=1e-6)

    def test_sequence_dir(self, tmp_path, seq):
        """Write a fake KITTI tree from the synthetic seq; read it back."""
        import cv2

        root = tmp_path / "kitti"
        sdir = root / "sequences" / "05" / "image_2"
        os.makedirs(sdir)
        for i in range(4):
            img = (seq.frame(i) * 255).astype(np.uint8)
            cv2.imwrite(str(sdir / f"{i:06d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        (root / "sequences" / "05" / "calib.txt").write_text(KITTI_CALIB)
        np.savetxt(root / "sequences" / "05" / "times.txt", np.arange(4) * 0.1)
        os.makedirs(root / "poses")
        (root / "poses" / "05.txt").write_text(format_poses_kitti(seq.poses[:4]))

        ko = KittiOdometry(str(root), "05")
        assert len(ko) == 4
        assert ko.K[0, 0] == pytest.approx(718.856)
        assert ko.gt_poses.shape == (4, 4, 4)
        frame = ko.load_frame(1, 24, 32)
        assert frame.shape == (24, 32, 3)
        K = ko.scaled_intrinsics(24, 32, (48, 64))
        assert K[0, 0] == pytest.approx(718.856 * 32 / 64)

    def test_precomputed_seg_ingestion(self, tmp_path, seq):
        """Reference parity R8: precomputed per-frame label maps load
        through KittiOdometry.load_seg and surface as KittiAdapter.seg
        (the flow_seg model's real-data cue path)."""
        import cv2

        from davo_tpu.data.snippets import KittiAdapter, SnippetDataset

        root = tmp_path / "kitti"
        sdir = root / "sequences" / "05" / "image_2"
        gdir = root / "sequences" / "05" / "seg"
        os.makedirs(sdir)
        os.makedirs(gdir)
        for i in range(5):
            img = (seq.frame(i) * 255).astype(np.uint8)
            cv2.imwrite(str(sdir / f"{i:06d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            cv2.imwrite(str(gdir / f"{i:06d}.png"), seq.seg(i).astype(np.uint8))
        (root / "sequences" / "05" / "calib.txt").write_text(KITTI_CALIB)

        ko = KittiOdometry(str(root), "05")
        assert ko.seg_dir is not None
        s = ko.load_seg(2, 24, 32)
        assert s.shape == (24, 32) and s.dtype == np.int32
        assert set(np.unique(s)) <= set(np.unique(seq.seg(2)))

        ad = KittiAdapter(ko, 24, 32, native_hw=(48, 64))
        assert hasattr(ad, "seg")
        ds = SnippetDataset(ad, batch_size=1, with_seg=True)
        batch = next(ds.batches(steps=1))
        assert batch["seg"].shape == (1, 24, 32)

        # Without a seg dir the adapter must NOT claim the capability.
        import shutil

        shutil.rmtree(gdir)
        ad2 = KittiAdapter(KittiOdometry(str(root), "05"), 24, 32, (48, 64))
        assert not hasattr(ad2, "seg")

    def test_scale_crop_augmentation_consistency(self, seq):
        """Scale/crop is an intrinsics-only change: warping the
        augmented source by the GT pose through the augmented K and
        depth must still reconstruct the augmented target."""
        from davo_tpu.core import warp as warp_mod
        from davo_tpu.data.snippets import apply_scale_crop

        t, s_idx = 2, 1
        frames = [seq.frame(s_idx), seq.frame(t), seq.depth(t)]
        K = np.asarray(seq.K, np.float32)
        (src_a, tgt_a, depth_a), _, K_a = apply_scale_crop(
            frames, None, K, s=1.12, oy=3, ox=5
        )
        pose = jnp.asarray(seq.warp_pose(t, s_idx), jnp.float32)[None]
        recon, valid = warp_mod.projective_inverse_warp(
            jnp.asarray(src_a)[None],
            jnp.asarray(depth_a)[None],
            pose,
            jnp.asarray(K_a)[None],
        )
        v = np.asarray(valid).reshape(tgt_a.shape[0], tgt_a.shape[1])
        err = (np.abs(np.asarray(recon[0]) - tgt_a).mean(-1) * v).sum() / v.sum()
        assert err < 0.02, err
        # Intrinsics algebra: focal scaled by the realized ratios,
        # principal point scaled then shifted by the crop offset.
        H, W = frames[0].shape[:2]
        sx = np.ceil(W * 1.12) / W
        sy = np.ceil(H * 1.12) / H
        assert K_a[0, 0] == pytest.approx(K[0, 0] * sx)
        assert K_a[1, 1] == pytest.approx(K[1, 1] * sy)
        assert K_a[0, 2] == pytest.approx(K[0, 2] * sx - 5)
        assert K_a[1, 2] == pytest.approx(K[1, 2] * sy - 3)


class TestDynamicWorld:
    """Dynamic-object billboards: exact GT compositing (SURVEY R6 —
    the attention mechanism needs scenes where photometric ego-motion
    is actually violated)."""

    @pytest.fixture(scope="class")
    def dyn(self):
        return SyntheticSequence(
            n_frames=6, height=48, width=64, seed=3, n_dynamic=3,
            dynamic_speed=0.6,
        )

    @pytest.fixture(scope="class")
    def static_twin(self):
        # Identical RNG stream for the static world (objects draw last).
        return SyntheticSequence(n_frames=6, height=48, width=64, seed=3)

    def test_static_world_unchanged(self, dyn, static_twin):
        """Poses/background texture identical to the static twin; the
        n_dynamic knob must not perturb existing GT fixtures."""
        np.testing.assert_array_equal(dyn.poses, static_twin.poses)
        mask = dyn.dynamic_mask(0)
        frame_d, frame_s = dyn.frame(0), static_twin.frame(0)
        np.testing.assert_array_equal(frame_d[~mask], frame_s[~mask])
        assert np.abs(frame_d[mask] - frame_s[mask]).mean() > 0.01

    def test_mask_coverage_and_labels(self, dyn):
        from davo_tpu.data.synthetic import DYNAMIC_LABEL_START

        masks = [dyn.dynamic_mask(i) for i in range(len(dyn))]
        frac = np.mean([m.mean() for m in masks])
        assert 0.03 < frac < 0.6, frac
        seg = dyn.seg(0)
        assert seg[masks[0]].min() >= DYNAMIC_LABEL_START
        assert seg[~masks[0]].max() < DYNAMIC_LABEL_START

    def test_depth_composited(self, dyn):
        mask = dyn.dynamic_mask(1)
        d = dyn.depth(1)
        assert d[mask].max() < dyn.plane_z
        assert d.min() > 0

    def test_flow_carries_object_motion(self, dyn, static_twin):
        """gt_flow == ego flow off-mask; differs on moving objects."""
        flow_d = dyn.gt_flow(1, 2)
        flow_ego = static_twin.gt_flow(1, 2)
        m1 = dyn.dynamic_mask(1)
        np.testing.assert_allclose(
            flow_d[~m1], flow_ego[~m1], atol=1e-4
        )
        diff = np.linalg.norm(flow_d[m1] - flow_ego[m1], axis=-1)
        # objects move ~0.6 world units/frame at z<plane_z: >=0.5px flow
        assert np.median(diff) > 0.5

    def test_photometric_violation_on_objects(self, dyn):
        """Ego-pose + composite-depth warping reconstructs the static
        background but NOT the moving objects — the failure mode the
        region attention exists to mask out."""
        t, s = 2, 1
        tgt = jnp.asarray(dyn.frame(t))[None]
        src = jnp.asarray(dyn.frame(s))[None]
        depth = jnp.asarray(dyn.depth(t))[None]
        pose = jnp.asarray(dyn.warp_pose(t, s), jnp.float32)[None]
        K = jnp.asarray(dyn.K, jnp.float32)[None]
        recon, valid = warp.projective_inverse_warp(src, depth, pose, K)
        err = np.abs(np.asarray(recon - tgt)).mean(-1) * np.asarray(valid).reshape(1, 48, 64)
        m = dyn.dynamic_mask(t) | dyn.dynamic_mask(s)
        err_dyn = err[0][m].mean()
        err_static = err[0][~m].mean()
        assert err_static < 0.02
        assert err_dyn > 3 * err_static


class TestLoopWorld:
    """KITTI-scale evaluation world: loop trajectory + procedural
    texture (unbounded extent) so 100..800 m segment errors are finite
    (VERDICT r1: every e2e t_err/r_err was NaN on the 38 m world)."""

    @pytest.fixture(scope="class")
    def loop(self):
        return SyntheticSequence(
            n_frames=120, height=48, width=64, seed=4, plane_z=30.0,
            forward_speed=0.8, trajectory="loop", texture_mode="procedural",
        )

    def test_travel_scales_with_frames(self, loop):
        from davo_tpu.eval.metrics import trajectory_distances

        dist = trajectory_distances(loop.poses)
        assert dist[-1] > 0.7 * 120 * 0.8  # jitter keeps it near arc len

    def test_textured_and_warp_consistent(self, loop):
        img = loop.frame(50)
        assert img.std() > 0.05  # local contrast for photometric loss
        t, s = 50, 49
        tgt = jnp.asarray(loop.frame(t))[None]
        src = jnp.asarray(loop.frame(s))[None]
        depth = jnp.asarray(loop.depth(t))[None]
        pose = jnp.asarray(loop.warp_pose(t, s), jnp.float32)[None]
        K = jnp.asarray(loop.K, jnp.float32)[None]
        recon, valid = warp.projective_inverse_warp(src, depth, pose, K)
        v = np.asarray(valid).reshape(1, 48, 64)
        err = (np.abs(np.asarray(recon - tgt)).mean(-1) * v).sum() / v.sum()
        assert err < 0.02, err

    def test_loop_roll_camera_frame_motion(self):
        """loop_roll=True: motion in CAMERA coordinates is a
        near-constant +x translation plus a true speed/r roll — the
        KITTI structure (dominant fixed-axis translation + small real
        rotation). The strafing loop (loop_roll=False) is unlearnable
        for a supervised pose net: its translation direction sweeps 2*pi
        while GT rotation is pure jitter (measured: pose_sup stalls at
        ~0.5 vs 0.007 on forward worlds)."""
        s = SyntheticSequence(
            n_frames=40, height=16, width=16, seed=6, plane_z=30.0,
            forward_speed=0.8, trajectory="loop", loop_roll=True,
            texture_mode="procedural", jitter=0.0, rot_jitter=0.0,
        )
        rels = np.stack(
            [s.warp_pose(t, t - 1) for t in range(1, 40)]
        )
        t_cam = rels[:, :3, 3]
        # +x dominant, constant across the loop
        np.testing.assert_allclose(t_cam[:, 0], t_cam[0, 0], rtol=1e-6)
        assert abs(t_cam[0, 0]) > 0.79
        assert np.all(np.abs(t_cam[:, 2]) < 0.02)
        # constant roll of speed/r radians about the view axis
        cos_roll = rels[:, 0, 0]
        roll = np.arccos(np.clip(cos_roll, -1, 1))
        np.testing.assert_allclose(roll, 0.8 / 30.0, rtol=1e-5)
        np.testing.assert_allclose(rels[:, 2, 2], 1.0, atol=1e-9)

    def test_loop_roll_warp_consistent(self):
        s = SyntheticSequence(
            n_frames=12, height=48, width=64, seed=7, plane_z=30.0,
            forward_speed=0.8, trajectory="loop", loop_roll=True,
            texture_mode="procedural",
        )
        tgt = jnp.asarray(s.frame(5))[None]
        src = jnp.asarray(s.frame(6))[None]
        depth = jnp.asarray(s.depth(5))[None]
        pose = jnp.asarray(s.warp_pose(5, 6), jnp.float32)[None]
        K = jnp.asarray(s.K, jnp.float32)[None]
        recon, valid = warp.projective_inverse_warp(src, depth, pose, K)
        v = np.asarray(valid).reshape(1, 48, 64)
        err = (np.abs(np.asarray(recon - tgt)).mean(-1) * v).sum() / v.sum()
        assert err < 0.02, err

    def test_segment_errors_finite_at_scale(self):
        from davo_tpu.eval.metrics import kitti_seg_errors

        # 1,300 frames * 0.8 m ~ 1,040 m of travel: all 100..800 m
        # segment lengths must produce finite errors. Poses only (no
        # rendering) keeps this fast.
        loop = SyntheticSequence(
            n_frames=1300, height=8, width=8, seed=5, trajectory="loop",
            texture_mode="procedural",
        )
        gt = loop.poses
        rng = np.random.default_rng(0)
        pred = gt.copy()
        drift = np.eye(4)
        for i in range(1, len(pred)):
            step = np.linalg.inv(gt[i - 1]) @ gt[i]
            noise = np.concatenate(
                [rng.normal(0, 0.01, 3), rng.normal(0, 0.0005, 3)]
            )
            drift = drift @ step @ _se3_like(noise)
            pred[i] = drift
        res = kitti_seg_errors(gt, pred)
        assert np.isfinite(res["t_err_pct"])
        assert np.isfinite(res["r_err_deg_per_100m"])
        assert len({s[1] for s in res["segments"]}) == 8  # all lengths hit
        assert res["t_err_pct"] > 0


def _se3_like(xi):
    from davo_tpu.data.synthetic import _se3_exp_np

    return _se3_exp_np(xi)


class TestWanderWorld:
    """Rotation-identifiable world class (r4): within-world VARYING
    rotation across all three axes. The r3 "loop" worlds have a
    constant within-world yaw rate, so a net regressing the dataset's
    rotation prior is indistinguishable from one reading rotation from
    the images (results_r3_quality3.json at cf6389d diag_rot_corr ~ 0 in every
    arm including supervised). On wander worlds pred-vs-GT per-frame
    rotation correlation is a falsifiable diagnostic
    (tools/dev/exp_rot_convention.py: supervised overfit reaches
    corr_rx 0.96 — no convention bug)."""

    @pytest.fixture(scope="class")
    def wander(self):
        return SyntheticSequence(
            n_frames=60, height=48, width=64, seed=3, plane_z=30.0,
            forward_speed=0.8, trajectory="wander",
            texture_mode="procedural", n_static=4, rot_amp=0.10,
            tilt_amp=0.12, rot_period=20.0, tilt_period=12.0,
        )

    def test_rotation_varies_within_world(self, wander):
        """The defining property: per-frame rotation angle must VARY
        (std comparable to mean), on every axis."""
        rels = np.stack([wander.gt_rel(i) for i in range(59)])
        angs = np.degrees(
            np.arccos(
                np.clip(
                    (np.trace(rels[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                    -1, 1,
                )
            )
        )
        assert angs.std() > 0.25 * angs.mean(), (angs.mean(), angs.std())
        assert angs.max() > 2.0  # degrees: visibly large rotations
        # per-axis variation (so all three correlation diagnostics
        # carry signal, not just roll)
        from scipy.spatial.transform import Rotation

        eul = Rotation.from_matrix(rels[:, :3, :3]).as_euler(
            "xyz", degrees=True
        )
        assert (eul.std(0) > 0.5).all(), eul.std(0)

    def test_warp_consistent(self, wander):
        t, s = 30, 29
        tgt = jnp.asarray(wander.frame(t))[None]
        src = jnp.asarray(wander.frame(s))[None]
        depth = jnp.asarray(wander.depth(t))[None]
        pose = jnp.asarray(wander.warp_pose(t, s), jnp.float32)[None]
        K = jnp.asarray(wander.K, jnp.float32)[None]
        recon, valid = warp.projective_inverse_warp(src, depth, pose, K)
        v = np.asarray(valid).reshape(1, 48, 64)
        err = (np.abs(np.asarray(recon - tgt)).mean(-1) * v).sum() / v.sum()
        assert err < 0.03, err

    def test_travel_and_segments_finite(self):
        from davo_tpu.eval.metrics import kitti_seg_errors, trajectory_distances

        w = SyntheticSequence(
            n_frames=1300, height=8, width=8, seed=5,
            trajectory="wander", texture_mode="procedural",
            rot_amp=0.06, rot_period=30.0, tilt_amp=0.05,
        )
        dist = trajectory_distances(w.poses)
        assert dist[-1] > 0.7 * 1300 * 0.8
        rng = np.random.default_rng(0)
        pred = w.poses.copy()
        drift = np.eye(4)
        for i in range(1, len(pred)):
            step = np.linalg.inv(w.poses[i - 1]) @ w.poses[i]
            drift = drift @ step @ _se3_like(
                np.concatenate(
                    [rng.normal(0, 0.01, 3), rng.normal(0, 0.0005, 3)]
                )
            )
            pred[i] = drift
        res = kitti_seg_errors(w.poses, pred)
        assert np.isfinite(res["t_err_pct"])
        assert len({s[1] for s in res["segments"]}) == 8

    def test_deterministic_and_distinct_across_seeds(self):
        kw = dict(
            n_frames=12, height=16, width=16, trajectory="wander",
            texture_mode="procedural", rot_amp=0.08,
        )
        a = SyntheticSequence(seed=1, **kw)
        b = SyntheticSequence(seed=1, **kw)
        c = SyntheticSequence(seed=2, **kw)
        np.testing.assert_array_equal(a.poses, b.poses)
        assert not np.allclose(a.poses, c.poses)


class TestDriveWorld:
    """Forward-looking ground-plane world (r4): the reference's actual
    regime — forward motion, varying yaw, real depth range, sky at
    infinity. Exact GT contracts identical to SyntheticSequence."""

    @pytest.fixture(scope="class")
    def drive(self):
        from davo_tpu.data.synthetic import DriveSequence

        return DriveSequence(
            n_frames=40, height=64, width=96, seed=1, yaw_amp=0.03,
            n_static=12,
        )

    def test_depth_range_and_sky(self, drive):
        d = drive.depth(10)
        assert d.min() < 10.0 and d.max() == drive.far_z
        sg = drive.seg(10)
        sky_frac = (sg == drive.sky_label).mean()
        assert 0.2 < sky_frac < 0.7
        # no ground/billboard pixel may carry the sky label
        surf, *_ = drive._surfaces(10)
        assert (sg[surf != -2] != drive.sky_label).all()

    def test_gt_flow_photometric(self, drive):
        from scipy.ndimage import map_coordinates

        f0, f1 = drive.frame(10), drive.frame(11)
        flow = drive.gt_flow(10, 11)
        H, W = drive.height, drive.width
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        uu, vv = u + flow[..., 0], v + flow[..., 1]
        valid = (uu >= 1) & (uu < W - 1) & (vv >= 1) & (vv < H - 1)
        rec = np.stack(
            [map_coordinates(f1[..., c], [vv, uu], order=1)
             for c in range(3)], -1,
        )
        err = np.abs(rec - f0).mean(-1)[valid].mean()
        assert err < 0.02, err

    def test_projective_warp_consistent(self, drive):
        tgt = jnp.asarray(drive.frame(10))[None]
        src = jnp.asarray(drive.frame(9))[None]
        depth = jnp.asarray(drive.depth(10))[None]
        pose = jnp.asarray(drive.warp_pose(10, 9), jnp.float32)[None]
        K = jnp.asarray(drive.K, jnp.float32)[None]
        recon, valid = warp.projective_inverse_warp(src, depth, pose, K)
        surf, *_ = drive._surfaces(10)
        # Sky rides at a finite far-depth proxy; exclude it from the
        # exactness check (its true depth is infinite).
        v = np.asarray(valid).reshape(1, 64, 96) * (surf[None] != -2)
        err = (np.abs(np.asarray(recon - tgt)).mean(-1) * v).sum() / v.sum()
        assert err < 0.03, err

    def test_rotation_varies_and_chains(self, drive):
        rels = np.stack([drive.gt_rel(i) for i in range(39)])
        angs = np.degrees(
            np.arccos(
                np.clip(
                    (np.trace(rels[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                    -1, 1,
                )
            )
        )
        assert angs.std() > 0.2 * angs.mean()
        chained = drive.poses[0]
        for r in rels:
            chained = chained @ r
        np.testing.assert_allclose(chained, drive.poses[39], atol=1e-8)

    def test_snippet_dataset_compatible(self, drive):
        from davo_tpu.data.snippets import SnippetDataset

        ds = SnippetDataset(
            drive, batch_size=2, with_seg=True, with_gt=True, seed=0
        )
        b = next(ds.batches(steps=1))
        assert b["target"].shape == (2, 64, 96, 3)
        assert b["gt_pose"].shape == (2, 2, 4, 4)
        assert b["seg"].dtype == np.int32


class TestSnippets:
    def test_indices(self):
        assert snippet_indices(6, 3) == [1, 2, 3, 4]
        assert snippet_indices(10, 5, stride=2) == [2, 4, 6]

    def test_batch_shapes(self, seq):
        ds = SnippetDataset(seq, batch_size=2, with_seg=True, with_gt=True)
        batch = next(ds.batches(steps=1))
        assert batch["target"].shape == (2, 48, 64, 3)
        assert batch["sources"].shape == (2, 2, 48, 64, 3)
        assert batch["K"].shape == (2, 3, 3)
        assert batch["seg"].shape == (2, 48, 64)
        assert batch["gt_pose"].shape == (2, 2, 4, 4)

    def test_gt_pose_is_warp_pose(self, seq):
        """gt_pose[0] (prev source) must equal warp_pose(t, t-1)."""
        ds = SnippetDataset(seq, batch_size=1, with_gt=True)
        t = 2
        snip = ds.snippet(t)
        np.testing.assert_allclose(
            snip["gt_pose"][0], seq.warp_pose(t, t - 1), atol=1e-6
        )
        np.testing.assert_allclose(
            snip["gt_pose"][1], seq.warp_pose(t, t + 1), atol=1e-6
        )

    def test_warp_pose_fallback_matches_direct(self, seq):
        """The gt_rel-composition fallback (used by KittiAdapter, which
        has no warp_pose) must agree with SyntheticSequence.warp_pose in
        BOTH directions (regression: past sources came back inverted)."""

        class _NoWarpPose:
            def __init__(self, inner):
                self._inner = inner
                self.K = inner.K

            def __len__(self):
                return len(self._inner)

            def frame(self, i):
                return self._inner.frame(i)

            def gt_rel(self, i):
                return self._inner.gt_rel(i)

        ds = SnippetDataset(_NoWarpPose(seq), batch_size=1, with_gt=True)
        for t, s in [(2, 1), (2, 3), (3, 1), (1, 3)]:
            np.testing.assert_allclose(
                ds._warp_pose(t, s), seq.warp_pose(t, s), atol=1e-5
            )

    def test_gt_pose_warps_correctly(self, seq):
        """End-to-end: batch gt_pose reconstructs the target from sources."""
        ds = SnippetDataset(seq, batch_size=1, with_gt=True)
        snip = ds.snippet(2)
        tgt = jnp.asarray(snip["target"])[None]
        src0 = jnp.asarray(snip["sources"][0])[None]
        depth = jnp.asarray(seq.depth(2))[None]
        K = jnp.asarray(snip["K"])[None]
        pose = jnp.asarray(snip["gt_pose"][0])[None]
        recon, valid = warp.projective_inverse_warp(src0, depth, pose, K)
        err = float((jnp.abs(recon - tgt) * valid).sum() / (valid.sum() * 3))
        assert err < 0.01

    def test_augment_preserves_shape_and_range(self, seq):
        ds = SnippetDataset(seq, batch_size=2, augment=True, seed=1)
        batch = next(ds.batches(steps=1))
        assert batch["target"].shape == (2, 48, 64, 3)
        assert batch["target"].min() >= 0.0 and batch["target"].max() <= 1.0

    def test_augment_color_skips_scale_crop(self, seq):
        """augment="color": photometric jitter only — K (and therefore
        the image-to-metric mapping GT-pose supervision relies on)
        stays untouched."""
        ds = SnippetDataset(seq, batch_size=2, augment="color", seed=1)
        batch = next(ds.batches(steps=1))
        np.testing.assert_array_equal(batch["K"][0], seq.K.astype(np.float32))
        # Full augment does perturb K (zoomed focal) for some draws.
        ds_full = SnippetDataset(seq, batch_size=4, augment=True, seed=1)
        bf = next(ds_full.batches(steps=1))
        assert not np.allclose(bf["K"], seq.K[None].astype(np.float32))

    def test_augment_batches_wrapper(self, seq):
        """Batch-level augmentation for prepared-layout readers: same
        semantics as SnippetDataset's internal augment — jitter shared
        per item, zoom/crop updates K, seg labels survive, gt_pose
        passes through untouched, shapes/ranges preserved."""
        from davo_tpu.data.snippets import augment_batches

        ds = SnippetDataset(
            seq, batch_size=4, with_seg=True, with_gt=True, seed=0
        )
        raw = next(ds.batches(steps=1))
        out = next(iter(augment_batches(iter([dict(raw)]), mode=True,
                                        seed=3)))
        assert out["target"].shape == raw["target"].shape
        assert out["sources"].shape == raw["sources"].shape
        assert out["target"].min() >= 0.0 and out["target"].max() <= 1.0
        assert not np.allclose(out["target"], raw["target"])  # jittered
        assert not np.allclose(out["K"], raw["K"])  # zoomed focal
        np.testing.assert_array_equal(out["gt_pose"], raw["gt_pose"])
        assert set(np.unique(out["seg"])) <= set(np.unique(raw["seg"]))
        # color-only: K untouched.
        out_c = next(iter(augment_batches(iter([dict(raw)]),
                                          mode="color", seed=3)))
        np.testing.assert_array_equal(out_c["K"], raw["K"])
        # deterministic by seed
        out2 = next(iter(augment_batches(iter([dict(raw)]), mode=True,
                                         seed=3)))
        np.testing.assert_array_equal(out["target"], out2["target"])

    def test_dynamic_along_path_coverage_persists(self):
        """dynamic_along_path=True keeps objects visible over LONG
        sequences (start-anchored placement decays to 0 coverage past
        ~frame 50 on loop worlds — measured r2)."""
        kw = dict(
            seed=99, height=48, width=64, plane_z=30.0,
            forward_speed=0.8, trajectory="loop", loop_roll=True,
            texture_mode="procedural", n_dynamic=10, dynamic_speed=0.8,
        )
        along = SyntheticSequence(
            n_frames=200, dynamic_along_path=True, **kw
        )
        halves = [
            np.mean([along.dynamic_mask(i).mean() for i in r])
            for r in (range(0, 100, 20), range(100, 200, 20))
        ]
        assert halves[0] > 0.01 and halves[1] > 0.01
        start = SyntheticSequence(n_frames=200, **kw)
        tail = np.mean(
            [start.dynamic_mask(i).mean() for i in range(100, 200, 20)]
        )
        assert tail < 0.01  # the decay along_path exists to fix

    def test_too_short_sequence_yields_nothing(self):
        """Regression: used to spin forever when no snippet fits."""
        tiny = SyntheticSequence(n_frames=2, height=16, width=16)
        assert list(SnippetDataset(tiny, batch_size=1).batches(steps=5)) == []

    def test_deterministic_with_seed(self, seq):
        b1 = next(SnippetDataset(seq, batch_size=2, seed=7).batches(steps=1))
        b2 = next(SnippetDataset(seq, batch_size=2, seed=7).batches(steps=1))
        np.testing.assert_array_equal(b1["target"], b2["target"])


class TestMultiSource:
    def test_batches_mix_worlds(self):
        from davo_tpu.data.snippets import MultiSourceDataset

        worlds = [
            SyntheticSequence(n_frames=5, height=16, width=16, seed=s)
            for s in range(3)
        ]
        ds = MultiSourceDataset(worlds, batch_size=4, with_gt=True, seed=0)
        assert len(ds.index) == 9  # 3 snippets per 5-frame world
        batches = list(ds.batches(steps=2))
        assert len(batches) == 2
        assert batches[0]["target"].shape == (4, 16, 16, 3)
        assert batches[0]["gt_pose"].shape == (4, 2, 4, 4)

    def test_too_small_pool(self):
        from davo_tpu.data.snippets import MultiSourceDataset

        worlds = [SyntheticSequence(n_frames=3, height=16, width=16)]
        ds = MultiSourceDataset(worlds, batch_size=4)
        assert list(ds.batches(steps=3)) == []


class TestPrefetch:
    def test_yields_all_batches_on_device(self, seq):
        ds = SnippetDataset(seq, batch_size=2)
        batches = list(ds.batches(steps=3))
        out = list(device_prefetch(iter(batches)))
        assert len(out) == 3
        for got, want in zip(out, batches):
            assert isinstance(got["target"], jnp.ndarray)
            np.testing.assert_allclose(np.asarray(got["target"]), want["target"])

    def test_overlap_stats(self, seq):
        """PrefetchStats separates host production time from consumer
        time and counts every produced batch."""
        import time as _time

        from davo_tpu.data.prefetch import PrefetchStats

        ds = SnippetDataset(seq, batch_size=2)
        batches = list(ds.batches(steps=4))
        stats = PrefetchStats()
        n = 0
        for _ in device_prefetch(iter(batches), stats=stats):
            _time.sleep(0.01)  # consumer "compute"
            n += 1
        assert n == 4
        assert stats.batches >= 2  # steady-state productions measured
        # 3 inter-batch gaps of >= 10 ms of consumer time.
        assert stats.consumer_s > 0.02
        assert 0.0 <= stats.host_fraction < 1.0
        s = stats.summary()
        assert set(s) == {"batches", "host_s", "consumer_s", "host_fraction"}


class TestProceduralWorlds:
    def test_infinite_batches_and_world_turnover(self):
        from davo_tpu.data.snippets import ProceduralWorldsDataset

        made = []

        def factory(seed):
            made.append(seed)
            return SyntheticSequence(
                n_frames=5, height=16, width=16, seed=seed
            )

        ds = ProceduralWorldsDataset(
            factory, batch_size=4, with_gt=True, seed=1, pool_size=2,
            draws_per_world=3,
        )
        batches = list(ds.batches(steps=6))
        assert len(batches) == 6
        assert batches[0]["target"].shape == (4, 16, 16, 3)
        assert batches[0]["gt_pose"].shape == (4, 2, 4, 4)
        # 24 draws at 3 draws/world retire ~8 worlds beyond the pool's 2.
        assert len(made) > 2, "worlds never turned over"
        assert len(set(made)) == len(made), "seed stream repeated"

    def test_deterministic_with_seed(self):
        from davo_tpu.data.snippets import ProceduralWorldsDataset

        def factory(seed):
            return SyntheticSequence(
                n_frames=5, height=16, width=16, seed=seed
            )

        a = next(ProceduralWorldsDataset(
            factory, batch_size=2, seed=9, pool_size=2
        ).batches(steps=1))
        b = next(ProceduralWorldsDataset(
            factory, batch_size=2, seed=9, pool_size=2
        ).batches(steps=1))
        np.testing.assert_array_equal(a["target"], b["target"])
