"""Training-layer tests: losses are sane, the jitted step runs and
reduces the loss, checkpoints round-trip, and the miniature
end-to-end slice (BASELINE config #1): supervised overfit on a
synthetic sequence -> streaming eval -> small ATE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from davo_tpu.config import Config, ModelConfig, TrainConfig
from davo_tpu.data.snippets import SnippetDataset
from davo_tpu.data.synthetic import SyntheticSequence
from davo_tpu.eval.runner import (
    assemble_trajectory,
    evaluate_sequence,
    make_pose_apply_fn,
    predict_sequence,
)
from davo_tpu.train.loop import (
    create_state,
    fit,
    make_checkpoint_manager,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from davo_tpu.train.losses import (
    photometric_loss,
    pose_supervision_loss,
    smoothness_loss,
)

TINY = ModelConfig(
    img_height=48,
    img_width=64,
    pose_channels=(8, 12, 16),
    disp_channels=(8, 12, 16),
    flow_levels=3,
    flow_search_range=2,
    attention="none",
    # pose_scale=1.0 so a ~0.8 m/frame synthetic motion is reachable in
    # a few hundred Adam steps (the reference's 0.01 needs raw outputs
    # ~100x larger, i.e. 100k-step training runs).
    pose_scale=1.0,
    compute_dtype="float32",
)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=10, height=48, width=64, seed=5)


@pytest.fixture(scope="module")
def dataset(seq):
    return SnippetDataset(seq, batch_size=2, with_gt=True, seed=0)


class TestLosses:
    def test_photometric_gt_depth_pose_beats_random(self, seq):
        """With GT depth + GT pose the warp loss must be much lower than
        with a wrong pose (loss landscape sanity)."""
        t = 3
        target = jnp.asarray(seq.frame(t))[None]
        sources = jnp.stack(
            [jnp.asarray(seq.frame(t - 1)), jnp.asarray(seq.frame(t + 1))]
        )[None]
        K = jnp.asarray(seq.K, jnp.float32)[None]
        from davo_tpu.core.geometry import mat_to_pose_vec
        from davo_tpu.models.dispnet import depth_to_disp

        gt_depth = jnp.asarray(seq.depth(t))[None]
        # Invert disp_to_depth to feed GT depth as "disparity".
        disp0 = depth_to_disp(gt_depth)
        disps = [disp0[..., None]]
        for s in range(1, 4):
            d = disp0[:, ::2**s, ::2**s]
            disps.append(d[..., None])
        gt_poses = jnp.stack(
            [
                mat_to_pose_vec(jnp.asarray(seq.warp_pose(t, t - 1), jnp.float32)),
                mat_to_pose_vec(jnp.asarray(seq.warp_pose(t, t + 1), jnp.float32)),
            ]
        )[None]
        good = float(photometric_loss(disps, gt_poses, target, sources, K, 0.85))
        bad_poses = gt_poses.at[..., 0].add(1.0)  # 1m lateral error
        bad = float(photometric_loss(disps, bad_poses, target, sources, K, 0.85))
        # Coarse pyramid levels contribute a noise floor (strided disp
        # vs avg-pooled images); fine-scale-only ratio is ~4x, full ~1.5x.
        assert good < 0.06
        assert bad > 1.4 * good
        good0 = float(photometric_loss(disps[:1], gt_poses, target, sources, K, 0.85))
        bad0 = float(photometric_loss(disps[:1], bad_poses, target, sources, K, 0.85))
        assert bad0 > 3 * good0

    def test_depth_norm_global_scale_invariance(self, seq):
        """SC-SfM depth_norm: the photometric loss must be invariant to
        a GLOBAL depth rescale (that is the scale-drift direction it
        exists to quotient out). A uniform disparity shift multiplies
        every depth by a constant under the log parametrization."""
        t = 3
        target = jnp.asarray(seq.frame(t))[None]
        sources = jnp.asarray(seq.frame(t - 1))[None, None]
        K = jnp.asarray(seq.K, jnp.float32)[None]
        from davo_tpu.core.geometry import mat_to_pose_vec
        from davo_tpu.models.dispnet import depth_to_disp

        disp0 = depth_to_disp(jnp.asarray(seq.depth(t))[None])[..., None]
        pose = mat_to_pose_vec(
            jnp.asarray(seq.warp_pose(t, t - 1), jnp.float32)
        )[None, None]
        a = float(photometric_loss(
            [disp0], pose, target, sources, K, 0.85, depth_norm=True
        ))
        b = float(photometric_loss(
            [disp0 + 0.1], pose, target, sources, K, 0.85, depth_norm=True
        ))
        assert a == pytest.approx(b, rel=1e-4)
        # Without normalization the rescale moves the loss.
        c = float(photometric_loss([disp0], pose, target, sources, K, 0.85))
        d = float(photometric_loss(
            [disp0 + 0.1], pose, target, sources, K, 0.85
        ))
        assert abs(c - d) > 1e-4

    def test_no_empty_mask_degeneracy(self, seq):
        """Regression (r2 training collapse): a pose that warps EVERYTHING
        out of frame must not be a photometric optimum. The masked
        variant rewards it (loss -> ~0 as the valid count empties);
        the border default keeps it penalized above the GT-pose loss."""
        t = 3
        target = jnp.asarray(seq.frame(t))[None]
        sources = jnp.asarray(seq.frame(t - 1))[None, None]
        K = jnp.asarray(seq.K, jnp.float32)[None]
        from davo_tpu.core.geometry import mat_to_pose_vec
        from davo_tpu.models.dispnet import depth_to_disp

        disp0 = depth_to_disp(jnp.asarray(seq.depth(t))[None])
        disps = [disp0[..., None]]
        gt_pose = mat_to_pose_vec(
            jnp.asarray(seq.warp_pose(t, t - 1), jnp.float32)
        )[None, None]
        runaway = gt_pose.at[..., 0].add(1e4)  # everything lands OOB

        good = float(
            photometric_loss(disps, gt_pose, target, sources, K, 0.85)
        )
        bad_border = float(
            photometric_loss(disps, runaway, target, sources, K, 0.85)
        )
        bad_masked = float(
            photometric_loss(
                disps, runaway, target, sources, K, 0.85, masking="valid"
            )
        )
        assert bad_masked < 1e-6      # the trap this test pins
        assert bad_border > 5 * good  # border keeps it repulsive

    def test_fullres_sampling(self, seq):
        """photo_fullres: (a) a full-res scale-0 disp gives the SAME
        term whether sampled fullres or per-scale (identity resize);
        (b) multi-scale fullres keeps the loss-landscape ordering and
        sends gradient into EVERY scale's disparity (the coarse heads
        train against full-res photometric error, not a blurred
        pyramid level)."""
        t = 3
        target = jnp.asarray(seq.frame(t))[None]
        sources = jnp.stack(
            [jnp.asarray(seq.frame(t - 1)), jnp.asarray(seq.frame(t + 1))]
        )[None]
        K = jnp.asarray(seq.K, jnp.float32)[None]
        from davo_tpu.core.geometry import mat_to_pose_vec
        from davo_tpu.models.dispnet import depth_to_disp

        disp0 = depth_to_disp(jnp.asarray(seq.depth(t))[None])
        disps = [disp0[..., None]]
        for s in range(1, 4):
            disps.append(disp0[:, ::2**s, ::2**s][..., None])
        gt_poses = jnp.stack(
            [
                mat_to_pose_vec(jnp.asarray(seq.warp_pose(t, t - 1), jnp.float32)),
                mat_to_pose_vec(jnp.asarray(seq.warp_pose(t, t + 1), jnp.float32)),
            ]
        )[None]

        # (a) scale-0-only: fullres == pyramid (same images, same disp).
        a = float(photometric_loss(disps[:1], gt_poses, target, sources, K, 0.85))
        b = float(
            photometric_loss(
                disps[:1], gt_poses, target, sources, K, 0.85, fullres=True
            )
        )
        assert abs(a - b) < 1e-6

        # (b) multi-scale fullres: ordering + per-scale gradients.
        good = float(
            photometric_loss(disps, gt_poses, target, sources, K, 0.85, fullres=True)
        )
        bad = float(
            photometric_loss(
                disps, gt_poses.at[..., 0].add(1.0), target, sources, K, 0.85,
                fullres=True,
            )
        )
        assert bad > 1.4 * good
        grads = jax.grad(
            lambda ds: photometric_loss(
                ds, gt_poses, target, sources, K, 0.85, fullres=True
            )
        )(disps)
        for g in grads:
            assert float(jnp.abs(g).max()) > 0.0

    def test_geometry_consistency_loss(self, seq):
        """GT depths + GT pose give near-zero scale-consistency
        residual; doubling the SOURCE depth scale (the drift this term
        exists to punish) inflates it by orders of magnitude; gradient
        reaches both depth inputs."""
        from davo_tpu.core.geometry import mat_to_pose_vec
        from davo_tpu.models.dispnet import depth_to_disp
        from davo_tpu.train.losses import geometry_consistency_loss

        t = 3
        K = jnp.asarray(seq.K, jnp.float32)[None]
        d_t = depth_to_disp(jnp.asarray(seq.depth(t))[None])[..., None]
        d_s = depth_to_disp(jnp.asarray(seq.depth(t - 1))[None])[..., None]
        pose = mat_to_pose_vec(
            jnp.asarray(seq.warp_pose(t, t - 1), jnp.float32)
        )[None, None]

        good = float(geometry_consistency_loss(d_t, d_s, pose, K))
        assert good < 0.01, good

        d_s_scaled = depth_to_disp(
            2.0 * jnp.asarray(seq.depth(t - 1))[None]
        )[..., None]
        bad = float(geometry_consistency_loss(d_t, d_s_scaled, pose, K))
        assert bad > 20 * max(good, 1e-4), (good, bad)

        g_t, g_s = jax.grad(
            lambda a, b: geometry_consistency_loss(a, b, pose, K),
            argnums=(0, 1),
        )(d_t, d_s_scaled)
        assert float(jnp.abs(g_t).max()) > 0
        assert float(jnp.abs(g_s).max()) > 0

    def test_geo_consistency_train_step_integration(self, dataset):
        """geo_consistency_weight > 0: the folded source-disp pass runs
        in the jitted step and the metric is finite."""
        import dataclasses

        from davo_tpu.config import Config
        from davo_tpu.train.loop import create_state, make_train_step

        cfg = Config(
            model=TINY,
            train=TrainConfig(
                batch_size=2, max_steps=3, geo_consistency_weight=0.5
            ),
        )
        it = dataset.batches(steps=3)
        first = next(it)
        model, state, tx = create_state(cfg, jax.random.key(0), first)
        step_fn = make_train_step(model, tx, cfg)
        state, metrics = step_fn(state, first)
        assert "geo_consistency" in metrics
        gc = float(metrics["geo_consistency"])
        assert jnp.isfinite(gc) and gc >= 0.0

    def test_flow_loss_automin_no_empty_mask_optimum(self, seq):
        """Regression (r3 review): flow_losses under masking="automin"
        must NOT reward a flow that warps everything out of frame —
        mapping automin to the zero-filled masked mean reintroduced
        the empty-mask optimum for the flow branch."""
        from davo_tpu.train.losses import flow_losses

        t = 3
        target = jnp.asarray(seq.frame(t))[None]
        sources = jnp.asarray(seq.frame(t - 1))[None, None]
        H, W = target.shape[1], target.shape[2]
        zero_flow = [jnp.zeros((1, H // 4, W // 4, 2), jnp.float32)]
        runaway = [jnp.full((1, H // 4, W // 4, 2), 1e4, jnp.float32)]
        for masking in ("border", "automin"):
            base = float(
                flow_losses([zero_flow], target, sources, 0.85, masking)
            )
            oob = float(
                flow_losses([runaway], target, sources, 0.85, masking)
            )
            assert oob > base, (masking, oob, base)
        # The "valid" ablation keeps the documented trap.
        oob_valid = float(
            flow_losses([runaway], target, sources, 0.85, "valid")
        )
        assert oob_valid < 1e-6

    def test_automin_drops_static_pixel_charge(self, seq):
        """photo_masking="automin" (Monodepth2 automask as min-with-
        identity): when source == target (static camera/world) the
        identity floor is 0, so the loss vanishes even with a nonzero
        pose, while plain border charges the misaligned warp. The tie
        upweighting keeps automin == border when identity is worse."""
        from davo_tpu.models.dispnet import depth_to_disp

        t = 3
        target = jnp.asarray(seq.frame(t))[None]
        static_sources = target[:, None]  # source IS the target frame
        K = jnp.asarray(seq.K, jnp.float32)[None]
        disps = [depth_to_disp(jnp.asarray(seq.depth(t))[None])[..., None]]
        pose = jnp.array([[[1.0, 0.0, 0.0, 0.0, 0.0, 0.0]]])  # wrong

        border = float(
            photometric_loss(disps, pose, target, static_sources, K, 0.85)
        )
        automin = float(
            photometric_loss(
                disps, pose, target, static_sources, K, 0.85,
                masking="automin",
            )
        )
        assert border > 0.01         # misaligned warp is charged
        assert automin < 0.1 * border  # identity floor absorbs it

        # Real moving pair: identity is WORSE than a GT warp, so the
        # automin value must match plain border (min picks the warp).
        from davo_tpu.core.geometry import mat_to_pose_vec

        sources = jnp.asarray(seq.frame(t - 1))[None, None]
        gt_pose = mat_to_pose_vec(
            jnp.asarray(seq.warp_pose(t, t - 1), jnp.float32)
        )[None, None]
        b2 = float(photometric_loss(disps, gt_pose, target, sources, K, 0.85))
        a2 = float(
            photometric_loss(
                disps, gt_pose, target, sources, K, 0.85, masking="automin"
            )
        )
        assert a2 <= b2 + 1e-6

    def test_automin_static_pair_sends_no_depth_gradient(self, seq):
        """Static pixels hit the identity floor -> zero gradient into
        disparity (the automask's purpose: dynamic objects moving with
        the camera stop dragging depth)."""
        from davo_tpu.models.dispnet import depth_to_disp

        t = 3
        target = jnp.asarray(seq.frame(t))[None]
        static_sources = target[:, None]
        K = jnp.asarray(seq.K, jnp.float32)[None]
        disp0 = depth_to_disp(jnp.asarray(seq.depth(t))[None])[..., None]
        pose = jnp.array([[[1.0, 0.0, 0.0, 0.0, 0.0, 0.0]]])

        g = jax.grad(
            lambda d: photometric_loss(
                [d], pose, target, static_sources, K, 0.85, masking="automin"
            )
        )(disp0)
        assert float(jnp.abs(g).max()) < 1e-7

    def test_smoothness_flat_disp_is_zero(self):
        disps = [jnp.full((1, 16, 16, 1), 0.3)]
        img = jnp.zeros((1, 16, 16, 3))
        assert float(smoothness_loss(disps, img)) == pytest.approx(0.0, abs=1e-7)

    def test_pose_supervision_zero_at_gt(self, rng):
        from davo_tpu.core.geometry import pose_vec_to_mat

        vec = jnp.asarray(rng.uniform(-0.1, 0.1, (2, 2, 6)), jnp.float32)
        mats = pose_vec_to_mat(vec)
        assert float(pose_supervision_loss(vec, mats)) < 1e-8
        assert float(pose_supervision_loss(vec + 0.1, mats)) > 1e-3


class TestImageSummaries:
    def test_fit_writes_image_panels(self, dataset, tmp_path):
        """image_every > 0 + a MetricsLogger => warped/disparity PNG
        panels on disk (SURVEY.md §5 observability; VERDICT r1 #7)."""
        import glob

        from davo_tpu.utils.metrics import MetricsLogger

        cfg = Config(
            model=TINY,
            train=TrainConfig(
                batch_size=2, max_steps=2, log_every=1, image_every=1,
                learning_rate=1e-4,
            ),
        )
        logger = MetricsLogger(str(tmp_path), tensorboard=False)
        fit(cfg, dataset.batches(steps=2), metrics_logger=logger)
        logger.close()
        pngs = glob.glob(str(tmp_path / "images" / "*.png"))
        names = {p.split("/")[-1].rsplit("_", 1)[0] for p in pngs}
        assert {
            "target", "source0", "warped_source0",
            "photometric_err", "disparity",
        } <= names, names
        # Scalar JSONL stream written alongside.
        assert (tmp_path / "metrics.jsonl").read_text().count("\n") >= 2


class TestTrainStep:
    def test_loss_decreases(self, dataset):
        cfg = Config(
            model=TINY,
            train=TrainConfig(
                batch_size=2,
                learning_rate=1e-3,
                max_steps=1,
                pose_supervision_weight=10.0,
            ),
        )
        batch = next(dataset.batches(steps=1))
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        model, state, tx = create_state(cfg, jax.random.key(0), batch)
        step = make_train_step(model, tx, cfg)
        _, m0 = step(state, batch)
        # re-create state (donated) and run 25 steps on the same batch
        model, state, tx = create_state(cfg, jax.random.key(0), batch)
        step = make_train_step(model, tx, cfg)
        losses = []
        for _ in range(25):
            state, metrics = step(state, batch)
            losses.append(float(metrics["total"]))
        assert losses[-1] < losses[0] * 0.9
        assert int(state.step) == 25

    def test_remat_step_matches_plain(self, dataset):
        """train.remat=True (jax.checkpoint around the forward) must
        produce the same loss and the same post-step params as the
        plain step — it changes memory, not math."""
        import dataclasses

        batch = next(dataset.batches(steps=1))
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        results = []
        for remat in (False, True):
            cfg = Config(
                model=TINY,
                train=TrainConfig(
                    batch_size=2,
                    learning_rate=1e-3,
                    max_steps=1,
                    pose_supervision_weight=10.0,
                    remat=remat,
                ),
            )
            model, state, tx = create_state(cfg, jax.random.key(0), batch)
            step = make_train_step(model, tx, cfg)
            state, metrics = step(state, batch)
            results.append((float(metrics["total"]), state.params))
        assert np.isclose(results[0][0], results[1][0], rtol=1e-6)
        flat0 = jax.tree_util.tree_leaves(results[0][1])
        flat1 = jax.tree_util.tree_leaves(results[1][1])
        for a, b in zip(flat0, flat1):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-6
            )

    def test_cosine_schedule_trains_and_decays(self, dataset):
        """lr_schedule="cosine": still learns, and by max_steps the
        effective lr has decayed (update magnitude shrinks ~100x)."""
        import optax

        from davo_tpu.train.loop import _make_tx

        cfg = Config(
            model=TINY,
            train=TrainConfig(
                batch_size=2, learning_rate=1e-3, lr_schedule="cosine",
                max_steps=20, pose_supervision_weight=10.0,
            ),
        )
        batch = next(dataset.batches(steps=1))
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        model, state, tx = create_state(cfg, jax.random.key(0), batch)
        step = make_train_step(model, tx, cfg)
        losses = []
        for _ in range(20):
            state, metrics = step(state, batch)
            losses.append(float(metrics["total"]))
        assert losses[-1] < losses[0]
        # The schedule itself: alpha=0.01 of peak at max_steps.
        sched = optax.cosine_decay_schedule(1e-3, 20, alpha=0.01)
        assert float(sched(20)) < 1.1e-5
        assert float(sched(0)) == pytest.approx(1e-3)

    def test_checkpoint_roundtrip(self, dataset, tmp_path):
        cfg = Config(model=TINY, train=TrainConfig(batch_size=2, max_steps=1))
        batch = {k: jnp.asarray(v) for k, v in next(dataset.batches(steps=1)).items()}
        model, state, tx = create_state(cfg, jax.random.key(0), batch)
        step = make_train_step(model, tx, cfg)
        state, _ = step(state, batch)
        mngr = make_checkpoint_manager(str(tmp_path / "ckpt"))
        save_checkpoint(mngr, state)
        _, template, _ = create_state(cfg, jax.random.key(1), batch)
        restored = restore_checkpoint(mngr, template)
        assert restored is not None
        assert int(restored.step) == 1
        a = jax.tree_util.tree_leaves(state.params)
        b = jax.tree_util.tree_leaves(restored.params)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestNanDebugTier:
    def test_step_clean_under_debug_nans(self, dataset):
        """SURVEY.md §5 sanitizer tier: one train step under
        jax_debug_nans must not trip (validity-masked warps etc.)."""
        import jax

        cfg = Config(
            model=TINY,
            train=TrainConfig(batch_size=2, pose_supervision_weight=10.0),
        )
        batch = {k: jnp.asarray(v) for k, v in next(dataset.batches(steps=1)).items()}
        jax.config.update("jax_debug_nans", True)
        try:
            model, state, tx = create_state(cfg, jax.random.key(0), batch)
            step = make_train_step(model, tx, cfg)
            state, metrics = step(state, batch)
            assert np.isfinite(float(metrics["total"]))
        finally:
            jax.config.update("jax_debug_nans", False)


class TestEndToEndTiny:
    """BASELINE config #1 in miniature: supervised PoseNet overfit on a
    synthetic sequence, then streaming eval -> trajectory -> ATE."""

    def test_overfit_then_eval(self, seq):
        ds = SnippetDataset(seq, batch_size=8, with_gt=True, seed=0)
        cfg = Config(
            model=TINY,
            train=TrainConfig(
                batch_size=8,
                learning_rate=5e-3,
                max_steps=600,
                pose_supervision_weight=100.0,
                smooth_weight=0.1,
                log_every=100,
            ),
        )
        model, state, history = fit(cfg, ds.batches(steps=600))
        # Direction-channel model converges before the first log point;
        # assert the absolute level instead of relative improvement.
        assert history[-1]["pose_sup"] < 0.05

        frames = np.stack([seq.frame(i) for i in range(seq.n_frames)])
        apply_fn = make_pose_apply_fn(model, state.params)
        rels = predict_sequence(apply_fn, frames, batch_size=4)
        pred = assemble_trajectory(rels)
        gt = seq.poses
        report = evaluate_sequence(pred, gt)
        # Overfit on 10 frames: trajectory should be in the right
        # ballpark (full GT ~7m of travel; demand ATE << travel).
        travel = np.linalg.norm(gt[-1, :3, 3])
        assert report["ate_full"] < 0.5 * travel
        assert report["snippet_ate_mean"] < 0.5


class TestScanServing:
    """Dispatch-amortized serving path (make_pose_apply_scan_fn +
    predict_sequence(scan_chunks=K)) must equal the per-call path —
    the scan body is the same forward, so any drift is a packing bug."""

    def _params(self, cfg, seq, with_seg):
        batch = {
            "target": np.stack([seq.frame(1), seq.frame(2)]),
            "sources": np.stack(
                [seq.frame(0), seq.frame(1)]
            )[:, None],
        }
        if with_seg:
            batch["seg"] = np.stack(
                [seq.seg(1), seq.seg(2)]
            ).astype(np.int32)
        from davo_tpu.train.loop import create_state

        model, state, _ = create_state(
            Config(model=cfg, train=TrainConfig(batch_size=2)),
            jax.random.PRNGKey(0),
            batch,
        )
        return model, state.params

    @pytest.mark.parametrize("attention", ["none", "flow_seg"])
    def test_scan_equals_per_call(self, seq, attention):
        from davo_tpu.eval.runner import make_pose_apply_scan_fn

        import dataclasses

        cfg = dataclasses.replace(TINY, attention=attention)
        model, params = self._params(cfg, seq, attention == "flow_seg")
        frames = np.stack([seq.frame(i) for i in range(seq.n_frames)])
        segs = (
            np.stack(
                [seq.seg(i) for i in range(seq.n_frames)]
            ).astype(np.int32)
            if attention == "flow_seg"
            else None
        )

        per_call = make_pose_apply_fn(model, params, attention)
        rels = predict_sequence(per_call, frames, seg=segs, batch_size=4)

        scan = make_pose_apply_scan_fn(model, params, attention)
        # K=2 with 9 pairs -> 3 batches -> padded tail group: exercises
        # both the K-grid padding and the in-batch padding trim.
        rels_scan = predict_sequence(
            scan, frames, seg=segs, batch_size=4, scan_chunks=2
        )
        np.testing.assert_allclose(rels_scan, rels, rtol=0, atol=1e-5)


class TestWarpGatherConfig:
    """TrainConfig.warp_gather -> core/warp policy resolution
    (train/loop._apply_warp_config): explicit config > DAVO_WARP_GATHER
    env > auto ("banded", gated by the r5 quality artifact)."""

    def _cfg(self, **kw):
        return Config(train=TrainConfig(**kw))

    def test_explicit_config_wins(self, monkeypatch):
        from davo_tpu.core import warp as warp_mod
        from davo_tpu.train.loop import _apply_warp_config

        monkeypatch.setenv("DAVO_WARP_GATHER", "block")
        monkeypatch.setattr(warp_mod, "_DEFAULT_GATHER", "block")
        _apply_warp_config(
            self._cfg(warp_gather="banded", warp_band=(8, 16))
        )
        assert warp_mod._DEFAULT_GATHER == "banded"
        assert warp_mod._BAND == (8, 16)

    def test_auto_respects_env(self, monkeypatch):
        from davo_tpu.core import warp as warp_mod
        from davo_tpu.train.loop import _apply_warp_config

        monkeypatch.setenv("DAVO_WARP_GATHER", "block")
        monkeypatch.setattr(warp_mod, "_DEFAULT_GATHER", "block")
        _apply_warp_config(self._cfg(warp_gather="auto"))
        assert warp_mod._DEFAULT_GATHER == "block"

    def test_auto_is_banded(self, monkeypatch):
        """The r5 twin-arm quality verdict (results_r5_warp_gate.json at cf6389d
        at cf6389d): auto resolves to the band clamp at the gated band
        on every backend."""
        from davo_tpu.core import warp as warp_mod
        from davo_tpu.train.loop import _apply_warp_config

        monkeypatch.delenv("DAVO_WARP_GATHER", raising=False)
        monkeypatch.setattr(warp_mod, "_DEFAULT_GATHER", "take4")
        _apply_warp_config(self._cfg(warp_gather="auto"))
        assert warp_mod._DEFAULT_GATHER == "banded"
        assert warp_mod._BAND == (4, 16)

    def test_banded_gather_step_runs_and_learns(self, dataset):
        """The default training path (warp_gather="banded") through a
        REAL train step, tiny band. Guards the config->warp plumbing
        (band tuple, gradients through every loss warp) that unit warp
        tests miss, and that the policy applies only while the step is
        traced: the process default is left as it was."""
        cfg = Config(
            model=TINY,
            train=TrainConfig(
                batch_size=2,
                learning_rate=1e-3,
                max_steps=1,
                pose_supervision_weight=10.0,
                warp_gather="banded",
                warp_band=(2, 4),
            ),
        )
        batch = next(dataset.batches(steps=1))
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        model, state, tx = create_state(cfg, jax.random.key(0), batch)
        from davo_tpu.core import warp as warp_mod

        before = (warp_mod._DEFAULT_GATHER, warp_mod._BAND)
        seen = []
        real = warp_mod._bilinear_sample_take4

        def spy(img, coords, fill, band=None):
            seen.append(band)
            return real(img, coords, fill, band=band)

        warp_mod._bilinear_sample_take4 = spy
        try:
            step = make_train_step(model, tx, cfg)
            losses = []
            for _ in range(3):
                state, metrics = step(state, batch)
                losses.append(float(metrics["total"]))
        finally:
            warp_mod._bilinear_sample_take4 = real
        assert np.isfinite(losses).all()
        assert seen and all(b == (2, 4) for b in seen)
        assert (warp_mod._DEFAULT_GATHER, warp_mod._BAND) == before
