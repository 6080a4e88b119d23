"""Presets, PCG solver, CLI smoke, metrics logger, bootstrap."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from davo_tpu.ba.pcg import pcg_solve
from davo_tpu.ba import schur
from davo_tpu.models import presets
from davo_tpu.utils.metrics import MetricsLogger


class TestPresets:
    def test_known_names(self):
        assert "davo" in presets.available()
        assert presets.get("davo").model.attention == "flow_seg"
        assert presets.get("base").model.attention == "none"

    def test_unknown_raises(self):
        with pytest.raises(KeyError):
            presets.get("nope")

    def test_overrides(self):
        cfg = presets.with_overrides("davo", img_height=64, img_width=96)
        assert cfg.model.img_height == 64
        # original untouched (frozen)
        assert presets.get("davo").model.img_height == 128


class TestPCG:
    def _random_spd_system(self, rng, M=6):
        A = rng.normal(size=(6 * M, 6 * M))
        dense = A @ A.T + 6 * M * np.eye(6 * M)
        S = dense.reshape(M, 6, M, 6).transpose(0, 2, 1, 3)
        rhs = rng.normal(size=(M, 6))
        return (
            jnp.asarray(S, jnp.float32),
            jnp.asarray(rhs, jnp.float32),
            dense,
        )

    def test_matches_direct(self, rng):
        S, rhs, dense = self._random_spd_system(rng)
        x_pcg = pcg_solve(S, rhs, iterations=60, n_fixed=2)
        x_lu = schur.solve_window(S, rhs, n_fixed=2)
        np.testing.assert_allclose(
            np.asarray(x_pcg), np.asarray(x_lu), rtol=1e-3, atol=1e-4
        )

    def test_gauge_clamped(self, rng):
        S, rhs, _ = self._random_spd_system(rng)
        x = pcg_solve(S, rhs, iterations=40, n_fixed=2)
        assert float(jnp.abs(x[:2]).max()) == 0.0


class TestMetricsLogger:
    def test_jsonl(self, tmp_path):
        logger = MetricsLogger(str(tmp_path), tensorboard=False)
        logger.log(1, {"loss": 0.5})
        logger.log(2, {"loss": jnp.asarray(0.25)})
        logger.close()
        lines = open(tmp_path / "metrics.jsonl").read().strip().splitlines()
        assert len(lines) == 2
        rec = json.loads(lines[1])
        assert rec["step"] == 2 and rec["loss"] == 0.25


class TestBootstrap:
    def test_single_process(self):
        from davo_tpu.dist.bootstrap import initialize

        topo = initialize()
        assert topo.num_processes == 1
        assert topo.is_coordinator
        assert topo.global_device_count == jax.device_count()


CLI_ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
}


@pytest.mark.slow
class TestCLI:
    def test_train_infer_eval_roundtrip(self, tmp_path):
        """Smoke the full CLI surface on the tiny synthetic preset."""
        ckpt = str(tmp_path / "ckpt")
        out = str(tmp_path / "pred.txt")
        r = subprocess.run(
            [
                sys.executable, "-m", "davo_tpu.cli.main", "train",
                "--version", "tiny", "--data", "synthetic",
                "--steps", "3", "--checkpoint-dir", ckpt,
                "--set", "train.batch_size=2",
                "--set", "train.pose_supervision_weight=10.0",
                "--set", "train.log_every=1",
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "step 3" in r.stdout

        r = subprocess.run(
            [
                sys.executable, "-m", "davo_tpu.cli.main", "infer",
                "--version", "tiny", "--data", "synthetic", "--seq", "0",
                "--ckpt", ckpt, "--out", out, "--batch-size", "8",
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert os.path.exists(out)

        # GT for the same synthetic sequence:
        from davo_tpu.data.kitti import write_poses_kitti
        from davo_tpu.data.synthetic import SyntheticSequence

        gt_path = str(tmp_path / "gt.txt")
        s = SyntheticSequence(n_frames=32, height=48, width=64, seed=0)
        write_poses_kitti(gt_path, s.poses)
        r = subprocess.run(
            [
                sys.executable, "-m", "davo_tpu.cli.main", "eval",
                "--gt", gt_path, "--pred", out,
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        report = json.loads(r.stdout)
        assert "ate_full" in report and np.isfinite(report["ate_full"])

        # depth maps from the same checkpoint
        depth_dir = str(tmp_path / "depth")
        r = subprocess.run(
            [
                sys.executable, "-m", "davo_tpu.cli.main", "depth",
                "--version", "tiny", "--data", "synthetic", "--seq", "0",
                "--ckpt", ckpt, "--out", depth_dir, "--batch-size", "8",
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        maps = sorted(os.listdir(depth_dir))
        assert len(maps) == 31  # 32 frames -> 31 pair targets
        d = np.load(os.path.join(depth_dir, maps[0]))
        assert d.shape == (48, 64) and np.all(d > 0)

        # Eigen-style depth metrics vs the synthetic GT (R3/R12)
        r = subprocess.run(
            [
                sys.executable, "-m", "davo_tpu.cli.main", "eval-depth",
                "--depth-dir", depth_dir, "--data", "synthetic",
                "--seq", "0",
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        dm = json.loads(r.stdout)
        assert np.isfinite(dm["abs_rel"]) and dm["n_valid"] > 0
        assert 0.0 <= dm["a1"] <= 1.0

        # BA refinement of the predicted trajectory
        refined = str(tmp_path / "refined.txt")
        r = subprocess.run(
            [
                sys.executable, "-m", "davo_tpu.cli.main", "ba",
                "--version", "tiny", "--data", "synthetic", "--seq", "0",
                "--pred", out, "--out", refined, "--window", "6",
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        from davo_tpu.data.kitti import parse_poses

        with open(refined) as f:
            rp = parse_poses(f.read())
        assert rp.shape == (32, 4, 4)


@pytest.mark.slow
class TestCLIPreparedTraining:
    def test_train_from_prepared_layout(self, tmp_path):
        """`davo-tpu train` consumes the offline-prepared triplet
        layout (the reference's prepare_train_data output) directly."""
        import subprocess
        import sys as _sys

        import cv2

        from davo_tpu.data.prep import prepare_kitti_odometry
        from davo_tpu.data.kitti import format_poses_kitti
        from davo_tpu.data.synthetic import SyntheticSequence

        seq = SyntheticSequence(n_frames=6, height=48, width=64, seed=0)
        root = tmp_path / "kitti"
        img_dir = root / "sequences" / "00" / "image_2"
        img_dir.mkdir(parents=True)
        for i in range(6):
            cv2.imwrite(
                str(img_dir / f"{i:06d}.png"),
                cv2.cvtColor(
                    (seq.frame(i) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR
                ),
            )
        K = np.hstack([seq.K, np.zeros((3, 1))])
        (root / "sequences" / "00" / "calib.txt").write_text(
            "P2: " + " ".join(str(v) for v in K.ravel()) + "\n"
        )
        (root / "poses").mkdir()
        (root / "poses" / "00.txt").write_text(format_poses_kitti(seq.poses))
        out = tmp_path / "prepared"
        prepare_kitti_odometry(
            str(root), str(out), height=48, width=64,
            seqs=("00",), num_workers=1, val_fraction=0.0,
        )

        r = subprocess.run(
            [
                _sys.executable, "-m", "davo_tpu.cli.main", "train",
                "--version", "tiny", "--data", str(out), "--steps", "2",
                "--set", "model.attention=flow",
                "--set", "train.batch_size=2",
                "--set", "train.log_every=1",
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "step 2" in r.stdout

        # flow_seg is rejected with a clear message (no seg in layout).
        r = subprocess.run(
            [
                _sys.executable, "-m", "davo_tpu.cli.main", "train",
                "--version", "tiny", "--data", str(out), "--steps", "1",
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=600,
        )
        assert r.returncode == 1 and "seg" in r.stderr

        # With a seg/ dir in the source tree, prep writes *_seg.png and
        # the FULL flow_seg model trains from the prepared layout
        # (reference parity: SURVEY.md R8 precomputed-seg ingestion).
        seg_dir = root / "sequences" / "00" / "seg"
        seg_dir.mkdir()
        for i in range(6):
            cv2.imwrite(
                str(seg_dir / f"{i:06d}.png"), seq.seg(i).astype(np.uint8)
            )
        out2 = tmp_path / "prepared_seg"
        prepare_kitti_odometry(
            str(root), str(out2), height=48, width=64,
            seqs=("00",), num_workers=1, val_fraction=0.0,
        )
        r = subprocess.run(
            [
                _sys.executable, "-m", "davo_tpu.cli.main", "train",
                "--version", "tiny", "--data", str(out2), "--steps", "2",
                "--set", "train.batch_size=2",
                "--set", "train.log_every=1",
            ],
            capture_output=True, text=True, env=CLI_ENV, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "step 2" in r.stdout


class TestSolAccounting:
    def test_model_flops_ladder(self):
        """Analytic FLOP counts: davo ~2.65 GF/pair (the recorded r2
        figure), davo-fast strictly fewer (projection + search=3),
        attention=none far fewer (no flow path)."""
        from davo_tpu.bench.sol import model_flops

        davo = model_flops(presets.get("davo").model)
        fast = model_flops(presets.get("davo-fast").model)
        none_ = model_flops(presets.get("base").model)
        assert 2.4e9 < davo < 2.9e9
        assert none_ < fast < davo
        # Projection FLOPs are tiny vs the correlation they shrink.
        assert fast > 0.8 * davo
