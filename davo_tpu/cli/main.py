"""davo-tpu CLI: train | infer | eval | bench.

Replaces the reference's per-entry flag scripts (`<ref>/train.py`,
`<ref>/test_kitti_pose.py`, SURVEY.md R1/R2) with one typed-config
CLI. `--version` selects a preset (models/presets.py); dotted
`--set key=value` overrides reach any config field.

Examples:
  python -m davo_tpu.cli train --version tiny --data synthetic \
      --steps 500 --checkpoint-dir /tmp/ckpt
  python -m davo_tpu.cli infer --version davo --data /kitti --seq 09 \
      --ckpt /tmp/ckpt --out results/09.txt
  python -m davo_tpu.cli eval --gt /kitti/poses/09.txt --pred results/09.txt
  python -m davo_tpu.cli bench --version davo
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


class _PreparedWrapper:
    """Adapt PreparedSnippets to the SnippetDataset.batches(steps=N)
    interface cmd_train consumes."""

    def __init__(self, prepared, batch_size: int):
        self.prepared = prepared
        self.batch_size = batch_size

    def batches(self, steps=None):
        return self.prepared.batches(self.batch_size, steps=steps)


def _apply_sets(cfg, sets: list[str]):
    from davo_tpu.config import apply_overrides

    overrides = {}
    for item in sets or []:
        key, _, value = item.partition("=")
        overrides[key] = value
    return apply_overrides(cfg, overrides)


def _load_sequence(data: str, seq: str, cfg, with_seg: bool):
    """Returns (frames (N,H,W,3) float32, seg or None, gt or None, K)."""
    import numpy as np

    H, W = cfg.model.img_height, cfg.model.img_width
    if data == "synthetic":
        from davo_tpu.data.synthetic import SyntheticSequence

        s = SyntheticSequence(n_frames=32, height=H, width=W, seed=int(seq or 0))
        frames = np.stack([s.frame(i) for i in range(len(s))])
        seg = np.stack([s.seg(i) for i in range(len(s))]) if with_seg else None
        return frames, seg, s.poses, s.K
    from davo_tpu.data.kitti import KittiOdometry

    ko = KittiOdometry(data, seq)
    native = __import__("cv2").imread(ko.frame_path(0)).shape[:2]
    frames = np.stack(
        [ko.load_frame(i, H, W) for i in range(len(ko))]
    )
    K = ko.scaled_intrinsics(H, W, native)
    return frames, None, ko.gt_poses, K


def cmd_train(args) -> int:
    from davo_tpu.data.snippets import SnippetDataset
    from davo_tpu.data.synthetic import SyntheticSequence
    from davo_tpu.models import presets
    from davo_tpu.train.loop import fit
    from davo_tpu.utils.metrics import MetricsLogger

    cfg = presets.get(args.version)
    cfg = _apply_sets(cfg, args.set)
    if args.steps:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, max_steps=args.steps)
        )

    # Zoom/crop augmentation makes GT translation magnitude
    # unobservable (no K input to the net) — color-only when the run
    # is supervised (data/snippets.py _scale_crop note; train_e2e.py).
    augment = "color" if cfg.train.pose_supervision_weight > 0 else True

    if args.data == "synthetic":
        # Multi-world training is the measured default (single-scene
        # training overfits texture — data/snippets.py
        # MultiSourceDataset note; the quality ladders train on 16).
        from davo_tpu.data.snippets import MultiSourceDataset
        from davo_tpu.data.synthetic import DriveSequence

        wcls = {
            "drive": lambda **kw: DriveSequence(**kw),
            "wander": lambda **kw: SyntheticSequence(
                trajectory="wander", rot_amp=0.06, tilt_amp=0.05, **kw
            ),
            "loop": lambda **kw: SyntheticSequence(**kw),
        }[args.world_class]
        worlds = [
            wcls(
                n_frames=args.world_frames,
                height=cfg.model.img_height,
                width=cfg.model.img_width,
                seed=cfg.train.seed + i,
            )
            for i in range(max(args.worlds, 1))
        ]
        ds = MultiSourceDataset(
            worlds,
            batch_size=cfg.train.batch_size,
            with_seg=cfg.model.attention == "flow_seg",
            with_gt=cfg.train.pose_supervision_weight > 0,
            # Synthetic worlds render exact flow; the supervised-flow
            # tier (losses.flow_supervision_loss) is a config knob
            # away: --set train.flow_supervision_weight=1.0
            with_flow=cfg.train.flow_supervision_weight > 0,
            augment=augment,
            seed=cfg.train.seed,
        )
    elif os.path.exists(os.path.join(args.data, "train.txt")):
        # Offline-prepared layout (data/prep.py; the reference's
        # prepare_train_data output — concat triplets + *_cam.txt,
        # plus *_seg.png label maps when the source tree had seg/).
        from davo_tpu.data.prep import PreparedSnippets

        prepared = PreparedSnippets(args.data, seed=cfg.train.seed)
        if cfg.model.attention == "flow_seg" and not prepared.has_seg:
            print(
                "prepared layout has no *_seg.png maps (re-run prep "
                "with a seg/ dir in the source tree); use --version "
                "flow or train from a KITTI root", file=sys.stderr,
            )
            return 1
        if cfg.train.pose_supervision_weight > 0 and not prepared.has_gt:
            print(
                "pose_supervision_weight > 0 but the prepared layout "
                "has no *_pose.txt GT (re-run prep from a source with "
                "poses, or train unsupervised)", file=sys.stderr,
            )
            return 1
        # Only decode/ship lanes the config consumes.
        prepared.has_seg &= cfg.model.attention == "flow_seg"
        prepared.has_gt &= cfg.train.pose_supervision_weight > 0
        ds = None
        if args.loader in ("auto", "native"):
            # C++ decode pool (tools/native_loader): overlaps JPEG
            # decode with the train step instead of serializing them.
            try:
                from davo_tpu.data.native_loader import NativeSnippetLoader

                ds = NativeSnippetLoader(
                    args.data,
                    batch_size=cfg.train.batch_size,
                    seed=cfg.train.seed,
                    with_seg=cfg.model.attention == "flow_seg",
                    with_gt=cfg.train.pose_supervision_weight > 0,
                )
                print("input pipeline: native C++ loader", flush=True)
            except Exception as e:
                if args.loader == "native":
                    raise
                print(f"native loader unavailable ({e}); python reader",
                      file=sys.stderr)
        if ds is None:
            ds = _PreparedWrapper(prepared, cfg.train.batch_size)
    else:
        from davo_tpu.data.kitti import TRAIN_SEQS, KittiOdometry
        from davo_tpu.data.snippets import KittiAdapter

        ko = KittiOdometry(args.data, args.seq or TRAIN_SEQS[0])
        native = __import__("cv2").imread(ko.frame_path(0)).shape[:2]
        ad = KittiAdapter(
            ko, cfg.model.img_height, cfg.model.img_width, native
        )
        ds = SnippetDataset(
            ad, batch_size=cfg.train.batch_size, augment=augment,
            with_gt=cfg.train.pose_supervision_weight > 0,
        )

    logger = (
        MetricsLogger(args.log_dir) if args.log_dir else None
    )

    def log_fn(step, metrics):
        line = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        print(f"step {step}: {line}", flush=True)

    # Double-buffered H2D prefetch (SURVEY.md R9 queue-runner analog):
    # batches land on device one step ahead; stats expose whether the
    # host input pipeline ever becomes the bottleneck.
    from davo_tpu.data.prefetch import PrefetchStats, device_prefetch

    stats = PrefetchStats()
    batch_iter = ds.batches(steps=cfg.train.max_steps)
    if not isinstance(ds, SnippetDataset):
        # Prepared-layout readers yield raw batches; apply the same
        # train-time augmentation SnippetDataset does internally.
        from davo_tpu.data.snippets import augment_batches

        batch_iter = augment_batches(
            batch_iter, mode=augment, seed=cfg.train.seed
        )
    fit(
        cfg,
        device_prefetch(batch_iter, stats=stats),
        checkpoint_dir=args.checkpoint_dir,
        log_fn=log_fn,
        # fit() writes scalars AND (when train.image_every > 0)
        # warped/disparity image panels through the logger.
        metrics_logger=logger,
    )
    print(f"prefetch: {stats.summary()}", flush=True)
    if logger:
        logger.close()
    return 0


def _restore_model(cfg, ckpt_dir, frames, seg):
    """Build a model state template and restore params from a ckpt."""
    import jax
    import numpy as np

    from davo_tpu.train.loop import (
        create_state,
        make_checkpoint_manager,
        restore_checkpoint,
    )

    sample = {
        "target": frames[:1],
        "sources": frames[:1][:, None],
        "K": np.eye(3, dtype=np.float32)[None],
    }
    if seg is not None:
        sample["seg"] = seg[:1]
    model, state, _ = create_state(cfg, jax.random.key(0), sample)
    mngr = make_checkpoint_manager(ckpt_dir)
    restored = restore_checkpoint(mngr, state)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    return model, restored.params


def cmd_infer(args) -> int:
    import jax
    import numpy as np

    from davo_tpu.data.kitti import write_poses_kitti
    from davo_tpu.eval.runner import (
        assemble_trajectory,
        make_pose_apply_fn,
        predict_sequence,
    )
    from davo_tpu.models import presets
    from davo_tpu.models.davo import DavoModel
    from davo_tpu.train.loop import (
        create_state,
        make_checkpoint_manager,
        restore_checkpoint,
    )

    cfg = _apply_sets(presets.get(args.version), args.set)
    frames, seg, gt_poses, _ = _load_sequence(
        args.data, args.seq, cfg, cfg.model.attention == "flow_seg"
    )
    # Build state template from a dummy batch and restore.
    sample = {
        "target": frames[:1],
        "sources": frames[:1][:, None],
        "K": np.eye(3, dtype=np.float32)[None],
    }
    if seg is not None:
        sample["seg"] = seg[:1]
    model, state, _ = create_state(cfg, jax.random.key(0), sample)
    if args.ckpt:
        mngr = make_checkpoint_manager(args.ckpt)
        restored = restore_checkpoint(mngr, state)
        if restored is None:
            print(f"no checkpoint found in {args.ckpt}", file=sys.stderr)
            return 1
        state = restored
    scan_chunks = max(1, getattr(args, "scan_chunks", 1))
    if scan_chunks > 1:
        # Dispatch-amortized serving: K batches per device call
        # (lax.scan) — pays the per-call host/dispatch gap once per K
        # batches, numerics identical (results_r4_serving_scan.json at cf6389d).
        from davo_tpu.eval.runner import make_pose_apply_scan_fn

        apply_fn = make_pose_apply_scan_fn(
            model, state.params, cfg.model.attention
        )
    else:
        apply_fn = make_pose_apply_fn(
            model, state.params, cfg.model.attention
        )
    rels = predict_sequence(
        apply_fn, frames, seg=seg, batch_size=args.batch_size,
        scan_chunks=scan_chunks,
    )
    traj = assemble_trajectory(rels)
    write_poses_kitti(args.out, traj)
    if args.tum:
        from davo_tpu.eval.tum import write_poses_tum

        write_poses_tum(args.tum, traj)
    if args.gt_out:
        # GT trajectory alongside (synthetic worlds / KITTI poses) so
        # `eval --gt ...` needs no separate dataset plumbing.
        if gt_poses is None:
            print("no GT poses available for --gt-out", file=sys.stderr)
            return 1
        write_poses_kitti(args.gt_out, np.asarray(gt_poses))
    print(f"wrote {len(traj)} poses to {args.out}")
    return 0


def cmd_depth(args) -> int:
    """Depth-map inference (reference parity: `<ref>/test_kitti_depth.py`,
    SURVEY.md R3): writes per-frame depth .npy files."""
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from davo_tpu.models import presets
    from davo_tpu.models.dispnet import disp_to_depth
    from davo_tpu.train.loop import (
        create_state,
        make_checkpoint_manager,
        restore_checkpoint,
    )

    cfg = _apply_sets(presets.get(args.version), args.set)
    frames, seg, _, _ = _load_sequence(args.data, args.seq, cfg, False)
    sample = {
        "target": frames[:1],
        "sources": frames[:1][:, None],
        "K": np.eye(3, dtype=np.float32)[None],
    }
    model, state, _ = create_state(cfg, jax.random.key(0), sample)
    if args.ckpt:
        mngr = make_checkpoint_manager(args.ckpt)
        restored = restore_checkpoint(mngr, state)
        if restored is None:
            print(f"no checkpoint found in {args.ckpt}", file=sys.stderr)
            return 1
        state = restored

    @jax.jit
    def depth_fn(targets, sources):
        out = model.apply(
            state.params, targets, sources, train=True
        )
        return disp_to_depth(out["disp"][0][..., 0])

    os.makedirs(args.out, exist_ok=True)
    bs = args.batch_size
    n = len(frames) - 1
    for start in range(0, n, bs):
        end = min(start + bs, n)
        pad = bs - (end - start)
        tgt = frames[start:end]
        src = frames[start + 1 : end + 1]
        if pad:
            tgt = np.concatenate([tgt, np.repeat(tgt[-1:], pad, 0)])
            src = np.concatenate([src, np.repeat(src[-1:], pad, 0)])
        d = np.asarray(depth_fn(jnp.asarray(tgt), jnp.asarray(src)[:, None]))
        for i in range(end - start):
            np.save(os.path.join(args.out, f"{start + i:06d}.npy"), d[i])
    print(f"wrote {n} depth maps to {args.out}")
    return 0


def cmd_eval(args) -> int:
    import numpy as np

    from davo_tpu.data.kitti import parse_poses
    from davo_tpu.eval.metrics import kitti_seg_errors, snippet_ate
    from davo_tpu.eval.runner import evaluate_sequence

    with open(args.gt) as f:
        gt = parse_poses(f.read())
    with open(args.pred) as f:
        pred = parse_poses(f.read())
    n = min(len(gt), len(pred))
    report = evaluate_sequence(pred[:n], gt[:n], snippet_len=args.snippet_len)
    if args.devkit:
        from davo_tpu.eval.devkit import kitti_seg_errors_cpp

        cpp = kitti_seg_errors_cpp(gt[:n], pred[:n])
        report["t_err_pct_cpp"] = cpp["t_err_pct"]
        report["r_err_deg_per_100m_cpp"] = cpp["r_err_deg_per_100m"]
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_eval_depth(args) -> int:
    """Eigen-style depth evaluation (reference parity:
    `<ref>/kitti_eval/eval_depth.py`, SURVEY.md R3/R12): per-frame
    median scaling, [min,max]-depth mask, abs_rel/sq_rel/RMSE/
    RMSE_log/delta accuracies. Predictions from --depth-dir
    (`davo-tpu depth` .npy output); GT from the synthetic world or a
    --gt-dir of matching .npy files."""
    import os

    import numpy as np

    from davo_tpu.eval.depth_metrics import depth_errors

    files = sorted(
        f for f in os.listdir(args.depth_dir) if f.endswith(".npy")
    )
    if not files:
        print(f"no .npy depth maps in {args.depth_dir}", file=sys.stderr)
        return 1
    pred = np.stack(
        [np.load(os.path.join(args.depth_dir, f)) for f in files]
    )
    if args.gt_dir:
        gt = np.stack(
            [np.load(os.path.join(args.gt_dir, f)) for f in files]
        )
    elif args.data == "synthetic":
        from davo_tpu.data.synthetic import SyntheticSequence

        s = SyntheticSequence(
            n_frames=len(files) + 1,
            height=pred.shape[1],
            width=pred.shape[2],
            seed=int(args.seq or 0),
        )
        gt = np.stack([s.depth(i) for i in range(len(files))])
    else:
        print("need --gt-dir for non-synthetic data", file=sys.stderr)
        return 1
    report = depth_errors(
        gt, pred, min_depth=args.min_depth, max_depth=args.max_depth,
        median_scale=not args.no_median_scale,
    )
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_ba(args) -> int:
    """Sliding-window BA refinement of a predicted trajectory
    (BASELINE config #4 surface). Observations are flow-tracked
    correspondences (ba/tracks.py): from the trained FlowNetLite when
    --ckpt is given, else (synthetic data) from the world's exact flow
    field. No GT-pose oracle in either path. Depth comes from
    --depth-dir (.npy per frame, e.g. `davo-tpu depth` output) or
    synthetic GT."""
    import numpy as np

    from davo_tpu.ba.tracks import make_flow_fn, refine_trajectory_tracked
    from davo_tpu.config import BAConfig
    from davo_tpu.data.kitti import parse_poses, write_poses_kitti
    from davo_tpu.models import presets

    cfg = _apply_sets(presets.get(args.version), args.set)
    with open(args.pred) as f:
        pred = parse_poses(f.read())
    frames, segs, _, K = _load_sequence(
        args.data, args.seq, cfg, args.exclude_dynamic
    )
    n = len(pred)

    if args.depth_dir:
        import os

        depths = np.stack(
            [
                np.load(os.path.join(args.depth_dir, f"{i:06d}.npy"))
                for i in range(n)
            ]
        )
    elif args.data == "synthetic":
        from davo_tpu.data.synthetic import SyntheticSequence

        s = SyntheticSequence(
            n_frames=32, height=cfg.model.img_height,
            width=cfg.model.img_width, seed=int(args.seq or 0),
        )
        depths = np.stack([s.depth(i) for i in range(n)])
    else:
        print("need --depth-dir for non-synthetic data", file=sys.stderr)
        return 1

    if args.ckpt:
        model, params = _restore_model(cfg, args.ckpt, frames, segs)
        flow_fn = make_flow_fn(params, cfg, frames[:n])
    elif args.data == "synthetic":
        from davo_tpu.data.synthetic import SyntheticSequence

        s = SyntheticSequence(
            n_frames=32, height=cfg.model.img_height,
            width=cfg.model.img_width, seed=int(args.seq or 0),
        )
        flow_fn = s.gt_flow
    else:
        print("need --ckpt for non-synthetic data", file=sys.stderr)
        return 1

    from davo_tpu.data.synthetic import DYNAMIC_LABEL_START

    ba_cfg = BAConfig(
        window_size=args.window, max_iterations=args.iterations,
        damping=1e-3, huber_delta=3.0,
    )
    refined = refine_trajectory_tracked(
        ba_cfg, pred, depths, np.asarray(K, np.float64), flow_fn,
        grid_step=args.grid_step, fb_px=args.fb_px,
        segs=segs if args.exclude_dynamic else None,
        exclude_labels=(
            tuple(range(DYNAMIC_LABEL_START, cfg.model.num_seg_classes))
            if args.exclude_dynamic
            else ()
        ),
    )
    write_poses_kitti(args.out, refined)
    print(f"refined {n} poses -> {args.out}")
    return 0


def cmd_bench(args) -> int:
    import bench as bench_mod  # repo-root bench.py

    bench_mod.main()
    return 0


def cmd_export(args) -> int:
    """Serialize the pose-inference forward as a portable StableHLO
    artifact (jax.export): params baked in, fixed batch/resolution —
    a serving deployable that needs no Python model code to run
    (`jax.export.deserialize(blob).call(...)`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import export as jexport

    from davo_tpu.models import presets
    from davo_tpu.models.davo import DavoModel

    cfg = _apply_sets(presets.get(args.version), args.set)
    H, W = cfg.model.img_height, cfg.model.img_width
    B = args.batch_size
    rng = np.random.default_rng(0)
    frames = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    seg0 = rng.integers(0, cfg.model.num_seg_classes, (B, H, W)).astype(
        np.int32
    )
    with_seg = cfg.model.attention == "flow_seg"
    if args.ckpt:
        model, params = _restore_model(
            cfg, args.ckpt, frames, seg0 if with_seg else None
        )
    else:
        from davo_tpu.train.loop import create_state

        sample = {
            "target": frames,
            "sources": frames[:, None],
            "K": np.eye(3, dtype=np.float32)[None].repeat(B, 0),
        }
        if with_seg:
            sample["seg"] = seg0
        model, state, _ = create_state(cfg, jax.random.key(0), sample)
        params = state.params
        print("warning: exporting UNTRAINED params (no --ckpt)",
              file=sys.stderr)

    def forward(target, source, seg):
        out = model.apply(
            params, target, source[:, None],
            seg=seg if with_seg else None, train=False,
        )
        return out["poses"][:, 0]

    spec = jax.ShapeDtypeStruct((B, H, W, 3), jnp.float32)
    seg_spec = jax.ShapeDtypeStruct((B, H, W), jnp.int32)
    # Without --platforms the artifact is pinned to the platform this
    # CLI runs on and deserialize().call() refuses elsewhere — let
    # deployment choose.
    platforms = args.platforms.split(",") if args.platforms else None
    exp = jexport.export(jax.jit(forward), platforms=platforms)(
        spec, spec, seg_spec
    )
    blob = exp.serialize()
    with open(args.out, "wb") as f:
        f.write(blob)
    print(
        f"exported {args.version} pose forward (B={B}, {H}x{W}) "
        f"-> {args.out} ({len(blob)} bytes, platforms={exp.platforms})"
    )
    return 0


def cmd_train_seg(args) -> int:
    """Train the in-repo segmentation source (SURVEY.md R8 / §7.2:
    the reference ships precomputed DeepLab masks; this produces our
    own) on synthetic GT labels and save a prep-consumable ckpt."""
    import json

    from davo_tpu.models.segnet import save_segnet
    from davo_tpu.train.seg import train_segnet

    model, params, metrics = train_segnet(
        steps=args.steps,
        batch_size=args.batch_size,
        height=args.height,
        width=args.width,
        seed=args.seed,
        channels=tuple(int(c) for c in args.channels.split(",")),
    )
    save_segnet(args.checkpoint_dir, model, params)
    print(json.dumps(metrics))
    return 0


def cmd_prep(args) -> int:
    """Offline dataset preparation (reference parity: SURVEY.md R11
    `<ref>/data/prepare_train_data.py`), plus `--write-seg`: stamp
    framework-generated `*_seg.png` masks onto the prepared tree so
    flow_seg trains without external segmentation."""
    from davo_tpu.data import prep as dprep

    if args.dataset is not None:
        if not args.root:  # usage error, not an opaque traceback (ADVICE r3)
            print("--dataset needs --root <raw dataset dir>",
                  file=sys.stderr)
            return 2
        fn = {
            "kitti_odom": dprep.prepare_kitti_odometry,
            "kitti_raw": dprep.prepare_kitti_raw,
            "cityscapes": dprep.prepare_cityscapes,
        }[args.dataset]
        kwargs = dict(
            root=args.root,
            out_dir=args.out,
            height=args.height,
            width=args.width,
            num_workers=args.num_workers,
        )
        if args.dataset == "kitti_odom" and args.seqs:
            kwargs["seqs"] = tuple(args.seqs.split(","))
        counts = fn(**kwargs)
        print(f"prepared {counts}")
    if args.write_seg:
        if not args.seg_ckpt:
            print("--write-seg needs --seg-ckpt (see `train-seg`)",
                  file=sys.stderr)
            return 2
        from davo_tpu.data.prep import annotate_prepared_seg
        from davo_tpu.models.segnet import make_seg_infer

        n = annotate_prepared_seg(
            args.out,
            make_seg_infer(args.seg_ckpt),
            batch_size=args.batch_size,
            overwrite=args.overwrite_seg,
        )
        print(f"wrote {n} seg maps into {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="davo-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model")
    t.add_argument("--version", default="davo")
    t.add_argument("--data", default="synthetic", help="'synthetic' or KITTI root")
    t.add_argument("--seq", default=None)
    t.add_argument(
        "--world-class", default="loop",
        choices=("loop", "wander", "drive"),
        help="synthetic data only: world family (ladder5: 'drive' is "
        "the rotation-identifiable class the quality recipes train on)",
    )
    t.add_argument(
        "--worlds", type=int, default=16,
        help="synthetic data only: number of procedural train worlds",
    )
    t.add_argument(
        "--world-frames", type=int, default=24,
        help="synthetic data only: frames per train world",
    )
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--log-dir", default=None)
    t.add_argument("--set", action="append", help="dotted override k=v")
    t.add_argument(
        "--loader", default="auto", choices=("auto", "native", "python"),
        help="prepared-layout reader: C++ decode pool or python",
    )
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="predict a trajectory")
    i.add_argument("--version", default="davo")
    i.add_argument("--data", default="synthetic")
    i.add_argument("--seq", default="09")
    i.add_argument("--ckpt", default=None)
    i.add_argument("--out", required=True)
    i.add_argument("--tum", default=None, help="also write TUM-format file")
    i.add_argument(
        "--gt-out", default=None,
        help="also write the sequence's GT trajectory (KITTI format)",
    )
    i.add_argument("--batch-size", type=int, default=32)
    i.add_argument(
        "--scan-chunks", type=int, default=1,
        help="batches per device call (lax.scan dispatch amortization; "
        "1 = per-call serving)",
    )
    i.add_argument("--set", action="append")
    i.set_defaults(fn=cmd_infer)

    d = sub.add_parser("depth", help="depth-map inference")
    d.add_argument("--version", default="davo")
    d.add_argument("--data", default="synthetic")
    d.add_argument("--seq", default="09")
    d.add_argument("--ckpt", default=None)
    d.add_argument("--out", required=True)
    d.add_argument("--batch-size", type=int, default=32)
    d.add_argument("--set", action="append")
    d.set_defaults(fn=cmd_depth)

    e = sub.add_parser("eval", help="evaluate a trajectory vs GT")
    e.add_argument("--gt", required=True)
    e.add_argument("--pred", required=True)
    e.add_argument("--snippet-len", type=int, default=5)
    e.add_argument("--devkit", action="store_true", help="also run C++ devkit")
    e.set_defaults(fn=cmd_eval)

    ed = sub.add_parser("eval-depth", help="evaluate depth maps vs GT")
    ed.add_argument("--depth-dir", required=True)
    ed.add_argument("--gt-dir", default=None)
    ed.add_argument("--data", default="synthetic")
    ed.add_argument("--seq", default="0")
    ed.add_argument("--min-depth", type=float, default=1e-3)
    ed.add_argument("--max-depth", type=float, default=80.0)
    ed.add_argument("--no-median-scale", action="store_true")
    ed.set_defaults(fn=cmd_eval_depth)

    a = sub.add_parser("ba", help="sliding-window BA refinement")
    a.add_argument("--version", default="davo")
    a.add_argument("--data", default="synthetic")
    a.add_argument("--seq", default="09")
    a.add_argument("--pred", required=True, help="predicted trajectory (KITTI fmt)")
    a.add_argument("--depth-dir", default=None)
    a.add_argument("--ckpt", default=None, help="model ckpt for flow tracks")
    a.add_argument("--out", required=True)
    a.add_argument("--window", type=int, default=8)
    a.add_argument("--iterations", type=int, default=8)
    a.add_argument("--grid-step", type=int, default=8)
    a.add_argument("--fb-px", type=float, default=1.0,
                   help="forward-backward track gate (pixels)")
    a.add_argument("--exclude-dynamic", action="store_true",
                   help="drop anchors on dynamic seg classes (11-18)")
    a.add_argument("--set", action="append")
    a.set_defaults(fn=cmd_ba)

    x = sub.add_parser(
        "export", help="serialize the pose forward (StableHLO)"
    )
    x.add_argument("--version", default="davo-fast")
    x.add_argument("--ckpt", default=None)
    x.add_argument("--out", required=True)
    x.add_argument("--batch-size", type=int, default=128)
    x.add_argument(
        "--platforms", default=None,
        help="comma list to lower for (e.g. cuda,cpu); default: current",
    )
    x.add_argument("--set", action="append")
    x.set_defaults(fn=cmd_export)

    b = sub.add_parser("bench", help="throughput benchmark")
    b.add_argument("--version", default="davo")
    b.set_defaults(fn=cmd_bench)

    ts = sub.add_parser(
        "train-seg", help="train the in-repo segmentation source"
    )
    ts.add_argument("--checkpoint-dir", required=True)
    ts.add_argument("--steps", type=int, default=600)
    ts.add_argument("--batch-size", type=int, default=8)
    ts.add_argument("--height", type=int, default=128)
    ts.add_argument("--width", type=int, default=416)
    ts.add_argument("--seed", type=int, default=0)
    ts.add_argument("--channels", default="16,32,64,128")
    ts.set_defaults(fn=cmd_train_seg)

    pp = sub.add_parser(
        "prep", help="offline dataset preparation (+ seg annotation)"
    )
    pp.add_argument(
        "--dataset", default=None,
        choices=("kitti_odom", "kitti_raw", "cityscapes"),
        help="omit to only annotate an existing prepared tree",
    )
    pp.add_argument("--root", default=None, help="raw dataset root")
    pp.add_argument("--out", required=True, help="prepared tree dir")
    pp.add_argument("--height", type=int, default=128)
    pp.add_argument("--width", type=int, default=416)
    pp.add_argument("--seqs", default=None, help="kitti_odom seq list, comma")
    pp.add_argument("--num-workers", type=int, default=4)
    pp.add_argument("--write-seg", action="store_true")
    pp.add_argument("--seg-ckpt", default=None)
    pp.add_argument("--overwrite-seg", action="store_true")
    pp.add_argument("--batch-size", type=int, default=16)
    pp.set_defaults(fn=cmd_prep)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from davo_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
