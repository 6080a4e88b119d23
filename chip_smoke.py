"""Smoke test of the main path on one GPU: serving, training, BA, kernels.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # the multi-card paths, on four cards

Each phase prints one line with its result, its wall time and the
numbers it compared, and raises on any failure: the script exits
non-zero and never prints the final JSON line. It refuses to run
without a GPU (no CPU fallback). Weights are random, made from a seed;
images are synthetic worlds rendered at the presets' 128x416.

Every check compares the card against a plain float32 reference run on
the CPU device of the same process. `davo_tpu` sets
`jax_default_matmul_precision="float32"`, so float32 matmuls and
convolutions on the card run in full float32, not TF32; the tolerances
below rely on that.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np

# Serving poses, float32 on the card vs float32 on the CPU: the same
# math summed in another order (cuDNN/XLA-GPU vs XLA-CPU). Relative to
# the largest pose component. Sound runs read ~1e-6; TF32 convolutions
# (10 mantissa bits) would read ~1e-3 and must fail.
POSE_F32_RTOL = 1e-4
# Serving poses, production bf16 on the card vs float32 on the CPU:
# bf16 keeps 8 mantissa bits (~4e-3 per rounding), compounded over
# ~30 layers and a softmax; reads ~7e-3.
POSE_BF16_RTOL = 1e-1
# First train-step loss, float32 on the card vs the float32 CPU twin
# (same params and batch): summation order only; reads ~8e-6, while
# the bf16 forward reads ~2.5e-3.
LOSS_F32_RTOL = 1e-4
# First train-step loss, production bf16 on the card vs the CPU twin:
# a mean over pixels of photometric/SSIM/smoothness terms of the bf16
# forward.
LOSS_BF16_RTOL = 5e-2
# BA poses/points after 10 GN steps, f32 card vs f32 CPU: the LU solve
# of the 96x96 reduced system and the Schur sums round differently.
BA_POSE_ATOL = 1e-3
BA_POINT_ATOL = 1e-2
# Window solves (batched, single, card, CPU) against each other and
# against a float64 solve of the same reduced systems, relative to the
# largest update. These windows' gauge-fixed reduced systems have
# condition numbers 7e6-9e6 (printed as `cond`), so cond * eps(f32) ~ 1
# bounds nothing a priori; f32 solves read 1e-3 to 5e-3 from each other
# and from float64, a wrong solve reads O(1).
BA_SOLVE_RTOL = 2e-2
# Cost volume kernel vs XLA, f32 means of C products of N(0,1)
# features: summation order only.
COSTVOL_ATOL = 1e-5

SERVE_FRAMES = 40     # 39 pairs: one full batch of 32 and a ragged tail
SERVE_BATCH = 32
TRAIN_BATCH = 8
TRAIN_STEPS = 3


def _line(name: str, t0: float, **nums) -> None:
    vals = " ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in nums.items()
    )
    print(f"[{name}] ok {time.perf_counter() - t0:.1f}s {vals}", flush=True)


def _check(name: str, value: float, bound: float) -> float:
    if not np.isfinite(value) or value > bound:
        raise AssertionError(f"{name}={value:.4g} exceeds {bound:g}")
    return value


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _motion(T):
    """(..., 4, 4) transforms minus identity: the motion part, so that a
    relative error is not diluted by the identity's ones."""
    return np.asarray(T, np.float64) - np.eye(4)


def _gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _world(n_frames: int, seed: int = 0):
    from davo_tpu.data.synthetic import SyntheticSequence

    return SyntheticSequence(n_frames=n_frames, height=128, width=416, seed=seed)


# ---------------------------------------------------------------------------
# Phase 1: serving
# ---------------------------------------------------------------------------

def phase_serving(preset: str, world, cpu) -> None:
    import jax

    from davo_tpu.eval.runner import (
        assemble_trajectory,
        evaluate_sequence,
        make_pose_apply_fn,
        predict_sequence,
    )
    from davo_tpu.models import presets
    from davo_tpu.models.davo import DavoModel

    t0 = time.perf_counter()
    cfg = presets.get(preset).model
    frames = np.stack([world.frame(i) for i in range(len(world))])
    seg = np.stack([world.seg(i) for i in range(len(world))])
    model = DavoModel(cfg)
    model32 = DavoModel(dataclasses.replace(cfg, compute_dtype="float32"))
    params = jax.jit(model.init, static_argnames=("train",))(
        jax.random.key(1), frames[:1], frames[:1, None], seg=seg[:1],
        train=False,
    )

    def run(m, p):
        fn = make_pose_apply_fn(m, p, cfg.attention)
        return predict_sequence(fn, frames, seg=seg, batch_size=SERVE_BATCH)

    rels = run(model, params)
    rels32 = run(model32, params)
    with jax.default_device(cpu):
        rels_ref = run(model32, jax.device_put(params, cpu))
    for name, r in (("bf16", rels), ("f32", rels32), ("cpu", rels_ref)):
        if r.shape != (len(frames) - 1, 4, 4) or not np.isfinite(r).all():
            raise AssertionError(f"{preset} {name}: bad poses {r.shape}")
    ref = _motion(rels_ref)
    err32 = _check(f"{preset} f32 rel err", _rel(_motion(rels32), ref),
                   POSE_F32_RTOL)
    err16 = _check(f"{preset} bf16 rel err", _rel(_motion(rels), ref),
                   POSE_BF16_RTOL)
    metrics = evaluate_sequence(assemble_trajectory(rels), np.asarray(world.poses))
    # KITTI t_err/r_err need >= 100 m of path; a short world has none.
    bad = [k for k, v in metrics.items()
           if k.startswith(("ate", "snippet")) and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{preset}: non-finite metrics {bad}")
    _line(
        f"serve {preset}", t0, hw="x".join(map(str, frames.shape[1:3])),
        pairs=len(frames) - 1, batch=SERVE_BATCH,
        f32_vs_cpu=err32, bf16_vs_cpu=err16,
        ate=float(metrics["ate_full"]),
    )


# ---------------------------------------------------------------------------
# Phase 2: training
# ---------------------------------------------------------------------------

def _train_batches(world, n: int):
    from davo_tpu.data.snippets import SnippetDataset

    ds = SnippetDataset(
        world, batch_size=TRAIN_BATCH, with_seg=True, with_gt=True, seed=0
    )
    return list(ds.batches(steps=n, shuffle=False))


def _first_loss(cfg, params, batch, device) -> float:
    import jax
    import jax.numpy as jnp

    from davo_tpu.models.davo import DavoModel
    from davo_tpu.train.loop import TrainState, _make_tx, make_train_step

    with jax.default_device(device):
        params = jax.device_put(params, device)
        tx = _make_tx(cfg)
        state = TrainState(
            params=params, opt_state=tx.init(params),
            step=jnp.zeros((), jnp.int32),
        )
        step = make_train_step(DavoModel(cfg.model), tx, cfg)
        _, metrics = step(state, jax.device_put(batch, device))
        return float(metrics["total"])


def phase_training(world, gpu, cpu) -> None:
    import jax

    from davo_tpu.models import presets
    from davo_tpu.train.loop import create_state, make_train_step

    t0 = time.perf_counter()
    cfg = presets.get("davo")
    tr = cfg.train
    assert tr.flow_loss_res == "level" and tr.geo_consistency_weight == 0.5
    assert tr.warp_gather == "auto"  # the band clamp (config.py)
    batches = _train_batches(world, TRAIN_STEPS)
    model, state, tx = create_state(cfg, jax.random.key(2), batches[0])
    params0 = jax.device_get(state.params)
    step = make_train_step(model, tx, cfg)
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["total"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite train loss: {losses}")
    cfg32 = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32")
    )
    loss_ref = _first_loss(cfg32, params0, batches[0], cpu)
    loss32 = _first_loss(cfg32, params0, batches[0], gpu)
    err32 = _check("train f32 loss rel err",
                   abs(loss32 - loss_ref) / abs(loss_ref), LOSS_F32_RTOL)
    err16 = _check("train bf16 loss rel err",
                   abs(losses[0] - loss_ref) / abs(loss_ref), LOSS_BF16_RTOL)
    _line(
        "train davo", t0, batch=TRAIN_BATCH, steps=len(losses),
        losses="/".join(f"{x:.4f}" for x in losses), cpu_f32=loss_ref,
        f32_vs_cpu=err32, bf16_vs_cpu=err16,
    )


# ---------------------------------------------------------------------------
# Phase 3: bundle adjustment
# ---------------------------------------------------------------------------

def _window_systems(problems, cfg):
    """Stacked GN linearizations (J_pose, J_point, r, w) of windows."""
    import jax.numpy as jnp

    from davo_tpu.ba import residuals as res

    parts = []
    for p in problems:
        r = res.reprojection_residuals(
            p.poses_cw, p.points_w, p.K, p.observations, p.mask
        )
        w = res.huber_weights(r, cfg.huber_delta, cfg.outlier_px) * p.mask
        Jp, Jl = res.reprojection_jacobians(p.poses_cw, p.points_w, p.K, p.mask)
        parts.append((Jp, Jl, r, w))
    return [jnp.stack(x) for x in zip(*parts)]


def _single_solve(Jp, Jl, r, w):
    from davo_tpu.ba import schur

    B, C, E, rp, rl = schur.gauss_newton_system(Jp, Jl, r, w)
    S, rhs, C_inv = schur.schur_reduce(B, C, E, rp, rl, 1e-4)
    dxp = schur.solve_window(S, rhs)
    return dxp, schur.backsubstitute(C_inv, E, rl, dxp)


def _f64_pose_solves(systems, cpu):
    """Pose updates of each window from its gauge-fixed reduced system
    (built in f32 on the CPU, as `solve_window` builds it) solved in
    float64 by NumPy, and the largest condition number of those
    systems."""
    import jax

    from davo_tpu.ba import schur

    sols, conds = [], []
    for k in range(len(systems[0])):
        Jp, Jl, r, w = (jax.device_put(x[k], cpu) for x in systems)
        B, C, E, rp, rl = schur.gauss_newton_system(Jp, Jl, r, w)
        S, rhs, _ = schur.schur_reduce(B, C, E, rp, rl, 1e-4)
        M = S.shape[0]
        A = np.asarray(S, np.float64).transpose(0, 2, 1, 3).reshape(6 * M, 6 * M)
        keep = np.r_[np.zeros(12), np.ones(6 * M - 12)]  # n_fixed = 2
        A = A * keep[:, None] * keep[None, :] + np.diag(1.0 - keep)
        b = np.asarray(rhs, np.float64).reshape(6 * M) * keep
        sols.append(np.linalg.solve(A, b).reshape(M, 6))
        conds.append(np.linalg.cond(A))
    return np.stack(sols), max(conds)


def phase_ba(cpu) -> None:
    import jax

    from davo_tpu.ba import schur
    from davo_tpu.ba.gn import ba_cost, ba_refine, synthetic_problem
    from davo_tpu.config import BAConfig

    t0 = time.perf_counter()
    cfg = BAConfig()
    prob = synthetic_problem(0, M=16, N=1024)
    got = ba_refine(prob, cfg)
    want = ba_refine(jax.device_put(prob, cpu), cfg)
    cost0, cost1 = float(ba_cost(prob, 1.0)), float(ba_cost(got, 1.0))
    if not cost1 < cost0:
        raise AssertionError(f"BA did not reduce the cost: {cost0} -> {cost1}")
    ep = _check("ba pose err", float(np.max(np.abs(
        np.asarray(got.poses_cw) - np.asarray(want.poses_cw)))), BA_POSE_ATOL)
    el = _check("ba point err", float(np.max(np.abs(
        np.asarray(got.points_w) - np.asarray(want.points_w)))), BA_POINT_ATOL)

    systems = _window_systems(
        [synthetic_problem(s, M=16, N=1024) for s in range(1, 5)], cfg
    )
    batched = jax.jit(schur.solve_windows_batched)(*systems)
    with jax.default_device(cpu):
        batched_cpu = jax.jit(schur.solve_windows_batched)(
            *jax.device_put(systems, cpu)
        )
    single = jax.jit(_single_solve)
    singles = [single(*(x[k] for x in systems)) for k in range(len(systems[0]))]
    ref64, cond = _f64_pose_solves(systems, cpu)
    e64 = _check("ba batched vs f64", _rel(batched[0], ref64), BA_SOLVE_RTOL)
    eb = _check("ba batched vs single", max(
        _rel(batched[i], np.stack([s[i] for s in singles])) for i in (0, 1)
    ), BA_SOLVE_RTOL)
    eg = _check("ba batched gpu vs cpu", max(
        _rel(g, c) for g, c in zip(batched, batched_cpu)
    ), BA_SOLVE_RTOL)
    _line(
        "ba", t0, M=16, N=1024, K=len(systems[0]), cost=f"{cost0:.1f}->{cost1:.1f}",
        pose_vs_cpu=ep, point_vs_cpu=el, cond=cond, batched_vs_f64=e64,
        batched_vs_single=eb, batched_vs_cpu=eg,
    )


# ---------------------------------------------------------------------------
# Phase 4: kernels
# ---------------------------------------------------------------------------

# (search, channels, height, width) of the refined flow levels of the
# 128x416 presets: davo (/4, /8, /16) and davo-fast (8-channel
# projection; /4, /8).
COSTVOL_LEVELS = [
    (4, 32, 32, 104), (4, 64, 16, 52), (4, 96, 8, 26),
    (3, 8, 32, 104), (3, 8, 16, 52),
]


def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp

    from davo_tpu.kernels.costvol import (
        cost_volume,
        cost_volume_pallas,
        cost_volume_xla,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    worst = 0.0
    for s, C, H, W in COSTVOL_LEVELS:
        f1 = jnp.asarray(rng.normal(size=(64, H, W, C)), jnp.float32)
        f2 = jnp.asarray(rng.normal(size=(64, H, W, C)), jnp.float32)
        want = jax.jit(cost_volume_xla, static_argnums=2)(f1, f2, s)
        for fn in (cost_volume_pallas, cost_volume):
            got = jax.jit(fn, static_argnums=2)(f1, f2, s)
            err = float(jnp.max(jnp.abs(got - want)))
            worst = max(worst, _check(f"costvol s{s} C{C} W{W}", err, COSTVOL_ATOL))
    _line("kernel cost_volume", t0, levels=len(COSTVOL_LEVELS), batch=64,
          max_abs_err=worst)


# ---------------------------------------------------------------------------
# --multi: the paths that span four cards
# ---------------------------------------------------------------------------

def _shardings(tree) -> str:
    import jax

    seen = {str(x.sharding) for x in jax.tree.leaves(tree) if hasattr(x, "sharding")}
    devs = {d.id for x in jax.tree.leaves(tree) if hasattr(x, "sharding")
            for d in x.sharding.device_set}
    return f"devices={sorted(devs)} shardings={sorted(seen)[:2]}"


def _kernel_split(name: str, hlo: str, pairs: int, n: int) -> str:
    """Each cost-volume kernel call in a compiled multi-card program
    must run on one device's share of the pairs, not on all of them."""
    batches = [
        int(m.group(1)) for line in hlo.splitlines()
        if "__gpu$xla.gpu.triton" in line
        for m in [re.search(r"=\s*\(?f32\[(\d+)", line)] if m
    ]
    if not batches or any(b != pairs // n for b in batches):
        targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
        raise AssertionError(
            f"{name}: cost-volume kernel batches {batches}, want "
            f"{pairs // n} per device ({pairs} pairs on {n} devices); "
            f"custom calls in program: {targets}"
        )
    gathers = len(re.findall(r"\ball-gather(?:-start)?\(", hlo))
    return (f"{name}: {len(batches)} cost-volume kernel calls, each on "
            f"{pairs // n} of {pairs} pairs; all-gathers in program: {gathers}")


def multi_dp_train(world, devices) -> None:
    import jax

    from davo_tpu.data.snippets import SnippetDataset
    from davo_tpu.dist.mesh import make_mesh, shard_batch
    from davo_tpu.dist.train import make_sharded_train_step, shard_state
    from davo_tpu.models import presets
    from davo_tpu.train.loop import create_state, make_train_step

    t0 = time.perf_counter()
    cfg = presets.get("davo")
    ds = SnippetDataset(world, batch_size=16, with_seg=True, with_gt=True, seed=0)
    batch = next(ds.batches(steps=1, shuffle=False))
    model, state, tx = create_state(cfg, jax.random.key(3), batch)
    host_state = jax.device_get(state)
    one = make_train_step(model, tx, cfg)
    s1, m1 = one(jax.device_put(host_state, devices[0]), batch)
    mesh = make_mesh(devices=devices)
    sbatch = shard_batch(batch, mesh)
    dp = make_sharded_train_step(model, tx, cfg, mesh)
    sstate = shard_state(host_state, mesh)
    exe = dp.lower(sstate, sbatch).compile()
    split = _kernel_split("dp step", exe.as_text(),
                          int(np.prod(batch["sources"].shape[:2])), len(devices))
    s4, m4 = exe(sstate, sbatch)
    l1, l4 = float(m1["total"]), float(m4["total"])
    el = _check("dp loss rel err", abs(l4 - l1) / abs(l1), LOSS_BF16_RTOL / 10)
    p1 = jax.tree.leaves(jax.device_get(s1.params))
    p4 = jax.tree.leaves(jax.device_get(s4.params))
    lr = cfg.train.learning_rate
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(p1, p4)])
    # One Adam step moves each weight by at most ~lr, so a weight whose
    # gradient sign differs between the two reductions moves ~2 lr
    # apart; near-zero gradients may flip, so bound their share.
    flipped = float(np.mean(diffs > lr))
    _check("dp params max diff", float(diffs.max()), 2.5 * lr)
    _check("dp params share > lr apart", flipped, 1e-2)
    print(f"  dp batch {_shardings(sbatch)}", flush=True)
    print(f"  dp state {_shardings(s4.params)}", flush=True)
    print(f"  {split}", flush=True)
    _line("multi dp_train davo", t0, global_batch=16, loss_1card=l1,
          loss_4card=l4, loss_rel_err=el, param_max_diff=float(diffs.max()),
          share_flipped=flipped)


def multi_sharded_ba(devices, cpu) -> None:
    import jax
    from jax.sharding import Mesh

    from davo_tpu.ba.gn import ba_refine, synthetic_problem
    from davo_tpu.ba.sharded import make_sharded_ba_refine, shard_problem
    from davo_tpu.config import BAConfig

    t0 = time.perf_counter()
    cfg = BAConfig()
    prob = synthetic_problem(0, M=16, N=1024)
    want = ba_refine(prob, cfg)
    mesh = Mesh(np.asarray(devices), ("window",))
    sharded = shard_problem(prob, mesh)
    got = make_sharded_ba_refine(cfg, mesh)(sharded)
    ep = _check("sharded ba pose err", float(np.max(np.abs(
        np.asarray(got.poses_cw) - np.asarray(want.poses_cw)))), BA_POSE_ATOL)
    el = _check("sharded ba point err", float(np.max(np.abs(
        np.asarray(got.points_w)[:1024] - np.asarray(want.points_w)))),
        BA_POINT_ATOL)
    print(f"  ba points {_shardings(got.points_w)}", flush=True)
    _line("multi sharded_ba", t0, M=16, N=1024, pose_err=ep, point_err=el)


def multi_streaming(world, devices) -> None:
    import jax

    from davo_tpu.dist.mesh import make_mesh
    from davo_tpu.dist.streaming import make_streaming_eval
    from davo_tpu.eval.runner import (
        assemble_trajectory,
        make_pose_apply_fn,
        predict_sequence,
    )
    from davo_tpu.models import presets
    from davo_tpu.models.davo import DavoModel

    t0 = time.perf_counter()
    # float32: the check is of the sharding, not of bf16 rounding,
    # which differs with the per-device batch.
    cfg = dataclasses.replace(
        presets.get("davo-fast").model, compute_dtype="float32"
    )
    frames = np.stack([world.frame(i) for i in range(33)])  # 32 pairs
    seg = np.stack([world.seg(i) for i in range(33)])
    model = DavoModel(cfg)
    params = jax.jit(model.init, static_argnames=("train",))(
        jax.random.key(4), frames[:1], frames[:1, None], seg=seg[:1],
        train=False,
    )
    mesh = make_mesh(devices=devices)
    stream = make_streaming_eval(model, params, mesh, cfg.attention)
    split = _kernel_split("streaming", stream.lower(frames, seg).compile().as_text(),
                          len(frames) - 1, len(devices))
    poses, vecs = stream(frames, seg)
    fn = make_pose_apply_fn(model, jax.device_put(params, devices[0]), cfg.attention)
    rels = predict_sequence(fn, frames, seg=seg, batch_size=32)
    want = assemble_trajectory(rels)
    err = _check("streaming traj rel err", _rel(_motion(poses), _motion(want)),
                 POSE_F32_RTOL)
    print(f"  streaming pairs PartitionSpec('data') over devices "
          f"{[d.id for d in mesh.devices.ravel()]} mesh={dict(mesh.shape)}",
          flush=True)
    print(f"  {split}", flush=True)
    _line("multi streaming davo-fast", t0, pairs=32, traj_rel_err=err)


def multi_dryrun(n: int) -> None:
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n)
    _line("multi dryrun pipeline+ep", t0, devices=n)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card paths only")
    args = ap.parse_args(argv)

    import jax

    t0 = time.perf_counter()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    need = 4 if args.multi else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    devices = devices[:need]

    from davo_tpu.utils.compile_cache import setup_compile_cache

    cache = setup_compile_cache()
    cpu = jax.devices("cpu")[0]
    print(_gpu_name_and_power_limit(), flush=True)
    print(f"jax {jax.__version__} device_kind={devices[0].device_kind} "
          f"count={len(devices)} compile_cache={cache}", flush=True)
    _line("device", t0)

    world = _world(SERVE_FRAMES)
    if args.multi:
        multi_dp_train(world, devices)
        multi_sharded_ba(devices, cpu)
        multi_streaming(world, devices)
        multi_dryrun(len(devices))
    else:
        phase_serving("davo", world, cpu)
        phase_serving("davo-fast", world, cpu)
        phase_training(world, devices[0], cpu)
        phase_ba(cpu)
        phase_kernels()
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
