"""Streaming sequence inference: frames -> relative poses -> trajectory.

Reference parity: `<ref>/test_kitti_pose.py` (snippet loop + TUM dumps,
SURVEY.md §3.2) re-designed for batched streaming: consecutive frame pairs
are packed into fixed-size batches (one compile), the pose net runs
batched on device, and the global trajectory is assembled with the
O(log N) associative scan. The same batch axis is what `dist/` shards
across devices for BASELINE config #5 (replicated nets, sharded pairs).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from davo_tpu.core import geometry as geo
from davo_tpu.eval.metrics import (
    ate_rmse,
    kitti_seg_errors,
    snippet_ate,
    snippet_ate_ref,
)


def predict_sequence(
    apply_fn: Callable,
    frames: np.ndarray,
    seg: np.ndarray | None = None,
    batch_size: int = 32,
    scan_chunks: int = 1,
) -> np.ndarray:
    """Predict all consecutive relative poses of a sequence.

    apply_fn(target, source, seg) -> (B, 6) pose vectors mapping
    target-cam points to source-cam points (the model convention);
    callers typically pass a jitted closure over params.

    scan_chunks > 1 selects the dispatch-amortized path: apply_fn must
    then be a `make_pose_apply_scan_fn` closure taking (K, B, ...)
    stacks; batches are packed K per device call (tail padded by
    repetition, trimmed on return).

    frames: (N, H, W, 3) float32. Returns (N-1, 4, 4) odometry
    increments rel[k] = T_{cam_k <- cam_{k+1}}^(-1)-style transforms
    such that poses[k+1] = poses[k] @ rel[k].
    """
    if scan_chunks > 1:
        vecs = _predict_scan(
            apply_fn, frames, seg, batch_size, scan_chunks
        )
    else:
        rel_vecs = [
            np.asarray(apply_fn(jnp.asarray(tgt), jnp.asarray(src), sg))[
                : end - start
            ]
            for start, end, tgt, src, sg in iter_pair_batches(
                frames, seg, batch_size
            )
        ]
        vecs = np.concatenate(rel_vecs, 0)  # (N-1, 6)

    # vec maps target(k+1) -> source(k): that IS the increment matrix.
    rels = np.asarray(geo.pose_vec_to_mat(jnp.asarray(vecs)))
    return rels


def _predict_scan(
    apply_fn: Callable,
    frames: np.ndarray,
    seg: np.ndarray | None,
    batch_size: int,
    scan_chunks: int,
) -> np.ndarray:
    """Pack pair batches K-at-a-time into (K, B, ...) stacks for the
    scan apply fn; same padding contract as the per-call path."""
    n_pairs = len(frames) - 1
    batches = list(iter_pair_batches(frames, seg, batch_size))
    # The single [:n_pairs] trim at the end is only correct because
    # iter_pair_batches pads NOTHING but the final batch (ADVICE r4
    # #4) — pin that contract here so a padding change fails loudly
    # instead of silently corrupting trajectories.
    assert all(
        b[1] - b[0] == batch_size for b in batches[:-1]
    ), "padding contract: only the final pair batch may be ragged"
    out = []
    for i in range(0, len(batches), scan_chunks):
        group = batches[i : i + scan_chunks]
        while len(group) < scan_chunks:  # pad tail group: repeat last
            group.append(group[-1])
        tgt = jnp.asarray(np.stack([g[2] for g in group]))
        src = jnp.asarray(np.stack([g[3] for g in group]))
        sg = (
            jnp.asarray(np.stack([g[4] for g in group]))
            if group[0][4] is not None
            else None
        )
        out.append(np.asarray(apply_fn(tgt, src, sg)).reshape(-1, 6))
    return np.concatenate(out, 0)[:n_pairs]


def iter_pair_batches(
    frames: np.ndarray,
    seg: np.ndarray | None,
    batch_size: int,
    start0: int = 0,
):
    """Yield (start, end, target, source, seg) fixed-shape pair batches.

    The single batching/padding contract for streaming eval — shared by
    `predict_sequence` and `resumable_predict_sequence` so the padding
    and seg-indexing conventions (targets = frames[1:], seg aligned to
    the target frame, ragged tail padded by repetition) cannot drift
    between the plain and crash-resumable paths.
    """
    n_pairs = len(frames) - 1
    targets = frames[1:]
    sources = frames[:-1]
    segs = seg[1:] if seg is not None else None
    for start in range(start0, n_pairs, batch_size):
        end = min(start + batch_size, n_pairs)
        pad = batch_size - (end - start)
        tgt = targets[start:end]
        src = sources[start:end]
        sg = segs[start:end] if segs is not None else None
        if pad:  # fixed shapes: one compile for every batch
            tgt = np.concatenate([tgt, np.repeat(tgt[-1:], pad, 0)], 0)
            src = np.concatenate([src, np.repeat(src[-1:], pad, 0)], 0)
            if sg is not None:
                sg = np.concatenate([sg, np.repeat(sg[-1:], pad, 0)], 0)
        yield start, end, tgt, src, sg


def assemble_trajectory(rels: np.ndarray) -> np.ndarray:
    """(N-1, 4, 4) increments -> (N, 4, 4) absolute poses from identity."""
    return np.asarray(
        geo.trajectory_from_relatives(jnp.asarray(rels, jnp.float32))
    )


def evaluate_sequence(
    pred_poses: np.ndarray, gt_poses: np.ndarray, snippet_len: int = 5
) -> dict:
    """All reference metrics for one sequence."""
    n = min(len(pred_poses), len(gt_poses))
    pred, gt = pred_poses[:n], gt_poses[:n]
    mean_ate, std_ate = snippet_ate(gt, pred, snippet_len)
    # Reference-exact variant (sqrt(sum)/N, first-frame alignment) —
    # THE number comparable to published SfMLearner/DAVO ATE tables.
    ref_mean, ref_std = snippet_ate_ref(gt, pred, snippet_len)
    seg_err = kitti_seg_errors(gt, pred)
    return {
        "ate_full": ate_rmse(gt, pred),
        "snippet_ate_mean": mean_ate,
        "snippet_ate_std": std_ate,
        "snippet_ate_ref_mean": ref_mean,
        "snippet_ate_ref_std": ref_std,
        "t_err_pct": seg_err["t_err_pct"],
        "r_err_deg_per_100m": seg_err["r_err_deg_per_100m"],
        "n_frames": n,
    }


def make_pose_apply_fn(
    model, params, attention: str = "none", K=None,
) -> Callable:
    """Jitted (targets, sources, seg) -> (B, 6) pose closure.

    K: (3, 3) sequence intrinsics — required by pose_head="geo_hybrid"
    models (closed over as a constant; one camera per sequence).
    """
    # Pass K only when set: stubs / legacy model objects need not grow
    # the kwarg, and the conv head ignores it anyway.
    kw = {} if K is None else {"K": jnp.asarray(K, jnp.float32)}

    @jax.jit
    def fn(targets, sources, seg=None):
        out = model.apply(
            params,
            targets,
            sources[:, None],
            seg=seg if attention == "flow_seg" else None,
            train=False,
            **kw,
        )
        return out["poses"][:, 0]

    return fn


def make_pose_apply_scan_fn(
    model, params, attention: str = "none", K=None,
) -> Callable:
    """Dispatch-amortized pose inference: ONE device program runs K
    batches via `lax.scan`.

    Takes (K, B, H, W, 3) targets/sources (+ (K, B, H, W) seg) and
    returns (K, B, 6) poses. Each per-call host round-trip (dispatch +
    result sync) is paid once per K batches instead of once per batch
    (`predict_sequence` packs the chunks). Numerics are identical to
    the per-call path: the scan body IS the same forward on the same
    (B, ...) slice.
    """
    use_seg = attention == "flow_seg"
    kw = {} if K is None else {"K": jnp.asarray(K, jnp.float32)}

    @jax.jit
    def fn(targets, sources, seg=None):
        def body(_, xs):
            if use_seg:
                t, s, g = xs
            else:
                (t, s), g = xs, None
            out = model.apply(
                params, t, s[:, None], seg=g, train=False, **kw
            )
            return None, out["poses"][:, 0]

        xs = (targets, sources, seg) if use_seg else (targets, sources)
        _, poses = jax.lax.scan(body, None, xs)
        return poses  # (K, B, 6)

    return fn
