"""Context-parallel streaming evaluation of long sequences.

SURVEY.md §2.2 P4: a KITTI odometry sequence (up to 4,541 frames) is
processed as one sharded batch of consecutive frame pairs — contiguous
device-local chunks, nets replicated (BASELINE config #5 inference
layout). Every relative pose T_{t->t+1} is computed on exactly one
device; the global trajectory is the all-prefix composition of SE(3)
increments, evaluated as `lax.associative_scan` over 4x4 matmul INSIDE
the same jitted program — XLA/GSPMD turns the scan's cross-chunk hops
into log-depth collectives, so no host round-trip touches the
sequence axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from davo_tpu.core import geometry as geo


def make_streaming_eval(model, params, mesh: Mesh, attention: str = "none"):
    """Returns fn(frames, seg) -> (poses (N,4,4), rel_vecs (N-1,6)).

    frames: (N, H, W, 3) numpy; N-1 must be a multiple of the data-axis
    size (pad the tail frame if needed — `pad_pairs` helps).
    """
    rep = NamedSharding(mesh, P())
    shard0 = NamedSharding(mesh, P("data"))
    params = jax.device_put(params, rep)

    # NOTE: this deliberately re-states the model-invocation convention
    # of eval/runner.make_pose_apply_fn (sources[:, None], seg gated on
    # attention, poses[:, 0]) INSIDE one jitted program so the
    # associative scan fuses with the forward — do not split it into
    # the runner closure + a second jit. tests/test_streaming.py pins
    # bit-equality against the single-device runner path, so drift
    # between the two conventions fails CI.
    @jax.jit
    def run(targets, sources, seg):
        out = model.apply(
            params,
            targets,
            sources[:, None],
            seg=seg if attention == "flow_seg" else None,
            train=False,
        )
        vecs = out["poses"][:, 0]  # (P, 6) target(t+1)->source(t)
        rels = geo.pose_vec_to_mat(vecs)  # odometry increments
        # All-prefix composition across the sharded pair axis.
        prefix = jax.lax.associative_scan(jnp.matmul, rels, axis=0)
        return vecs, prefix

    def place(frames: np.ndarray, seg: np.ndarray | None):
        n_pairs = len(frames) - 1
        axis = mesh.shape["data"]
        assert n_pairs % axis == 0, (
            f"n_pairs={n_pairs} must divide data axis {axis}; pad first"
        )
        targets = jax.device_put(frames[1:], shard0)
        sources = jax.device_put(frames[:-1], shard0)
        seg_dev = (
            jax.device_put(seg[1:], shard0) if seg is not None else None
        )
        return targets, sources, seg_dev

    def fn(frames: np.ndarray, seg: np.ndarray | None = None):
        vecs, prefix = run(*place(frames, seg))
        prefix = np.asarray(prefix)
        poses = np.concatenate([np.eye(4)[None], prefix], axis=0)
        return poses, np.asarray(vecs)

    # AOT access to the sharded program (its partitioned HLO).
    fn.lower = lambda frames, seg=None: run.lower(*place(frames, seg))
    return fn


def pad_pairs(frames: np.ndarray, axis_size: int) -> tuple[np.ndarray, int]:
    """Repeat the last frame so (N-1) divides the data axis.

    Returns (padded frames, original n_pairs) — padded increments are
    near-identity self-pairs; slice trajectories to n_pairs+1.
    """
    n_pairs = len(frames) - 1
    pad = (-n_pairs) % axis_size
    if pad:
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], pad, axis=0)], axis=0
        )
    return frames, n_pairs
