"""Pipeline parallelism (SURVEY.md §2.2 P3): stage the VO pipeline
(flow-net -> attention+pose) across device groups — forward AND
training (grads through the schedule, `make_pipeline_train_fns`).

The reference is single-GPU and has no analog; this is a target-only
capability tier. Design: a GPipe-style schedule written as
`shard_map` over a 'stage' mesh axis — every device runs the same
traced program, selects its stage's computation with `lax.switch`, and
hands activations to the next stage with a ring `lax.ppermute` each
tick. Microbatch = a chunk of frame pairs; with M microbatches and S
stages the schedule runs M + S - 1 ticks (bubble fraction
(S-1)/(M+S-1), amortized away by more microbatches).

Heterogeneous stages are homogenized through a fixed activation buffer
(mb, H, W, 10) so the switch branches agree on shapes:

    ch 0-2  target image        (input)
    ch 3-5  source image        (input)
    ch 6    temporal-direction  (input; models/davo.py convention)
    ch 7-8  full-res flow       (written by the flow stage)
    ch 9    seg labels as float (input; consumed by the pose stage)

Stage 0 (flow): FlowNetLite on (target, source) -> full-res flow into
ch 7-8. Stage 1 (pose): RegionAttention on the flow + seg one-hot ->
region weight map; PoseNet on (target, source, [dir, flow]) -> 6-DoF.
Semantics match `DavoModel.__call__` exactly (equality-tested vs the
single-device forward on the CI mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from davo_tpu.config import ModelConfig
from davo_tpu.models.attention import region_weight_map, seg_to_onehot
from davo_tpu.models.flownet import FlowNetLite
from davo_tpu.models.posenet import PoseNet

NUM_STAGES = 2
BUF_CHANNELS = 10


def pack_microbatches(
    targets, sources, seg=None, direction: float = -1.0, n_microbatches: int = 4
):
    """Host-side: (N, H, W, 3) x2 [+ (N, H, W) seg] -> (M, mb, H, W, 10).

    N must divide into n_microbatches equal chunks (pad upstream).
    """
    N, H, W, _ = targets.shape
    assert N % n_microbatches == 0, (N, n_microbatches)
    dir_plane = jnp.full((N, H, W, 1), direction, targets.dtype)
    flow0 = jnp.zeros((N, H, W, 2), targets.dtype)
    seg_plane = (
        seg[..., None].astype(targets.dtype)
        if seg is not None
        else jnp.zeros((N, H, W, 1), targets.dtype)
    )
    buf = jnp.concatenate(
        [targets, sources, dir_plane, flow0, seg_plane], axis=-1
    )
    return buf.reshape(n_microbatches, N // n_microbatches, H, W, BUF_CHANNELS)


def make_pipeline_pose_fn(
    params, cfg: ModelConfig, mesh: Mesh, axis: str = "stage"
):
    """Build a jitted (microbatches) -> (M, mb, 6) pipelined pose
    forward over the mesh's `axis` (size must be NUM_STAGES).

    `params` is the DavoModel param tree ({'params': {'flownet': ...,
    'posenet': ..., 'attn': ...}}); each stage uses only its subtree
    (passed replicated — the nets are small; sharding param storage per
    stage is a memory optimization, not a semantics change).
    """
    assert mesh.shape[axis] == NUM_STAGES, mesh.shape
    pipelined = _make_pipelined(cfg, mesh, axis)
    return jax.jit(partial(pipelined, params))


def _make_pipelined(cfg: ModelConfig, mesh: Mesh, axis: str = "stage"):
    """Staged (params, microbatches) -> (M, mb, 6) — params a traced
    argument so the schedule is differentiable (see
    `make_pipeline_train_fns`)."""
    fnet = FlowNetLite(cfg)
    pnet = PoseNet(cfg)
    use_attn = cfg.attention == "flow_seg"
    if use_attn:
        from davo_tpu.models.attention import RegionAttention

        anet = RegionAttention(cfg)

    def flow_stage(p, buf):
        tgt, src = buf[..., 0:3], buf[..., 3:6]
        pyr = fnet.apply({"params": p["flownet"]}, tgt, src)
        H, W = tgt.shape[1], tgt.shape[2]
        flow_full = FlowNetLite.full_res_flow(pyr[0], H, W)
        buf = jnp.concatenate(
            [buf[..., :7], flow_full.astype(buf.dtype), buf[..., 9:]],
            axis=-1,
        )
        return buf, jnp.zeros((buf.shape[0], 6), jnp.float32)

    def pose_stage(p, buf):
        tgt, src = buf[..., 0:3], buf[..., 3:6]
        extra = buf[..., 6:9]  # dir + flow, the DavoModel layout
        region_fn = None
        if use_attn:
            weights = anet.apply({"params": p["attn"]}, buf[..., 7:9])
            seg_oh = seg_to_onehot(
                buf[..., 9].astype(jnp.int32), cfg.num_seg_classes
            )
            region_fn = lambda hw: region_weight_map(weights, seg_oh, hw)
        pose = pnet.apply(
            {"params": p["posenet"]}, tgt, src,
            extra=extra, region_weight_fn=region_fn,
        )
        return buf, pose

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def pipelined(params, microbatches):  # both replicated
        p = params["params"]
        M = microbatches.shape[0]
        stage = lax.axis_index(axis)
        perm = [(i, (i + 1) % NUM_STAGES) for i in range(NUM_STAGES)]

        def tick(buf, t):
            # Stage 0 picks up microbatch t (clamped; ticks >= M reuse
            # the last one — its output never reaches the pose stage
            # within the schedule, so it is dead).
            fresh = lax.dynamic_index_in_dim(
                microbatches, jnp.clip(t, 0, M - 1), 0, keepdims=False
            )
            buf = jnp.where(stage == 0, fresh, buf)
            buf, pose = lax.switch(
                jnp.minimum(stage, NUM_STAGES - 1),
                [flow_stage, pose_stage],
                p,
                buf,
            )
            # Hand off to the next stage around the ring.
            buf = lax.ppermute(buf, axis, perm)
            # Only the last stage's pose is real; psum broadcasts it.
            pose = pose * (stage == NUM_STAGES - 1)
            return buf, lax.psum(pose, axis)

        mb = microbatches.shape[1]
        H, W = microbatches.shape[2], microbatches.shape[3]
        buf0 = jnp.zeros((mb, H, W, BUF_CHANNELS), microbatches.dtype)
        _, poses = lax.scan(tick, buf0, jnp.arange(M + NUM_STAGES - 1))
        # Tick t >= S-1 emits microbatch t-(S-1)'s poses.
        return poses[NUM_STAGES - 1 :]

    return pipelined


NUM_STAGES_FULL = 3


def make_pipeline3_train_fns(
    cfg: ModelConfig,
    mesh: Mesh,
    axis: str = "stage",
    ssim_weight: float = 0.85,
    pose_weight: float = 0.0,
    photo_masking: str = "border",
):
    """FULL-graph pipeline training (SURVEY.md §2.2 P3: "flow-net ->
    attention+pose -> depth/loss"): three stages across three device
    groups, photometric loss computed ON the pipeline.

    Stage 0 (flow): FlowNetLite -> full-res flow channels.
    Stage 1 (pose): RegionAttention + PoseNet -> 6-DoF, carried as a
    separate (mb, 6) leaf of the ring state (images stay in `buf`).
    Stage 2 (depth/loss): DispNet on the target + multi-scale
    photometric view-synthesis loss (train/losses.photometric_loss)
    against the carried pose and per-microbatch intrinsics; optional
    supervised pose term rides along (pose_weight > 0).

    Per-microbatch side inputs (K, gt_vec) are injected at stage 0 and
    travel the ring WITH the activations, so stage 2 never needs to
    index the global arrays with a lagged tick counter.

    Returns jitted:
        loss_fn(params, microbatches, Ks, gt_vec) -> scalar
        grad_fn(params, microbatches, Ks, gt_vec) -> (loss, grads)
    with microbatches (M, mb, H, W, 10), Ks (M, mb, 3, 3),
    gt_vec (M, mb, 6). Differentiating the scan/ppermute schedule is
    the GPipe backward (see `make_pipeline_train_fns`).
    """
    assert mesh.shape[axis] == NUM_STAGES_FULL, mesh.shape
    from davo_tpu.models.dispnet import DispNet
    from davo_tpu.train.losses import photometric_loss, pose_vec_l2

    fnet = FlowNetLite(cfg)
    pnet = PoseNet(cfg)
    dnet = DispNet(cfg)
    use_attn = cfg.attention == "flow_seg"
    if use_attn:
        from davo_tpu.models.attention import RegionAttention

        anet = RegionAttention(cfg)

    def flow_stage(p, buf, pose, K, gt):
        tgt, src = buf[..., 0:3], buf[..., 3:6]
        pyr = fnet.apply({"params": p["flownet"]}, tgt, src)
        H, W = tgt.shape[1], tgt.shape[2]
        flow_full = FlowNetLite.full_res_flow(pyr[0], H, W)
        buf = jnp.concatenate(
            [buf[..., :7], flow_full.astype(buf.dtype), buf[..., 9:]],
            axis=-1,
        )
        return buf, pose, jnp.zeros((), jnp.float32)

    def pose_stage(p, buf, pose, K, gt):
        tgt, src = buf[..., 0:3], buf[..., 3:6]
        extra = buf[..., 6:9]
        region_fn = None
        if use_attn:
            weights = anet.apply({"params": p["attn"]}, buf[..., 7:9])
            seg_oh = seg_to_onehot(
                buf[..., 9].astype(jnp.int32), cfg.num_seg_classes
            )
            region_fn = lambda hw: region_weight_map(weights, seg_oh, hw)
        pose = pnet.apply(
            {"params": p["posenet"]}, tgt, src,
            extra=extra, region_weight_fn=region_fn,
        )
        return buf, pose, jnp.zeros((), jnp.float32)

    def depth_stage(p, buf, pose, K, gt):
        tgt, src = buf[..., 0:3], buf[..., 3:6]
        disps = dnet.apply({"params": p["dispnet"]}, tgt)
        loss = photometric_loss(
            disps, pose[:, None], tgt, src[:, None], K,
            ssim_weight=ssim_weight, masking=photo_masking,
        )
        if pose_weight:
            loss = loss + pose_weight * pose_vec_l2(pose, gt)
        return buf, pose, loss

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def pipelined_loss(params, microbatches, Ks, gt_vec):
        p = params["params"]
        M = microbatches.shape[0]
        mb = microbatches.shape[1]
        H, W = microbatches.shape[2], microbatches.shape[3]
        stage = lax.axis_index(axis)
        perm = [
            (i, (i + 1) % NUM_STAGES_FULL) for i in range(NUM_STAGES_FULL)
        ]

        def tick(carry, t):
            buf, pose, K, gt = carry
            idx = jnp.clip(t, 0, M - 1)
            fresh_buf = lax.dynamic_index_in_dim(
                microbatches, idx, 0, keepdims=False
            )
            fresh_K = lax.dynamic_index_in_dim(Ks, idx, 0, keepdims=False)
            fresh_gt = lax.dynamic_index_in_dim(
                gt_vec, idx, 0, keepdims=False
            )
            is0 = stage == 0
            buf = jnp.where(is0, fresh_buf, buf)
            K = jnp.where(is0, fresh_K, K)
            gt = jnp.where(is0, fresh_gt, gt)
            buf, pose, loss = lax.switch(
                jnp.minimum(stage, NUM_STAGES_FULL - 1),
                [flow_stage, pose_stage, depth_stage],
                p, buf, pose, K, gt,
            )
            # Only the last stage's loss is real; zero elsewhere so the
            # psum is exactly its value.
            loss = lax.psum(loss * (stage == NUM_STAGES_FULL - 1), axis)
            buf, pose, K, gt = lax.ppermute(
                (buf, pose, K, gt), axis, perm
            )
            return (buf, pose, K, gt), loss

        carry0 = (
            jnp.zeros((mb, H, W, BUF_CHANNELS), microbatches.dtype),
            jnp.zeros((mb, 6), jnp.float32),
            # Identity K, NOT zeros: bubble-tick losses are sliced off
            # the output, but a fx=0 division-by-zero in the warp makes
            # them NaN and 0 * NaN = NaN poisons the backward.
            jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (mb, 3, 3)),
            jnp.zeros((mb, 6), jnp.float32),
        )
        _, losses = lax.scan(
            tick, carry0, jnp.arange(M + NUM_STAGES_FULL - 1)
        )
        # Tick t >= S-1 emits microbatch t-(S-1)'s loss.
        return jnp.mean(losses[NUM_STAGES_FULL - 1 :])

    return jax.jit(pipelined_loss), jax.jit(
        jax.value_and_grad(pipelined_loss)
    )


def make_pipeline_train_fns(cfg: ModelConfig, mesh: Mesh, axis: str = "stage"):
    """Pipeline-parallel TRAINING: loss + grads through the staged
    schedule.

    Differentiating the scan/ppermute program IS the GPipe backward:
    jax linearizes each tick (stashing the microbatch activations the
    way GPipe stashes per-microbatch forward state), runs the reverse
    scan (the backward pipeline), and transposes each `ppermute` into
    the reverse-ring hop — so cotangents flow pose-stage -> flow-stage
    across devices, and each stage only ever evaluates its own
    sub-network's VJP. Returns jitted:

        loss_fn(params, microbatches, gt_vec) -> scalar
        grad_fn(params, microbatches, gt_vec) -> (loss, grads)

    gt_vec: (M, mb, 6) GT pose vectors (supervised regime — the
    depth/photometric stages live outside this 2-stage pipeline).
    """
    assert mesh.shape[axis] == NUM_STAGES, mesh.shape
    pipelined = _make_pipelined(cfg, mesh, axis)

    def loss(params, microbatches, gt_vec):
        from davo_tpu.train.losses import pose_vec_l2

        poses = pipelined(params, microbatches)
        return pose_vec_l2(poses, gt_vec)

    return jax.jit(loss), jax.jit(jax.value_and_grad(loss))
