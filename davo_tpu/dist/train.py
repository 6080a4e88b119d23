"""Sharded training step: jit + GSPMD over the device mesh.

DP (SURVEY.md §2.2 P1): batch dim sharded over 'data', params
replicated; XLA inserts the gradient psum. TP rules for the conv
channel dims slot in via `sharding_rules` when the model axis > 1
(nets are small — TP is a capability tier, not a perf requirement;
SURVEY.md P2).
"""

from __future__ import annotations

from functools import partial

import jax
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from davo_tpu.config import Config
from davo_tpu.dist.mesh import batch_sharding, replicated
from davo_tpu.train.loop import TrainState
from davo_tpu.train.losses import total_loss


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Replicate params/opt state across the mesh (DP layout)."""
    rep = replicated(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, rep), state
    )


def make_sharded_train_step(model, tx, cfg: Config, mesh: Mesh):
    """jit-compiled (state, batch) -> (state, metrics) under the mesh.

    batch leaves are dim-0-sharded over 'data'; state is replicated.
    XLA/GSPMD partitions the forward/backward and inserts the psum for
    gradients — the all-reduce data-parallel wrapper the reference
    never had.
    """
    from davo_tpu.train.loop import warp_policy

    def forward(params, target, sources, seg):
        # source_disp must mirror train/loop.py: without it the geo-
        # consistency term silently drops from the sharded loss (no
        # "disp_src" in outputs) and sharded != single-device.
        return model.apply(
            params, target, sources, seg=seg, train=True,
            source_disp=cfg.train.geo_consistency_weight > 0.0,
        )

    if cfg.train.remat:
        # Same memory/FLOP trade as the single-device step (train/loop.py):
        # activations recomputed in the backward pass.
        forward = jax.checkpoint(forward)

    def loss_fn(params, batch, step_i):
        with warp_policy(cfg):  # same gather policy as the local step
            return _loss(params, batch, step_i)

    def _loss(params, batch, step_i):
        outputs = forward(
            params,
            batch["target"],
            batch["sources"],
            batch.get("seg") if cfg.model.attention == "flow_seg" else None,
        )
        return total_loss(outputs, batch, cfg.model, cfg.train, step=step_i)

    rep = replicated(mesh)

    def batch_specs(batch):
        return {
            k: batch_sharding(mesh, v.ndim) for k, v in batch.items()
        }

    def step(state: TrainState, batch: dict):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, state.step
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return (
            TrainState(params=params, opt_state=opt_state, step=state.step + 1),
            metrics,
        )

    # The jit wrapper is built ONCE (lazily — shardings need the batch
    # pytree structure) and reused: reconstructing jax.jit per call
    # discards its trace cache and retraces every step (r1 weak item;
    # invalidated bench/scaling timings).
    compiled = {}

    def jit_for(state, batch):
        key = tuple(sorted(batch))
        if key not in compiled:
            compiled[key] = jax.jit(
                step,
                in_shardings=(
                    jax.tree_util.tree_map(lambda _: rep, state),
                    batch_specs(batch),
                ),
                out_shardings=(
                    jax.tree_util.tree_map(lambda _: rep, state),
                    None,
                ),
                donate_argnums=0,
            )
        return compiled[key]

    def jitted(state, batch):
        return jit_for(state, batch)(state, batch)

    # AOT access to the same program: `.lower(state, batch).compile()`
    # gives the executable and its partitioned HLO.
    jitted.lower = lambda state, batch: jit_for(state, batch).lower(state, batch)
    return jitted


def make_sharded_pose_apply(model, params, mesh: Mesh, attention: str = "none"):
    """Streaming-eval closure: frame pairs sharded over 'data', nets
    replicated (BASELINE config #5 inference layout)."""

    rep = replicated(mesh)
    params = jax.device_put(params, rep)

    @partial(
        jax.jit,
        in_shardings=(
            NamedSharding(mesh, P("data")),
            NamedSharding(mesh, P("data")),
        ),
        out_shardings=NamedSharding(mesh, P("data")),
    )
    def fn(targets, sources):
        out = model.apply(params, targets, sources[:, None], train=False)
        return out["poses"][:, 0]

    return fn
