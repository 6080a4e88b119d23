"""Train state, jitted train step, fit loop, checkpointing.

Replaces the reference's `tf.train.Supervisor` session loop + `Saver`
(`<ref>/train.py`, SURVEY.md §3.1 / §5). One jitted step function —
traced once, compiled once — consumes fixed-shape device batches; the
sharded variant lives in `dist/` (same step fn under a mesh).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from functools import partial
from typing import Any, Callable, Iterable

import jax
import jax.numpy as jnp
import optax

from davo_tpu.config import Config
from davo_tpu.models.davo import DavoModel
from davo_tpu.train.checkpoint import CheckpointManager
from davo_tpu.train.losses import total_loss


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: jnp.ndarray


def _make_tx(cfg: Config) -> optax.GradientTransformation:
    if cfg.train.lr_schedule == "cosine":
        lr = optax.cosine_decay_schedule(
            cfg.train.learning_rate, cfg.train.max_steps, alpha=0.01
        )
    else:
        lr = cfg.train.learning_rate
    tx = optax.adam(lr, b1=cfg.train.beta1)
    if cfg.train.grad_clip_norm > 0.0:
        tx = optax.chain(
            optax.clip_by_global_norm(cfg.train.grad_clip_norm), tx
        )
    return tx


def create_state(
    cfg: Config, rng: jax.Array, sample_batch: dict
) -> tuple[DavoModel, TrainState, optax.GradientTransformation]:
    model = DavoModel(cfg.model)
    params = model.init(
        rng,
        jnp.asarray(sample_batch["target"]),
        jnp.asarray(sample_batch["sources"]),
        seg=(
            jnp.asarray(sample_batch["seg"])
            if cfg.model.attention == "flow_seg" and "seg" in sample_batch
            else None
        ),
        K=(
            jnp.asarray(sample_batch["K"])
            if cfg.model.pose_head == "geo_hybrid" and "K" in sample_batch
            else None
        ),
    )
    tx = _make_tx(cfg)
    state = TrainState(
        params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32)
    )
    return model, state, tx


def _apply_warp_config(cfg: Config) -> None:
    """Resolve cfg.train.warp_gather into the process-wide default.

    An explicit config value beats the DAVO_WARP_GATHER env, which
    beats "auto" = "banded" (config.py warp_gather)."""
    from davo_tpu.core import warp as warp_mod

    g = cfg.train.warp_gather
    if g == "auto":
        if "DAVO_WARP_GATHER" in os.environ:
            return  # env already seeded the module default at import
        g = "banded"
    warp_mod.configure(g, tuple(cfg.train.warp_band))


@contextlib.contextmanager
def warp_policy(cfg: Config):
    """Apply cfg's warp policy while a train step is traced, then
    restore the process default, so the training policy does not leak
    into other warps of the process."""
    from davo_tpu.core import warp as warp_mod

    saved = (warp_mod._DEFAULT_GATHER, warp_mod._BAND)
    _apply_warp_config(cfg)
    try:
        yield
    finally:
        warp_mod.configure(*saved)


def make_train_step(
    model: DavoModel, tx: optax.GradientTransformation, cfg: Config
) -> Callable:
    """Returns jitted (state, batch) -> (state, metrics)."""

    def forward(params, target, sources, seg, K):
        return model.apply(
            params, target, sources, seg=seg, train=True,
            source_disp=cfg.train.geo_consistency_weight > 0.0,
            K=K,
        )

    if cfg.train.remat:
        # Memory/FLOP trade: drop the forward activations and
        # recompute them in the backward pass, so batch can grow at
        # fixed device memory.
        # Grads are bit-comparable to the unremat'd step (tested).
        forward = jax.checkpoint(forward)

    def loss_fn(params, batch, step_i):
        with warp_policy(cfg):
            return _loss(params, batch, step_i)

    def _loss(params, batch, step_i):
        outputs = forward(
            params,
            batch["target"],
            batch["sources"],
            batch.get("seg") if cfg.model.attention == "flow_seg" else None,
            # geo_hybrid reads the camera; conv head ignores it. The
            # batch K is (B, 3, 3) (data/snippets.py).
            batch.get("K") if cfg.model.pose_head == "geo_hybrid" else None,
        )
        return total_loss(outputs, batch, cfg.model, cfg.train, step=step_i)

    @partial(jax.jit, donate_argnums=0)
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

    return step


# ---------------------------------------------------------------------------
# Checkpointing: params + opt state + step (train/checkpoint.py).
# ---------------------------------------------------------------------------

def make_checkpoint_manager(
    directory: str, max_to_keep: int = 3
) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep=max_to_keep)


def save_config(directory: str, cfg: Config) -> None:
    """Serialize the full config next to the checkpoints (SURVEY.md §5:
    reproducibility — every run's exact config rides with its state)."""
    import dataclasses
    import json

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_config(directory: str) -> dict | None:
    import json

    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_checkpoint(mngr: CheckpointManager, state: TrainState) -> None:
    mngr.save(int(state.step), state)


def restore_checkpoint(
    mngr: CheckpointManager, template: TrainState
) -> TrainState | None:
    step = mngr.latest_step()
    if step is None:
        return None
    return mngr.restore(step, template)


# ---------------------------------------------------------------------------
# Fit loop
# ---------------------------------------------------------------------------

def fit(
    cfg: Config,
    batches: Iterable[dict],
    checkpoint_dir: str | None = None,
    log_fn: Callable[[int, dict], None] | None = None,
    state: TrainState | None = None,
    model: DavoModel | None = None,
    metrics_logger=None,
) -> tuple[DavoModel, TrainState, list[dict]]:
    """Train for cfg.train.max_steps over `batches`. Returns history.

    `metrics_logger` (utils.metrics.MetricsLogger): when given and
    cfg.train.image_every > 0, warped-target/disparity panels are
    rendered every image_every steps (train/summaries.py)."""
    it = iter(batches)
    first = next(it)
    if model is None or state is None:
        model, state, tx = create_state(
            cfg, jax.random.key(cfg.train.seed), first
        )
    else:
        tx = _make_tx(cfg)
    step_fn = make_train_step(model, tx, cfg)
    summary_fn = None
    if metrics_logger is not None and cfg.train.image_every > 0:
        from davo_tpu.train.summaries import make_summary_fn

        summary_fn = make_summary_fn(model, cfg)

    mngr = make_checkpoint_manager(checkpoint_dir) if checkpoint_dir else None
    if mngr is not None:
        save_config(checkpoint_dir, cfg)
        restored = restore_checkpoint(mngr, state)
        if restored is not None:
            state = restored

    history: list[dict] = []
    t0 = time.time()
    batch = first
    for i in range(cfg.train.max_steps):
        state, metrics = step_fn(state, batch)
        if (i + 1) % cfg.train.log_every == 0 or i == cfg.train.max_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_s"] = (i + 1) / (time.time() - t0)
            history.append(m)
            if log_fn:
                log_fn(i + 1, m)
            if metrics_logger is not None:
                metrics_logger.log(i + 1, m)
        if summary_fn is not None and (i + 1) % cfg.train.image_every == 0:
            metrics_logger.log_images(i + 1, summary_fn(state.params, batch))
        if mngr is not None and (i + 1) % cfg.train.checkpoint_every == 0:
            save_checkpoint(mngr, state)
        try:
            batch = next(it)
        except StopIteration:
            break
    if mngr is not None:
        save_checkpoint(mngr, state)
    return model, state, history
