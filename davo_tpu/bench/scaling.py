"""Scaling-efficiency harness: same per-device work, growing mesh.

BASELINE target: >= 80 % scaling efficiency at N >= 2 hosts. On
virtual CPU devices this is a functional check of the numbers
pipeline; on a multi-device machine it measures the real thing with
no code change (weak scaling: global batch = per_device_batch * n_devices).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from davo_tpu.config import Config
from davo_tpu.dist.mesh import make_mesh, shard_batch
from davo_tpu.dist.train import make_sharded_train_step, shard_state
from davo_tpu.utils.profiling import timed


def scaling_efficiency(
    cfg: Config,
    device_counts: list[int],
    per_device_batch: int = 2,
    iters: int = 5,
) -> dict:
    """Weak-scaling frames/s per device count; efficiency vs smallest."""
    from davo_tpu.data.snippets import SnippetDataset
    from davo_tpu.data.synthetic import SyntheticSequence

    results = {}
    for n in device_counts:
        devices = jax.devices()[:n]
        batch = per_device_batch * n
        seq = SyntheticSequence(
            n_frames=batch + 4,
            height=cfg.model.img_height,
            width=cfg.model.img_width,
        )
        ds = SnippetDataset(
            seq, batch_size=batch,
            with_seg=cfg.model.attention == "flow_seg", with_gt=True,
        )
        b = {k: jnp.asarray(v) for k, v in next(ds.batches(steps=1)).items()}
        mesh = make_mesh(devices=devices)
        from davo_tpu.train.loop import create_state

        model, state, tx = create_state(cfg, jax.random.key(0), b)
        state = shard_state(state, mesh)
        sb = shard_batch(b, mesh)
        step = make_sharded_train_step(model, tx, cfg, mesh)

        import time

        state, _ = step(state, sb)
        jax.block_until_ready(state.params)
        times = []
        for _ in range(5):  # repo protocol: min over >= 5 loops
            t0 = time.perf_counter()
            for _ in range(iters):
                state, _ = step(state, sb)
            jax.block_until_ready(state.params)
            times.append((time.perf_counter() - t0) / iters)
        ms = min(times) * 1000.0
        results[n] = {"ms_per_step": ms, "frames_per_s": batch / ms * 1000.0}

    base_n = min(device_counts)
    base = results[base_n]["frames_per_s"] / base_n
    for n in device_counts:
        results[n]["efficiency"] = (
            results[n]["frames_per_s"] / n
        ) / base
    return results
