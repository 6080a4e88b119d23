"""Device mesh construction and basic shardings.

Axes (SURVEY.md §5 "Distributed communication backend"):
  data   — batch / frame-pair parallelism (DP, streaming eval)
  model  — tensor parallelism over channel dims (TP)
  window — BA keyframe-block partitioning (sliding-window backend)

Collectives stay within a host's interconnect; on multi-host clusters
the first (outermost) axis maps across hosts (JAX device ordering).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("data", "model", "window")


def make_mesh(
    data: int | None = None,
    model: int = 1,
    window: int = 1,
    devices=None,
) -> Mesh:
    """Build a ('data', 'model', 'window') mesh.

    `data=None` absorbs all remaining devices into the data axis.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if data is None:
        assert n % (model * window) == 0, (n, model, window)
        data = n // (model * window)
    assert data * model * window == n, (data, model, window, n)
    return Mesh(devices.reshape(data, model, window), AXES)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard dim 0 over 'data', replicate the rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Place a host batch dict with dim-0 sharded over 'data'."""
    return {
        k: jax.device_put(v, batch_sharding(mesh, np.ndim(v)))
        for k, v in batch.items()
    }
