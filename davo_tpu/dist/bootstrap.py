"""Multi-host bootstrap: jax.distributed initialization + helpers.

The reference is strictly single-process (SURVEY.md §2.2 [H]); this is
the multi-host entry layer: one process per host, coordinator-based
rendezvous, per-host data sharding via `jax.make_array_from_process_
local_data`. On a cluster the mesh's outermost axis spans hosts;
inner axes stay within a host's interconnect. Testable without a cluster by launching N
local processes over loopback (tests/test_multiprocess.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax


@dataclass
class HostTopology:
    process_id: int
    num_processes: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> HostTopology:
    """Initialize the multi-host runtime (no-op on single process).

    Arguments default from the standard env vars so pod launches are
    config-free; explicit args support the loopback test harness.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "DAVO_COORDINATOR"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("DAVO_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("DAVO_PROCESS_ID", "0"))

    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return HostTopology(
        process_id=jax.process_index(),
        num_processes=jax.process_count(),
        local_device_count=jax.local_device_count(),
        global_device_count=jax.device_count(),
    )


def local_batch_to_global(batch: dict, mesh, axis: str = "data") -> dict:
    """Assemble per-host batch shards into global arrays on the mesh.

    Each process passes its local slice of the batch (dim 0); returns
    globally-sharded arrays (dim 0 = axis). Single-process: equivalent
    to `shard_batch`.
    """
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = {}
    for key, val in batch.items():
        spec = P(axis, *([None] * (np.ndim(val) - 1)))
        sharding = NamedSharding(mesh, spec)
        out[key] = jax.make_array_from_process_local_data(sharding, val)
    return out
