"""Host->device prefetch: overlap H2D transfer with device compute.

The reference relies on TF1 queue runners (SURVEY.md R9); the
JAX equivalent is a small double-buffered iterator that calls
`jax.device_put` (optionally with a `NamedSharding` so per-host batches
land directly on the right mesh shards) one batch ahead of consumption,
letting the copy overlap the previous step's compute.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterable, Iterator

import jax


@dataclasses.dataclass
class PrefetchStats:
    """Per-host prefetch overlap accounting (SURVEY.md §5 observability).

    host_s is the wall time the consumer loop loses to host-side batch
    production + H2D enqueue (device_put returns after enqueue; the
    copy itself overlaps device compute). consumer_s is the time the
    consumer spends between batches (device compute + bookkeeping).
    A healthy pipeline has host_fraction << 1; near 1 means the input
    pipeline is the bottleneck (the TF1 queue-runner starvation analog).
    """

    batches: int = 0
    host_s: float = 0.0
    consumer_s: float = 0.0

    @property
    def host_fraction(self) -> float:
        total = self.host_s + self.consumer_s
        return self.host_s / total if total > 0 else 0.0

    def summary(self) -> dict:
        return {
            "batches": self.batches,
            "host_s": round(self.host_s, 4),
            "consumer_s": round(self.consumer_s, 4),
            "host_fraction": round(self.host_fraction, 4),
        }


def device_prefetch(
    batches: Iterable[dict],
    sharding=None,
    buffer_size: int = 2,
    stats: PrefetchStats | None = None,
) -> Iterator[dict]:
    """Yield device-resident batches, staying `buffer_size` ahead.

    `sharding` may be a single sharding applied to every leaf or a dict
    mapping batch keys to shardings (e.g. batch-axis NamedSharding for
    arrays, replicated for intrinsics).
    `stats`: optional PrefetchStats, filled in-place while iterating.
    """

    def put(batch: dict) -> dict:
        out = {}
        for key, val in batch.items():
            s = sharding.get(key) if isinstance(sharding, dict) else sharding
            out[key] = jax.device_put(val, s) if s is not None else jax.device_put(val)
        return out

    queue: collections.deque = collections.deque()
    it = iter(batches)
    try:
        for _ in range(buffer_size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    last_yield = None
    while queue:
        out = queue.popleft()
        t0 = time.perf_counter()
        if stats is not None and last_yield is not None:
            stats.consumer_s += t0 - last_yield
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        if stats is not None:
            stats.host_s += time.perf_counter() - t0
            stats.batches += 1
            last_yield = time.perf_counter()
        yield out
