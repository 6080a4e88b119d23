"""Explicit collectives layer: testable shard_map wrappers.

SURVEY.md §5 "Distributed communication backend": the NCCL-equivalent
surface, made explicit — psum / all_gather / ppermute ring shifts /
all_to_all over named mesh axes, plus the halo-exchange primitive the
context-parallel and BA-window pipelines are built on. Every wrapper
is exercised against a numpy oracle on the 8-fake-device CI mesh
(tests/test_collectives.py), so pod runs are config-only changes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def all_reduce_sum(x: jnp.ndarray, mesh: Mesh, axis: str = "data") -> jnp.ndarray:
    """Sum dim-0 shards; every shard receives the total (psum)."""

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(axis), out_specs=P(axis),
        check_vma=False,
    )
    def f(local):
        s = jax.lax.psum(local.sum(axis=0, keepdims=True), axis)
        return jnp.broadcast_to(s, local.shape)

    return f(x)


def all_gather_axis(x: jnp.ndarray, mesh: Mesh, axis: str = "data") -> jnp.ndarray:
    """Gather dim-0 shards on every device: (N, ...) -> (N, ...) full
    copy per shard (result replicated along `axis`)."""

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(axis), out_specs=P(),
        check_vma=False,
    )
    def f(local):
        return jax.lax.all_gather(local, axis, axis=0, tiled=True)

    return f(x)


def ring_shift(x: jnp.ndarray, mesh: Mesh, axis: str = "data", shift: int = 1) -> jnp.ndarray:
    """Send each dim-0 shard to the neighbor `shift` steps up the ring
    (shard i's data lands on shard (i+shift) mod n) via ppermute."""
    n = mesh.shape[axis]

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(axis), out_specs=P(axis),
        check_vma=False,
    )
    def f(local):
        perm = [(i, (i + shift) % n) for i in range(n)]
        return jax.lax.ppermute(local, axis, perm)

    return f(x)


def halo_exchange(x: jnp.ndarray, mesh: Mesh, axis: str = "data", halo: int = 1):
    """Contiguous dim-0 chunks + `halo` rows from each neighbor.

    Returns (left_halo, right_halo) sharded like x: left_halo[chunk i]
    holds the LAST `halo` rows of chunk i-1 (zeros for i=0);
    right_halo holds the FIRST `halo` rows of chunk i+1 (zeros at the
    end). This is the boundary exchange of the CP/BA pipelines
    (SURVEY.md P4/P6): 1-frame overlap so every pairwise term is
    computed on exactly one device.
    """
    n = mesh.shape[axis]

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(axis), out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    def f(local):
        idx = jax.lax.axis_index(axis)
        down = [(i, (i + 1) % n) for i in range(n)]  # i -> i+1
        up = [(i, (i - 1) % n) for i in range(n)]    # i -> i-1
        left = jax.lax.ppermute(local[-halo:], axis, down)
        right = jax.lax.ppermute(local[:halo], axis, up)
        left = jnp.where(idx == 0, jnp.zeros_like(left), left)
        right = jnp.where(idx == n - 1, jnp.zeros_like(right), right)
        return left, right

    return f(x)


def all_to_all_axis(x: jnp.ndarray, mesh: Mesh, axis: str = "data") -> jnp.ndarray:
    """Transpose shard/split axes: dim 0 sharded, dim 1 = n chunks ->
    dim 1 sharded, dim 0 = n chunks (Ulysses-style redistribution)."""
    n = mesh.shape[axis]

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(axis, None), out_specs=P(None, axis),
        check_vma=False,
    )
    def f(local):
        # local: (rows/n, n*cols_per) -> exchange so each device keeps
        # all rows of its column block.
        rows, total_cols = local.shape
        cols = total_cols // n
        blocks = local.reshape(rows, n, cols)
        out = jax.lax.all_to_all(blocks, axis, split_axis=1, concat_axis=0)
        return out.reshape(n * rows, cols)

    return f(x)
