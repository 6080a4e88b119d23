"""Correlation cost volume: XLA reference and a fused GPU kernel.

out[b, h, w, k] = mean_c f1[b, h, w, c] * f2[b, h+dy_k, w+dx_k, c]

with (dy_k, dx_k) = divmod(k, 2s+1) - s and f2 zero outside the frame.

`cost_volume_xla` is the plain lowering: (2s+1)^2 shifted slices of a
padded f2, each multiplied with f1 and reduced over channels. XLA reads
f1 and a shifted f2 once per displacement.

`cost_volume_pallas` is the PWC-Net/FlowNet correlation layer as one
Pallas kernel through Triton: one program per (batch, row) holds that
row of f1 in registers and sweeps every displacement over the rows of
f2 around it, so each output is written once and f1 is read once.
`cost_volume` picks it when lowering for CUDA and the XLA form
everywhere else; its gradient is the VJP of the XLA form.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as plgpu
from jax.sharding import NamedSharding, PartitionSpec as P


def cost_volume_xla(f1: jnp.ndarray, f2: jnp.ndarray, search: int) -> jnp.ndarray:
    """Reference XLA lowering (shifted dynamic slices)."""
    B, H, W, C = f1.shape
    f2p = jnp.pad(f2, ((0, 0), (search, search), (search, search), (0, 0)))
    slices = []
    for dy in range(2 * search + 1):
        for dx in range(2 * search + 1):
            shifted = jax.lax.dynamic_slice(f2p, (0, dy, dx, 0), (B, H, W, C))
            slices.append(jnp.mean(f1 * shifted, axis=-1))
    return jnp.stack(slices, axis=-1)


def _costvol_kernel(f1_ref, f2_ref, out_ref, *, search, H, W, C, BW, BC):
    b = pl.program_id(0)
    y = pl.program_id(1)
    d = 2 * search + 1
    xs = jnp.arange(BW)
    cs = jnp.arange(BC)
    x_in = xs < W
    c_in = (cs < C)[None, :]
    f1 = plgpu.load(
        f1_ref.at[b, y, xs[:, None], cs[None, :]],
        mask=x_in[:, None] & c_in, other=0.0,
    ).astype(jnp.float32)
    inv_c = 1.0 / C

    def row(dy, carry):
        yy = y + dy - search
        y_in = (yy >= 0) & (yy < H)
        yc = jnp.clip(yy, 0, H - 1)
        for dx in range(d):
            xx = xs + (dx - search)
            m = y_in & (xx >= 0) & (xx < W)
            win = plgpu.load(
                f2_ref.at[b, yc, xx[:, None], cs[None, :]],
                mask=m[:, None] & c_in, other=0.0,
            ).astype(jnp.float32)
            corr = jnp.sum(f1 * win, axis=1) * inv_c
            plgpu.store(out_ref.at[b, y, dy * d + dx, xs], corr, mask=x_in)
        return carry

    jax.lax.fori_loop(0, d, row, 0)


def cost_volume_pallas(
    f1: jnp.ndarray, f2: jnp.ndarray, search: int, *, interpret: bool = False
) -> jnp.ndarray:
    """(B, H, W, C) x2 -> (B, H, W, (2*search+1)^2), float32.

    Triton route. The row and channel tiles are the next powers of two
    of W and C, masked at the edges. The kernel writes (B, H, K, W) so
    that every store is a contiguous row; the transpose to the
    estimator's NHWC layout fuses into the consumer.
    """
    B, H, W, C = f1.shape
    d = 2 * search + 1
    BW, BC = pl.next_power_of_2(W), pl.next_power_of_2(C)
    out = pl.pallas_call(
        partial(_costvol_kernel, search=search, H=H, W=W, C=C, BW=BW, BC=BC),
        grid=(B, H),
        out_shape=jax.ShapeDtypeStruct((B, H, d * d, W), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="cost_volume",
    )(f1, f2)
    return jnp.transpose(out, (0, 1, 3, 2))


def batch_partitioned(fn):
    """`fn(f1, f2, search)` as an op that SPMD partitioning splits over
    the batch axis: each device runs `fn` on its own batch shard.

    A kernel is an opaque custom call to the partitioner, which would
    otherwise gather the whole batch onto every device and run the
    kernel on all of it. Rows, columns and channels are gathered if
    they were sharded: the window reaches across rows and columns.
    """
    op = custom_partitioning(
        lambda f1, f2, search: fn(f1, f2, search), static_argnums=(2,)
    )

    def sharding(mesh, arg_shapes):
        spec = arg_shapes[0].sharding.spec
        return NamedSharding(mesh, P(spec[0] if len(spec) else None))

    def infer(search, mesh, arg_shapes, result_shape):
        return sharding(mesh, arg_shapes)

    def partition(search, mesh, arg_shapes, result_shape):
        s = sharding(mesh, arg_shapes)
        return mesh, lambda a, b: fn(a, b, search), s, (s, s)

    op.def_partition(
        partition,
        infer_sharding_from_operands=infer,
        sharding_rule="b h w c, b h w c -> b h w k",
        need_replication_factors=("h", "w", "c", "k"),
    )
    return op


_cost_volume_cuda = batch_partitioned(cost_volume_pallas)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def cost_volume(f1: jnp.ndarray, f2: jnp.ndarray, search: int) -> jnp.ndarray:
    """The Triton kernel when lowering for CUDA, `cost_volume_xla`
    elsewhere. Differentiable: the backward is the XLA form's VJP.
    Under a sharded jit each device runs the kernel on its own batch
    shard (`batch_partitioned`)."""
    return jax.lax.platform_dependent(
        f1, f2,
        cuda=lambda a, b: _cost_volume_cuda(a, b, search),
        default=lambda a, b: cost_volume_xla(a, b, search).astype(jnp.float32),
    )


def _cost_volume_fwd(f1, f2, search):
    return cost_volume(f1, f2, search), (f1, f2)


def _cost_volume_bwd(search, res, g):
    f1, f2 = res
    _, vjp = jax.vjp(partial(cost_volume_xla, search=search), f1, f2)
    return vjp(g.astype(jnp.result_type(f1, f2)))


cost_volume.defvjp(_cost_volume_fwd, _cost_volume_bwd)
