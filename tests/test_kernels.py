"""Kernels vs their plain references (Pallas in interpret mode on CPU;
SURVEY.md §4.1 'Pallas kernels vs jax.lax reference ops')."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from davo_tpu.core import warp
from davo_tpu.kernels.costvol import (
    batch_partitioned,
    cost_volume,
    cost_volume_pallas,
    cost_volume_xla,
)
from davo_tpu.kernels.resize import resize_bilinear_aligned, upsample2x_bilinear
from davo_tpu.kernels.sample import bilinear_sample_matmul
from davo_tpu.core.warp import bilinear_sample

# (search, channels, level width) of every refined flow level of the
# 128x416 presets: davo (search 4; /4, /8, /16 levels with 32, 64, 96
# channels) and davo-fast (search 3; 8-channel projection; /4, /8).
PRESET_LEVELS = [(4, 32, 104), (4, 64, 52), (4, 96, 26), (3, 8, 104), (3, 8, 52)]


def _features(rng, shape, dtype=jnp.float32):
    return (
        jnp.asarray(rng.normal(size=shape), dtype),
        jnp.asarray(rng.normal(size=shape), dtype),
    )


class TestCostVolume:
    @pytest.mark.parametrize("search,C,W", PRESET_LEVELS)
    def test_matches_xla(self, rng, search, C, W):
        """The Triton kernel, interpreted, at the presets' widths; f32
        sums in another order than XLA's mean, hence the 1e-5."""
        f1, f2 = _features(rng, (2, 3, W, C))
        got = cost_volume_pallas(f1, f2, search, interpret=True)
        want = cost_volume_xla(f1, f2, search)
        assert got.shape == (2, 3, W, (2 * search + 1) ** 2)
        assert got.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)

    def test_ragged_tiles_are_masked(self, rng):
        """W and C far from powers of two: the masked tile edges must
        read zeros, and the frame border must act as zero padding."""
        f1, f2 = _features(rng, (1, 5, 13, 5))
        got = cost_volume_pallas(f1, f2, 2, interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(cost_volume_xla(f1, f2, 2)), atol=1e-5
        )

    def test_bf16_inputs_accumulate_in_f32(self, rng):
        f1, f2 = _features(rng, (1, 3, 26, 32), jnp.bfloat16)
        got = cost_volume_pallas(f1, f2, 2, interpret=True)
        want = cost_volume_xla(f1.astype(jnp.float32), f2.astype(jnp.float32), 2)
        assert got.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)

    def test_gradient_is_xla_vjp(self, rng):
        f1, f2 = _features(rng, (2, 4, 10, 6))
        w = jnp.asarray(rng.normal(size=(2, 4, 10, 25)), jnp.float32)

        def loss(fn):
            return lambda a, b: jnp.sum(fn(a, b, 2) * w)

        got = jax.grad(loss(cost_volume), (0, 1))(f1, f2)
        want = jax.grad(loss(cost_volume_xla), (0, 1))(f1, f2)
        for g, r in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(r), atol=1e-6)

    def test_cpu_lowering_takes_xla_branch(self, rng):
        """platform_dependent resolves at lowering: on the CPU no
        Triton call is emitted and the result is the XLA form's."""
        f1, f2 = _features(rng, (1, 4, 9, 3))
        fn = jax.jit(lambda a, b: cost_volume(a, b, 1))
        text = fn.lower(f1, f2).as_text()
        assert "triton" not in text.lower()
        np.testing.assert_allclose(
            np.asarray(fn(f1, f2)), np.asarray(cost_volume_xla(f1, f2, 1)),
            atol=1e-6,
        )


def _interpreted(f1, f2, search):
    return cost_volume_pallas(f1, f2, search, interpret=True)


@pytest.fixture
def mesh8():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))


class TestCostVolumeSharding:
    """`batch_partitioned` under a sharded jit on the 8-device CPU mesh,
    with the kernel interpreted: each device runs it on its own batch
    shard."""

    @pytest.mark.parametrize("spec", [P("data"), P(("data", "model"))])
    def test_batch_shards_stay_local(self, rng, mesh8, spec):
        f1, f2 = _features(rng, (8, 4, 10, 6))
        sh = NamedSharding(mesh8, spec)
        fn = jax.jit(
            lambda a, b: batch_partitioned(_interpreted)(a, b, 2),
            in_shardings=(sh, sh),
        )
        hlo = fn.lower(f1, f2).compile().as_text()
        assert not re.search(r"all-gather|all-reduce|collective-permute|all-to-all", hlo)
        out = fn(f1, f2)
        assert out.sharding.spec == spec
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(cost_volume_xla(f1, f2, 2)), atol=1e-5
        )

    def test_sharded_channels_are_gathered(self, rng, mesh8):
        """Channels sharded over 'model' are gathered for the kernel;
        the batch stays split over 'data'."""
        f1, f2 = _features(rng, (8, 4, 10, 6))
        sh = NamedSharding(mesh8, P("data", None, None, "model"))
        fn = jax.jit(
            lambda a, b: batch_partitioned(_interpreted)(a, b, 2),
            in_shardings=(sh, sh),
        )
        out = fn(f1, f2)
        assert out.sharding.spec == P("data")
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(cost_volume_xla(f1, f2, 2)), atol=1e-5
        )

    def test_cuda_lowering_is_partitioned(self, mesh8):
        """Lowered for CUDA, `cost_volume` is the partitioned kernel
        under a multi-device sharding and the plain Triton call on one
        device (no compile: the CPU cannot build CUDA code)."""
        x = jax.ShapeDtypeStruct((8, 8, 24, 32), jnp.float32)
        xs = jax.ShapeDtypeStruct(
            x.shape, x.dtype, sharding=NamedSharding(mesh8, P("data"))
        )

        def cuda_text(arg):
            return jax.jit(lambda a, b: cost_volume(a, b, 4)).trace(arg, arg).lower(
                lowering_platforms=("cuda",)
            ).as_text()

        sharded, single = cuda_text(xs), cuda_text(x)
        assert sharded.count("CustomSPMDPartitioning") == 1
        assert "xla.gpu.triton" not in sharded  # lowered per shard at compile
        assert single.count("xla.gpu.triton") == 1
        assert "CustomSPMDPartitioning" not in single


class TestResize:
    @pytest.mark.parametrize("factor", [2, 4])
    def test_matches_jax_image(self, rng, factor):
        x = jnp.asarray(rng.uniform(size=(2, 6, 10, 3)), jnp.float32)
        want = jax.image.resize(
            x, (2, 6 * factor, 10 * factor, 3), method="bilinear"
        )
        got = upsample2x_bilinear(x, factor)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)

    def test_aligned_fallback(self, rng):
        x = jnp.asarray(rng.uniform(size=(1, 4, 4, 2)), jnp.float32)
        out = resize_bilinear_aligned(x, 6, 6)  # non-integer factor
        assert out.shape == (1, 6, 6, 2)


def _band_sample_np(img, coords, rv, rh, fill):
    """NumPy reference: clamp each displacement into the band, then
    into the frame, then sample bilinearly."""
    img = np.asarray(img, np.float64)
    B, H, W, C = img.shape
    u, v = np.asarray(coords[..., 0]), np.asarray(coords[..., 1])
    Ho, Wo = u.shape[1:]
    x = np.arange(Wo)[None, None, :]
    y = np.arange(Ho)[None, :, None]
    valid = ((u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1))[..., None]
    uc = np.clip(np.clip(u - x, -rh, rh) + x, 0, W - 1)
    vc = np.clip(np.clip(v - y, -rv, rv) + y, 0, H - 1)
    u0, v0 = np.floor(uc).astype(int), np.floor(vc).astype(int)
    u1, v1 = np.minimum(u0 + 1, W - 1), np.minimum(v0 + 1, H - 1)
    fu, fv = (uc - u0)[..., None], (vc - v0)[..., None]
    b = np.arange(B)[:, None, None]
    top = img[b, v0, u0] * (1 - fu) + img[b, v0, u1] * fu
    bot = img[b, v1, u0] * (1 - fu) + img[b, v1, u1] * fu
    out = top * (1 - fv) + bot * fv
    return (out * valid if fill == "zeros" else out), valid


@pytest.fixture
def band(monkeypatch):
    def set_band(rv, rh):
        monkeypatch.setattr(warp, "_BAND", (rv, rh))

    return set_band


class TestBandedWarp:
    @pytest.mark.parametrize("fill", ["border", "zeros"])
    @pytest.mark.parametrize("rv,rh", [(1, 2), (2, 4), (4, 16)])
    def test_band_clamp_matches_numpy(self, rng, band, rv, rh, fill):
        band(rv, rh)
        img = jnp.asarray(rng.uniform(size=(2, 12, 20, 3)), jnp.float32)
        coords = jnp.asarray(
            rng.uniform(-8, 28, size=(2, 12, 20, 2)), jnp.float32
        )
        got, gvalid = bilinear_sample(img, coords, fill=fill, method="banded")
        want, wvalid = _band_sample_np(img, coords, rv, rh, fill)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(gvalid), wvalid)

    def test_matches_gather_in_band(self, rng, band):
        """Exact equality vs the take4 gather wherever the
        displacement fits the (rh, rv) band."""
        band(2, 4)
        B, H, W, C = 2, 16, 24, 3
        img = jnp.asarray(rng.uniform(size=(B, H, W, C)), jnp.float32)
        gy, gx = np.meshgrid(
            np.arange(H), np.arange(W), indexing="ij"
        )
        du = 2.5 * np.sin(gy / 5.0)[None]
        dv = 1.5 * np.cos(gx / 7.0)[None]
        coords = jnp.asarray(
            np.stack(
                [np.broadcast_to(gx + du, (B, H, W)),
                 np.broadcast_to(gy + dv, (B, H, W))], -1
            ),
            jnp.float32,
        )
        want, wvalid = bilinear_sample(img, coords, fill="border", method="take4")
        got, gvalid = bilinear_sample(img, coords, fill="border", method="banded")
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), atol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(gvalid), np.asarray(wvalid)
        )

    def test_grads_match_gather_in_band(self, rng, band):
        """d/d(img) and d/d(coords) equal take4's inside the band,
        including exactly-integer coords and the frame edges: the
        floor-cell subgradient and the edge clamp are pinned by the
        u=0 / u=W-1 samples of the du=0 row."""
        band(2, 4)
        B, H, W, C = 2, 12, 16, 3
        img = jnp.asarray(rng.uniform(size=(B, H, W, C)), jnp.float32)
        gy, gx = np.meshgrid(
            np.arange(H), np.arange(W), indexing="ij"
        )
        du = rng.uniform(-3.9, 3.9, (B, H, W))
        dv = rng.uniform(-1.9, 1.9, (B, H, W))
        du[0, 2] = 0.0  # a row of exactly-integer u (kink subgradient)
        coords = jnp.asarray(
            np.stack([gx + du, gy + dv], -1), jnp.float32
        )
        wgt = jnp.asarray(rng.normal(size=(B, H, W, C)), jnp.float32)

        def loss(method):
            return lambda im, c: (
                bilinear_sample(im, c, fill="border", method=method)[0] * wgt
            ).sum()

        gr = jax.grad(loss("take4"), (0, 1))(img, coords)
        gb = jax.grad(loss("banded"), (0, 1))(img, coords)
        np.testing.assert_allclose(
            np.asarray(gr[0]), np.asarray(gb[0]), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(gr[1]), np.asarray(gb[1]), atol=1e-5
        )

    def test_out_of_band_clamps_and_stays_finite(self, rng, band):
        band(2, 4)
        img = jnp.asarray(rng.uniform(size=(1, 8, 16, 2)), jnp.float32)
        coords = jnp.asarray(
            rng.uniform(-30, 60, size=(1, 8, 16, 2)), jnp.float32
        )
        out, valid = bilinear_sample(img, coords, fill="zeros", method="banded")
        assert bool(jnp.isfinite(out).all())
        # zeros fill: invalid (out-of-frame) samples are zeroed
        assert float(jnp.abs(out * (1 - valid)).max()) == 0.0
        g = jax.grad(
            lambda c: bilinear_sample(img, c, fill="border", method="banded")[0].sum()
        )(coords)
        assert bool(jnp.isfinite(g).all())


class TestMatmulSampler:
    def test_matches_gather_sampler(self, rng):
        img = jnp.asarray(rng.uniform(size=(2, 8, 10, 4)), jnp.float32)
        coords = jnp.asarray(
            rng.uniform(-1, 11, size=(2, 6, 7, 2)), jnp.float32
        )
        got, gvalid = bilinear_sample_matmul(img, coords)
        want, wvalid = bilinear_sample(img, coords)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), atol=1e-5
        )
        np.testing.assert_array_equal(np.asarray(gvalid), np.asarray(wvalid))
