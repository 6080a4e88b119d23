"""Golden tests for warping / SSIM / pyramids (SURVEY.md §4.1):
a textured plane with known depth + pose must reconstruct exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from davo_tpu.core import geometry as geo
from davo_tpu.core import pyramid as pyr
from davo_tpu.core.ssim import ssim
from davo_tpu.core import warp


def checkerboard(H, W, C=3, period=4):
    u = np.arange(W)[None, :] // period
    v = np.arange(H)[:, None] // period
    base = ((u + v) % 2).astype(np.float32)
    img = np.stack([base * (0.3 + 0.2 * c) + 0.1 for c in range(C)], axis=-1)
    return img[None]  # (1, H, W, C)


def smooth_texture(rng, H, W, C=3):
    """Band-limited random texture — smooth enough for bilinear fidelity."""
    x = rng.uniform(0.0, 1.0, size=(1, H, W, C)).astype(np.float32)
    k = np.ones((5, 5)) / 25.0
    from scipy.ndimage import convolve

    for c in range(C):
        x[0, ..., c] = convolve(x[0, ..., c], k, mode="nearest")
    return x


class TestBilinearSample:
    def test_identity_coords(self, rng):
        img = jnp.asarray(rng.uniform(size=(2, 8, 12, 3)), jnp.float32)
        grid = geo.pixel_grid(8, 12)[:2]
        coords = jnp.broadcast_to(jnp.moveaxis(grid, 0, -1)[None], (2, 8, 12, 2))
        out, valid = warp.bilinear_sample(img, coords)
        np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-6)
        assert float(valid.min()) == 1.0

    def test_integer_shift(self, rng):
        img = jnp.asarray(rng.uniform(size=(1, 8, 12, 1)), jnp.float32)
        grid = jnp.moveaxis(geo.pixel_grid(8, 12)[:2], 0, -1)[None]
        coords = grid + jnp.array([2.0, 0.0])  # sample at u+2
        out, valid = warp.bilinear_sample(img, coords)
        np.testing.assert_allclose(
            np.asarray(out[0, :, :10, 0]), np.asarray(img[0, :, 2:, 0]), atol=1e-6
        )
        # Last two columns sample out of bounds -> invalid, zeroed.
        assert float(valid[0, :, 10:].max()) == 0.0
        assert float(jnp.abs(out[0, :, 10:]).max()) == 0.0

    def test_border_fill_returns_edge_sample(self, rng):
        """fill="border": out-of-frame samples keep the edge-clamped
        value (valid still 0) instead of being zeroed."""
        img = jnp.asarray(rng.uniform(0.5, 1.0, size=(1, 8, 12, 2)), jnp.float32)
        grid = jnp.moveaxis(geo.pixel_grid(8, 12)[:2], 0, -1)[None]
        coords = grid + jnp.array([5.0, 0.0])  # u+5: right strip OOB
        out, valid = warp.bilinear_sample(img, coords, fill="border")
        assert float(valid[0, :, 7:].max()) == 0.0
        # OOB columns clamp to the last source column, not zero.
        np.testing.assert_allclose(
            np.asarray(out[0, :, 7:]),
            np.broadcast_to(np.asarray(img[0, :, -1:]), (8, 5, 2)),
            atol=1e-6,
        )

    def test_halfpixel_average(self):
        img = jnp.zeros((1, 4, 4, 1)).at[0, 1, 1, 0].set(1.0)
        coords = jnp.array([[[[0.5, 1.0]]]])  # between (1,0) and (1,1) in u
        out, _ = warp.bilinear_sample(img, coords)
        assert float(out[0, 0, 0, 0]) == 0.5

    def test_block_gather_matches_take4(self, rng):
        """The (2,2,C)-block lax.gather formulation equals the four-tap
        formulation — values, masks, and d/d(coords) — including
        far-out-of-range coordinates (both clamp to the border pixel
        with total weight 1)."""
        img = jnp.asarray(rng.uniform(size=(2, 9, 13, 3)), jnp.float32)
        # Coordinates spanning in-range, boundary, and far OOB.
        coords = jnp.asarray(
            rng.uniform(-4.0, 17.0, size=(2, 6, 7, 2)), jnp.float32
        )
        for fill in ("zeros", "border"):
            a, va = warp.bilinear_sample(
                img, coords, fill=fill, method="take4"
            )
            b, vb = warp.bilinear_sample(
                img, coords, fill=fill, method="block"
            )
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-6
            )
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        # Smooth in-range field: coordinate gradients must agree too
        # (at exact integer boundaries the clamp subgradient may
        # differ — measure-zero; the loss never sits there).
        sm = jnp.asarray(
            rng.uniform(0.3, 7.3, size=(2, 6, 7, 2)), jnp.float32
        )
        ga = jax.grad(
            lambda c: warp.bilinear_sample(
                img, c, fill="border", method="take4"
            )[0].mean()
        )(sm)
        gb = jax.grad(
            lambda c: warp.bilinear_sample(
                img, c, fill="border", method="block"
            )[0].mean()
        )(sm)
        np.testing.assert_allclose(
            np.asarray(ga), np.asarray(gb), atol=1e-6
        )


class TestProjectiveInverseWarp:
    def test_identity_pose(self, rng):
        img = jnp.asarray(checkerboard(16, 24))
        depth = jnp.full((1, 16, 24), 5.0)
        K = geo.make_intrinsics(20.0, 20.0, 12.0, 8.0)[None]
        out, valid = warp.projective_inverse_warp(
            img, depth, jnp.zeros((1, 6)), K
        )
        np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-5)
        assert float(valid.min()) == 1.0

    def test_translation_on_plane(self, rng):
        """Fronto-parallel plane + x-translation == exact integer pixel shift."""
        H, W, fx, z0 = 16, 24, 10.0, 5.0
        src = jnp.asarray(smooth_texture(rng, H, W))
        depth = jnp.full((1, H, W), z0)
        K = geo.make_intrinsics(fx, fx, W / 2, H / 2)[None]
        # target->source translation +x by d => pixels shift by fx*d/z0 = 2
        d = 1.0
        pose = jnp.array([[d, 0.0, 0.0, 0.0, 0.0, 0.0]])
        out, valid = warp.projective_inverse_warp(src, depth, pose, K)
        shift = int(fx * d / z0)
        got = np.asarray(out[0, :, : W - shift])
        want = np.asarray(src[0, :, shift:])
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_z_translation_valid(self, rng):
        """Moving forward keeps center pixels valid and differentiable."""
        import jax

        H, W = 16, 24
        src = jnp.asarray(smooth_texture(rng, H, W))
        K = geo.make_intrinsics(20.0, 20.0, W / 2, H / 2)[None]

        def loss(pose_vec, depth):
            out, valid = warp.projective_inverse_warp(src, depth, pose_vec, K)
            return jnp.sum((out - src) ** 2 * valid)

        depth = jnp.full((1, H, W), 5.0)
        pose = jnp.array([[0.0, 0.0, 0.3, 0.0, 0.0, 0.0]])
        g = jax.grad(loss)(pose, depth)
        assert np.all(np.isfinite(np.asarray(g)))
        assert float(jnp.abs(g).max()) > 0.0


class TestFlowWarp:
    def test_constant_flow(self, rng):
        img = jnp.asarray(rng.uniform(size=(1, 8, 12, 2)), jnp.float32)
        flow = jnp.broadcast_to(jnp.array([1.0, 0.0]), (1, 8, 12, 2))
        out, _ = warp.flow_warp(img, flow)
        np.testing.assert_allclose(
            np.asarray(out[0, :, :11]), np.asarray(img[0, :, 1:]), atol=1e-6
        )


class TestFlowWarpSeparable:
    """Gather-free two-pass warp (core/warp.flow_warp_separable): the
    path used inside the flow pyramid. Exact when either flow
    component is integer/uniform; near-exact on smooth fields."""

    def test_horizontal_flow_exact(self, rng):
        img = jnp.asarray(rng.uniform(size=(2, 8, 12, 4)), jnp.float32)
        flow = jnp.zeros((2, 8, 12, 2)).at[..., 0].set(
            jnp.asarray(rng.uniform(-2, 2, (2, 8, 12)), jnp.float32)
        )
        a, va = warp.flow_warp(img, flow)
        b, vb = warp.flow_warp_separable(img, flow)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))

    def test_constant_flow_exact(self, rng):
        img = jnp.asarray(rng.uniform(size=(1, 8, 12, 2)), jnp.float32)
        flow = jnp.broadcast_to(jnp.array([0.7, -1.3]), (1, 8, 12, 2))
        a, _ = warp.flow_warp(img, flow)
        b, _ = warp.flow_warp_separable(img, flow)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)

    def test_smooth_flow_close(self, rng):
        """PWC-regime field (2x-upsampled previous-level flow: locally
        smooth, |dv| small relative to du variation): the two-pass
        error |d du/dy|*|dv| stays subpixel -> small value error."""
        from scipy.ndimage import gaussian_filter

        from davo_tpu.kernels.resize import resize_bilinear_aligned

        img_np = rng.uniform(size=(1, 16, 24, 8)).astype(np.float32)
        for c in range(8):  # feature-map-like smoothness
            img_np[0, ..., c] = gaussian_filter(img_np[0, ..., c], 1.0)
        img = jnp.asarray(img_np)
        coarse = np.stack(
            [
                rng.uniform(-4, 4, (1, 8, 12)),  # du: large, smooth
                rng.uniform(-1, 1, (1, 8, 12)),  # dv: small (driving)
            ],
            axis=-1,
        ).astype(np.float32)
        for c in range(2):
            coarse[0, ..., c] = gaussian_filter(coarse[0, ..., c], 2.0)
        flow = 2.0 * resize_bilinear_aligned(jnp.asarray(coarse), 16, 24)
        a, va = warp.flow_warp(img, flow)
        b, vb = warp.flow_warp_separable(img, flow)
        m = np.asarray(va * vb)
        diff = np.abs(np.asarray(a - b)) * m
        assert diff.max() < 0.06, diff.max()
        assert diff.mean() < 0.005, diff.mean()

    def test_grads_finite(self, rng):
        img = jnp.asarray(rng.uniform(size=(1, 8, 12, 2)), jnp.float32)

        def loss(flow):
            out, _ = warp.flow_warp_separable(img, flow)
            return (out**2).sum()

        g = jax.grad(loss)(jnp.full((1, 8, 12, 2), 0.3))
        assert np.all(np.isfinite(np.asarray(g)))
        assert float(jnp.abs(g).max()) > 0.0


class TestSSIM:
    def test_identical_images(self, rng):
        x = jnp.asarray(rng.uniform(size=(1, 16, 16, 3)), jnp.float32)
        d = ssim(x, x)
        assert float(jnp.abs(d).max()) < 1e-5

    def test_different_images(self, rng):
        x = jnp.asarray(rng.uniform(size=(1, 16, 16, 3)), jnp.float32)
        y = 1.0 - x
        d = ssim(x, y)
        assert float(d.mean()) > 0.1
        assert d.shape == (1, 14, 14, 3)


class TestPyramid:
    def test_downsample_constant(self):
        x = jnp.full((1, 8, 8, 3), 0.7)
        levels = pyr.image_pyramid(x, 3)
        assert [l.shape[1] for l in levels] == [8, 4, 2]
        for l in levels:
            np.testing.assert_allclose(np.asarray(l), 0.7, atol=1e-6)

    def test_downsample_mean(self):
        x = jnp.arange(16.0).reshape(1, 4, 4, 1)
        d = pyr.downsample2(x)
        np.testing.assert_allclose(
            np.asarray(d[0, :, :, 0]), [[2.5, 4.5], [10.5, 12.5]], atol=1e-6
        )

    def test_resize_shapes(self, rng):
        x = jnp.asarray(rng.uniform(size=(2, 8, 12, 3)), jnp.float32)
        out = pyr.resize_bilinear(x, 16, 24)
        assert out.shape == (2, 16, 24, 3)
