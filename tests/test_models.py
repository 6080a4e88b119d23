"""Model zoo tests: shapes, dtype policy, attention semantics, grads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from davo_tpu.config import ModelConfig
from davo_tpu.models import DavoModel, DispNet, FlowNetLite, PoseNet
from davo_tpu.models.attention import (
    RegionAttention,
    region_weight_map,
    seg_to_onehot,
)
from davo_tpu.models.dispnet import disp_to_depth
from davo_tpu.models.flownet import cost_volume

CFG = ModelConfig(
    img_height=64,
    img_width=96,
    pose_channels=(8, 12, 16, 16),
    disp_channels=(8, 12, 16, 16),
    flow_levels=3,
    flow_search_range=2,
    compute_dtype="float32",
)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return {
        "target": jnp.asarray(rng.uniform(size=(2, 64, 96, 3)), jnp.float32),
        "sources": jnp.asarray(rng.uniform(size=(2, 2, 64, 96, 3)), jnp.float32),
        "seg": jnp.asarray(rng.integers(0, 19, size=(2, 64, 96)), jnp.int32),
    }


class TestPoseNet:
    def test_output_shape_and_scale(self, batch):
        net = PoseNet(CFG)
        params = net.init(jax.random.key(0), batch["target"], batch["sources"][:, 0])
        pose = net.apply(params, batch["target"], batch["sources"][:, 0])
        assert pose.shape == (2, 6)
        assert pose.dtype == jnp.float32
        # pose_scale keeps initial outputs small (reference x0.01).
        assert float(jnp.abs(pose).max()) < 0.5

    def test_grads_flow(self, batch):
        net = PoseNet(CFG)
        params = net.init(jax.random.key(0), batch["target"], batch["sources"][:, 0])

        def loss(p):
            return jnp.sum(net.apply(p, batch["target"], batch["sources"][:, 0]) ** 2)

        g = jax.grad(loss)(params)
        leaves = jax.tree_util.tree_leaves(g)
        assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
        assert any(float(jnp.abs(l).max()) > 0 for l in leaves)

class TestDispNet:
    def test_multiscale_shapes(self, batch):
        net = DispNet(CFG)
        params = net.init(jax.random.key(0), batch["target"])
        disps = net.apply(params, batch["target"])
        assert len(disps) == CFG.num_scales
        assert disps[0].shape == (2, 64, 96, 1)
        assert disps[1].shape == (2, 32, 48, 1)
        assert disps[3].shape == (2, 8, 12, 1)
        for d in disps:
            assert d.dtype == jnp.float32
            assert float(d.min()) > 0.0 and float(d.max()) < 1.0

    def test_odd_width(self):
        """416-style width (not divisible by 2^levels) must round-trip."""
        cfg = ModelConfig(
            disp_channels=(8, 12, 16, 16, 16), compute_dtype="float32"
        )
        x = jnp.zeros((1, 128, 416, 3))
        net = DispNet(cfg)
        params = net.init(jax.random.key(0), x)
        disps = net.apply(params, x)
        assert disps[0].shape == (1, 128, 416, 1)

    def test_resnet_encoder_variant(self, batch):
        """disp_encoder="resnet" (SURVEY R5 ResNet variant): identical
        multi-scale output shapes (shared decoder), residual-block
        params present, and gradients flow to the stem."""
        import dataclasses

        cfg = dataclasses.replace(CFG, disp_encoder="resnet")
        net = DispNet(cfg)
        params = net.init(jax.random.key(0), batch["target"])
        disps = net.apply(params, batch["target"])
        assert len(disps) == cfg.num_scales
        assert disps[0].shape == (2, 64, 96, 1)
        enc1 = params["params"]["enc1"]
        assert {"conv1", "conv2", "proj"} <= set(enc1.keys())

        def loss(p):
            return net.apply(p, batch["target"])[0].mean()

        g = jax.grad(loss)(params)
        g0 = g["params"]["enc0"]["Conv_0"]["kernel"]
        assert float(jnp.abs(g0).max()) > 0.0


    def test_disp_to_depth_range(self):
        from davo_tpu.models.dispnet import (
            MAX_DEPTH,
            MIN_DEPTH,
            depth_to_disp,
            disp_to_depth_ref,
        )

        # Log parametrization: endpoints hit the depth bounds; the
        # sigmoid midpoint is the geometric mid-scene.
        assert float(disp_to_depth(jnp.array(0.0))) == pytest.approx(MIN_DEPTH)
        assert float(disp_to_depth(jnp.array(1.0))) == pytest.approx(MAX_DEPTH)
        assert float(disp_to_depth(jnp.array(0.5))) == pytest.approx(
            np.sqrt(MIN_DEPTH * MAX_DEPTH)
        )
        # Round-trip and reference-convention endpoints.
        for d in (0.7, 7.0, 60.0):
            assert float(
                disp_to_depth(depth_to_disp(jnp.array(d)))
            ) == pytest.approx(d, rel=1e-5)
        assert float(disp_to_depth_ref(jnp.array(0.0))) == pytest.approx(100.0)

    def test_depth_gradient_not_saturated_at_scene_depths(self):
        """Regression (r1: depth pinned at the 100 m cap): the loss
        gradient w.r.t. the head pre-activation must stay usable at far
        scene depths. Reference (inverse-linear) parametrization decays
        like 1/depth^2; log parametrization is ~depth * const."""
        from davo_tpu.models.dispnet import depth_to_disp

        def depth_from_logit(x):
            return disp_to_depth(jax.nn.sigmoid(x))

        for target in (15.0, 60.0, 90.0):
            x0 = jax.scipy.special.logit(depth_to_disp(jnp.array(target)))
            g = float(jax.grad(depth_from_logit)(x0))
            # d(depth)/d(logit) = depth*ln(r)*s*(1-s); worst case (90m)
            # still > 1m per unit logit — far from the ~1e-3 the
            # saturated reference head had.
            assert abs(g) > 1.0, (target, g)


class TestFlowNet:
    def test_cost_volume_identity_peak(self):
        """cv of identical features peaks at zero displacement."""
        rng = np.random.default_rng(1)
        f = jnp.asarray(rng.normal(size=(1, 8, 8, 32)), jnp.float32)
        cv = cost_volume(f, f, search=2)
        assert cv.shape == (1, 8, 8, 25)
        center = 2 * 5 + 2
        interior = np.asarray(cv)[0, 2:-2, 2:-2]
        assert np.all(interior.argmax(axis=-1) == center)

    def test_cost_volume_known_shift(self):
        rng = np.random.default_rng(2)
        f1 = jnp.asarray(rng.normal(size=(1, 10, 10, 32)), jnp.float32)
        # f2 shifted by dx=+1: f2[y, x+1] == f1[y, x] -> peak at (0, +1)
        f2 = jnp.pad(f1, ((0, 0), (0, 0), (1, 0), (0, 0)))[:, :, :10]
        cv = cost_volume(f1, f2, search=2)
        interior = np.asarray(cv)[0, 2:-2, 2:-2]
        assert np.all(interior.argmax(axis=-1) == 2 * 5 + 3)  # dy=0, dx=+1

    def test_cost_volume_gram_matches_slices(self):
        """MXU Gram formulation == reference slice formulation.

        bf16 operands bound the tolerance (~3 decimal digits on unit-
        scale features); the diagonal extraction itself is exact."""
        from davo_tpu.models.flownet import cost_volume_gram

        rng = np.random.default_rng(3)
        for H, W, C, s in ((8, 8, 32, 2), (6, 26, 16, 4), (5, 13, 8, 3)):
            f1 = jnp.asarray(rng.normal(size=(2, H, W, C)), jnp.float32)
            f2 = jnp.asarray(rng.normal(size=(2, H, W, C)), jnp.float32)
            ref = cost_volume(f1, f2, search=s)
            got = cost_volume_gram(f1, f2, search=s)
            assert got.shape == ref.shape
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(ref), atol=2e-2, rtol=2e-2
            )

    def test_cost_volume_scan_matches_slices(self):
        """lax.scan formulation == the unrolled slice formulation."""
        from davo_tpu.models.flownet import cost_volume_scan

        rng = np.random.default_rng(4)
        for H, W, C, s in ((8, 8, 32, 2), (6, 26, 16, 4)):
            f1 = jnp.asarray(rng.normal(size=(2, H, W, C)), jnp.float32)
            f2 = jnp.asarray(rng.normal(size=(2, H, W, C)), jnp.float32)
            ref = cost_volume(f1, f2, search=s)
            got = cost_volume_scan(f1, f2, search=s)
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(ref), atol=1e-6
            )

    def test_cost_volume_patches_matches_slices(self):
        """One-patches-op formulation == the unrolled slice form."""
        from davo_tpu.models.flownet import cost_volume_patches

        rng = np.random.default_rng(5)
        for H, W, C, s in ((8, 8, 32, 2), (6, 26, 16, 4), (5, 13, 8, 3)):
            f1 = jnp.asarray(rng.normal(size=(2, H, W, C)), jnp.float32)
            f2 = jnp.asarray(rng.normal(size=(2, H, W, C)), jnp.float32)
            ref = cost_volume(f1, f2, search=s)
            got = cost_volume_patches(f1, f2, search=s)
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(ref), atol=1e-5
            )

    def test_cost_volume_pallas_matches_slices(self):
        """The Triton correlation kernel == slice form (interpret mode
        on CPU), including non-square dims and odd widths where the
        tile-edge masks matter."""
        from davo_tpu.kernels.costvol import cost_volume_pallas

        rng = np.random.default_rng(6)
        for H, W, C, s in ((8, 8, 32, 2), (6, 26, 16, 4), (5, 13, 8, 3)):
            f1 = jnp.asarray(rng.normal(size=(2, H, W, C)), jnp.float32)
            f2 = jnp.asarray(rng.normal(size=(2, H, W, C)), jnp.float32)
            ref = cost_volume(f1, f2, search=s)
            got = cost_volume_pallas(f1, f2, search=s, interpret=True)
            assert got.shape == ref.shape
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(ref), atol=1e-5
            )

    def test_flownet_pallas_impl_matches(self, batch, monkeypatch):
        """FlowNetLite(costvol_impl="pallas") == the default program to
        float tolerance (same params): as lowered here (the XLA
        branch), and with the Triton kernel itself interpreted."""
        import dataclasses

        from davo_tpu.kernels.costvol import cost_volume_pallas
        from davo_tpu.models import flownet

        cfg = dataclasses.replace(CFG, costvol_feat_channels=8)
        model = FlowNetLite(cfg)
        params = model.init(
            jax.random.key(0), batch["target"], batch["sources"][:, 0]
        )
        ref = model.apply(params, batch["target"], batch["sources"][:, 0])
        m2 = FlowNetLite(dataclasses.replace(cfg, costvol_impl="pallas"))
        got = m2.apply(params, batch["target"], batch["sources"][:, 0])
        monkeypatch.setitem(
            flownet._COSTVOL, "pallas",
            lambda a, b, s: cost_volume_pallas(a, b, s, interpret=True),
        )
        got_kernel = m2.apply(params, batch["target"], batch["sources"][:, 0])
        for a, b, c in zip(ref, got, got_kernel):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-4
            )
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(c), atol=1e-4
            )

    def test_costvol_projection(self, batch):
        """costvol_feat_channels: shared cv_proj params exist, pyramid
        shapes unchanged, gradients flow through the projection."""
        import dataclasses

        cfg = dataclasses.replace(
            CFG, costvol_feat_channels=8, costvol_impl="scan"
        )
        net = FlowNetLite(cfg)
        params = net.init(
            jax.random.key(0), batch["target"], batch["sources"][:, 0]
        )
        flows = net.apply(params, batch["target"], batch["sources"][:, 0])
        assert flows[0].shape == (2, 16, 24, 2)
        pp = params["params"]
        assert "cv_proj1" in pp and "cv_proj2" in pp
        assert pp["cv_proj1"]["kernel"].shape == (1, 1, 32, 8)

        def loss(p):
            return net.apply(
                p, batch["target"], batch["sources"][:, 0]
            )[0].mean()

        g = jax.grad(loss)(params)["params"]["cv_proj1"]["kernel"]
        assert float(jnp.abs(g).max()) > 0.0

    def test_pyramid_shapes(self, batch):
        net = FlowNetLite(CFG)
        params = net.init(
            jax.random.key(0), batch["target"], batch["sources"][:, 0]
        )
        flows = net.apply(params, batch["target"], batch["sources"][:, 0])
        assert len(flows) == CFG.flow_levels - 1
        assert flows[0].shape == (2, 16, 24, 2)  # /4 finest
        assert flows[-1].shape == (2, 8, 12, 2)  # /8 coarsest
        full = FlowNetLite.full_res_flow(flows[0], 64, 96)
        assert full.shape == (2, 64, 96, 2)

    def test_full_res_flow_scales_per_component(self):
        """du scales by width/w, dv by height/h — distinct when the
        level ratios differ (regression: shared width factor)."""
        flow = jnp.ones((1, 10, 20, 2))  # upsample to 40x80: x4 h, x4 w
        full = FlowNetLite.full_res_flow(flow, 30, 80)  # x3 h, x4 w
        np.testing.assert_allclose(np.asarray(full[..., 0]), 4.0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(full[..., 1]), 3.0, atol=1e-5)


    def test_estimator_bottleneck(self, batch):
        """flow_est_bottleneck: same output pyramid shapes, an est_in
        1x1 layer in the params, and strictly fewer estimator weights
        than the paper-parity stack."""
        import dataclasses

        import jax.tree_util as jtu

        from davo_tpu.models.flownet import FlowNetLite

        def est_params(cfg):
            net = FlowNetLite(cfg)
            params = net.init(
                jax.random.key(0), batch["target"], batch["sources"][:, 0]
            )
            flows = net.apply(
                params, batch["target"], batch["sources"][:, 0]
            )
            assert len(flows) == cfg.flow_levels - 1
            est = params["params"]["estimator1"]
            return est, sum(
                x.size for x in jtu.tree_leaves(params)
            )

        base_est, base_n = est_params(CFG)
        bn_est, bn_n = est_params(
            dataclasses.replace(CFG, flow_est_bottleneck=8)
        )
        assert "est_in" not in base_est and "est_in" in bn_est
        assert bn_est["est_in"]["Conv_0"]["kernel"].shape[-1] == 8
        assert bn_n < base_n


class TestAttention:
    def test_weights_normalized(self, batch):
        net = RegionAttention(CFG)
        flow = jnp.zeros((2, 64, 96, 2))
        params = net.init(jax.random.key(0), flow)
        w = net.apply(params, flow)
        assert w.shape == (2, 19)
        np.testing.assert_allclose(np.asarray(w.sum(-1)), 19.0, rtol=1e-5)
        assert float(w.min()) >= 0.0

    def test_uniform_weights_are_identity(self, batch):
        """weights == 1 everywhere -> weight map == 1 -> no-op fusion."""
        seg_oh = seg_to_onehot(batch["seg"], 19)
        wmap = region_weight_map(jnp.ones((2, 19)), seg_oh, (4, 6))
        np.testing.assert_allclose(np.asarray(wmap), 1.0, atol=1e-5)

    def test_region_selectivity(self):
        """Down-weighting class k zeroes exactly class-k pixels."""
        seg = jnp.zeros((1, 8, 8), jnp.int32).at[0, :4].set(3)
        seg_oh = seg_to_onehot(seg, 19)
        weights = jnp.ones((1, 19)).at[0, 3].set(0.0)
        wmap = region_weight_map(weights, seg_oh, (8, 8))
        assert float(wmap[0, :4].max()) == 0.0
        assert float(wmap[0, 4:].min()) == 1.0

class TestDavoModel:
    @pytest.mark.parametrize("attention", ["none", "flow", "flow_seg"])
    def test_variants(self, batch, attention):
        cfg = ModelConfig(
            img_height=64,
            img_width=96,
            pose_channels=(8, 12, 16, 16),
            disp_channels=(8, 12, 16, 16),
            flow_levels=3,
            flow_search_range=2,
            attention=attention,
            compute_dtype="float32",
        )
        model = DavoModel(cfg)
        seg = batch["seg"] if attention == "flow_seg" else None
        params = model.init(
            jax.random.key(0), batch["target"], batch["sources"], seg=seg
        )
        out = model.apply(params, batch["target"], batch["sources"], seg=seg)
        assert out["poses"].shape == (2, 2, 6)
        assert len(out["disp"]) == 4
        if attention != "none":
            assert len(out["flows"]) == 2
        if attention == "flow_seg":
            assert out["attn"].shape == (2, 2, 19)

    def test_flow_fb_cue_variant(self, batch):
        """attention_cue="flow_fb": forward runs, outputs keep their
        shapes, and gradient reaches the attention subnet through the
        consistency channel."""
        cfg = ModelConfig(
            img_height=64,
            img_width=96,
            pose_channels=(8, 12, 16, 16),
            disp_channels=(8, 12, 16, 16),
            flow_levels=3,
            flow_search_range=2,
            attention="flow_seg",
            attention_cue="flow_fb",
            compute_dtype="float32",
        )
        model = DavoModel(cfg)
        params = model.init(
            jax.random.key(0), batch["target"], batch["sources"],
            seg=batch["seg"],
        )
        out = model.apply(
            params, batch["target"], batch["sources"], seg=batch["seg"]
        )
        assert out["poses"].shape == (2, 2, 6)
        assert out["attn"].shape == (2, 2, 19)

        def attn_sum(p):
            o = model.apply(
                p, batch["target"], batch["sources"], seg=batch["seg"]
            )
            return (o["attn"] ** 2).sum()

        g = jax.grad(attn_sum)(params)
        leaves = jax.tree.leaves(
            g["params"]["attn"] if "attn" in g["params"] else g
        )
        assert any(float(jnp.abs(x).max()) > 0 for x in leaves)

    def test_fb_consistency_zero_for_inverse_uniform_flows(self):
        """The gating arithmetic itself: when bwd == -fwd (uniform
        fields), |fwd(x) + bwd(x + fwd(x))| must be exactly 0 — rigid
        co-visible pixels produce no occlusion signal."""
        from davo_tpu.core.warp import flow_warp_separable

        fwd = jnp.full((1, 16, 24, 2), 1.5, jnp.float32)
        bwd = -fwd
        bwd_at_fwd, _ = flow_warp_separable(bwd, fwd)
        fb_mag = jnp.linalg.norm(fwd + bwd_at_fwd, axis=-1)
        # Interior pixels (edge-clamped samples differ at the border).
        assert float(jnp.abs(fb_mag[:, 3:-3, 3:-3]).max()) < 1e-5

    def test_inference_mode_skips_disp(self, batch):
        model = DavoModel(CFG._replace_attention("none") if hasattr(CFG, "_replace_attention") else ModelConfig(
            img_height=64, img_width=96,
            pose_channels=(8, 12, 16, 16), disp_channels=(8, 12, 16, 16),
            flow_levels=3, flow_search_range=2, attention="none",
            compute_dtype="float32",
        ))
        params = model.init(
            jax.random.key(0), batch["target"], batch["sources"], train=True
        )
        out = model.apply(
            params, batch["target"], batch["sources"], train=False
        )
        assert "disp" not in out

    def test_bf16_compute_f32_output(self, batch):
        cfg = ModelConfig(
            img_height=64, img_width=96,
            pose_channels=(8, 12, 16, 16), disp_channels=(8, 12, 16, 16),
            flow_levels=3, flow_search_range=2, attention="none",
            compute_dtype="bfloat16",
        )
        model = DavoModel(cfg)
        params = model.init(jax.random.key(0), batch["target"], batch["sources"])
        # Params stored f32.
        for leaf in jax.tree_util.tree_leaves(params):
            assert leaf.dtype == jnp.float32
        out = model.apply(params, batch["target"], batch["sources"])
        assert out["poses"].dtype == jnp.float32
        assert out["disp"][0].dtype == jnp.float32


class TestS2dFirstConv:
    """conv_same_stride2_s2d is an algebraic rewrite of the SAME
    stride-2 conv: same params, bit-comparable output (f32)."""

    @pytest.mark.parametrize("k,C,O", [(3, 3, 16), (5, 9, 16), (7, 9, 16)])
    def test_convblock_s2d_equality(self, k, C, O):
        from davo_tpu.models.common import ConvBlock

        x = jnp.asarray(
            np.random.default_rng(0).normal(size=(2, 24, 32, C)),
            jnp.float32,
        )
        plain = ConvBlock(O, k, 2, jnp.float32)
        params = plain.init(jax.random.PRNGKey(1), x)
        y0 = plain.apply(params, x)
        y1 = ConvBlock(O, k, 2, jnp.float32, s2d=True).apply(params, x)
        assert y1.shape == y0.shape
        np.testing.assert_allclose(y1, y0, atol=1e-5, rtol=1e-5)

    def test_full_model_s2d_equality(self):
        import dataclasses

        from davo_tpu.models import presets
        from davo_tpu.models.davo import DavoModel

        base = presets.get("tiny").model
        cfg0 = dataclasses.replace(base, compute_dtype="float32")
        cfg1 = dataclasses.replace(cfg0, s2d_first_conv=True)
        rng = np.random.default_rng(2)
        tgt = jnp.asarray(rng.uniform(size=(2, 48, 64, 3)), jnp.float32)
        src = jnp.asarray(rng.uniform(size=(2, 1, 48, 64, 3)), jnp.float32)
        seg = jnp.asarray(rng.integers(0, 19, (2, 48, 64)), jnp.int32)
        m0, m1 = DavoModel(cfg0), DavoModel(cfg1)
        params = m0.init(jax.random.PRNGKey(0), tgt, src, seg=seg)
        p0 = m0.apply(params, tgt, src, seg=seg, train=False)["poses"]
        p1 = m1.apply(params, tgt, src, seg=seg, train=False)["poses"]
        np.testing.assert_allclose(p1, p0, atol=1e-5, rtol=1e-5)
