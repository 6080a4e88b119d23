"""The in-repo module layer against Flax linen as an oracle.

The model files are imported a second time with `davo_tpu.models.layers`
replaced by Flax's `Module`/`compact`/`Conv`/`Dense`, which gives a Flax
twin of every model built from the same source. Both twins must build
the same parameter tree (paths and shapes) and, for the same
parameters, compute the same outputs.
"""

import contextlib
import dataclasses
import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from davo_tpu.config import ModelConfig
from davo_tpu.models import presets

_MODEL_MODULES = (
    "common", "posenet", "dispnet", "flownet", "attention", "davo", "segnet",
)


@contextlib.contextmanager
def _swapped_layers(shim):
    pkg = importlib.import_module("davo_tpu.models")
    names = ["davo_tpu.models.layers"] + [
        f"davo_tpu.models.{m}" for m in _MODEL_MODULES
    ]
    saved = {n: sys.modules.get(n) for n in names}
    saved_attrs = {n: getattr(pkg, n.rsplit(".", 1)[1], None) for n in names}
    try:
        for n in names:
            sys.modules.pop(n, None)
        sys.modules["davo_tpu.models.layers"] = shim
        pkg.layers = shim
        yield {m: importlib.import_module(f"davo_tpu.models.{m}")
               for m in _MODEL_MODULES}
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
        for n, attr in saved_attrs.items():
            if attr is not None:
                setattr(pkg, n.rsplit(".", 1)[1], attr)


@pytest.fixture(scope="module")
def twins():
    """(ours, flax): dicts of model modules built on each layer."""
    nn = pytest.importorskip("flax.linen")
    shim = types.ModuleType("flax_layers")
    shim.Module, shim.compact = nn.Module, nn.compact
    shim.Conv, shim.Dense = nn.Conv, nn.Dense
    ours = {m: importlib.import_module(f"davo_tpu.models.{m}")
            for m in _MODEL_MODULES}
    with _swapped_layers(shim) as theirs:
        pass
    return ours, theirs


def _tree_sig(tree):
    return sorted(
        (jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    )


def _assert_close(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_allclose(
            np.asarray(x, np.float32), np.asarray(y, np.float32),
            rtol=1e-5, atol=1e-5,
        )


H, W = 32, 64


def _inputs(seed=0, b=2, s=1):
    rng = np.random.default_rng(seed)
    tgt = jnp.asarray(rng.uniform(size=(b, H, W, 3)), jnp.float32)
    src = jnp.asarray(rng.uniform(size=(b, s, H, W, 3)), jnp.float32)
    seg = jnp.asarray(rng.integers(0, 19, (b, H, W)), jnp.int32)
    return tgt, src, seg


def _compare(ours_mod, flax_mod, args, kwargs=None, check=("tree", "out")):
    kwargs = kwargs or {}
    ours_vars = ours_mod.init(jax.random.key(0), *args, **kwargs)
    flax_vars = flax_mod.init(jax.random.key(0), *args, **kwargs)
    assert set(ours_vars) == set(flax_vars) == {"params"}
    if "tree" in check:
        assert _tree_sig(ours_vars) == _tree_sig(flax_vars)
    if "out" in check:
        _assert_close(
            ours_mod.apply(ours_vars, *args, **kwargs),
            flax_mod.apply(ours_vars, *args, **kwargs),
        )


@pytest.mark.parametrize("mode", ["tree", "infer", "train"])
@pytest.mark.parametrize("preset", presets.available())
def test_preset_matches_flax(twins, preset, mode):
    ours, theirs = twins
    cfg = dataclasses.replace(
        presets.get(preset).model, img_height=H, img_width=W
    )
    tgt, src, seg = _inputs()
    kw = {"seg": seg if cfg.attention == "flow_seg" else None}
    m_ours = ours["davo"].DavoModel(cfg)
    m_flax = theirs["davo"].DavoModel(cfg)
    if mode == "tree":
        _compare(m_ours, m_flax, (tgt, src), kw, check=("tree",))
        return
    kw["train"] = mode == "train"
    if mode == "train":
        kw["source_disp"] = True
    _compare(m_ours, m_flax, (tgt, src), kw, check=("out",))


_CFG = ModelConfig(
    img_height=H, img_width=W, pose_channels=(8, 16, 16),
    disp_channels=(8, 16, 16), flow_levels=3, flow_search_range=2,
    costvol_feat_channels=4, attention="flow_seg", compute_dtype="float32",
)


def _standalone_cases():
    x = np.random.default_rng(1).uniform(size=(2, H, W, 3)).astype(np.float32)
    x = jnp.asarray(x)
    pair = jnp.concatenate([x, x[::-1], x[:, :, :, :1]], axis=-1)
    flow = jnp.asarray(
        np.random.default_rng(2).normal(size=(2, H, W, 2)), jnp.float32
    )
    return {
        "ConvBlock": (lambda m: m["common"].ConvBlock(8, 3, 2, jnp.float32), (x,)),
        "ConvBlock_s2d": (
            lambda m: m["common"].ConvBlock(8, 7, 2, jnp.float32, s2d=True),
            (x,),
        ),
        "ResBlock": (lambda m: m["dispnet"].ResBlock(8, 2, jnp.float32), (x,)),
        "PoseEncoder": (lambda m: m["posenet"].PoseEncoder(_CFG), (pair,)),
        "PoseHead": (lambda m: m["posenet"].PoseHead(_CFG), (x,)),
        "PoseNet": (lambda m: m["posenet"].PoseNet(_CFG), (x, x[::-1])),
        "FeaturePyramid": (lambda m: m["flownet"].FeaturePyramid(_CFG), (x,)),
        "FlowEstimator": (
            lambda m: m["flownet"].FlowEstimator(_CFG),
            (x[..., :2], x, flow),
        ),
        "FlowNetLite": (lambda m: m["flownet"].FlowNetLite(_CFG), (x, x[::-1])),
        "RegionAttention": (
            lambda m: m["attention"].RegionAttention(_CFG), (flow,)
        ),
        "DispNet": (lambda m: m["dispnet"].DispNet(_CFG), (x,)),
        "DispNet_resnet": (
            lambda m: m["dispnet"].DispNet(
                dataclasses.replace(_CFG, disp_encoder="resnet")
            ),
            (x,),
        ),
        "SegNetLite": (
            lambda m: m["segnet"].SegNetLite(
                channels=(8, 16), compute_dtype="float32"
            ),
            (x,),
        ),
    }


@pytest.mark.parametrize("check", ["tree", "out"])
@pytest.mark.parametrize("name", sorted(_standalone_cases()))
def test_module_matches_flax(twins, name, check):
    ours, theirs = twins
    build, args = _standalone_cases()[name]
    _compare(build(ours), build(theirs), args, check=(check,))


def test_submodule_apply_on_subtree(twins):
    """A submodule applied standalone to its slice of a parent's params
    (the pipeline and BA-track paths do this) equals the parent's own
    forward of that submodule."""
    ours, _ = twins
    tgt, src, seg = _inputs()
    model = ours["davo"].DavoModel(_CFG)
    params = model.init(jax.random.key(0), tgt, src, seg=seg)["params"]
    fnet = ours["flownet"].FlowNetLite(_CFG)
    flows = fnet.apply({"params": params["flownet"]}, tgt, src[:, 0])
    out = model.apply({"params": params}, tgt, src, seg=seg, train=False)
    _assert_close(flows, out["flows"][0])


def test_unbound_module_raises():
    from davo_tpu.models.layers import Conv

    with pytest.raises(RuntimeError, match="unbound"):
        Conv(4)(jnp.zeros((1, 4, 4, 3)))


def test_init_is_deterministic_and_order_free():
    from davo_tpu.models.layers import Dense

    x = jnp.ones((2, 5))
    a = Dense(3).init(jax.random.key(7), x)
    b = Dense(3).init(jax.random.key(7), x)
    _assert_close(a, b)
    assert float(jnp.abs(a["params"]["bias"]).max()) == 0.0
    c = Dense(3).init(jax.random.key(8), x)
    assert not np.allclose(a["params"]["kernel"], c["params"]["kernel"])
