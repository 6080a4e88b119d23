"""Checkpoint module: npz-by-tree-path files, atomic writes, pruning."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from davo_tpu.config import Config, ModelConfig, TrainConfig
from davo_tpu.train.checkpoint import CheckpointManager, load_tree, save_tree
from davo_tpu.train.loop import (
    TrainState,
    create_state,
    make_checkpoint_manager,
    restore_checkpoint,
    save_checkpoint,
)

CFG = Config(
    model=ModelConfig(
        img_height=32, img_width=48, pose_channels=(8, 8),
        disp_channels=(8, 8), num_scales=2, flow_levels=2,
        flow_search_range=1, attention="none", compute_dtype="float32",
    ),
    train=TrainConfig(batch_size=2),
)


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(0)
    batch = {
        "target": rng.uniform(size=(2, 32, 48, 3)).astype(np.float32),
        "sources": rng.uniform(size=(2, 2, 32, 48, 3)).astype(np.float32),
    }
    _, st, tx = create_state(CFG, jax.random.key(0), batch)
    # A non-trivial optimizer state: one Adam update of fake grads.
    grads = jax.tree.map(jnp.ones_like, st.params)
    _, opt_state = tx.update(grads, st.opt_state, st.params)
    return TrainState(params=st.params, opt_state=opt_state,
                      step=jnp.asarray(7, jnp.int32))


def _assert_same(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_train_state_roundtrip_is_exact(state, tmp_path):
    mngr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mngr, state)
    template = jax.tree.map(jnp.zeros_like, state)
    restored = restore_checkpoint(mngr, template)
    assert isinstance(restored, TrainState)
    assert int(restored.step) == 7
    _assert_same(restored, state)


def test_max_to_keep_prunes_oldest(tmp_path):
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 5, 3, 9):
        mngr.save(step, {"w": np.full((2,), step, np.float32)})
    assert mngr.all_steps() == [5, 9]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_5.npz", "ckpt_9.npz"]


def test_latest_step_and_empty_dir(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "new"))
    assert mngr.latest_step() is None
    assert restore_checkpoint(mngr, {"w": np.zeros(2)}) is None
    mngr.save(4, {"w": np.arange(2.0)})
    mngr.save(12, {"w": np.arange(2.0) + 1})
    assert mngr.latest_step() == 12
    np.testing.assert_array_equal(
        restore_checkpoint(mngr, {"w": np.zeros(2)})["w"], [1.0, 2.0]
    )


def test_torn_temp_file_is_ignored(tmp_path):
    """A save killed mid-write leaves only `<name>.tmp`: it is neither
    listed nor restored, and the previous checkpoint stays readable."""
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(3, {"w": np.ones(3, np.float32)})
    (tmp_path / "ckpt_8.npz.tmp").write_bytes(b"PK\x03\x04 torn")
    assert mngr.latest_step() == 3
    got = mngr.restore(3, {"w": np.zeros(3, np.float32)})
    np.testing.assert_array_equal(got["w"], np.ones(3, np.float32))


@pytest.mark.parametrize(
    "template",
    [
        {"w": np.zeros(3, np.float32), "extra": np.zeros(1, np.float32)},
        {"w": np.zeros(4, np.float32)},
        {"w": np.zeros(3, np.int32)},
    ],
    ids=["missing-key", "shape", "dtype"],
)
def test_mismatched_template_is_refused(tmp_path, template):
    path = str(tmp_path / "t.npz")
    save_tree(path, {"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="template"):
        load_tree(path, template)


def test_segnet_roundtrip(tmp_path):
    from davo_tpu.models.segnet import SegNetLite, load_segnet, save_segnet

    model = SegNetLite(num_classes=5, channels=(4, 8), compute_dtype="float32")
    x = jnp.asarray(
        np.random.default_rng(1).uniform(size=(1, 16, 16, 3)), jnp.float32
    )
    params = model.init(jax.random.key(3), x)
    save_segnet(str(tmp_path), model, params)
    model2, params2 = load_segnet(str(tmp_path))
    assert (model2.num_classes, model2.channels) == (5, (4, 8))
    _assert_same(params2, params)
    np.testing.assert_array_equal(
        np.asarray(model2.apply(params2, x)), np.asarray(model.apply(params, x))
    )
