"""SegNetLite: the in-repo segmentation source for the flow_seg cue.

The reference consumes *precomputed* DeepLab masks it never produces
(SURVEY.md R8 [M]: `<ref>/data_loader.py` loads per-frame Cityscapes
19-class label maps from disk). That leaves a hole this module closes
(SURVEY.md §7.2 risk item): a lightweight encoder-decoder trained
in-repo on synthetic GT labels, so `cli prep --write-seg` can stamp
`*_seg.png` onto ANY prepared tree — the full flow_seg model then
trains from masks the framework itself generated, no external network
or weights required.

Architecture mirrors DispNet's conv family (stride-2 ConvBlock encoder,
skip-connected nearest-upsample decoder) at a fraction of the width —
segmentation for attention cueing needs region shapes, not boundary
precision. NHWC, bf16 compute / f32 params, gather-free upsampling.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp

from davo_tpu.models import layers
from davo_tpu.models.common import ConvBlock, dtype_of, resize_nearest


class SegNetLite(layers.Module):
    """Per-pixel class logits: (B, H, W, 3) -> (B, H, W, num_classes)."""

    num_classes: int = 19
    channels: tuple = (16, 32, 64, 128)
    compute_dtype: str = "bfloat16"

    @layers.compact
    def __call__(self, img: jnp.ndarray) -> jnp.ndarray:
        dt = dtype_of(self.compute_dtype)
        x = img.astype(dt)
        skips = []
        for i, ch in enumerate(self.channels):
            k = 7 if i == 0 else 3
            x = ConvBlock(ch, k, 2, dt, name=f"enc{i}")(x)
            x = ConvBlock(ch, 3, 1, dt, name=f"enc{i}b")(x)
            skips.append(x)
        full_hw = (img.shape[1], img.shape[2])
        up_channels = list(self.channels[::-1][1:]) + [self.channels[0]]
        for i, ch in enumerate(up_channels):
            skip_idx = len(self.channels) - 2 - i
            target_hw = (
                (skips[skip_idx].shape[1], skips[skip_idx].shape[2])
                if skip_idx >= 0
                else full_hw
            )
            x = resize_nearest(x, target_hw)
            x = ConvBlock(ch, 3, 1, dt, name=f"dec{i}")(x)
            if skip_idx >= 0:
                x = jnp.concatenate([x, skips[skip_idx]], axis=-1)
            x = ConvBlock(ch, 3, 1, dt, name=f"dec{i}b")(x)
        logits = layers.Conv(
            self.num_classes, (3, 3), padding="SAME", dtype=dt,
            param_dtype=jnp.float32, name="head",
        )(x)
        return logits.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Checkpoint I/O: npz params + json meta — self-contained, no
# training-state baggage (prep-time inference needs params only).
# ---------------------------------------------------------------------------

def save_segnet(directory: str, model: SegNetLite, params) -> None:
    from davo_tpu.train.checkpoint import save_tree

    os.makedirs(directory, exist_ok=True)
    save_tree(os.path.join(directory, "segnet.npz"), params)
    with open(os.path.join(directory, "segnet.json"), "w") as f:
        json.dump(
            {
                "num_classes": model.num_classes,
                "channels": list(model.channels),
                "compute_dtype": model.compute_dtype,
            },
            f,
        )
        f.write("\n")


def load_segnet(directory: str) -> tuple[SegNetLite, dict]:
    from davo_tpu.train.checkpoint import load_tree

    with open(os.path.join(directory, "segnet.json")) as f:
        meta = json.load(f)
    model = SegNetLite(
        num_classes=meta["num_classes"],
        channels=tuple(meta["channels"]),
        compute_dtype=meta["compute_dtype"],
    )
    # Parameter shapes do not depend on the image size: a template
    # traced at a tiny shape (no compute) fixes the tree to restore.
    template = jax.eval_shape(
        model.init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32),
    )
    params = load_tree(os.path.join(directory, "segnet.npz"), template)
    return model, params


def make_seg_infer(directory: str):
    """Jitted batched labeler: (B, H, W, 3) float [0,1] -> (B, H, W) u8."""
    model, params = load_segnet(directory)

    @jax.jit
    def infer(img):
        return jnp.argmax(model.apply(params, img), axis=-1).astype(
            jnp.uint8
        )

    return infer
