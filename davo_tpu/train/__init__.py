"""Training: losses, train state/step, checkpointing, metrics.

Reference parity: the loss construction in `<ref>/davo.py`
`build_train_graph` (photometric L1+SSIM across source->target warps,
multi-scale edge-aware disparity smoothness, Adam) — SURVEY.md R4 [H] —
re-designed as pure jitted step functions over optax, with npz
checkpoints (train/checkpoint.py).
"""

from davo_tpu.train.losses import (  # noqa: F401
    photometric_loss,
    smoothness_loss,
    pose_supervision_loss,
    flow_losses,
    total_loss,
)
from davo_tpu.train.loop import (  # noqa: F401
    TrainState,
    create_state,
    make_train_step,
    fit,
)
