"""Model zoo: DispNet / PoseNet / FlowNet / dynamic region attention.

Re-designs of the reference networks (`<ref>/nets.py`, SURVEY.md
R5-R7) on the small module layer of `models/layers.py`. Conventions
shared by every module here:

* NHWC activations.
* Parameters are float32; compute runs in `compute_dtype` (bfloat16 by
  default) so convolutions run on the tensor cores; outputs that feed
  geometry (poses, disparities) are cast back to float32.
* No transposed convs: decoders upsample with nearest-resize + conv
  (identical receptive field, simpler lowering).
* Static shapes everywhere; variants are selected by config, not
  runtime branching.
"""

from davo_tpu.models.posenet import PoseNet  # noqa: F401
from davo_tpu.models.dispnet import DispNet, disp_to_depth  # noqa: F401
from davo_tpu.models.flownet import FlowNetLite  # noqa: F401
from davo_tpu.models.attention import RegionAttention  # noqa: F401
from davo_tpu.models.davo import DavoModel  # noqa: F401
