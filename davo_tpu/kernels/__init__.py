"""Kernels for the hot ops, each beside the plain XLA form it is tested
against.

`costvol.cost_volume` runs a Pallas Triton kernel when lowering for
CUDA and the XLA form elsewhere; `resize` and `sample` are plain JAX.
"""

from davo_tpu.kernels.costvol import cost_volume, cost_volume_xla  # noqa: F401
from davo_tpu.kernels.sample import bilinear_sample_matmul  # noqa: F401
from davo_tpu.kernels.resize import upsample2x_bilinear, resize_bilinear_aligned  # noqa: F401
