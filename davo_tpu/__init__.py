"""davo_tpu — a learned visual-odometry engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
BassyKuo/DAVO reference (Dynamic Attention-based Visual Odometry):
DispNet-style depth, PoseNet 6-DoF regression, dynamic 19-region
attention fusing flow/segmentation cues, photometric training, KITTI
odometry evaluation, plus a distributed sliding-window bundle-adjustment
backend (mesh sharding, shard_map).

Layer map (mirrors SURVEY.md §7.3):
  core/     SE(3)/SO(3) geometry, camera models, warping, SSIM, pyramids
  data/     KITTI readers, offline prep, synthetic sequences, prefetch
  models/   DispNet / PoseNet / FlowNet / AttentionNet (models/layers)
  kernels/  cost volume (Pallas Triton on CUDA), resize, sampler
  train/    losses, train step, checkpointing, metrics
  ba/       sliding-window bundle adjustment (GN + Schur + PCG), pose graph
  dist/     device mesh, sharding rules, collectives, multihost bootstrap
  eval/     trajectory assembly, ATE / t_err / r_err (Python + C++ devkit)
  bench/    throughput + roofline harnesses
  cli/      command-line entry points
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry / BA math must be exact f32: an accelerator's default matmul
# precision may downcast f32 inputs (TF32 or bf16-class error, ~5e-4),
# which is fatal for SE(3) chains and Schur solves. The model hot path
# opts into speed explicitly by feeding bf16 operands, which this
# setting does not affect.
_jax.config.update("jax_default_matmul_precision", "float32")
