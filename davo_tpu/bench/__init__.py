"""Benchmark harnesses: throughput, scaling efficiency, analytic FLOP
counts (SURVEY.md §7.1 step 10)."""

from davo_tpu.bench.throughput import bench_inference, bench_train_step  # noqa: F401
from davo_tpu.bench.scaling import scaling_efficiency  # noqa: F401
from davo_tpu.bench.sol import model_flops  # noqa: F401
