"""Benchmark harness: flagship VO inference throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
naming the device it ran on. Exits non-zero, printing no number, when
JAX finds no GPU.

Metric: frames/s of streaming pose inference (full DAVO forward —
flow + attention + pose — over consecutive frame pairs), the
reference's `test_kitti_pose.py` hot loop (SURVEY.md §3.2), for the
`davo-fast` serving preset, with the paper-parity `davo` preset on the
same line. `vs_baseline` is measured against BASELINE_FPS below
(reference single-GPU throughput; unverifiable — see BASELINE.md — so
a conservative 2020-era single-GPU estimate is used until the real
number is obtainable).

Run on the card: `python bench.py`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Reference DAVO (TF1, single 2020-era GPU) streaming pose inference.
# Placeholder until the reference can be run (BASELINE.md): PWC-flow +
# attention + pose at 128x416 on a GTX-1080-class GPU ~ O(15) fps.
BASELINE_FPS = 15.0

BATCH = 256
WARMUP = 2
# Calls chained per timed loop, so that host dispatch overlaps device
# work as it does in steady-state streaming.
ITERS = 32
LOOPS = 5  # min, median and spread over the loops are reported


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_loops(fn, args, loops: int) -> list[float]:
    for _ in range(WARMUP):
        fn(*args).block_until_ready()
    times = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn(*args)
        out.block_until_ready()
        times.append(time.perf_counter() - t0)
    return times


def _serving_fn(preset: str, targets, sources, seg):
    import jax

    from davo_tpu.models import presets
    from davo_tpu.models.davo import DavoModel

    model = DavoModel(presets.get(preset).model)
    # train=False: inference needs no DispNet params.
    params = jax.jit(model.init, static_argnames=("train",))(
        jax.random.key(0), targets, sources, seg=seg, train=False
    )

    @jax.jit
    def infer(targets, sources, seg):
        return model.apply(params, targets, sources, seg=seg, train=False)[
            "poses"
        ]

    return infer


def main() -> int:
    import jax
    import jax.numpy as jnp

    from davo_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (platform {dev.platform!r}); refusing to "
              "measure", file=sys.stderr)
        return 1

    from davo_tpu.models import presets

    cfg = presets.get("davo-fast").model
    rng = np.random.default_rng(0)
    H, W = cfg.img_height, cfg.img_width
    targets = jnp.asarray(rng.uniform(size=(BATCH, H, W, 3)), jnp.float32)
    sources = jnp.asarray(rng.uniform(size=(BATCH, 1, H, W, 3)), jnp.float32)
    seg = jnp.asarray(rng.integers(0, 19, (BATCH, H, W)), jnp.int32)
    args = (targets, sources, seg)

    times = _time_loops(_serving_fn("davo-fast", *args), args, LOOPS)
    best = min(times)
    med = float(np.median(times))
    fps = BATCH * ITERS / best
    ptimes = _time_loops(_serving_fn("davo", *args), args, 3)

    print(json.dumps({
        "metric": "pose_infer_frames_per_s",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "median": round(BATCH * ITERS / med, 2),
        "spread_pct": round(100.0 * (max(times) - best) / best, 1),
        "loops": LOOPS,
        "davo_preset_fps": round(BATCH * ITERS / min(ptimes), 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu": gpu_name_and_power_limit(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
