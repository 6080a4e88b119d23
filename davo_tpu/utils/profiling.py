"""Profiling harness: jax.profiler traces + wall-clock timing.

SURVEY.md §5 "Tracing / profiling": trace contexts around train/eval
steps (TensorBoard/Perfetto-readable), plus a robust `timed` helper —
a single timing loop can be contaminated by secondary compiles and
program-load costs, so `timed` reports the min over several loops.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler trace into `log_dir`."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, iters: int = 20, loops: int = 5) -> dict:
    """Robust wall-clock timing of a device function.

    Returns {"ms": min-over-loops per-call ms, "all_ms": [...]}.
    Blocks on the final output each loop (async dispatch otherwise
    hides device time).
    """
    out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / iters * 1000.0)
    return {"ms": min(times), "all_ms": times}
