"""Where JAX keeps its persistent compilation cache.

The cache is keyed by its path, so the path must not move between runs:
`JAX_COMPILATION_CACHE_DIR` when it is set, otherwise one fixed
directory inside the checkout (`<repo>/.jax_cache`).
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory.

    JAX reads `JAX_COMPILATION_CACHE_DIR` itself, so when it is set no
    other directory is configured."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
