"""Entry-point guards: the compile-cache location, and `chip_smoke.py` /
`bench.py` refusing to run without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from davo_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_env_var_wins(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set no other


def test_cache_default_is_fixed_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.setup_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_path_is_stable(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert {compile_cache.setup_compile_cache() for _ in range(3)} == {
        compile_cache.DEFAULT_DIR
    }


def _run(args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize(
    "args",
    [["chip_smoke.py"], ["chip_smoke.py", "--multi"], ["bench.py"]],
    ids=["chip_smoke", "chip_smoke-multi", "bench"],
)
def test_refuses_without_gpu(args):
    out = _run(args)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert '"value"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.gpu
def test_cost_volume_kernel_on_gpu():
    """The Triton kernel compiled for the card vs the XLA form at a
    preset width (chip_smoke.py's kernel phase runs all of them)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the Triton kernel has no CPU lowering")
    from davo_tpu.kernels.costvol import cost_volume_pallas, cost_volume_xla

    rng = np.random.default_rng(0)
    f1, f2 = (
        jax.numpy.asarray(rng.normal(size=(8, 32, 104, 32)), np.float32)
        for _ in range(2)
    )
    got = jax.jit(cost_volume_pallas, static_argnums=2)(f1, f2, 4)
    want = jax.jit(cost_volume_xla, static_argnums=2)(f1, f2, 4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
