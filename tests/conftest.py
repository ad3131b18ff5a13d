"""Test configuration: run on CPU with 8 virtual devices and float64 enabled.

Must run before jax initialises a backend, hence the env mutation at import
time. Tests marked ``gpu`` need an NVIDIA GPU (the CUDA wavefront kernel has
no CPU mode); they skip elsewhere, and run on a GPU host with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_paths(rng, batch, length, dim, dtype=np.float64, scale=0.3):
    """Smooth-ish random paths (cumsum of small increments)."""
    steps = rng.normal(size=(batch, length, dim)) * scale / np.sqrt(length)
    return np.cumsum(steps, axis=1).astype(dtype)


@pytest.fixture
def paths():
    return make_paths


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` skip unless JAX's first device is a GPU. Decided
    here, at run time: a decision taken while a module is imported can give
    pytest-xdist workers different collections."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                        "python -m pytest tests/ -m gpu")


# ---------------------------------------------------------------------------
# fast / slow split: `pytest -m fast` is the < 5 min iteration gate; the
# full suite (no -m) stays the round gate. Slow = 8-device shard_map tests
# and subprocess-spawning bench smoke tests.
# ---------------------------------------------------------------------------

_SLOW_FILES = {
    "test_sharding.py", "test_bench_smoke.py", "test_uea_cross_impl.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = os.path.basename(str(item.fspath))
        if fname in _SLOW_FILES or item.get_closest_marker("slow"):
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)
