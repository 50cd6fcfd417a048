"""Test environment: the CPU with 8 virtual devices.

This makes mesh/sharding/collective tests (SURVEY §4 "Distributed")
runnable anywhere; the trace kernel runs in Pallas interpret mode
there (`sphereflake.backend.kernel_route`). Tests that need an NVIDIA
GPU are marked `gpu` and take the `gpu` fixture, which skips them
unless JAX's default backend is a GPU (``JAX_PLATFORMS=cuda``);
`chip_smoke.py` runs the same checks as its phases on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from sphereflake.backend import setup_compile_cache  # noqa: E402

# The suite compiles ~100 sizeable XLA programs (shard_map meshes,
# interpret-mode kernels); the persistent cache cuts re-runs.
setup_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless this process computes on an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this check "
                    "on the card)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop in-memory compiled executables between test modules: a
    50-minute single-process run accumulated enough XLA state to
    segfault the CPU compiler around the 95th test."""
    yield
    jax.clear_caches()
