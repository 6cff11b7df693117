"""Test harness config.

By default the suite runs on the CPU with 8 virtual devices (the sharding
tests need a mesh).  The environment is only defaulted, never overridden, so
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the card-only
tests on a GPU.  Must set the env vars BEFORE jax is imported anywhere.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Compilation dominates the suite's wall time; a repo-local persistent cache
# (gitignored) makes reruns load this host's entries instead of recompiling.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    ),
)
# cache every compile, not just the >1 s ones (the suite's cost is the long
# tail of mid-size programs)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked ``gpu`` run only where JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda -m gpu)")
