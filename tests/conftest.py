"""Test config: run on a virtual 8-device CPU mesh, except on the card.

Multi-device sharding logic is exercised without accelerators via
`--xla_force_host_platform_device_count` (the "fake backend" layer; see
SURVEY.md §4). JAX is held to the CPU before its first operation.

Tests marked `gpu` need the card: they skip here (in a fixture, never at
import time) and run through chip_smoke.py, which calls pytest in its own
process with KPT_TESTS_ON_DEVICE=1 after JAX has opened the GPU; the CPU
setup below is then left alone.
"""

import os

import pytest

ON_DEVICE = os.environ.get("KPT_TESTS_ON_DEVICE") == "1"

if not ON_DEVICE:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: runs on the card through chip_smoke.py")
