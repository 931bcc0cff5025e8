"""The platform table (ops/platform.py): the one place the code chooses an
implementation by the platform it runs on."""

import pytest

from kylespathtracer.ops import platform


def test_cpu_maps_to_xla():
    assert platform.frame_forward_impl("cpu") == "xla"
    assert platform.default_pipeline("cpu") == "pass"
    # The test process runs on the CPU backend: the default lookup agrees.
    assert platform.frame_forward_impl() == "xla"


def test_gpu_maps_to_triton():
    assert platform.frame_forward_impl("gpu") == "triton"
    assert platform.default_pipeline("gpu") == "fused"


@pytest.mark.parametrize("lookup", ["frame_forward_impl", "default_pipeline"])
def test_unknown_platform_raises(lookup):
    with pytest.raises(ValueError, match="no .* for platform 'metal'"):
        getattr(platform, lookup)("metal")
