"""The fused frame kernel's real `pallas_call` (Triton route, interpret
mode) in the default gate.

The kernel runs its actual `pl.pallas_call` at a tiny multi-block
resolution and is checked against its jnp twin, so a BlockSpec, operand
order, grid or padding regression is caught by `pytest` on the CPU. What
the card's Triton compiler says is checked by tests/test_gpu.py on the card
and, short of the card, by the CUDA lowering in tests/test_frame_kernel.py.
"""

import numpy as np
import jax.numpy as jnp

from kylespathtracer.ops import frame_kernel as fk
from kylespathtracer.render.camera import Camera
from kylespathtracer.scene import default_scene
from kylespathtracer.utils.config import RenderConfig

SCENE = default_scene()
CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
FRAME = jnp.asarray(0, jnp.int32)
PLANES = ("add_d", "add_s", "alb", "ene", "depth", "curv")


def test_frame_kernel_pallas_call():
    """Fused forward kernel (2x1 grid of (8,128) blocks) ==
    frame_forward_jnp."""
    cfg = RenderConfig(width=128, height=16)
    out = fk.frame_forward_pallas(SCENE, CAM, FRAME, cfg, block=(8, 128),
                                  interpret=True)
    ref = fk.frame_forward_jnp(SCENE, CAM, FRAME, cfg)
    for k in PLANES:
        np.testing.assert_allclose(
            np.asarray(out[k]), np.asarray(ref[k]), atol=2e-5, err_msg=k
        )
    assert (np.asarray(out["oid"]) == np.asarray(ref["oid"])).all()


def test_frame_kernel_column_blocks():
    """Block shape and padding: two block shapes over a width and height
    neither divides (row and column padding, the j-grid col0 offset and
    the crop) give the same planes, to float-association ulps, as each
    other; the planes have the image's shape."""
    cfg = RenderConfig(width=80, height=12)
    a = fk.frame_forward_pallas(SCENE, CAM, FRAME, cfg, block=(8, 64),
                                interpret=True)
    b = fk.frame_forward_pallas(SCENE, CAM, FRAME, cfg, block=(16, 32),
                                interpret=True)
    assert a["oid"].shape == (12, 80) and a["add_d"].shape == (12, 80, 3)
    assert (np.asarray(a["oid"]) == np.asarray(b["oid"])).all()
    for k in PLANES:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(
            np.asarray(a[k]), np.asarray(b[k]), atol=2e-5, rtol=1e-5,
            err_msg=k,
        )
