"""The fused frame forward (ops/frame_kernel.py): the Triton kernel in
interpret mode against its XLA twin at ragged sizes and in tile mode, and
the kernel's lowering for CUDA at full size, which needs no card and
catches primitives and shapes the GPU route cannot take."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kylespathtracer.ops import frame_kernel as fk
from kylespathtracer.render.camera import Camera
from kylespathtracer.scene import default_scene
from kylespathtracer.utils.config import RenderConfig

SCENE = default_scene()
CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
FRAME = jnp.asarray(3, jnp.int32)
PLANES = ("add_d", "add_s", "alb", "ene", "depth", "curv")


def _assert_planes_close(got, ref):
    assert (np.asarray(got["oid"]) == np.asarray(ref["oid"])).all()
    for k in PLANES:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(ref[k]), atol=2e-5, rtol=1e-5,
            err_msg=k,
        )


def test_triton_interpret_matches_jnp_ragged_width():
    """Width 72 and height 10 are multiples of neither block dimension:
    the padded grid and the crop must give frame_forward_jnp's planes."""
    cfg = RenderConfig(width=72, height=10)
    got = fk.frame_forward_pallas(SCENE, CAM, FRAME, cfg, block=(8, 64),
                                  interpret=True)
    _assert_planes_close(got, fk.frame_forward_jnp(SCENE, CAM, FRAME, cfg))


@pytest.mark.parametrize("impl", ["triton-interpret", "xla"])
def test_tile_mode_matches_crop(impl):
    """row_base/rows render rows [row_base, row_base+rows) with the full
    image's NDC and seeds: the tile equals that crop of the full frame."""
    cfg = RenderConfig(width=64, height=24)
    row_base, rows = 8, 8
    full = fk.frame_forward_jnp(SCENE, CAM, FRAME, cfg)
    if impl == "xla":
        tile = fk.frame_forward_jnp(SCENE, CAM, FRAME, cfg,
                                    row_base=row_base, rows=rows)
    else:
        tile = fk.frame_forward_pallas(SCENE, CAM, FRAME, cfg, block=(8, 64),
                                       interpret=True, row_base=row_base,
                                       rows=rows)
    crop = {k: v[row_base:row_base + rows] for k, v in full.items()}
    _assert_planes_close(tile, crop)


def test_block_must_be_powers_of_two():
    cfg = RenderConfig(width=64, height=8)
    with pytest.raises(ValueError, match="powers of two"):
        fk.frame_forward_pallas(SCENE, CAM, FRAME, cfg, block=(3, 64),
                                interpret=True)


def test_kernel_lowers_for_cuda_at_1080p():
    """The Triton-route kernel lowers for CUDA at 1920x1080 with the
    default block, in the full quality config (soft shadows on)."""
    cfg = RenderConfig(width=1920, height=1080, soft_shadows=0.05)
    lowered = jax.jit(
        lambda s, c, f: fk.frame_forward_pallas(s, c, f, cfg)
    ).trace(SCENE, CAM, FRAME).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "frame_forward" in text
