"""No matrix product on the render or gradient path.

A float32 `dot_general` may run in TF32 on the GPU (about three decimal
digits) unless a precision is asked for. The renderer computes every dot
product as explicit multiply-adds (scene/intersect.py, scene/sdf.py); this
keeps it so for the frame (both pipelines) and the fwd+bwd step."""

import jax
import jax.numpy as jnp
import pytest

from kylespathtracer.diff import inverse
from kylespathtracer.render.camera import Camera
from kylespathtracer.render.pipeline import init_history, render_frame
from kylespathtracer.scene import default_scene
from kylespathtracer.utils.config import RenderConfig

CAM = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
FRAME = jnp.asarray(1, jnp.int32)


def _assert_no_dot(lowered):
    text = lowered.as_text()
    assert "dot_general" not in text and "stablehlo.dot " not in text


@pytest.mark.parametrize("pipeline", ["fused", "pass"])
def test_render_frame_has_no_dot(pipeline):
    cfg = RenderConfig(width=32, height=16, pipeline=pipeline)
    hist = init_history(cfg, CAM)
    _assert_no_dot(
        jax.jit(render_frame, static_argnames=("config",)).lower(
            default_scene(), CAM, hist, FRAME, cfg
        )
    )


@pytest.mark.parametrize("pipeline", ["fused", "pass"])
def test_fwd_bwd_step_has_no_dot(pipeline):
    cfg = RenderConfig(width=32, height=16, pipeline=pipeline,
                       soft_shadows=0.05)
    scene = default_scene()
    params = inverse.extract_params(scene)
    target = jnp.zeros((16, 32, 3), jnp.float32)
    _assert_no_dot(
        jax.jit(jax.value_and_grad(
            lambda p: inverse.loss_fn(p, scene, CAM, target, FRAME, cfg)
        )).lower(params)
    )
