"""kylespathtracer — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the *capabilities* of
CamelCaseKyle/KylesPathtracer (a GLSL/OpenGL real-time MIS path tracer with
temporal reprojection): analytic-scene intersection, MIS-weighted BSDF +
light sampling, low-discrepancy per-pixel RNG, diffuse/specular
temporal-reprojection accumulation — made differentiable (pixel gradients
flow to scene parameters) and multi-device sharded (pixel tiles over a
`jax.sharding.Mesh`, scene-parameter grads all-reduced across devices).

Layering (bottom-up):
  core/      pure math + sampler + color toolkit (ref: common.glsl:33-196)
  scene/     parameterized scene pytree, SDF + analytic intersection,
             materials (ref: common.glsl:199-295)
  render/    wavefront passes: camera/raygen, G-buffer, MIS estimators,
             temporal reprojection, composite (ref: *.frag)
  diff/      inverse rendering (gradient descent on scene params)
  parallel/  mesh + shard_map sharding of the pixel grid, grad psum
  ops/       the fused frame: Pallas/Triton kernel, XLA twin, custom VJP
  utils/     config, metrics, checkpointing
  cpu_reference/  NumPy twin of every math component, the golden oracle
"""

from kylespathtracer.utils.config import RenderConfig
from kylespathtracer.scene.scene import Scene, default_scene
from kylespathtracer.render.pipeline import (
    History,
    Camera,
    init_history,
    render_frame,
    render_image,
)
from kylespathtracer.render.wavefront import pathtrace, render_pathtraced
from kylespathtracer.scene.scene import sphere_scene
from kylespathtracer.scene.types import BSDF

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Scene",
    "default_scene",
    "History",
    "Camera",
    "init_history",
    "render_frame",
    "render_image",
    "pathtrace",
    "render_pathtraced",
    "sphere_scene",
    "BSDF",
]
