"""Geometry pass: primary intersection → struct-of-arrays G-buffer.

The reference packs (normal·objID, depth) into an RGBA texel and smuggles
the camera through top-row pixels (geometry.frag:58-72, common.glsl:619-627);
here the G-buffer is an honest SoA pytree and the camera is loop-carried
state — no encode/decode, no NaN normals on miss.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath
from kylespathtracer.render import camera as cam_mod
from kylespathtracer.scene import sdf as sdf_mod
from kylespathtracer.scene.types import Scene
from kylespathtracer.utils.config import RenderConfig
from kylespathtracer.utils import struct


@struct.dataclass
class GBuffer:
    normal: jnp.ndarray  # f32[H,W,3]; zeros on miss (reference stores NaN)
    obj_id: jnp.ndarray  # i32[H,W]; 0 on miss
    depth: jnp.ndarray   # f32[H,W]: march t - eps (geometry.frag:71)
    ray_dir: jnp.ndarray  # f32[H,W,3] primary directions (recomputable; cached)
    curv: jnp.ndarray    # f32[H,W] surface curvature at the hit — computed
    #                      alongside the normal (norcurv); the reference
    #                      recomputes it in the specular pass (specular.frag:46)


def use_tetra_normals(config: RenderConfig) -> bool:
    """Resolve the normal estimator: tetrahedron for march parity, analytic
    closed-form otherwise (scene/normals.py)."""
    if config.normal_mode == "auto":
        return config.intersect_mode == "march"
    return config.normal_mode == "tetra"


def geometry_pass(scene: Scene, camera: cam_mod.Camera, config: RenderConfig
                  ) -> GBuffer:
    """Primary intersection + surface normals at the hits.

    (reference: geometry.frag:66-72; normals are analytic per primitive on
    the fast path, tetrahedron `norcurv` on the march-parity path)
    """
    rd = cam_mod.ray_dirs(camera, config.width, config.height, config.fov)
    ro = jnp.broadcast_to(camera.loc, rd.shape)
    if config.intersect_mode == "analytic":
        from kylespathtracer.scene import intersect as isect
        t, oid = isect.intersect(scene, ro, rd, -1, config.steps)
    else:
        t, oid = sdf_mod.march(scene, ro, rd, -1, config.steps)
    hit = oid > 0
    hl = ro + rd * t[..., None]
    if use_tetra_normals(config):
        n, c = sdf_mod.norcurv(scene, hl)
    else:
        from kylespathtracer.scene import normals as nrm_mod
        n, c = nrm_mod.normal_curv(scene, hl, oid)
    n = jnp.where(hit[..., None], n, 0.0)
    return GBuffer(normal=n, obj_id=oid, depth=t - gmath.EPS, ray_dir=rd, curv=c)
