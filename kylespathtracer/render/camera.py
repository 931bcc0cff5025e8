"""Camera model and primary-ray generation.

The reference camera is a position + (pitch, yaw) orientation pushed as
uniforms (main.cpp:126-129) with ray directions built per fragment
(geometry.frag:38-39,67). Here the camera is a tiny pytree and raygen is one
broadcasted expression over the (H, W) pixel grid.

Convention: pixel row 0 is the *bottom* of the image (GL fragCoord), so the
math matches the reference exactly; flip row order only when exporting.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath
from kylespathtracer.utils import struct


@struct.dataclass
class Camera:
    loc: jnp.ndarray     # f32[3]
    orient: jnp.ndarray  # f32[2] (pitch, yaw)

    @classmethod
    def create(cls, loc=(3.0, 2.0, -3.0), orient=(0.0, 0.0)) -> "Camera":
        return cls(
            loc=jnp.asarray(loc, jnp.float32), orient=jnp.asarray(orient, jnp.float32)
        )


def ndc_grid(width: int, height: int, dtype=jnp.float32) -> jnp.ndarray:
    """Aspect-scaled NDC coords of pixel centers; f32[H, W, 2].

    ndca = (2*fragCoord/res - 1) * (aspect, 1) (geometry.frag:38-39).
    """
    asp = width / height
    x = (2.0 * (jnp.arange(width, dtype=dtype) + 0.5) / width - 1.0) * asp
    y = 2.0 * (jnp.arange(height, dtype=dtype) + 0.5) / height - 1.0
    return jnp.stack(jnp.meshgrid(x, y, indexing="xy"), axis=-1)


def ray_dirs(camera: Camera, width: int, height: int, fov: float = gmath.FOV
             ) -> jnp.ndarray:
    """Primary ray directions f32[H, W, 3].

    rd = rotateXY(normalize(vec3(ndca, FOV)), orient) (geometry.frag:67).
    """
    ndca = ndc_grid(width, height)
    d = jnp.concatenate(
        [ndca, jnp.full(ndca.shape[:-1] + (1,), fov, ndca.dtype)], axis=-1
    )
    return gmath.rotate_xy(gmath.normalize_fast(d), camera.orient)


def ray_dirs_window(camera: Camera, width: int, height: int, row0: int,
                    rows: int, fov: float = gmath.FOV) -> jnp.ndarray:
    """Ray directions for image rows [row0, row0+rows) of a height-`height`
    image — the per-device tile of the sharded renderer. Bitwise equal to
    the matching rows of `ray_dirs`."""
    asp = width / height
    dtype = jnp.float32
    x = (2.0 * (jnp.arange(width, dtype=dtype) + 0.5) / width - 1.0) * asp
    y = 2.0 * (row0 + jnp.arange(rows, dtype=dtype) + 0.5) / height - 1.0
    ndca = jnp.stack(jnp.meshgrid(x, y, indexing="xy"), axis=-1)
    d = jnp.concatenate(
        [ndca, jnp.full(ndca.shape[:-1] + (1,), fov, dtype)], axis=-1
    )
    return gmath.rotate_xy(gmath.normalize_fast(d), camera.orient)


def camera_pose_spline(t: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's scripted camera path (geometry.frag:26-55, commented
    out upstream but kept as the benchmark camera): smoothstep between three
    poses on a 6-second loop. Returns (loc[3], orient[2]) for scalar t."""
    poses_loc = jnp.asarray(
        [[4.8, 0.5, -9.5], [4.8, 0.5, -4.8], [-3.5, 2.5, -4.0]], jnp.float32
    )
    poses_or = jnp.asarray(
        [[0.20, 0.85], [0.15, 2.33], [0.10, 1.80]], jnp.float32
    )
    # cLast = poses(t), cNext = poses(t+1), ft = smoothstep(fract(t)) with
    # poses(t) holding each pose for 2 units of t = iTime*0.5 on a 6-unit
    # loop — i.e. hold 1, blend 1, hold 1, ... (geometry.frag:45-55).
    tt = jnp.asarray(t, jnp.float32) * 0.5
    i0 = jnp.floor(jnp.mod(tt, 6.0) / 2.0).astype(jnp.int32)
    i1 = jnp.floor(jnp.mod(tt + 1.0, 6.0) / 2.0).astype(jnp.int32)
    ft = gmath.smoothstep01(tt - jnp.floor(tt))
    loc = gmath.mix(poses_loc[i0], poses_loc[i1], ft)
    orient = gmath.mix(poses_or[i0], poses_or[i1], ft)
    return loc, orient
