"""Scene and material pytrees.

The reference hardcodes its scene as GLSL globals and a procedural material
switch (reference: common.glsl:220-273). Here the scene is a *parameter
pytree*: arrays of planes / spheres / rounded boxes plus a per-object-ID
material table, so every quantity is differentiable and the same renderer
serves the Cornell-style default scene, the BASELINE sphere-scenes, and
inverse rendering.

Object IDs: 0 is reserved for "miss"; the default scene uses the reference's
IDs (common.glsl:220-226): LIGHT=1, FLOOR=2, WALL1=3, BOX=4, WALL2=6, CEIL=7.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.utils import struct


class OBJ:
    """Reference object IDs (common.glsl:220-226)."""

    MISS = 0
    LIGHT = 1
    FLOOR = 2
    WALL1 = 3
    BOX = 4
    WALL2 = 6
    CEIL = 7


@struct.dataclass
class Materials:
    """Per-object-ID material table, evaluated by `materials.surface`.

    Generalizes the reference's procedural `getSurface` (common.glsl:237-262)
    into a differentiable table. Per object a scalar "reflectivity" channel

        s(hl) = s0 + s1 * checker(hl * freq)

    modulates albedo and energy:

        albedo  = alb_const + alb_scale * s
        energy  = en_const  + en_scale  * s      # (diffuse, specular)
        emission = emission

    which reproduces all three reference material branches exactly (see
    scene.default_scene) while staying a pure gather + fma per pixel.
    """

    s0: jnp.ndarray         # f32[K]
    s1: jnp.ndarray         # f32[K]
    freq: jnp.ndarray       # f32[K] checker spatial frequency
    alb_const: jnp.ndarray  # f32[K,3]
    alb_scale: jnp.ndarray  # f32[K,3]
    emission: jnp.ndarray   # f32[K,3]
    en_const: jnp.ndarray   # f32[K,2]
    en_scale: jnp.ndarray   # f32[K,2]
    # BSDF lobe selector for the multi-bounce wavefront integrator (BASELINE
    # config #3); the reference's estimators always shade both a Lambertian
    # and a Phong response (common.glsl:430-616), which maps to DIFFUSE /
    # GLOSSY here. None → all-diffuse (filled by `bsdf_table`).
    bsdf: jnp.ndarray | None = None  # i32[K] in BSDF.{DIFFUSE,GLOSSY,MIRROR,DIELECTRIC}
    ior: jnp.ndarray | None = None   # f32[K] refraction index (DIELECTRIC only)

    @property
    def num_ids(self) -> int:
        return self.s0.shape[0]


class BSDF:
    """BSDF lobe kinds for `Materials.bsdf`."""

    DIFFUSE = 0     # Lambertian, cosine-sampled
    GLOSSY = 1      # normalized Phong around the mirror direction
    MIRROR = 2      # perfect specular reflection (delta)
    DIELECTRIC = 3  # Fresnel-weighted reflect/refract glass (delta)


def bsdf_table(materials: Materials) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(bsdf[K] i32, ior[K] f32) with all-diffuse / ior-1.5 defaults."""
    k = materials.num_ids
    b = materials.bsdf
    if b is None:
        b = jnp.zeros((k,), jnp.int32)
    i = materials.ior
    if i is None:
        i = jnp.full((k,), 1.5, jnp.float32)
    return b, i


@struct.dataclass
class Scene:
    """Differentiable analytic scene.

    Geometry arrays have static leading sizes (P planes, S spheres, B boxes);
    entries are real parameters — gradients flow to all of them.
    """

    planes: jnp.ndarray      # f32[P,4] (n, d): signed distance = dot(p,n)+d
    plane_ids: jnp.ndarray   # i32[P]
    spheres: jnp.ndarray     # f32[S,4] (center, radius)
    sphere_ids: jnp.ndarray  # i32[S]
    boxes: jnp.ndarray       # f32[B,7] (center, half-extent, rounding radius)
    box_ids: jnp.ndarray     # i32[B]
    light_color: jnp.ndarray  # f32[3] emission of the NEE light (common.glsl:230)
    materials: Materials
    # Index of the NEE light sphere in `spheres` (static; common.glsl:229).
    light_index: int = struct.field(static=True, default=0)

    @property
    def light(self) -> jnp.ndarray:
        """The NEE sphere light as (pos, radius) — f32[4]."""
        return self.spheres[self.light_index]

    @property
    def light_id(self) -> jnp.ndarray:
        return self.sphere_ids[self.light_index]
