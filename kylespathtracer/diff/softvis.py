"""Soft visibility: differentiable silhouettes for shadow terms.

The reference's visibility is a hard sphere-trace hit test
(common.glsl:348-353 via march :283-295). Its derivative w.r.t. an
occluder's position/radius is zero almost everywhere and undefined at the
silhouette — the IFT backward (scene/sdf.py) differentiates the smooth
t(θ) of the *hit* surface, but the binary did-it-hit indicator contributes
no gradient, so inverse rendering cannot move an occluder's shadow.

Mitigation (config.soft_shadows = β > 0): replace the binary light-occlusion
test for *sphere* occluders with a smooth transmittance

    T(ray) = Π_spheres σ( sd_i / (β · t_i) )

where sd_i is the signed closest-approach distance of the shadow ray to
sphere i over the segment to the light and t_i the distance of that closest
point — the classic penumbra ratio (sd/t is the angular miss). As β → 0
this approaches the hard test; for β > 0 the estimator is *biased*
(penumbras are artificially smooth) but its gradient is exact for the
smoothed rendering — the standard soft-visibility trade
(cf. differentiable-rendering practice; SURVEY §7 hard part (a)).

Planes and boxes stay hard occluders: this transmittance only covers
spheres, so callers (render/mis.dual_mis) must still gate it with the hard
trace result — visibility is zeroed when the shadow ray's nearest hit is a
plane, a box, or a miss, and only sphere occlusion is smoothed. BASELINE's
inverse-rendering configs optimize spheres, so those are the silhouettes
that need gradients.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kylespathtracer.core import gmath
from kylespathtracer.scene.types import Scene


def sphere_soft_transmittance(
    scene: Scene,
    ro: jnp.ndarray,      # f32[...,3] shadow-ray origins
    rd: jnp.ndarray,      # f32[...,3] unit directions toward the light
    t_max: jnp.ndarray,   # f32[...] distance to the light surface
    exclude: jnp.ndarray,  # i32[...] object id of the shaded surface
    beta: float,
) -> jnp.ndarray:
    """Smooth transmittance in (0, 1] through all non-light spheres."""
    trans = jnp.ones(ro.shape[:-1], ro.dtype)
    light_id = scene.light_id
    for i in range(int(scene.spheres.shape[0])):
        c = scene.spheres[i, :3]
        r = scene.spheres[i, 3]
        oc = c - ro
        tc = jnp.clip(jnp.sum(oc * rd, axis=-1), gmath.EPS, t_max)
        closest = ro + rd * tc[..., None]
        sd = gmath.length(closest - c) - r
        v = jax.nn.sigmoid(sd / (beta * tc))
        skip = (scene.sphere_ids[i] == light_id) | (scene.sphere_ids[i] == exclude)
        trans = trans * jnp.where(skip, 1.0, v)
    return trans


def soft_direct_light(scene: Scene, hl, hn, ho, beta: float) -> jnp.ndarray:
    """Differentiable direct lighting at surface points: analytic
    solid-angle × Lambert × soft sphere transmittance — the silhouette-aware
    replacement for the hard NEE term in inverse rendering."""
    lv = scene.light[:3] - hl
    dist = gmath.length(lv)
    ndir = lv / jnp.maximum(dist, 1e-6)[..., None]
    pdf = gmath.solid_angle(dist * dist, scene.light[3] ** 2)
    lam = gmath.lambertian(hn, ndir)
    t_surface = jnp.maximum(dist - scene.light[3], gmath.EPS)
    trans = sphere_soft_transmittance(scene, hl, ndir, t_surface, ho, beta)
    return (pdf * lam * trans)[..., None] * scene.light_color
