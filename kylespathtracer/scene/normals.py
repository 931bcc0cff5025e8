"""Analytic surface normals and curvature.

The reference estimates the normal and curvature with a 4-point tetrahedron
of scene-SDF evaluations (`norcurv`, reference: common.glsl:276-281) — five
full SDF evaluations per shaded pixel. Every primitive in the scene has a
closed-form normal and mean curvature, so the fast path selects the hit
primitive by object ID and evaluates one fma chain instead:

    plane       n = plane normal                        ΔF = 0
    sphere      n = (p - c)/|p - c|                     ΔF = 2/|p - c|
    rounded box n = m·sign(q)/|m|, m = max(|q|-half, 0) ΔF = (k-1)/|m|
                (k = #positive components of |q|-half: face 1, edge 2,
                 corner 3 — the Minkowski-sum regions)

The curvature scalar matches the tetrahedron estimator's second-order
expansion: with offsets e_i of ±eps per axis, sum(e_i)=0 and
sum(e_i e_iᵀ)=4eps²I, so

    curv ≈ 0.25/eps · ½·Σ e_iᵀ H e_i = 0.5 · eps · ΔF.

Differentiable by construction (used by the gradient path as well as the
fused forward kernel); `sdf.norcurv` remains as the march-parity reference.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath
from kylespathtracer.scene.types import Scene


def normal_curv(scene: Scene, p: jnp.ndarray, oid: jnp.ndarray,
                ep: float = gmath.EPS) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form (normal[...,3], curvature[...]) of the hit primitive.

    p:   f32[...,3] surface points (one eps off the surface, as the
         geometry pass produces them).
    oid: i32[...] hit object IDs; 0 (miss) yields zero normal and curvature.
    """
    n = jnp.zeros_like(p)
    c = jnp.zeros(p.shape[:-1], p.dtype)

    for i in range(int(scene.planes.shape[0])):
        sel = (oid == scene.plane_ids[i])[..., None]
        n = jnp.where(sel, scene.planes[i, :3], n)
        # plane curvature is 0 — c unchanged

    for i in range(int(scene.spheres.shape[0])):
        sel = oid == scene.sphere_ids[i]
        diff = p - scene.spheres[i, :3]
        l = jnp.sqrt(jnp.maximum(gmath.dot(diff, diff), 1e-12))
        n = jnp.where(sel[..., None], diff / l[..., None], n)
        c = jnp.where(sel, ep / l, c)

    for i in range(int(scene.boxes.shape[0])):
        sel = oid == scene.box_ids[i]
        q = p - scene.boxes[i, :3]
        d = jnp.abs(q) - scene.boxes[i, 3:6]
        m = jnp.maximum(d, 0.0)
        l = jnp.sqrt(jnp.maximum(gmath.dot(m, m), 1e-12))
        nb = m * jnp.sign(q) / l[..., None]
        k = jnp.sum((d > 0.0).astype(p.dtype), axis=-1)
        n = jnp.where(sel[..., None], nb, n)
        c = jnp.where(sel, 0.5 * ep * jnp.maximum(k - 1.0, 0.0) / l, c)

    return n, c
