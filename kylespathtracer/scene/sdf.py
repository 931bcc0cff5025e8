"""Signed-distance evaluation and sphere tracing.

Vectorized, branchless equivalents of the reference's scene distance field
and sphere tracer (reference: common.glsl:199-295). All primitives are
evaluated for the whole pixel batch at once; "self-exclusion by object ID"
(common.glsl:264-273) becomes a mask, the 255-step march becomes a
`lax.while_loop` with a per-ray done mask and a global all-done exit.

Gradients: a sphere-trace with data-dependent iteration count is not
reverse-differentiable, and unrolling 255 steps would be absurd.
Instead `march` exposes a `jax.custom_vjp` built on the implicit function
theorem: at a hit, f(o + t d, θ) = 0 defines t(o, d, θ), so

    ∂t/∂θ = -(∂f/∂θ) / (∇f·d),   ∂t/∂o = -∇f / (∇f·d),   ∂t/∂d = t ∂t/∂o

one extra sdf gradient at the hit point instead of 255 unrolled steps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from kylespathtracer.core import gmath
from kylespathtracer.scene.types import Scene

_BIG = 1e9


def sd_box(p: jnp.ndarray, half: jnp.ndarray) -> jnp.ndarray:
    """Axis-aligned box signed distance (reference: common.glsl:215-218).

    The reference's oriented variant is always called with the identity
    orientation (common.glsl:271); rotation can be applied to p by callers.
    """
    d = jnp.abs(p) - half
    outside = gmath.length(jnp.maximum(d, 0.0))
    inside = jnp.minimum(jnp.maximum(d[..., 0], jnp.maximum(d[..., 1], d[..., 2])), 0.0)
    return inside + outside


def smin(a: jnp.ndarray, b: jnp.ndarray, k) -> jnp.ndarray:
    """Polynomial smooth minimum (reference: common.glsl:206-209; unused by
    the reference scene but part of its SDF toolkit)."""
    h = jnp.maximum(k - jnp.abs(a - b), 0.0) / k
    return jnp.minimum(a, b) - h * h * k * 0.25


def smax(a: jnp.ndarray, b: jnp.ndarray, k) -> jnp.ndarray:
    """Smooth maximum via smin (reference: common.glsl:211-213)."""
    return -smin(-a, -b, k)


def primitive_distances(scene: Scene, p: jnp.ndarray) -> jnp.ndarray:
    """Distances to every primitive; shape (..., 1+P+S+B).

    Slot 0 is the zfar "miss" sentinel with ID 0, mirroring the reference's
    `vec2 d = vec2(zfar, 0.)` accumulator seed (common.glsl:265). Ordering
    matches the reference's sdMin chain (planes, light sphere, box) so strict
    `<` tie-breaking agrees with argmin-takes-first.
    """
    parts = [jnp.full(p.shape[:-1] + (1,), gmath.ZFAR, p.dtype)]
    if scene.planes.shape[0]:
        # dot(p, n) + d for each plane (common.glsl:266-269).
        # Explicit mul+sum, NOT einsum: dot_general's default matmul
        # precision truncates f32 to bf16, destroying plane distances near
        # large coordinates (10 - 9.986 → 0).
        pd = jnp.sum(
            p[..., None, :] * scene.planes[:, :3], axis=-1
        ) + scene.planes[:, 3]
        parts.append(pd)
    if scene.spheres.shape[0]:
        # |p - c| - r (common.glsl:270).
        diff = p[..., None, :] - scene.spheres[:, :3]
        sd = gmath.length(diff) - scene.spheres[:, 3]
        parts.append(sd)
    if scene.boxes.shape[0]:
        # rounded box: sdBox(p - c, half) - round (common.glsl:271).
        diff = p[..., None, :] - scene.boxes[:, :3]
        bd = sd_box(diff, scene.boxes[:, 3:6]) - scene.boxes[:, 6]
        parts.append(bd)
    return jnp.concatenate(parts, axis=-1)


def primitive_ids(scene: Scene) -> jnp.ndarray:
    """Object ID per distance slot; shape (1+P+S+B,)."""
    return jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), scene.plane_ids, scene.sphere_ids, scene.box_ids]
    )


def sdf(scene: Scene, p: jnp.ndarray, exclude: jnp.ndarray | int = -1
        ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scene distance with self-exclusion → (distance, object_id).

    exclude: int or int32[...] object ID removed from consideration
    (reference: common.glsl:264-273). -1 excludes nothing. Accumulated as the
    reference's sdMin chain — `a.x < b.x ? a : b` — so the *later* primitive
    wins distance ties (common.glsl:199-203).
    """
    dists = primitive_distances(scene, p)
    ids = primitive_ids(scene)
    excl = jnp.asarray(exclude, jnp.int32)
    d = dists[..., 0]
    oid = jnp.zeros(d.shape, jnp.int32)
    for slot in range(1, int(ids.shape[0])):
        di = dists[..., slot]
        take = (di <= d) & (ids[slot] != excl)
        d = jnp.where(take, di, d)
        oid = jnp.where(take, ids[slot], oid)
    return d, oid


def sdf_dist(scene: Scene, p: jnp.ndarray, exclude: jnp.ndarray | int = -1
             ) -> jnp.ndarray:
    """Distance only (differentiable min via jnp.min)."""
    dists = primitive_distances(scene, p)
    ids = primitive_ids(scene)
    excl = jnp.asarray(exclude, jnp.int32)
    dists = jnp.where(ids == excl[..., None], _BIG, dists)
    return jnp.min(dists, axis=-1)


def norcurv(scene: Scene, p: jnp.ndarray, ep: float = gmath.EPS
            ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """4-point tetrahedron normal + curvature (reference: common.glsl:276-281).

    Returns (normal[...,3], curvature[...]). No exclusion (the reference
    passes -1).
    """
    e = jnp.asarray(
        [[ep, -ep, -ep], [-ep, -ep, ep], [-ep, ep, -ep], [ep, ep, ep]], p.dtype
    )
    t = jnp.stack(
        [sdf_dist(scene, p + e[i]) for i in range(4)], axis=-1
    )  # (..., 4)
    n = jnp.sum(t[..., None] * e, axis=-2)  # mul+sum: full f32 (see sdf_dist)
    n = gmath.normalize(n)
    c = 0.25 / ep * (jnp.sum(t, axis=-1) - 4.0 * sdf_dist(scene, p))
    return n, c


def _march_fwd_loop(scene: Scene, ro: jnp.ndarray, rd: jnp.ndarray,
                    exclude: jnp.ndarray, steps: int
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reference-faithful sphere trace (common.glsl:283-295), all rays in
    lockstep with a done-mask; exits when every ray has hit or escaped."""
    batch = ro.shape[:-1]
    t0 = jnp.zeros(batch, ro.dtype)
    id0 = jnp.zeros(batch, jnp.int32)
    done0 = jnp.zeros(batch, bool)
    miss0 = jnp.zeros(batch, bool)

    def cond(state):
        i, _, _, done, _ = state
        return jnp.logical_and(i < steps, ~jnp.all(done))

    def body(state):
        i, t, hid, done, missed = state
        d, oid = sdf(scene, ro + rd * t[..., None], exclude)
        hit_now = d < gmath.EPS
        t_new = jnp.where(done, t, t + d)
        # A hit takes precedence over crossing zfar (the reference checks the
        # hit break before the miss return, common.glsl:289-292).
        miss_now = (t_new > gmath.ZFAR) & ~hit_now
        # Record id of the last sdf sample for not-yet-done rays; on miss the
        # reference returns id 0 (common.glsl:292).
        hid = jnp.where(done, hid, jnp.where(miss_now, 0, oid))
        missed = jnp.where(done, missed, miss_now)
        done = done | hit_now | miss_now
        return i + 1, t_new, hid, done, missed

    _, t, hid, done, missed = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), t0, id0, done0, miss0)
    )
    t = jnp.where(missed, gmath.ZFAR, jnp.minimum(t, gmath.ZFAR))
    return t, hid


def march(scene: Scene, ro: jnp.ndarray, rd: jnp.ndarray,
          exclude: jnp.ndarray | int = -1, steps: int = 255
          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sphere-trace the scene → (t[...], object_id[...]).

    ro, rd: f32[...,3]; exclude: int or int32[...]; steps: static int.
    Reference semantics (common.glsl:283-295): step by the scene distance,
    stop below eps (hit) or beyond zfar (miss → t=zfar, id=0). Differentiable
    w.r.t. scene parameters, ro and rd via the implicit function theorem.
    """
    excl = jnp.broadcast_to(jnp.asarray(exclude, jnp.int32), ro.shape[:-1])
    return _march_cvjp(steps, scene, ro, rd, excl)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _march_cvjp(steps, scene, ro, rd, excl):
    return _march_fwd_loop(scene, ro, rd, excl, steps)


def _march_cvjp_fwd(steps, scene, ro, rd, excl):
    t, hid = _march_fwd_loop(scene, ro, rd, excl, steps)
    return (t, hid), (scene, ro, rd, excl, t, hid)


def ift_backward(residuals, cotangents):
    """Shared implicit-function-theorem backward for any intersector whose
    result satisfies sdf(ro + t·rd, θ) ≈ 0 at hits (march and analytic)."""
    scene, ro, rd, excl, t, hid = residuals
    g_t = cotangents[0]  # object-id cotangent is symbolic zero (int output)

    hit = hid > 0
    p = ro + rd * t[..., None]

    # ∇f·d at the hit point (the IFT denominator); rays hit surfaces from the
    # outside so this is negative at genuine hits — guard near-tangent cases.
    gp = jax.grad(lambda pp: jnp.sum(sdf_dist(scene, pp, excl)))(p)
    denom = jnp.sum(gp * rd, axis=-1)
    denom = jnp.where(denom < 0, jnp.minimum(denom, -1e-4), jnp.maximum(denom, 1e-4))
    scale = jnp.where(hit, -g_t / denom, 0.0)

    # dL/dx = Σ_rays scale_r · ∂f_r/∂x for x ∈ (scene, ro, rd): one weighted
    # sdf gradient at the hit points replaces differentiating the march steps.
    # allow_int=True makes integer leaves (object-id arrays) yield float0
    # cotangents, which is exactly what custom_vjp expects back for them.
    def fw(scene_, ro_, rd_, excl_):
        d = sdf_dist(scene_, ro_ + rd_ * t[..., None], excl_)
        return jnp.sum(d * scale)

    return jax.grad(fw, argnums=(0, 1, 2, 3), allow_int=True)(scene, ro, rd, excl)


def _march_cvjp_bwd(steps, residuals, cotangents):
    return ift_backward(residuals, cotangents)


_march_cvjp.defvjp(_march_cvjp_fwd, _march_cvjp_bwd)
