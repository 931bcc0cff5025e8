"""Closed-form ray intersection — the fast path.

The reference sphere-traces everything (≤255 sdf evaluations per ray,
common.glsl:283-295). That is 255 serial dependent steps, so the
default pipeline intersects planes and spheres analytically (one fma chain
each) and only sphere-traces rounded boxes, clipped to their AABB slab
interval with a short fixed-iteration loop. Hit semantics mirror the march:
t is pulled back by eps from the exact surface, misses return (zfar, 0),
later primitives win ties.

Gradients use the same implicit-function-theorem backward as the march
(scene/sdf.py:ift_backward).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kylespathtracer.core import gmath
from kylespathtracer.scene import sdf as sdf_mod
from kylespathtracer.scene.types import Scene

_INF = 1e9


def _plane_hits(scene: Scene, ro, rd):
    """t to each plane from the positive side; (..., P)."""
    n = scene.planes[:, :3]
    w = scene.planes[:, 3]
    # Explicit mul+sum, NOT einsum: einsum lowers to dot_general whose
    # default matmul precision may truncate f32 operands (bf16 on some
    # backends, TF32 on the GPU), which rounds 10 - 9.986 to exactly 0.
    denom = jnp.sum(rd[..., None, :] * n, axis=-1)
    sd0 = jnp.sum(ro[..., None, :] * n, axis=-1) + w
    t = -sd0 / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    valid = (denom < -1e-7) & (t > 0)
    return jnp.where(valid, t, _INF)


def _sphere_hits(scene: Scene, ro, rd, inside_hits: bool):
    """Nearest positive root of each sphere; (..., S).

    From outside this is the near root (reference march semantics). With
    `inside_hits` (the wavefront integrator's dielectric rays), a ray
    starting *inside* a sphere returns the far root — the exit point —
    instead of missing. The reference's signed-distance march would
    terminate at t≈0 for such rays, so the default keeps march parity and
    only render/wavefront opts in.
    """
    c = scene.spheres[:, :3]
    r = scene.spheres[:, 3]
    oc = ro[..., None, :] - c
    b = jnp.sum(oc * rd[..., None, :], axis=-1)
    c2 = jnp.sum(oc * oc, axis=-1) - r * r
    disc = b * b - c2
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = -b - sq
    t = jnp.where(t_near > 0, t_near, -b + sq) if inside_hits else t_near
    valid = (disc > 0) & (t > 0)
    return jnp.where(valid, t, _INF)


def _box_hits(scene: Scene, ro, rd):
    """Closed-form rounded-box intersection; (..., B).

    The rounded box {p : sdBox(p, half) = round} is the Minkowski sum of the
    core box and a sphere, so its boundary decomposes exactly into 6 face
    rectangles (inflated planes), 12 edge quarter-cylinders and 8 corner
    sphere octants. All 26 candidates are evaluated branchlessly with their
    region-validity masks and min-reduced — pure fma chains, no serial march
    (the reference sphere-traces this shape for ≤255 steps,
    common.glsl:271,283-295).
    """
    half = scene.boxes[:, 3:6]
    rnd = scene.boxes[:, 6]

    o = ro[..., None, :] - scene.boxes[:, :3]      # (..., B, 3)
    d = jnp.broadcast_to(rd[..., None, :], o.shape)

    best = jnp.full(o.shape[:-1], _INF, ro.dtype)

    def consider(t, valid):
        return jnp.minimum(best, jnp.where(valid & (t > 0), t, _INF))

    # 6 faces: plane p_k = ±(half_k + rnd), flat region |p_j| <= half_j.
    for k in range(3):
        j1, j2 = (k + 1) % 3, (k + 2) % 3
        dk = d[..., k]
        dk = jnp.where(jnp.abs(dk) < 1e-12, 1e-12, dk)
        for s in (1.0, -1.0):
            t = (s * (half[:, k] + rnd) - o[..., k]) / dk
            p1 = o[..., j1] + d[..., j1] * t
            p2 = o[..., j2] + d[..., j2] * t
            valid = (jnp.abs(p1) <= half[:, j1]) & (jnp.abs(p2) <= half[:, j2])
            best = consider(t, valid)

    # 12 edges: cylinder radius rnd around each edge line, valid in the
    # outward quadrant with |p_k| <= half_k along the edge axis.
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        di, dj = d[..., i], d[..., j]
        a = di * di + dj * dj
        a = jnp.maximum(a, 1e-12)
        for si in (1.0, -1.0):
            for sj in (1.0, -1.0):
                oi = o[..., i] - si * half[:, i]
                oj = o[..., j] - sj * half[:, j]
                b = oi * di + oj * dj
                cq = oi * oi + oj * oj - rnd * rnd
                disc = b * b - a * cq
                t = (-b - jnp.sqrt(jnp.maximum(disc, 0.0))) / a
                pk = o[..., k] + d[..., k] * t
                valid = (
                    (disc > 0)
                    & (jnp.abs(pk) <= half[:, k])
                    & ((oi + di * t) * si > 0)
                    & ((oj + dj * t) * sj > 0)
                )
                best = consider(t, valid)

    # 8 corners: sphere radius rnd at (±half), valid in the outward octant.
    for sx in (1.0, -1.0):
        for sy in (1.0, -1.0):
            for sz in (1.0, -1.0):
                s = jnp.stack(
                    [sx * half[:, 0], sy * half[:, 1], sz * half[:, 2]], axis=-1
                )
                oc = o - s
                b = jnp.sum(oc * d, axis=-1)
                cq = jnp.sum(oc * oc, axis=-1) - rnd * rnd
                disc = b * b - cq
                t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
                p = oc + d * t[..., None]
                valid = (
                    (disc > 0)
                    & (p[..., 0] * sx > 0)
                    & (p[..., 1] * sy > 0)
                    & (p[..., 2] * sz > 0)
                )
                best = consider(t, valid)

    return best


def _intersect_fwd_impl(scene: Scene, ro, rd, excl, inside_hits: bool = False):
    parts = [jnp.full(ro.shape[:-1] + (1,), _INF, ro.dtype)]
    ids = [jnp.zeros((1,), jnp.int32)]
    if scene.planes.shape[0]:
        parts.append(_plane_hits(scene, ro, rd))
        ids.append(scene.plane_ids)
    if scene.spheres.shape[0]:
        parts.append(_sphere_hits(scene, ro, rd, inside_hits))
        ids.append(scene.sphere_ids)
    if scene.boxes.shape[0]:
        parts.append(_box_hits(scene, ro, rd))
        ids.append(scene.box_ids)
    ts = jnp.concatenate(parts, axis=-1)
    idv = jnp.concatenate(ids)
    ts = jnp.where(idv == excl[..., None], _INF, ts)

    t = ts[..., 0]
    oid = jnp.zeros(t.shape, jnp.int32)
    for slot in range(1, int(idv.shape[0])):
        ti = ts[..., slot]
        take = (ti <= t) & (ti < _INF)
        t = jnp.where(take, ti, t)
        oid = jnp.where(take, idv[slot], oid)

    # Match march semantics: pull back eps, clamp misses to (zfar, 0)
    # (common.glsl:289-294).
    t = t - gmath.EPS
    miss = (t > gmath.ZFAR) | (oid == 0)
    t = jnp.where(miss, gmath.ZFAR, t)
    oid = jnp.where(miss, 0, oid)
    return t, oid


from functools import partial as _partial


@_partial(jax.custom_vjp, nondiff_argnums=(0,))
def _intersect_cvjp(inside_hits, scene, ro, rd, excl):
    return _intersect_fwd_impl(scene, ro, rd, excl, inside_hits)


def _intersect_cvjp_fwd(inside_hits, scene, ro, rd, excl):
    t, hid = _intersect_fwd_impl(scene, ro, rd, excl, inside_hits)
    return (t, hid), (scene, ro, rd, excl, t, hid)


def _intersect_cvjp_bwd(inside_hits, residuals, cotangents):
    return sdf_mod.ift_backward(residuals, cotangents)


_intersect_cvjp.defvjp(_intersect_cvjp_fwd, _intersect_cvjp_bwd)


def intersect(scene: Scene, ro, rd, exclude=-1, steps: int = 255,
              inside_hits: bool = False) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Analytic intersect → (t, object_id), march-compatible signature.

    `steps` is accepted for interface parity with `sdf.march` and ignored
    (box tracing uses a fixed short loop). `inside_hits` (static) opts into
    far-root sphere hits for rays starting inside a sphere — wavefront
    dielectrics only; off by default for march parity (see _sphere_hits).
    """
    del steps
    excl = jnp.broadcast_to(jnp.asarray(exclude, jnp.int32), ro.shape[:-1])
    return _intersect_cvjp(inside_hits, scene, ro, rd, excl)
