"""Multi-bounce wavefront path integrator (BASELINE config #3).

The reference is a one-bounce biased estimator pair (common.glsl:430-616,
BOUNCES is defined but unused, common.glsl:6). This module is the unbiased
multi-bounce extension the BASELINE requires: a wavefront-style integrator —
generate → intersect → shade → continue — with

  * explicit BSDFs (diffuse / glossy / mirror / dielectric, render/bsdf.py),
  * next-event estimation toward the sphere light with proper solid-angle
    pdfs and balance-heuristic MIS against BSDF sampling,
  * the PCG-hashed R2 low-discrepancy sampler (core/sampler.py:r2_pair),
  * a fixed `max_depth` bounce loop as `lax.scan` (static shapes, no
    data-dependent control flow — rays that miss carry a dead mask).

All state lives in arrays of shape [H, W, ...]; the scan body is a pure
function so XLA fuses the whole bounce into a handful of kernels. Differentiable end-to-end: intersections use the analytic
closed-form path with the implicit-function-theorem backward
(scene/intersect.py), so pixel gradients flow to sphere positions, radii,
albedo, emission and IOR.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kylespathtracer.core import color as color_mod
from kylespathtracer.core import gmath, sampler
from kylespathtracer.render import bsdf as bsdf_mod
from kylespathtracer.render.camera import Camera, ray_dirs
from kylespathtracer.scene import intersect as isect_mod
from kylespathtracer.scene import materials as mat_mod
from kylespathtracer.scene import sdf as sdf_mod
from kylespathtracer.scene.types import BSDF, Scene, bsdf_table
from kylespathtracer.utils.config import RenderConfig

_PAIRS_PER_BOUNCE = 3  # (nee u1,u2), (bsdf u1,u2), (bsdf u3, lobe)


def _surface_normal(scene: Scene, p: jnp.ndarray) -> jnp.ndarray:
    """Exact outward surface normal: the sdf gradient at the hit point.

    The sum-trick gives per-point gradients of the pointwise distance field
    in one reverse pass; for planes/spheres/boxes this is the analytic
    normal (vs the reference's 4-tap tetrahedron, common.glsl:276-281).
    Kept as the oracle; the integrator uses the cheaper per-primitive
    closed form below (`_hit_normal`) by default.
    """
    g = jax.grad(lambda q: jnp.sum(sdf_mod.sdf_dist(scene, q)))(p)
    return gmath.normalize(g)


def _hit_normal(scene: Scene, p, oid, config: RenderConfig) -> jnp.ndarray:
    """Surface normal at hit points, selected per primitive by object id
    (scene/normals.py) — one where-chain instead of differentiating the
    whole scene SDF at every bounce (~3x fewer flops per vertex; identical
    values on the surface). config.normal_mode='tetra' keeps the SDF
    gradient for oracle parity."""
    if config.normal_mode == "tetra":
        return _surface_normal(scene, p)
    from kylespathtracer.scene import normals as nrm_mod

    n, _ = nrm_mod.normal_curv(scene, p, oid)
    # Misses (oid 0) have no primitive: keep a finite unit placeholder.
    bad = gmath.dot(n, n) < 0.5
    up = jnp.zeros_like(n).at[..., 1].set(1.0)
    return jnp.where(bad[..., None], up, n)


def _sample_light(scene: Scene, hl, u1, u2):
    """Uniform solid-angle cone sample toward the NEE sphere light.

    Returns (wi[...,3], pdf_sa[...], cos_max guard mask). pdf is with
    respect to solid angle: 1 / (2π(1−cosθmax)).
    """
    li = scene.light
    lv = li[:3] - hl
    d2 = jnp.maximum(gmath.dot(lv, lv), 1e-12)
    r2 = li[3] * li[3]
    # The 1e-9 floors keep sqrt gradients finite when a path vertex sits on
    # the light surface (d2≈r2): where-masking downstream does not stop
    # 0·inf = NaN in the backward pass.
    cos_max = jnp.sqrt(jnp.maximum(1e-9, 1.0 - jnp.clip(r2 / d2, 0.0, 1.0)))
    ct = 1.0 - u1 * (1.0 - cos_max)
    st = jnp.sqrt(jnp.maximum(1e-12, 1.0 - ct * ct))
    phi = gmath.TWOPI * u2
    w = gmath.normalize(lv)
    f, r = gmath.basis(w)
    wi = (
        f * (st * jnp.cos(phi))[..., None]
        + r * (st * jnp.sin(phi))[..., None]
        + w * ct[..., None]
    )
    omega = gmath.TWOPI * jnp.maximum(1e-9, 1.0 - cos_max)
    pdf = 1.0 / omega
    outside = d2 > r2  # no NEE from inside the light
    return wi, pdf, outside


def _nee_pdf_toward_light(scene: Scene, origin):
    """pdf (solid angle) the NEE sampler would assign to a direction that
    reaches the light, as seen from `origin` — the MIS counterpart term."""
    li = scene.light
    lv = li[:3] - origin
    d2 = jnp.maximum(gmath.dot(lv, lv), 1e-12)
    cos_max = jnp.sqrt(jnp.maximum(1e-9, 1.0 - jnp.clip(li[3] * li[3] / d2, 0.0, 1.0)))
    return 1.0 / (gmath.TWOPI * jnp.maximum(1e-9, 1.0 - cos_max))


def trace_sample(scene: Scene, ro, rd, px, py, config: RenderConfig,
                 sample_index) -> jnp.ndarray:
    """One radiance sample per pixel → f32[..., 3].

    ro, rd: f32[...,3] primary rays; px, py: i32[...] pixel coords (sampler
    stream ids); sample_index: traced uint32 scalar (frame*spp + s).
    """
    kinds_tab, ior_tab = bsdf_table(scene.materials)
    gloss = config.gloss
    light_id = scene.light_id

    batch = ro.shape[:-1]
    n_idx = jnp.broadcast_to(jnp.asarray(sample_index, jnp.uint32), batch)

    state = dict(
        ro=ro,
        rd=rd,
        throughput=jnp.ones(batch + (3,), ro.dtype),
        radiance=jnp.zeros(batch + (3,), ro.dtype),
        alive=jnp.ones(batch, bool),
        excl=jnp.full(batch, -1, jnp.int32),
        prev_pdf=jnp.zeros(batch, ro.dtype),
        prev_delta=jnp.ones(batch, bool),  # bounce 0: camera "delta"
        prev_nee=jnp.zeros(batch, bool),   # did NEE run at the last vertex?
        inside=jnp.zeros(batch, bool),
    )

    def u2_for(pair, bounce):
        stream = sampler.pixel_stream(
            px, py, config.width, bounce * _PAIRS_PER_BOUNCE + pair
        )
        return sampler.r2_pair(n_idx, stream)

    def bounce_body(state, bounce):
        ro, rd = state["ro"], state["rd"]
        t, oid = isect_mod.intersect(scene, ro, rd, state["excl"],
                                     inside_hits=True)
        hit = (oid != 0) & state["alive"]
        hl = ro + rd * t[..., None]

        n_geo = _hit_normal(scene, hl, oid, config)
        into = gmath.dot(rd, n_geo) < 0.0
        n = jnp.where(into[..., None], n_geo, -n_geo)
        wo = -rd

        albedo, emission, energy = mat_mod.surface(scene.materials, oid, hl)
        kid = jnp.clip(oid, 0, kinds_tab.shape[0] - 1)
        kind = kinds_tab[kid]
        ior = ior_tab[kid]
        rho_d = albedo * energy[..., 0:1]
        rho_s = albedo * energy[..., 1:2]

        # ---- emitted radiance, MIS-weighted against the previous NEE. The
        # balance weight only applies when NEE actually ran at the previous
        # vertex (prev_nee) and that lobe was non-delta — otherwise the NEE
        # strategy could not have produced this light hit and down-weighting
        # would darken those paths.
        is_light = oid == light_id
        pdf_nee_prev = _nee_pdf_toward_light(scene, ro)
        w_mis = jnp.where(
            state["prev_delta"] | ~state["prev_nee"] | ~is_light,
            1.0,
            state["prev_pdf"] / jnp.maximum(1e-12, state["prev_pdf"] + pdf_nee_prev),
        )
        rad = state["radiance"] + jnp.where(
            hit[..., None], state["throughput"] * emission * w_mis[..., None], 0.0
        )

        # ---- next-event estimation (non-delta lobes only).
        u1, u2 = u2_for(0, bounce)
        l_wi, l_pdf, l_ok = _sample_light(scene, hl, u1, u2)
        ro_off = hl + n * gmath.EPS
        _, vis_id = isect_mod.intersect(scene, ro_off, l_wi, oid)
        visible = vis_id == light_id
        f_cos, b_pdf = bsdf_mod.eval_pdf(kind, rho_d, rho_s, n, wo, l_wi, gloss)
        w_nee = l_pdf / jnp.maximum(1e-12, l_pdf + b_pdf)
        nee_on = hit & visible & l_ok & ~is_light
        rad = rad + jnp.where(
            nee_on[..., None],
            state["throughput"] * f_cos * scene.light_color
            * (w_nee / jnp.maximum(1e-12, l_pdf))[..., None],
            0.0,
        )

        # ---- continue the path with a BSDF sample.
        b1, b2 = u2_for(1, bounce)
        b3, _ = u2_for(2, bounce)
        eta_rel = jnp.where(state["inside"], ior, 1.0 / ior)
        wi, weight, pdf, is_delta, transmit = bsdf_mod.sample(
            kind, rho_d, rho_s, eta_rel, n, wo, gloss, b1, b2, b3
        )
        new_tp = state["throughput"] * weight
        alive = hit & (jnp.max(new_tp, axis=-1) > 1e-5)

        new_ro = hl + jnp.where(transmit[..., None], -n, n) * gmath.EPS
        # Convex primitives: a reflected ray *outside* its object cannot
        # re-hit it, so self-exclusion is safe there. Whenever the
        # continuation ray travels inside the object — a transmitted ray
        # (must hit the far side of the glass) or an internally reflected
        # one (TIR / Fresnel reflection at the exit interface, which must
        # re-hit the same surface from inside) — exclusion is lifted.
        new_excl = jnp.where(transmit | state["inside"], -1, oid)

        new_state = dict(
            ro=new_ro,
            rd=wi,
            throughput=jnp.where(alive[..., None], new_tp, 0.0),
            radiance=rad,
            alive=alive,
            excl=new_excl,
            prev_pdf=pdf,
            prev_delta=is_delta,
            prev_nee=hit & l_ok & ~is_light,
            inside=jnp.where(transmit, ~state["inside"], state["inside"]),
        )
        return new_state, None

    state, _ = jax.lax.scan(
        bounce_body, state, jnp.arange(config.max_depth, dtype=jnp.uint32)
    )
    return state["radiance"]


def pathtrace(scene: Scene, camera: Camera, config: RenderConfig,
              frame=0) -> jnp.ndarray:
    """HDR radiance image f32[H, W, 3]: `config.spp` samples per pixel at
    depth `config.max_depth`, one `lax.scan` over the bounces per sample."""
    h, w = config.height, config.width
    rd = ray_dirs(camera, w, h, config.fov)
    ro = jnp.broadcast_to(camera.loc, rd.shape)
    py, px = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.int32), jnp.arange(w, dtype=jnp.int32),
        indexing="ij",
    )
    frame = jnp.asarray(frame, jnp.uint32)
    spp = max(1, config.spp)

    def body(s, acc):
        n = frame * jnp.uint32(spp) + s.astype(jnp.uint32)
        return acc + trace_sample(scene, ro, rd, px, py, config, n)

    acc = jax.lax.fori_loop(
        0, spp, body, jnp.zeros((h, w, 3), jnp.float32)
    )
    return acc / spp


def render_pathtraced(scene: Scene, camera: Camera, config: RenderConfig,
                      frame=0) -> jnp.ndarray:
    """Tonemapped sRGB image (the composite transform of passthrough.frag:
    exposure → ACES → sRGB; reference passthrough.frag:27,45)."""
    hdr = pathtrace(scene, camera, config, frame)
    return color_mod.linear_srgb(color_mod.aces_fitted(hdr * config.brightness))
