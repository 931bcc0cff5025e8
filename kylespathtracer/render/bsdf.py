"""BSDF evaluation and sampling for the multi-bounce wavefront integrator.

The reference shades every surface with both a Lambertian and a Phong
response through its biased MIS estimators (reference: common.glsl:430-616)
and has no transmissive materials. BASELINE config #3 extends the material
model to explicit single-lobe BSDFs — DIFFUSE (Lambertian), GLOSSY
(normalized Phong), MIRROR and DIELECTRIC (Fresnel glass) — with proper
pdf bookkeeping so the integrator's NEE/BSDF multiple importance sampling
is unbiased.

Everything is branchless over the per-pixel BSDF kind: all four lobes are
evaluated/sampled and the result selected with `jnp.where`, the standard
data-parallel trade (a few extra fma chains, zero divergence).

Conventions: `wo` points *away* from the surface toward the camera
(wo = -rd), `wi` away from the surface toward the light / next vertex;
`n` is the forward-facing shading normal (flipped against the incoming ray).
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath
from kylespathtracer.scene.types import BSDF

_INV_PI = 1.0 / gmath.PI
_DELTA_PDF = 1e8  # stand-in pdf for delta lobes (never used to divide)


def _cos(n, w):
    return jnp.maximum(0.0, gmath.dot(n, w))


def eval_pdf(kind, rho_d, rho_s, n, wo, wi, gloss):
    """(f(wo,wi)·cosθi [...,3], pdf(wi) [...]) for the non-delta lobes.

    Delta lobes (MIRROR, DIELECTRIC) evaluate to 0 — they are unreachable by
    next-event estimation, matching standard path-tracer practice.
    """
    ci = _cos(n, wi)

    # DIFFUSE: f = rho_d/pi, pdf = cos/pi (cosine-sampled).
    f_d = rho_d * (_INV_PI * ci)[..., None]
    pdf_d = ci * _INV_PI

    # GLOSSY: normalized Phong around the mirror direction. f·cos carries the
    # full cosθi factor so NEE agrees with sample()'s weight·pdf
    # (= rho_s·(g+2)/2π·cosᵍα·cosθi); a sign() here would overestimate
    # grazing-angle NEE by 1/cosθi.
    refl = gmath.reflect(-wo, n)
    ca = jnp.maximum(0.0, gmath.dot(refl, wi))
    ca_g = gmath.pow_static(ca, gloss)
    f_g = rho_s * ((gloss + 2.0) / gmath.TWOPI * ca_g * ci)[..., None]
    pdf_g = (gloss + 1.0) / gmath.TWOPI * ca_g

    is_g = kind == BSDF.GLOSSY
    is_delta = kind >= BSDF.MIRROR
    f = jnp.where(is_g[..., None], f_g, f_d)
    pdf = jnp.where(is_g, pdf_g, pdf_d)
    zero = is_delta | (ci <= 0.0)
    return jnp.where(zero[..., None], 0.0, f), jnp.where(zero, 0.0, pdf)


def sample(kind, rho_d, rho_s, ior, n, wo, gloss, u1, u2, u3):
    """Sample an outgoing direction from the BSDF.

    Returns (wi[...,3], weight[...,3], pdf[...], is_delta[...], transmit[...])
    where weight = f·cosθ/pdf (throughput multiplier) and `transmit` marks
    refraction events (the continuation ray crosses the surface).
    """
    f, r = gmath.basis(n)

    # DIFFUSE: cosine-weighted hemisphere.
    srt = jnp.sqrt(u1)
    phi = gmath.TWOPI * u2
    x = srt * jnp.cos(phi)
    y = srt * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    wi_d = f * x[..., None] + r * y[..., None] + n * z[..., None]
    w_d = rho_d
    pdf_d = z * _INV_PI

    # GLOSSY: power-cosine lobe around the mirror direction.
    refl = gmath.reflect(-wo, n)
    fg, rg = gmath.basis(refl)
    ca = u1 ** (1.0 / (gloss + 1.0))
    sa = jnp.sqrt(jnp.maximum(0.0, 1.0 - ca * ca))
    wi_g = (
        fg * (sa * jnp.cos(phi))[..., None]
        + rg * (sa * jnp.sin(phi))[..., None]
        + refl * ca[..., None]
    )
    ci_g = gmath.dot(n, wi_g)
    # f·cos/pdf = rho_s · (g+2)/(g+1) · cosθi, zeroed below the horizon.
    w_g = rho_s * jnp.maximum(0.0, (gloss + 2.0) / (gloss + 1.0) * ci_g)[..., None]
    pdf_g = (gloss + 1.0) / gmath.TWOPI * gmath.pow_static(ca, gloss)

    # MIRROR: delta reflection.
    wi_m = refl
    w_m = rho_d + rho_s  # full reflectance tint

    # DIELECTRIC: Schlick-Fresnel-weighted reflect/refract. `n` already faces
    # the incoming ray, so eta flips with the (traced) inside flag derived
    # from the geometric normal by the caller via `entering`.
    ci = jnp.maximum(1e-6, gmath.dot(n, wo))
    # entering ⇔ caller passes eta = 1/ior, exiting ⇔ eta = ior; we take
    # ior as "relative index of the medium being entered" and let the caller
    # pre-invert. Here ior is already the relative eta.
    eta = ior
    sin2t = eta * eta * jnp.maximum(0.0, 1.0 - ci * ci)
    tir = sin2t > 1.0
    # 1e-9 floor: finite grad at the TIR boundary (the reflect branch is
    # selected there, but 0·inf would still poison the backward pass).
    cost = jnp.sqrt(jnp.maximum(1e-9, 1.0 - sin2t))
    r0 = (eta - 1.0) / (eta + 1.0)
    r0 = r0 * r0
    fres = r0 + (1.0 - r0) * (1.0 - ci) ** 5
    p_reflect = jnp.where(tir, 1.0, fres)
    take_refl = u3 < p_reflect
    wi_t = gmath.normalize_fast(
        (-wo) * eta[..., None] + n * (eta * ci - cost)[..., None]
    )
    wi_x = jnp.where(take_refl[..., None], refl, wi_t)
    # Radiance transport: selecting by Fresnel probability cancels F/(1-F);
    # the tint applies to both branches.
    w_x = rho_d + rho_s

    is_g = kind == BSDF.GLOSSY
    is_m = kind == BSDF.MIRROR
    is_x = kind == BSDF.DIELECTRIC
    is_delta = is_m | is_x

    wi = jnp.where(
        is_x[..., None], wi_x, jnp.where(
            is_m[..., None], wi_m, jnp.where(is_g[..., None], wi_g, wi_d)
        )
    )
    weight = jnp.where(
        is_delta[..., None], jnp.where(is_x[..., None], w_x, w_m),
        jnp.where(is_g[..., None], w_g, w_d),
    )
    pdf = jnp.where(is_delta, _DELTA_PDF, jnp.where(is_g, pdf_g, pdf_d))
    transmit = is_x & ~take_refl
    return wi, weight, pdf, is_delta, transmit
