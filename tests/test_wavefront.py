"""Multi-bounce wavefront integrator + PCG/R2 sampler tests (BASELINE
config #3): sampler stratification, BSDF physics (Snell, TIR, mirror
geometry), estimator agreement with a quadrature oracle, determinism, and
finite-difference gradient checks through the bounce loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kylespathtracer import Camera, RenderConfig
from kylespathtracer.core import gmath, sampler
from kylespathtracer.render import bsdf as bsdf_mod
from kylespathtracer.render import wavefront
from kylespathtracer.scene.scene import sphere_scene
from kylespathtracer.scene.types import BSDF


# ------------------------------------------------------------- sampler

def test_pcg_hash_deterministic_and_spread():
    x = jnp.arange(1024, dtype=jnp.uint32)
    h1 = sampler.pcg_hash(x)
    h2 = sampler.pcg_hash(x)
    assert (h1 == h2).all()
    # Bijective-ish over a small range: no collisions.
    assert len(np.unique(np.asarray(h1))) == 1024
    # Bits well spread: each of the 32 bits is set 40-60% of the time.
    bits = (np.asarray(h1)[:, None] >> np.arange(32)) & 1
    frac = bits.mean(axis=0)
    assert (frac > 0.4).all() and (frac < 0.6).all()


def test_r2_pair_stratification_beats_random():
    """R2 star-discrepancy proxy: max 1D gap of 256 points is far below the
    ~(ln N)/N tail of uniform random points."""
    n = jnp.arange(256, dtype=jnp.uint32)
    stream = jnp.zeros((), jnp.uint32)
    u1, u2 = sampler.r2_pair(n, stream)
    for u in (np.asarray(u1), np.asarray(u2)):
        assert (u >= 0).all() and (u < 1).all()
        s = np.sort(u)
        gaps = np.diff(np.concatenate([[s[-1] - 1.0], s]))
        # Low-discrepancy additive sequence: gaps take ≤3 distinct values,
        # all O(1/N); random would have expected max gap ~ ln(N)/N ≈ 0.022.
        assert gaps.max() < 3.0 / 256
        assert abs(u.mean() - 0.5) < 0.02


def test_r2_streams_decorrelated():
    n = jnp.arange(512, dtype=jnp.uint32)
    a, _ = sampler.r2_pair(n, jnp.uint32(1))
    b, _ = sampler.r2_pair(n, jnp.uint32(2))
    corr = np.corrcoef(np.asarray(a), np.asarray(b))[0, 1]
    assert abs(corr) < 0.2


# ------------------------------------------------------------- BSDF physics

def _sample_dielectric(wo, n, eta_rel, u3):
    shape = wo.shape[:-1]
    kind = jnp.full(shape, BSDF.DIELECTRIC, jnp.int32)
    rho = jnp.ones(shape + (3,), jnp.float32)
    z = jnp.zeros(shape, jnp.float32)
    return bsdf_mod.sample(
        kind, rho, jnp.zeros_like(rho), jnp.full(shape, eta_rel, jnp.float32),
        n, wo, 5.0, z, z, jnp.full(shape, u3, jnp.float32),
    )


def test_dielectric_snell():
    """Refraction at a flat air→glass interface obeys Snell's law."""
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    ang_i = 0.5  # incident angle from normal
    wo = jnp.asarray([[np.sin(ang_i), np.cos(ang_i), 0.0]], jnp.float32)
    wi, w, pdf, is_delta, transmit = _sample_dielectric(wo, n, 1.0 / 1.5, 0.999)
    assert bool(transmit[0]) and bool(is_delta[0])
    sin_t = float(jnp.sqrt(wi[0, 0] ** 2 + wi[0, 2] ** 2))
    assert abs(sin_t - np.sin(ang_i) / 1.5) < 1e-5
    assert float(wi[0, 1]) < 0  # into the surface


def test_dielectric_tir():
    """Beyond the critical angle inside glass, only reflection survives."""
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    ang_i = 1.2  # > asin(1/1.5) ≈ 0.7297
    wo = jnp.asarray([[np.sin(ang_i), np.cos(ang_i), 0.0]], jnp.float32)
    # u3=0.999 would normally pick refraction; TIR must force reflection.
    wi, w, pdf, is_delta, transmit = _sample_dielectric(wo, n, 1.5, 0.999)
    assert not bool(transmit[0])
    assert float(wi[0, 1]) > 0  # reflected back up
    np.testing.assert_allclose(
        np.asarray(wi[0]), [np.sin(ang_i), -np.cos(ang_i), 0.0] * np.array([-1, -1, 1]),
        atol=1e-5,
    )


def test_diffuse_sample_cosine_distributed():
    shape = (4096,)
    kind = jnp.zeros(shape, jnp.int32)
    rho = jnp.ones(shape + (3,), jnp.float32)
    n = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), shape + (3,))
    wo = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), shape + (3,))
    idx = jnp.arange(4096, dtype=jnp.uint32)
    u1, u2 = sampler.r2_pair(idx, jnp.uint32(7))
    wi, w, pdf, is_delta, transmit = bsdf_mod.sample(
        kind, rho, jnp.zeros_like(rho), jnp.full(shape, 1.5), n, wo, 5.0,
        u1, u2, jnp.zeros(shape),
    )
    cz = np.asarray(wi[..., 2])
    assert (cz > 0).all()
    # E[cosθ] = 2/3 for pdf = cosθ/π.
    assert abs(cz.mean() - 2.0 / 3.0) < 0.01
    np.testing.assert_allclose(np.asarray(pdf), cz / np.pi, atol=1e-5)


# ------------------------------------------------------- integrator physics

CAM = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))


def _scene(kinds=None, iors=None, albedo=(0.6, 0.6, 0.6), light=(6.0, 5.0, -4.0, 1.0)):
    # Sphere dead ahead of the camera so the center pixel hits it.
    return sphere_scene(
        centers=[[0.0, 2.0, 6.0]], radii=[1.0], albedos=[list(albedo)],
        kinds=kinds, iors=iors, light=light,
        diffuse_energy=1.0, specular_energy=0.0, with_floor=False,
    )


def test_direct_light_matches_quadrature_oracle():
    """A diffuse sphere lit by the sphere light: the center pixel's NEE
    estimate converges to ρ/π · Le · ∫_cone cosθ dΩ (quadrature oracle)."""
    cfg = RenderConfig(width=9, height=9, max_depth=1, spp=256)
    scene = _scene()
    img = jax.jit(
        wavefront.pathtrace, static_argnames=("config",)
    )(scene, CAM, cfg, 0)
    got = np.asarray(img[4, 4])

    # Oracle: hit point ≈ nearest point of the sphere along +z from (0,2,0);
    # compute it exactly, then integrate the cosine over the light cone.
    ro = np.array([0.0, 2.0, 0.0])
    c = np.array([0.0, 2.0, 6.0])
    rd = np.array([0.0, 0.0, 1.0])
    # Center-pixel ray of a 9x9 grid is exactly +z after normalize/rotate(0).
    oc = ro - c
    b = oc @ rd
    t = -b - np.sqrt(b * b - (oc @ oc - 1.0)) - 1e-3  # march pullback eps
    hl = ro + rd * t
    n = (hl - c) / np.linalg.norm(hl - c)

    lc = np.array([6.0, 5.0, -4.0])
    lv = lc - hl
    d = np.linalg.norm(lv)
    w = lv / d
    cos_max = np.sqrt(1.0 - (1.0 / d) ** 2)
    # Quadrature over the cone (θ, φ).
    th = np.linspace(0.0, np.arccos(cos_max), 512)
    f, r = np.zeros(3), np.zeros(3)
    # Build ONB around w.
    a = np.array([0.0, 1.0, 0.0]) if abs(w[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    f = np.cross(w, a); f /= np.linalg.norm(f)
    r = np.cross(w, f)
    phi = np.linspace(0.0, 2 * np.pi, 512, endpoint=False)
    TH, PH = np.meshgrid(th, phi, indexing="ij")
    dirs = (
        np.sin(TH)[..., None] * (np.cos(PH)[..., None] * f + np.sin(PH)[..., None] * r)
        + np.cos(TH)[..., None] * w
    )
    cos_i = np.clip(dirs @ n, 0.0, None)
    dOmega = np.sin(TH) * (th[1] - th[0]) * (2 * np.pi / 512)
    integral = (cos_i * dOmega).sum()
    expect = 0.6 / np.pi * 10.0 * integral  # ρ/π · Le · ∫cos dΩ

    np.testing.assert_allclose(got, expect, rtol=0.08)


def test_glossy_nee_matches_quadrature_oracle():
    """A GLOSSY sphere lit by the sphere light: the center pixel's depth-1
    estimate converges to the exact NEE expectation

        E = ∫_cone w_nee(ω) · f·cos(ω) · Le dΩ,
        f·cos = ρ_s (g+2)/2π · cosᵍα · cosθi,

    catching any f/pdf convention mismatch between eval_pdf and sample()
    (a sign(cosθi) in place of cosθi overestimates grazing NEE by 1/cosθi)."""
    gloss = 5.0
    cfg = RenderConfig(width=9, height=9, max_depth=1, spp=512, gloss=gloss)
    scene = sphere_scene(
        centers=[[0.0, 2.0, 6.0]], radii=[1.0], albedos=[[0.6, 0.6, 0.6]],
        kinds=[BSDF.GLOSSY], light=(6.0, 5.0, -4.0, 1.0),
        diffuse_energy=0.0, specular_energy=1.0, with_floor=False,
    )
    img = jax.jit(
        wavefront.pathtrace, static_argnames=("config",)
    )(scene, CAM, cfg, 0)
    got = np.asarray(img[4, 4])

    # Exact center-pixel hit geometry (camera at (0,2,0) looking +z).
    ro = np.array([0.0, 2.0, 0.0])
    c = np.array([0.0, 2.0, 6.0])
    rd = np.array([0.0, 0.0, 1.0])
    oc = ro - c
    b = oc @ rd
    t = -b - np.sqrt(b * b - (oc @ oc - 1.0)) - 1e-3
    hl = ro + rd * t
    n = (hl - c) / np.linalg.norm(hl - c)
    refl = rd - 2.0 * (rd @ n) * n

    lc = np.array([6.0, 5.0, -4.0])
    lv = lc - hl
    d = np.linalg.norm(lv)
    w = lv / d
    cos_max = np.sqrt(1.0 - (1.0 / d) ** 2)
    l_pdf = 1.0 / (2.0 * np.pi * (1.0 - cos_max))

    a = np.array([0.0, 1.0, 0.0]) if abs(w[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    f = np.cross(w, a); f /= np.linalg.norm(f)
    r = np.cross(w, f)
    th = np.linspace(0.0, np.arccos(cos_max), 512)
    phi = np.linspace(0.0, 2 * np.pi, 512, endpoint=False)
    TH, PH = np.meshgrid(th, phi, indexing="ij")
    dirs = (
        np.sin(TH)[..., None] * (np.cos(PH)[..., None] * f + np.sin(PH)[..., None] * r)
        + np.cos(TH)[..., None] * w
    )
    cos_i = np.clip(dirs @ n, 0.0, None)
    cos_a = np.clip(dirs @ refl, 0.0, None)
    f_cos = 0.6 * (gloss + 2.0) / (2.0 * np.pi) * cos_a**gloss * cos_i
    b_pdf = np.where(cos_i > 0, (gloss + 1.0) / (2.0 * np.pi) * cos_a**gloss, 0.0)
    w_nee = l_pdf / (l_pdf + b_pdf)
    dOmega = np.sin(TH) * (th[1] - th[0]) * (2 * np.pi / 512)
    expect = (w_nee * f_cos * 10.0 * dOmega).sum()

    np.testing.assert_allclose(got, expect, rtol=0.08)


def test_dielectric_internal_reflection_rehits_glass():
    """An internally reflected ray (Fresnel reflection at the exit interface)
    must re-hit its own sphere from inside, not escape through the wall: with
    the light *behind* the camera, a glass sphere still shows contributions
    from internal-bounce paths and never leaks a stale inside flag (finite,
    energy-bounded image)."""
    scene = sphere_scene(
        centers=[[0.0, 2.0, 4.0]], radii=[1.0], albedos=[[1.0, 1.0, 1.0]],
        kinds=[BSDF.DIELECTRIC], iors=[1.5],
        light=(0.0, 2.0, 9.0, 1.0),
        diffuse_energy=1.0, specular_energy=0.0, with_floor=False,
    )
    cfg = RenderConfig(width=24, height=24, max_depth=8, spp=16)
    img = jax.jit(
        wavefront.pathtrace, static_argnames=("config",)
    )(scene, CAM, cfg, 0)
    assert bool(jnp.isfinite(img).all())
    # Energy conservation: nothing exceeds the light's emission.
    assert float(img.max()) <= 10.0 + 1e-3
    # Transmission through both interfaces still dominates the center.
    assert float(img[12, 12].max()) > 0.5


def test_mirror_reflects_light_geometrically():
    """Looking at a mirror sphere from where its reflection of the light is
    visible produces pixels that saw the light's full emission."""
    # Big light right above the mirror sphere: the sphere's upper cap
    # reflects camera rays up into the light — a pure delta path.
    scene = _scene(kinds=[BSDF.MIRROR], light=(0.0, 8.0, 6.0, 3.0))
    cfg = RenderConfig(width=48, height=48, max_depth=2, spp=1)
    img = jax.jit(
        wavefront.pathtrace, static_argnames=("config",)
    )(scene, CAM, cfg, 0)
    # Delta path, MIS weight 1: pixel = tint 0.6 × Le 10 = 6 exactly.
    assert float(img.max()) > 4.0
    assert bool(jnp.isfinite(img).all())


def test_deeper_paths_add_energy_not_bias():
    """With a floor under the sphere, indirect bounces add energy; the image
    stays finite and monotonically brighter in the mean."""
    scene = sphere_scene(
        centers=[[0.0, 1.0, 6.0]], radii=[1.0], albedos=[[0.7, 0.7, 0.7]],
        diffuse_energy=1.0, specular_energy=0.0, with_floor=True,
    )
    cfg1 = RenderConfig(width=24, height=24, max_depth=1, spp=8)
    cfg6 = RenderConfig(width=24, height=24, max_depth=6, spp=8)
    f = jax.jit(wavefront.pathtrace, static_argnames=("config",))
    i1 = f(scene, CAM, cfg1, 0)
    i6 = f(scene, CAM, cfg6, 0)
    assert bool(jnp.isfinite(i6).all())
    assert float(i6.mean()) > float(i1.mean())
    # Indirect light is a correction, not a blow-up.
    assert float(i6.mean()) < 4.0 * float(i1.mean()) + 1e-3


def test_pathtrace_deterministic():
    scene = _scene()
    cfg = RenderConfig(width=16, height=16, max_depth=3, spp=2)
    f = jax.jit(wavefront.pathtrace, static_argnames=("config",))
    a = f(scene, CAM, cfg, 0)
    b = f(scene, CAM, cfg, 0)
    assert (a == b).all()
    c = f(scene, CAM, cfg, 1)  # different frame → different sample index
    assert not bool((a == c).all())


def test_wavefront_gradient_matches_finite_difference():
    """dL/d(radius) through 2 bounces ≈ central finite difference."""
    cfg = RenderConfig(width=12, height=12, max_depth=2, spp=4)
    base = _scene()

    def loss(dr):
        sph = base.spheres.at[1, 3].add(dr)
        img = wavefront.pathtrace(base.replace(spheres=sph), CAM, cfg, 0)
        return img.sum()

    g = float(jax.grad(loss)(0.0))
    h = 1e-3
    fd = (float(loss(h)) - float(loss(-h))) / (2 * h)
    # Visibility edges make FD noisy; interior shading terms dominate here.
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=0.15, atol=0.05)


def test_dielectric_renders_finite_and_transmits():
    """A glass sphere in front of the light: light reaches the camera
    through the glass (nonzero pixels behind it), everything finite."""
    scene = sphere_scene(
        centers=[[0.0, 2.0, 4.0]], radii=[1.0], albedos=[[1.0, 1.0, 1.0]],
        kinds=[BSDF.DIELECTRIC], iors=[1.5],
        light=(0.0, 2.0, 9.0, 1.0),
        diffuse_energy=1.0, specular_energy=0.0, with_floor=False,
    )
    cfg = RenderConfig(width=24, height=24, max_depth=6, spp=4)
    img = jax.jit(
        wavefront.pathtrace, static_argnames=("config",)
    )(scene, CAM, cfg, 0)
    assert bool(jnp.isfinite(img).all())
    # The center pixel looks straight through the glass at the light.
    assert float(img[12, 12].max()) > 0.5
