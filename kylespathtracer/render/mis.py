"""MIS-weighted light + surface sampling estimators.

Branchless, batched equivalents of the reference's PDF strategies,
contribution estimators and the DMIS/SMIS sampling strategies
(reference: common.glsl:300-616). The reference's per-pixel if/else roulette
over four planes becomes: evaluate all P plane PDFs (cheap fma chains),
cumulative-sum a CDF, pick one plane per pixel with the shared Weyl draw,
gather that plane's parameters, and run a *single* contribution march —
same variance properties, no divergence, P-way generality.

All estimators take a `trace(scene, ro, rd, exclude)` callable so the same
code runs on the sphere-trace path (reference parity) and the analytic path
(speed); both are differentiable via the IFT backward.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath, sampler
from kylespathtracer.scene import materials as mat_mod
from kylespathtracer.scene.types import OBJ, Scene


# ------------------------------------------------------------- PDFs (G9)

def sphere_light_pdf(hl, li, seed=None, pre=None):
    """Cone sample toward a sphere light → (dir[...,3], pdf[...]).

    (reference: common.glsl:300-305)
    """
    lv = li[:3] - hl
    dir_ = sampler.uniform_cone_dir(lv, li[3], seed, pre=pre)
    pdf = gmath.solid_angle(gmath.dot(lv, lv), li[3] * li[3])
    return dir_, pdf


def lambert_plane_pdf(hl, li, pl, seed=None, pre=None):
    """Cone sample toward the light's projection disc on a diffuse plane.

    pl: (...,4) or (4,) plane (n, w). Returns (dir, pdf)
    (reference: common.glsl:308-322).
    """
    n = pl[..., :3]
    w = pl[..., 3]
    # Project the light onto the plane.
    d = li[:3] - n * (gmath.dot_k(jnp.broadcast_to(li[:3], n.shape), n) + w[..., None])
    dv = d - hl
    ld = li[:3] - d
    frad = jnp.minimum(gmath.length(dv), gmath.length(ld)) * 0.9
    dir_ = sampler.uniform_cone_dir(dv, frad, seed, pre=pre)
    lpdf = gmath.solid_angle(gmath.dot(dv, dv), frad * frad) / gmath.PI
    g2pdf = gmath.lambertian(n, -dir_)
    # Degenerate geometry (shaded point at the light's plane projection →
    # dv≈0): finite dir from the safe normalize, pdf forced to 0 so the
    # roulette never weights this strategy.
    ok = gmath.dot(dv, dv) > 1e-12
    return dir_, jnp.where(ok, lpdf * g2pdf, 0.0)


def phong_plane_pdf(hl, li, pl, seed=None, pre=None):
    """Cone sample toward the light's mirror image in a glossy plane.

    (reference: common.glsl:325-343)
    """
    n = pl[..., :3]
    w = pl[..., 3]
    a = gmath.dot(hl, n) + w
    b = gmath.dot(jnp.broadcast_to(li[:3], n.shape), n) + w
    # Similar triangles: reflection point on the plane between hl and light.
    # Guard a+b≈0 (hit and light on opposite sides at equal heights — only
    # reachable for already-masked rays) against NaN leaking through grads.
    ab = a + b
    ab = jnp.where(jnp.abs(ab) < 1e-6, 1e-6, ab)
    s = gmath.mix(
        hl - a[..., None] * n,
        li[:3] - b[..., None] * n,
        (a / ab)[..., None],
    )
    sv = s - hl
    lsv = jnp.sqrt(gmath.dot(sv, sv)) * li[3]
    ls = li[:3] - s
    ts = sv * jnp.sqrt(gmath.dot(ls, ls))[..., None]
    dir_ = sampler.uniform_cone_dir(ts, lsv, seed, pre=pre)
    lpdf = gmath.solid_angle(gmath.dot(ts, ts), lsv * lsv) / gmath.PI
    spdf = gmath.schlick(1.0, 3.0, gmath.dot(gmath.normalize(sv), n))
    # Degenerate geometry (shaded point on the sampled plane → sv≈0, only
    # reachable through f32 cancellation in a+b): pdf forced to 0.
    ok = gmath.dot(sv, sv) > 1e-12
    return dir_, jnp.where(ok, lpdf * spdf, 0.0)


# ----------------------------------------------------- contributions (G10)

def light_contribution(scene: Scene, trace, hl, ho, dir_, pdf):
    """March toward the light; lightColor·pdf on hit, else 0.

    The pdf *multiplies* (biased weighting, not division)
    (reference: common.glsl:348-353).
    """
    _, lm_id = trace(scene, hl, dir_, ho)
    hit = lm_id == scene.light_id
    return jnp.where(hit[..., None], scene.light_color * pdf[..., None], 0.0)


def plane_contrib(scene: Scene, trace, dir_, pdfw, hl, ho, pl, po, seed,
                  energy_channel: int, pre=None):
    """March to a sampled plane, verify the hit, re-sample the light there.

    energy_channel 0 → LambertPlaneContrib (diffuse energy, common.glsl:356-371),
    1 → PhongPlaneContrib (specular energy, common.glsl:374-389).
    """
    t, tid = trace(scene, hl, dir_, ho)
    ok = tid == po
    n = pl[..., :3]
    hl2 = hl + dir_ * t[..., None] + n * gmath.EPS
    lv2 = scene.light[:3] - hl2
    sample_dir = sampler.uniform_cone_dir(lv2, scene.light[3], seed, pre=pre)
    lc = light_contribution(scene, trace, hl2, po, sample_dir, pdfw)
    albedo, emission, energy = mat_mod.surface(scene.materials, po, hl2)
    contrib = emission + energy[..., energy_channel:energy_channel + 1] * albedo * lc
    return jnp.where(ok[..., None], contrib, 0.0)


# ------------------------------------------------- strategies (G11)

def plane_pdfs(scene: Scene, pdf_fn, hl, seed=None, pre=None):
    """Evaluate pdf_fn for every plane at once → (dirs[...,P,3], pdfs[...,P]).

    Shared between DMIS and SMIS in the fused path: the reference evaluates
    these cone samples twice per frame with identical seeds
    (common.glsl:456-472 in DMIS vs :551-567 in SMIS) — the samples are
    bitwise the same, so compute them once.
    """
    hl_p = hl[..., None, :]                    # (..., 1, 3)
    if pre is not None:
        pre = tuple(c[..., None] for c in pre)
        return pdf_fn(hl_p, scene.light, scene.planes, None, pre=pre)
    return pdf_fn(hl_p, scene.light, scene.planes, seed[..., None])


def _roulette_from(scene: Scene, trace, dirs, pdfs, brdf_w, hl, ho, seed,
                   energy_channel: int, pre=None):
    """Indirect block from precomputed per-plane samples: weight → CDF →
    one-sample roulette → single contribution march
    (reference: common.glsl:453-519, 548-613).
    """
    planes = scene.planes                      # (P, 4)
    w = pdfs * brdf_w(dirs)                    # (..., P)

    cdf = jnp.cumsum(w, axis=-1)
    total = cdf[..., -1]
    rnd = (pre[3] if pre is not None else sampler.weyl3(seed)[..., 2]) * total
    # idx = first k with rnd <= cdf_k; the last plane is the unconditional
    # else branch (common.glsl:475-482).
    idx = jnp.sum((rnd[..., None] > cdf[..., :-1]).astype(jnp.int32), axis=-1)

    take = lambda arr: jnp.take_along_axis(arr, idx[..., None], axis=-1)[..., 0]
    dir_sel = jnp.take_along_axis(
        dirs, idx[..., None, None], axis=-2
    )[..., 0, :]
    w_sel = take(w)
    pl_sel = planes[idx]                       # (..., 4)
    po_sel = scene.plane_ids[idx]

    contrib = plane_contrib(
        scene, trace, dir_sel, w_sel, hl, ho, pl_sel, po_sel, seed,
        energy_channel, pre=pre,
    )
    return contrib * (total / jnp.maximum(gmath.EPS, w_sel))[..., None]


def _roulette_planes(scene: Scene, trace, pdf_fn, brdf_w, hl, ho, seed,
                     energy_channel: int):
    """PDF evaluation + roulette in one call (the unfused estimators)."""
    dirs, pdfs = plane_pdfs(scene, pdf_fn, hl, seed)
    return _roulette_from(
        scene, trace, dirs, pdfs, brdf_w, hl, ho, seed, energy_channel
    )


def dual_mis(scene: Scene, trace, rd, hl, hn, ho, seed, config):
    """DMIS and SMIS fused → (diffuse_est, specular_est).

    The reference runs the two estimators in separate fragment passes with
    identical per-pixel seeds, so every cone sample and the direct-light
    visibility march are computed twice (common.glsl:430-522 vs :525-616).
    Here the per-plane PDF samples are evaluated once and the direct-light
    march is shared; only the BRDF weightings, roulettes and the selected
    plane marches differ. Requires all six SMP_* counts equal (the
    reference's defaults are all 1; pipeline falls back to dmis+smis
    otherwise).
    """
    smp = config.smp_direct_lambert
    assert (
        smp == config.smp_lambert_surface_lambert
        == config.smp_lambert_surface_phong == config.smp_direct_phong
        == config.smp_phong_surface_lambert == config.smp_phong_surface_phong
    ), "dual_mis requires equal sample counts; use dmis/smis"

    gloss = config.gloss
    lam = lambda dirs: jnp.maximum(
        gmath.EPS, jnp.sum(dirs * hn[..., None, :], axis=-1)
    )
    refl = gmath.reflect(rd, hn)[..., None, :]
    pho = lambda dirs: gmath.pow_static(
        jnp.maximum(gmath.EPS, jnp.sum(dirs * refl, axis=-1)), gloss
    )

    est_d = jnp.zeros(hl.shape, hl.dtype)
    est_s = jnp.zeros(hl.shape, hl.dtype)
    for i in range(smp):
        si = sampler.fold_seed(seed, i, config.decorrelate_samples)
        pre = sampler.cone_pre(si)

        # Direct-light cone sample (the visibility march is batched with the
        # roulette plane marches below — one trace call instead of five, so
        # the intersector is traced/compiled once).
        dl_dir, dl_pdf = sphere_light_pdf(hl, scene.light, pre=pre)

        # Per-plane cone samples once; four roulettes (2 estimators × 2
        # strategy families) share them.
        dirs_l, pdfs_l = plane_pdfs(scene, lambert_plane_pdf, hl, pre=pre)
        dirs_p, pdfs_p = plane_pdfs(scene, phong_plane_pdf, hl, pre=pre)

        sels = []
        for dirs, pdfs, brdf_w in (
            (dirs_l, pdfs_l, lam),
            (dirs_p, pdfs_p, lam),
            (dirs_l, pdfs_l, pho),
            (dirs_p, pdfs_p, pho),
        ):
            sels.append(_roulette_select(scene, dirs, pdfs, brdf_w, pre))

        # Stage A: direct-light visibility + the 4 selected plane marches,
        # one batched trace from hl.
        dirs_a = jnp.stack([dl_dir] + [s["dir"] for s in sels], axis=0)
        ro_a = jnp.broadcast_to(hl, dirs_a.shape)
        ho_a = jnp.broadcast_to(ho, dirs_a.shape[:-1])
        t_a, id_a = trace(scene, ro_a, dirs_a, ho_a)

        if config.soft_shadows > 0.0:
            # Differentiable silhouettes: smooth sphere transmittance instead
            # of the hard march hit (diff/softvis.py; biased, inverse-
            # rendering mode only). Planes/boxes are NOT softened: the hard
            # trace result still gates them — a shadow ray whose nearest hit
            # is a plane or box (or a miss) keeps zero visibility, only
            # sphere occlusion is smoothed.
            from kylespathtracer.diff import softvis

            dist = gmath.length(scene.light[:3] - hl)
            t_surf = jnp.maximum(dist - scene.light[3], gmath.EPS)
            vis = softvis.sphere_soft_transmittance(
                scene, hl, dl_dir, t_surf, ho, config.soft_shadows
            )
            sphere_or_light = jnp.any(
                id_a[0][..., None] == scene.sphere_ids, axis=-1
            )
            vis = jnp.where(sphere_or_light, vis, 0.0)
            base = scene.light_color * vis[..., None]
        else:
            base = jnp.where(
                (id_a[0] == scene.light_id)[..., None], scene.light_color, 0.0
            )
        est_d += base * (dl_pdf * gmath.lambertian(hn, dl_dir))[..., None]
        est_s += base * (dl_pdf * gmath.phong(rd, hn, dl_dir, gloss))[..., None]

        # Stage B: the 4 light re-samples from the sampled-plane points,
        # one more batched trace.
        hl2s, sdirs, pos = [], [], []
        for k, s in enumerate(sels):
            n = s["plane"][..., :3]
            hl2 = hl + s["dir"] * t_a[k + 1][..., None] + n * gmath.EPS
            lv2 = scene.light[:3] - hl2
            hl2s.append(hl2)
            sdirs.append(sampler.uniform_cone_dir(lv2, scene.light[3], pre=pre))
            pos.append(s["po"])
        ro_b = jnp.stack(hl2s, axis=0)
        dirs_b = jnp.stack(sdirs, axis=0)
        po_b = jnp.stack(pos, axis=0)
        _, id_b = trace(scene, ro_b, dirs_b, po_b)

        for k, (s, ch, est) in enumerate(
            ((sels[0], 0, "d"), (sels[1], 1, "d"), (sels[2], 0, "s"),
             (sels[3], 1, "s"))
        ):
            ok = id_a[k + 1] == s["po"]
            lhit = id_b[k] == scene.light_id
            lc = jnp.where(
                lhit[..., None], scene.light_color * s["w"][..., None], 0.0
            )
            albedo, emission, energy = mat_mod.surface(
                scene.materials, s["po"], ro_b[k]
            )
            contrib = emission + energy[..., ch:ch + 1] * albedo * lc
            contrib = jnp.where(ok[..., None], contrib, 0.0)
            contrib = contrib * (s["total"] / jnp.maximum(gmath.EPS, s["w"]))[..., None]
            if est == "d":
                est_d += contrib
            else:
                est_s += contrib

    return est_d / smp, est_s / smp


def _roulette_select(scene: Scene, dirs, pdfs, brdf_w, pre):
    """The roulette pick of `_roulette_from`, without the marches: returns
    the selected direction/weight/plane/id and the CDF total so the marches
    can be batched across strategies (common.glsl:453-519)."""
    w = pdfs * brdf_w(dirs)
    cdf = jnp.cumsum(w, axis=-1)
    total = cdf[..., -1]
    rnd = pre[3] * total
    idx = jnp.sum((rnd[..., None] > cdf[..., :-1]).astype(jnp.int32), axis=-1)
    dir_sel = jnp.take_along_axis(dirs, idx[..., None, None], axis=-2)[..., 0, :]
    w_sel = jnp.take_along_axis(w, idx[..., None], axis=-1)[..., 0]
    return {
        "dir": dir_sel,
        "w": w_sel,
        "total": total,
        "plane": scene.planes[idx],
        "po": scene.plane_ids[idx],
    }


def dmis(scene: Scene, trace, hl, hn, ho, seed, config):
    """Diffuse MIS: direct light + roulette over Lambert/Phong plane
    strategies, Lambertian-weighted (reference: common.glsl:430-522)."""
    ret = jnp.zeros(hl.shape, hl.dtype)
    lam = lambda dirs: jnp.maximum(gmath.EPS, jnp.sum(dirs * hn[..., None, :], axis=-1))

    if config.smp_direct_lambert:
        acc = 0.0
        for i in range(config.smp_direct_lambert):
            si = sampler.fold_seed(seed, i, config.decorrelate_samples)
            dl_dir, dl_pdf = sphere_light_pdf(hl, scene.light, si)
            wpdf = dl_pdf * gmath.lambertian(hn, dl_dir)
            acc += light_contribution(scene, trace, hl, ho, dl_dir, wpdf)
        ret += acc / config.smp_direct_lambert

    if config.smp_lambert_surface_lambert:
        acc = 0.0
        for i in range(config.smp_lambert_surface_lambert):
            si = sampler.fold_seed(seed, i, config.decorrelate_samples)
            acc += _roulette_planes(
                scene, trace, lambert_plane_pdf, lam, hl, ho, si, 0
            )
        ret += acc / config.smp_lambert_surface_lambert

    if config.smp_lambert_surface_phong:
        acc = 0.0
        for i in range(config.smp_lambert_surface_phong):
            si = sampler.fold_seed(seed, i, config.decorrelate_samples)
            acc += _roulette_planes(
                scene, trace, phong_plane_pdf, lam, hl, ho, si, 1
            )
        ret += acc / config.smp_lambert_surface_phong

    return ret


def smis(scene: Scene, trace, rd, hl, hn, ho, seed, config):
    """Specular MIS: the same three blocks Phong-weighted
    (reference: common.glsl:525-616)."""
    ret = jnp.zeros(hl.shape, hl.dtype)
    gloss = config.gloss
    refl = gmath.reflect(rd, hn)[..., None, :]
    pho = lambda dirs: gmath.pow_static(
        jnp.maximum(gmath.EPS, jnp.sum(dirs * refl, axis=-1)), gloss
    )

    if config.smp_direct_phong:
        acc = 0.0
        for i in range(config.smp_direct_phong):
            si = sampler.fold_seed(seed, i, config.decorrelate_samples)
            dl_dir, dl_pdf = sphere_light_pdf(hl, scene.light, si)
            wpdf = dl_pdf * gmath.phong(rd, hn, dl_dir, gloss)
            acc += light_contribution(scene, trace, hl, ho, dl_dir, wpdf)
        ret += acc / config.smp_direct_phong

    if config.smp_phong_surface_lambert:
        acc = 0.0
        for i in range(config.smp_phong_surface_lambert):
            si = sampler.fold_seed(seed, i, config.decorrelate_samples)
            acc += _roulette_planes(
                scene, trace, lambert_plane_pdf, pho, hl, ho, si, 0
            )
        ret += acc / config.smp_phong_surface_lambert

    if config.smp_phong_surface_phong:
        acc = 0.0
        for i in range(config.smp_phong_surface_phong):
            si = sampler.fold_seed(seed, i, config.decorrelate_samples)
            acc += _roulette_planes(
                scene, trace, phong_plane_pdf, pho, hl, ho, si, 1
            )
        ret += acc / config.smp_phong_surface_phong

    return ret


# ---------------------------------------------- one-bounce BRDF mutators

def brdf_lambertian(hl, hn, seed):
    """Next-bounce ray for a diffuse surface → (ro, rd): offset origin along
    the normal, cosine-hemisphere direction (reference: common.glsl:418-421;
    upstream defines but never calls these — kept for the multi-bounce
    extension)."""
    ro = hl + hn * gmath.EPS
    return ro, sampler.cos_hemi_dir(hn, seed)


def brdf_phong(rd, hl, hn):
    """Next-bounce ray for a specular surface → (ro, rd): mirror reflection
    (reference: common.glsl:424-427)."""
    ro = hl + hn * gmath.EPS
    return ro, gmath.reflect(rd, hn)


# ------------------------------------------------- unbiased ground truth

def unbiased_lambertian(scene: Scene, trace, hl, hn, ho, seed, config):
    """Cosine-hemisphere brute force (reference: common.glsl:394-403)."""
    acc = 0.0
    for i in range(config.smp_direct_lambert):
        si = sampler.fold_seed(seed, i, config.decorrelate_samples)
        d = sampler.cos_hemi_dir(hn, si)
        acc += light_contribution(
            scene, trace, hl, ho, d, jnp.full(hl.shape[:-1], gmath.PI, hl.dtype)
        )
    return acc / config.smp_direct_lambert


def unbiased_phong(scene: Scene, trace, rd, hl, hn, ho, seed, config):
    """Mirror-reflection brute force (reference: common.glsl:406-415).

    The loop count reuses SMP_DIRECT_LAMBERT, as upstream does."""
    acc = 0.0
    for i in range(config.smp_direct_lambert):
        d = gmath.reflect(rd, hn)
        acc += light_contribution(
            scene, trace, hl, ho, d, jnp.ones(hl.shape[:-1], hl.dtype)
        )
    return acc / config.smp_direct_lambert
