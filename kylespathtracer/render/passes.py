"""Diffuse and specular temporal-accumulation passes.

Functional equivalents of diffuse.frag / specular.frag: reproject the
previous accumulation onto the current hits, clamp the history window by
camera velocity, add emission plus one MIS (or unbiased) sample, bump the
sample count. Old state in, new state out — the reference's same-texture
read/write feedback (main.cpp:95 vs :176) becomes honest double buffering.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath, sampler
from kylespathtracer.render import mis as mis_mod
from kylespathtracer.render import reproject as rep_mod
from kylespathtracer.render.camera import Camera
from kylespathtracer.render.gbuffer import GBuffer
from kylespathtracer.scene import materials as mat_mod
from kylespathtracer.scene import sdf as sdf_mod
from kylespathtracer.scene.types import Scene
from kylespathtracer.utils.config import RenderConfig
from kylespathtracer.utils import struct


@struct.dataclass
class Channel:
    """One accumulation buffer (diffuse or specular): SoA for the reference's
    RGBA texel with count+ID packed in alpha (common.glsl:629-635)."""

    rgb: jnp.ndarray  # f32[H,W,3]
    cnt: jnp.ndarray  # f32[H,W]
    oid: jnp.ndarray  # i32[H,W] object ID at accumulation time

    @classmethod
    def zeros(cls, height: int, width: int, dtype=jnp.float32) -> "Channel":
        return cls(
            rgb=jnp.zeros((height, width, 3), dtype),
            cnt=jnp.zeros((height, width), dtype),
            oid=jnp.zeros((height, width), jnp.int32),
        )


def get_trace(config: RenderConfig):
    """Pick the intersector: analytic (fast path) or sphere trace (parity)."""
    if config.intersect_mode == "analytic":
        from kylespathtracer.scene import intersect as isect

        return lambda scene, ro, rd, excl: isect.intersect(scene, ro, rd, excl)
    return lambda scene, ro, rd, excl: sdf_mod.march(
        scene, ro, rd, excl, config.steps
    )


def count_floor(cnt):
    """floor(count + 1e-4): the reprojected-sample-count floor
    (fcol.a = floor(fcol.a), diffuse.frag:46) with an epsilon guard.

    Counts are semantically integers whenever the 2x2 taps agree, but
    float32 bilinear weights reconstruct them as c·(1±1e-4-ish) when the
    projection lands near a texel center (du ≈ 0 or 1): a bare floor then
    drops an exact count of 3 to 2 on knife-edge pixels. Measured at 1080p
    over the 8-frame config-4 spline, ~0.3% of border-adjacent pixels
    knife-edged per frame and the count offsets compounded through the
    history. Every pipeline floors through this helper so the paths cannot
    diverge. Genuinely fractional counts (partial tap coverage) are
    unaffected at 1e-4."""
    return jnp.floor(cnt + 1e-4)


def _temporal_clamp(rep_rgb, rep_cnt, vv, config: RenderConfig):
    """Velocity-adaptive history clamp (diffuse.frag:49-51).

    lvv = min(T-1, int(T·2·sqrt(|vv|))); texels holding more than T-lvv
    samples are rescaled down to exactly T-lvv.
    """
    T = float(config.temporal)
    lvv = jnp.minimum(T - 1.0, jnp.floor(T * 2.0 * jnp.sqrt(vv)))
    limit = T - lvv
    over = rep_cnt > limit
    scale = jnp.where(over, limit / jnp.maximum(rep_cnt, 1e-6), 1.0)
    return rep_rgb * scale[..., None], jnp.where(over, limit, rep_cnt)


def _shade_common(scene, config, gb: GBuffer, camera: Camera, frame):
    hl = camera.loc + gb.ray_dir * gb.depth[..., None]
    H, W = gb.obj_id.shape
    px = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (H, W))
    py = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[:, None], (H, W))
    seed = sampler.gen_seed(frame, px, py, W, H)
    return hl, seed


def shade_passes(
    scene: Scene,
    config: RenderConfig,
    gb: GBuffer,
    camera: Camera,
    prev_camera: Camera,
    prev_d: Channel,
    prev_s: Channel,
    frame: jnp.ndarray,
) -> tuple[Channel, Channel]:
    """Diffuse + specular accumulation fused into one pass.

    The reference renders them as two sequential fragment passes with
    identical per-pixel seeds (main.cpp:346-348), recomputing every cone
    sample, the direct-light march, the material fetch and the curvature.
    Fused, the shared work runs once (mis.dual_mis); results are bitwise the
    estimators of diffuse.frag:26-79 / specular.frag:26-83.

    Falls back to the unfused passes when the per-strategy sample counts
    differ (dual_mis requires them equal) or the unbiased estimators are on.
    """
    if not config.biased or not (
        config.smp_direct_lambert
        == config.smp_lambert_surface_lambert == config.smp_lambert_surface_phong
        == config.smp_direct_phong
        == config.smp_phong_surface_lambert == config.smp_phong_surface_phong
    ):
        d = diffuse_pass(scene, config, gb, camera, prev_camera, prev_d, frame)
        s = specular_pass(scene, config, gb, camera, prev_camera, prev_s, frame)
        return d, s

    trace = get_trace(config)
    hl, seed = _shade_common(scene, config, gb, camera, frame)
    ho = gb.obj_id
    hn = gb.normal
    rd = gb.ray_dir
    vv = gmath.length(camera.loc - prev_camera.loc)

    if config.no_history:
        # Fresh-history single-frame render: the reprojection of an all-zero
        # history is zeros — skip the gather (dominant in the differentiable
        # single-frame forward) and the temporal clamp entirely.
        zero3 = jnp.zeros(ho.shape + (3,), jnp.float32)
        zero1 = jnp.zeros(ho.shape, jnp.float32)
        rep_rgb_d = rep_rgb_s = zero3
        rep_cnt_d = rep_cnt_s = zero1
    else:
        # Diffuse reprojects at the hit point; specular pushes the anchor
        # toward the virtual image by curvature (specular.frag:45-49;
        # curvature comes from the G-buffer instead of a second norcurv).
        light_dist = gmath.length(hl - scene.light[:3])
        fac = gmath.EPS / jnp.sqrt(jnp.maximum(gmath.EPS, gb.curv))
        sl = hl + rd * (light_dist * fac)[..., None]

        rep_rgb_d, rep_cnt_d = rep_mod.reproject(
            prev_camera.loc, prev_camera.orient, hl, ho,
            prev_d.rgb, prev_d.cnt, prev_d.oid, config.fov,
        )
        rep_rgb_s, rep_cnt_s = rep_mod.reproject(
            prev_camera.loc, prev_camera.orient, sl, ho,
            prev_s.rgb, prev_s.cnt, prev_s.oid, config.fov,
        )
        rep_cnt_d = count_floor(rep_cnt_d)
        rep_cnt_s = count_floor(rep_cnt_s)
        rep_rgb_d, rep_cnt_d = _temporal_clamp(rep_rgb_d, rep_cnt_d, vv, config)
        rep_rgb_s, rep_cnt_s = _temporal_clamp(rep_rgb_s, rep_cnt_s, vv, config)

    _, emission, _ = mat_mod.surface(scene.materials, ho, hl)
    est_d, est_s = mis_mod.dual_mis(scene, trace, rd, hl, hn, ho, seed, config)
    shade = ((ho != scene.light_id) & (ho > 0))[..., None]

    rgb_d = rep_rgb_d + emission + jnp.where(shade, est_d, 0.0)
    rgb_s = rep_rgb_s + emission + jnp.where(shade, est_s, 0.0)
    return (
        Channel(rgb=rgb_d, cnt=rep_cnt_d + 1.0, oid=ho),
        Channel(rgb=rgb_s, cnt=rep_cnt_s + 1.0, oid=ho),
    )


def diffuse_pass(
    scene: Scene,
    config: RenderConfig,
    gb: GBuffer,
    camera: Camera,
    prev_camera: Camera,
    prev: Channel,
    frame: jnp.ndarray,
) -> Channel:
    """(reference: diffuse.frag:26-79)"""
    trace = get_trace(config)
    hl, seed = _shade_common(scene, config, gb, camera, frame)
    ho = gb.obj_id
    hn = gb.normal
    vv = gmath.length(camera.loc - prev_camera.loc)

    if config.no_history:
        rep_rgb = jnp.zeros(ho.shape + (3,), jnp.float32)
        rep_cnt = jnp.zeros(ho.shape, jnp.float32)
    else:
        rep_rgb, rep_cnt = rep_mod.reproject(
            prev_camera.loc, prev_camera.orient, hl, ho,
            prev.rgb, prev.cnt, prev.oid, config.fov,
        )
        rep_cnt = count_floor(rep_cnt)  # fcol.a = floor(fcol.a), diffuse.frag:46
        rep_rgb, rep_cnt = _temporal_clamp(rep_rgb, rep_cnt, vv, config)

    _, emission, _ = mat_mod.surface(scene.materials, ho, hl)
    rgb = rep_rgb + emission

    if config.biased:
        est = mis_mod.dmis(scene, trace, hl, hn, ho, seed, config)
    else:
        est = mis_mod.unbiased_lambertian(scene, trace, hl, hn, ho, seed, config)
    # The reference only skips the light (diffuse.frag:59); we also skip
    # misses, whose G-buffer normals the reference leaves NaN (common.glsl:625).
    shade = (ho != scene.light_id) & (ho > 0)
    rgb = rgb + jnp.where(shade[..., None], est, 0.0)

    return Channel(rgb=rgb, cnt=rep_cnt + 1.0, oid=ho)


def specular_pass(
    scene: Scene,
    config: RenderConfig,
    gb: GBuffer,
    camera: Camera,
    prev_camera: Camera,
    prev: Channel,
    frame: jnp.ndarray,
) -> Channel:
    """(reference: specular.frag:26-83)"""
    trace = get_trace(config)
    hl, seed = _shade_common(scene, config, gb, camera, frame)
    ho = gb.obj_id
    hn = gb.normal
    rd = gb.ray_dir
    vv = gmath.length(camera.loc - prev_camera.loc)

    # Reprojection anchor pushed toward the virtual image by surface
    # curvature (specular.frag:45-49). The curvature comes from the G-buffer
    # (computed once alongside the normal) instead of a second norcurv; the
    # two evaluation points differ by eps along the ray, which is far inside
    # the fac clamp below.
    curv = gb.curv
    light_dist = gmath.length(hl - scene.light[:3])
    fac = gmath.EPS / jnp.sqrt(jnp.maximum(gmath.EPS, curv))
    sl = hl + rd * (light_dist * fac)[..., None]

    if config.no_history:
        rep_rgb = jnp.zeros(ho.shape + (3,), jnp.float32)
        rep_cnt = jnp.zeros(ho.shape, jnp.float32)
    else:
        rep_rgb, rep_cnt = rep_mod.reproject(
            prev_camera.loc, prev_camera.orient, sl, ho,
            prev.rgb, prev.cnt, prev.oid, config.fov,
        )
        rep_cnt = count_floor(rep_cnt)
        rep_rgb, rep_cnt = _temporal_clamp(rep_rgb, rep_cnt, vv, config)

    _, emission, _ = mat_mod.surface(scene.materials, ho, hl)
    rgb = rep_rgb + emission

    if config.biased:
        est = mis_mod.smis(scene, trace, rd, hl, hn, ho, seed, config)
    else:
        est = mis_mod.unbiased_phong(scene, trace, rd, hl, hn, ho, seed, config)
    shade = (ho != scene.light_id) & (ho > 0)
    rgb = rgb + jnp.where(shade[..., None], est, 0.0)

    return Channel(rgb=rgb, cnt=rep_cnt + 1.0, oid=ho)
