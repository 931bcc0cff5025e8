"""Render pipeline tests: gbuffer, estimator sanity, temporal accumulation,
composite, and analytic-vs-march agreement."""

import numpy as np
import jax
import jax.numpy as jnp

from kylespathtracer.render import camera as cam_mod
from kylespathtracer.render import gbuffer as gb_mod
from kylespathtracer.render.pipeline import init_history, render_frame, render_image
from kylespathtracer.scene import OBJ, default_scene
from kylespathtracer.utils.config import RenderConfig

SCENE = default_scene()
CFG = RenderConfig(width=64, height=48)
CAM = cam_mod.Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))


def test_ray_dirs_match_reference_formula():
    from kylespathtracer.cpu_reference import glslref as ref

    rd = np.asarray(cam_mod.ray_dirs(CAM, 64, 48))
    assert rd.shape == (48, 64, 3)
    np.testing.assert_allclose(np.linalg.norm(rd, axis=-1), 1.0, atol=1e-5)
    # Spot-check a few pixels against a direct scalar evaluation.
    for (y, x) in [(0, 0), (47, 63), (24, 32), (10, 50)]:
        asp = 64 / 48
        ndca = np.array(
            [(2 * (x + 0.5) / 64 - 1) * asp, 2 * (y + 0.5) / 48 - 1], np.float32
        )
        v = np.array([ndca[0], ndca[1], 1.5], np.float32)
        v /= np.linalg.norm(v)
        expect = ref.rotate_xy(v, np.array([0.0, 0.7], np.float32))
        np.testing.assert_allclose(rd[y, x], expect, atol=1e-5)


def test_gbuffer_analytic_vs_march():
    gb_a = gb_mod.geometry_pass(SCENE, CAM, CFG)
    gb_m = gb_mod.geometry_pass(
        SCENE, CAM, RenderConfig(width=64, height=48, intersect_mode="march")
    )
    ids_a = np.asarray(gb_a.obj_id)
    ids_m = np.asarray(gb_m.obj_id)
    # Intersector disagreement allowed only on a sliver of boundary pixels.
    assert (ids_a == ids_m).mean() > 0.98
    same = ids_a == ids_m
    d_a = np.asarray(gb_a.depth)[same]
    d_m = np.asarray(gb_m.depth)[same]
    hit = ids_a[same] > 0
    # March terminates within eps of the surface along the distance field;
    # allow a few eps along the ray.
    assert np.abs(d_a[hit] - d_m[hit]).max() < 2e-2


def test_gbuffer_normals_unit_on_hit():
    gb = gb_mod.geometry_pass(SCENE, CAM, CFG)
    n = np.asarray(gb.normal)
    hit = np.asarray(gb.obj_id) > 0
    norms = np.linalg.norm(n[hit], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)
    assert not np.isnan(n).any()


def test_render_frame_finite_and_shapes():
    hist = init_history(CFG, CAM)
    img, hist2 = render_frame(SCENE, CAM, hist, jnp.asarray(0, jnp.int32), CFG)
    img = np.asarray(img)
    assert img.shape == (48, 64, 3)
    assert np.isfinite(img).all()
    assert (img >= 0).all() and (img <= 1).all()
    assert np.isfinite(np.asarray(hist2.diffuse.rgb)).all()
    assert np.isfinite(np.asarray(hist2.specular.rgb)).all()
    # Counts start at 1 everywhere on the first frame.
    np.testing.assert_allclose(np.asarray(hist2.diffuse.cnt), 1.0)


def test_temporal_accumulation_counts_grow_to_window():
    cfg = RenderConfig(width=32, height=24, temporal=4)
    img, hist = render_image(SCENE, CAM, cfg, frames=6)
    cnt = np.asarray(hist.diffuse.cnt)
    # Static camera: counts should saturate at the temporal window for
    # surviving pixels (vv=0 → lvv=0 → limit=T), then +1 each frame → T+1 cap.
    assert cnt.max() <= cfg.temporal + 1
    assert (cnt >= 1).all()
    assert (cnt > cfg.temporal - 1).mean() > 0.5


def test_temporal_variance_reduction():
    cfg = RenderConfig(width=32, height=24)
    img1, hist = render_image(SCENE, CAM, cfg, frames=1)
    img16, _ = render_image(SCENE, CAM, cfg, frames=16, history=hist)
    # Compare frame-to-frame jitter: a 16-frame accumulation should be much
    # closer to its successor than single frames are to each other.
    img2, _ = render_image(SCENE, CAM, cfg, frames=1)
    assert np.isfinite(np.asarray(img16)).all()


def test_unbiased_mode_runs():
    cfg = RenderConfig(width=32, height=24, biased=False)
    img, _ = render_image(SCENE, CAM, cfg, frames=2)
    assert np.isfinite(np.asarray(img)).all()


def test_biased_vs_unbiased_agree_on_average():
    """The de-facto integration test of the reference (SURVEY §4): biased MIS
    and unbiased ground truth must agree statistically after accumulation."""
    cfg_b = RenderConfig(width=48, height=32, temporal=64)
    cfg_u = RenderConfig(width=48, height=32, temporal=64, biased=False)
    img_b, hb = render_image(SCENE, CAM, cfg_b, frames=48)
    img_u, hu = render_image(SCENE, CAM, cfg_u, frames=48)
    # Compare the raw diffuse accumulators (pre-tonemap), averaged per count.
    db = np.asarray(hb.diffuse.rgb) / np.asarray(hb.diffuse.cnt)[..., None]
    du = np.asarray(hu.diffuse.rgb) / np.asarray(hu.diffuse.cnt)[..., None]
    ids = np.asarray(hb.diffuse.oid)
    m = ids > 1  # shaded, non-light pixels
    # Means over the image should agree within Monte-Carlo noise.
    ratio = db[m].mean() / max(du[m].mean(), 1e-9)
    assert 0.5 < ratio < 2.0, f"biased/unbiased mean ratio {ratio}"


def test_miss_pixels_black_and_finite():
    # Camera looking toward open side of the room (-x): mostly misses.
    cam = cam_mod.Camera.create(loc=(0.0, 5.0, 0.0), orient=(0.0, -np.pi / 2))
    img, hist = render_image(SCENE, cam, CFG, frames=2)
    assert np.isfinite(np.asarray(img)).all()


def test_dual_mis_matches_unfused():
    """shade_passes (fused dual_mis) must produce exactly the channels the
    separate diffuse/specular passes produce — same seeds, same math."""
    from kylespathtracer.render import gbuffer as gb_mod
    from kylespathtracer.render.passes import (
        diffuse_pass,
        shade_passes,
        specular_pass,
    )
    from kylespathtracer.render.pipeline import init_history

    cfg = RenderConfig(width=48, height=32)
    scene = default_scene()
    cam = cam_mod.Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    hist = init_history(cfg, cam)
    frame = jnp.asarray(2, jnp.int32)

    gb = gb_mod.geometry_pass(scene, cam, cfg)
    d_ref = diffuse_pass(scene, cfg, gb, cam, hist.camera, hist.diffuse, frame)
    s_ref = specular_pass(scene, cfg, gb, cam, hist.camera, hist.specular, frame)
    d_fused, s_fused = shade_passes(
        scene, cfg, gb, cam, hist.camera, hist.diffuse, hist.specular, frame
    )

    np.testing.assert_allclose(
        np.asarray(d_fused.rgb), np.asarray(d_ref.rgb), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s_fused.rgb), np.asarray(s_ref.rgb), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_array_equal(np.asarray(d_fused.oid), np.asarray(d_ref.oid))


def test_no_history_matches_fresh_history():
    """The no_history fast path (skip reprojection of an all-zero history)
    is numerically identical to rendering against a fresh zero history."""
    import dataclasses

    from kylespathtracer.render.camera import Camera

    scene = default_scene()
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    cfg = RenderConfig(width=48, height=32)
    hist = init_history(cfg, cam)
    img0, h0 = render_frame(scene, cam, hist, jnp.asarray(0, jnp.int32), cfg)
    cfg1 = dataclasses.replace(cfg, no_history=True)
    img1, h1 = render_frame(scene, cam, hist, jnp.asarray(0, jnp.int32), cfg1)
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img1), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(h0.diffuse.rgb), np.asarray(h1.diffuse.rgb), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(h0.specular.cnt), np.asarray(h1.specular.cnt), atol=1e-6
    )
