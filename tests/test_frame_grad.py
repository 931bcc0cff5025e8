"""Differentiable fused frame (ops/frame_grad.py).

The kernel MATH is checked through `frame_kernel.frame_forward_jnp` — the
same `frame_block` the Triton kernel runs, as plain jnp — against the XLA
pass pipeline, forward and backward. The custom VJP itself (Triton forward
in interpret mode or the XLA forward, the chunked XLA backward, symbolic
zero pruning) is checked against the pass pipeline and plain `jax.grad`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kylespathtracer.diff import inverse
from kylespathtracer.ops import frame_grad as fg
from kylespathtracer.ops import frame_kernel as fk
from kylespathtracer.render.camera import Camera
from kylespathtracer.render.pipeline import init_history, render_frame
from kylespathtracer.scene import default_scene
from kylespathtracer.utils.config import RenderConfig

W, H = 64, 48
LOC = (3.0, 2.0, -3.0)
ORI = (0.0, 0.7)
FRAME = jnp.asarray(0, jnp.int32)


def _image_from_planes(out, cfg):
    from kylespathtracer.render import composite as comp_mod
    from kylespathtracer.render.passes import Channel

    ones = jnp.ones(out["oid"].shape, jnp.float32)
    d = Channel(rgb=out["add_d"], cnt=ones, oid=out["oid"])
    s = Channel(rgb=out["add_s"], cnt=ones, oid=out["oid"])
    return comp_mod.composite_from(out["alb"], out["ene"], d, s, cfg)


def _pass_image(scene, cam, cfg, frame=FRAME):
    hist = init_history(cfg, cam)
    img, _ = render_frame(scene, cam, hist, frame, cfg)
    return img


@pytest.mark.parametrize("soft", [0.0, 0.05])
def test_frame_block_matches_pass(soft):
    """frame_block math (incl. the in-kernel soft-shadow transmittance)
    reproduces the XLA pass pipeline's single-frame image."""
    scene = default_scene()
    cam = Camera.create(loc=LOC, orient=ORI)
    cfg = RenderConfig(width=W, height=H, no_history=True, soft_shadows=soft)
    out = fk.frame_forward_jnp(scene, cam, FRAME, cfg)
    img_block = _image_from_planes(out, cfg)
    img_pass = _pass_image(scene, cam, cfg)
    d = np.abs(np.asarray(img_block) - np.asarray(img_pass))
    assert np.isfinite(np.asarray(img_block)).all()
    assert np.median(d) < 1e-5
    assert (d > 3e-2).mean() < 0.02, f"{(d > 3e-2).mean():.3%} differ"


def test_frame_block_honors_smp():
    """smp_*=2 on the fused path averages two per-strategy samples exactly
    like mis.dual_mis — fused == pass at the same quality config (the
    round-3 fused path silently rendered 1 sample whatever smp said)."""
    scene = default_scene()
    cam = Camera.create(loc=LOC, orient=ORI)
    smp2 = {f"smp_{k}": 2 for k in (
        "direct_lambert", "lambert_surface_lambert", "lambert_surface_phong",
        "direct_phong", "phong_surface_lambert", "phong_surface_phong")}
    cfg = RenderConfig(width=W, height=H, no_history=True, **smp2)
    out = fk.frame_forward_jnp(scene, cam, FRAME, cfg)
    img_block = _image_from_planes(out, cfg)
    img_pass = _pass_image(scene, cam, cfg)
    d = np.abs(np.asarray(img_block) - np.asarray(img_pass))
    assert np.median(d) < 1e-5
    assert (d > 3e-2).mean() < 0.02, f"{(d > 3e-2).mean():.3%} differ"
    # And the smp=2 image is genuinely different from smp=1 (the knob acts).
    cfg1 = RenderConfig(width=W, height=H, no_history=True)
    out1 = fk.frame_forward_jnp(scene, cam, FRAME, cfg1)
    img1 = _image_from_planes(out1, cfg1)
    assert np.abs(np.asarray(img_block) - np.asarray(img1)).max() > 1e-3


def test_fused_rejects_unequal_smp():
    """Unequal smp_* counts raise (the fused path never silently diverges
    from the quality config)."""
    scene = default_scene()
    cam = Camera.create(loc=LOC, orient=ORI)
    cfg_bad = RenderConfig(
        width=W, height=H, no_history=True, pipeline="fused",
        smp_direct_lambert=2,
    )
    hist = init_history(cfg_bad, cam)
    with pytest.raises(ValueError, match="smp"):
        render_frame(scene, cam, hist, FRAME, cfg_bad)


@pytest.mark.parametrize("smp", [1, 2])
def test_frame_block_unbiased_matches_pass(smp):
    """biased=False runs the unbiased ground-truth estimators IN-KERNEL
    (shade_kernel._shade_core_unbiased) and reproduces the pass pipeline's
    unbiased frame (common.glsl:394-415)."""
    scene = default_scene()
    cam = Camera.create(loc=LOC, orient=ORI)
    smp_kw = {f"smp_{k}": smp for k in (
        "direct_lambert", "lambert_surface_lambert", "lambert_surface_phong",
        "direct_phong", "phong_surface_lambert", "phong_surface_phong")}
    cfg = RenderConfig(
        width=W, height=H, no_history=True, biased=False, **smp_kw
    )
    out = fk.frame_forward_jnp(scene, cam, FRAME, cfg)
    img_block = _image_from_planes(out, cfg)
    cfg_pass = RenderConfig(
        width=W, height=H, no_history=True, pipeline="pass", biased=False,
        **smp_kw,
    )
    img_pass = _pass_image(scene, cam, cfg_pass)
    d = np.abs(np.asarray(img_block) - np.asarray(img_pass))
    assert np.isfinite(np.asarray(img_block)).all()
    assert np.median(d) < 1e-5
    assert (d > 3e-2).mean() < 0.02, f"{(d > 3e-2).mean():.3%} differ"


@pytest.mark.parametrize("soft", [0.05])
def test_frame_block_grads_match_xla(soft):
    """Scene-parameter gradients through frame_block (direct AD of the
    closed forms — what the backward kernel computes) agree with the XLA
    pass pipeline's gradients (IFT backward, scene/intersect.py).

    Only the soft-shadow config (the one inverse rendering uses) runs in
    the default suite — the hard-visibility gradient path is covered by
    tests/test_grad.py's finite-difference checks and the slow test below;
    each additional parametrization costs ~4 min of XLA compile on CPU."""
    scene = default_scene()
    cam = Camera.create(loc=LOC, orient=ORI)
    cfg = RenderConfig(width=W, height=H, no_history=True, soft_shadows=soft)
    target = jnp.zeros((H, W, 3), jnp.float32)

    def loss_block(params):
        sc = inverse.apply_params(scene, params)
        out = fk.frame_forward_jnp(sc, cam, FRAME, cfg)
        return jnp.mean((_image_from_planes(out, cfg) - target) ** 2)

    def loss_pass(params):
        sc = inverse.apply_params(scene, params)
        return jnp.mean((_pass_image(sc, cam, cfg) - target) ** 2)

    params = inverse.extract_params(scene)
    g_block = jax.jit(jax.grad(loss_block))(params)
    g_pass = jax.jit(jax.grad(loss_pass))(params)
    for k in params:
        a, b = np.asarray(g_pass[k]), np.asarray(g_block[k])
        assert np.isfinite(b).all(), k
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=2e-3 * scale, err_msg=k)


def _sphere_scene_and_camera():
    """Two spheres, floor and light, no box: the inverse fit's kind of
    scene, whose frame compiles and runs much faster on the CPU."""
    from kylespathtracer.scene.scene import sphere_scene

    scene = sphere_scene([[0.0, 1.0, 6.0], [2.0, 1.2, 7.0]], [1.0, 0.8],
                         [[0.7, 0.3, 0.2], [0.2, 0.5, 0.6]])
    return scene, Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))


def _loss_planes(out):
    return jnp.mean(out["add_d"]) + jnp.mean(out["add_s"]) + jnp.mean(
        out["alb"]
    ) + jnp.mean(out["ene"]) + jnp.mean(out["depth"]) * 0.01


def test_custom_vjp_grads_match_plain_grad():
    """Triton forward (interpret) + chunked XLA backward == plain jax.grad
    of frame_forward_jnp, for the scene tables and the camera, on a loss
    touching every float plane."""
    scene = default_scene()
    cam = Camera.create(loc=LOC, orient=ORI)
    cfg = RenderConfig(width=32, height=8, no_history=True)

    g_ref = jax.grad(
        lambda s, c: _loss_planes(fk.frame_forward_jnp(s, c, FRAME, cfg)),
        argnums=(0, 1), allow_int=True,
    )(scene, cam)
    g_vjp = jax.grad(
        lambda s, c: _loss_planes(
            fg.frame_forward(s, c, FRAME, cfg, interpret=True)
        ),
        argnums=(0, 1), allow_int=True,
    )(scene, cam)
    for name in ("planes", "spheres", "boxes", "light_color"):
        a = np.asarray(getattr(g_ref[0], name))
        b = np.asarray(getattr(g_vjp[0], name))
        np.testing.assert_allclose(
            b, a, atol=1e-5 * (np.abs(a).max() + 1e-6), err_msg=name
        )
    a = np.asarray(g_ref[1].loc)
    np.testing.assert_allclose(
        np.asarray(g_vjp[1].loc), a, atol=1e-4 * (np.abs(a).max() + 1e-6)
    )


def _fused_vs_pass_grads(cfg):
    """value_and_grad of the image MSE through pipeline="fused" (the
    custom VJP) against pipeline="pass", on the inverse fit's parameters
    and a sphere scene like the fit's."""
    import dataclasses

    scene, cam = _sphere_scene_and_camera()
    target = jnp.full((cfg.height, cfg.width, 3), 0.3, jnp.float32)
    params = inverse.extract_params(scene)
    out = {}
    for pipeline in ("fused", "pass"):
        c = dataclasses.replace(cfg, pipeline=pipeline)
        out[pipeline] = jax.jit(jax.value_and_grad(
            lambda p: inverse.loss_fn(p, scene, cam, target, FRAME, c)
        ))(params)
    (v_f, g_f), (v_p, g_p) = out["fused"], out["pass"]
    np.testing.assert_allclose(float(v_f), float(v_p), rtol=1e-5)
    for k in params:
        a, b = np.asarray(g_p[k]), np.asarray(g_f[k])
        assert np.isfinite(b).all(), k
        np.testing.assert_allclose(
            b, a, atol=2e-3 * (np.abs(a).max() + 1e-8), err_msg=k
        )


def test_custom_vjp_grads_production_inverse_config():
    """soft_shadows>0 AND smp>1 combined — the configuration the inverse
    fit runs (diff/inverse.py anneals a soft-shadow beta; multi-sample
    steps share the fused frame) — through the custom VJP, against the
    pass pipeline's value and gradients."""
    smp2 = {f"smp_{k}": 2 for k in (
        "direct_lambert", "lambert_surface_lambert", "lambert_surface_phong",
        "direct_phong", "phong_surface_lambert", "phong_surface_phong")}
    _fused_vs_pass_grads(
        RenderConfig(width=W, height=H, no_history=True, soft_shadows=0.05,
                     **smp2)
    )


def test_symbolic_zero_pruning(monkeypatch):
    """A depth-only loss hands the backward only the depth cotangent (the
    other planes arrive as symbolic zeros and are pruned), and its
    gradients equal plain jax.grad of the same loss."""
    scene, cam = _sphere_scene_and_camera()
    cfg = RenderConfig(width=32, height=16, no_history=True)
    seen = []
    real = fg.frame_backward

    def spy(scene, camera, frame, g, config, **kw):
        seen.append(sorted(k for k, v in g.items() if v is not None))
        return real(scene, camera, frame, g, config, **kw)

    monkeypatch.setattr(fg, "frame_backward", spy)
    g_vjp = jax.grad(lambda s: jnp.mean(
        fg.frame_forward(s, cam, FRAME, cfg)["depth"]), allow_int=True)(scene)
    g_ref = jax.grad(lambda s: jnp.mean(
        fk.frame_forward_jnp(s, cam, FRAME, cfg)["depth"]), allow_int=True)(scene)
    assert seen == [["depth"]]
    for name in ("planes", "spheres"):
        a = np.asarray(getattr(g_ref, name))
        np.testing.assert_allclose(
            np.asarray(getattr(g_vjp, name)), a,
            atol=1e-6 * (np.abs(a).max() + 1e-6), err_msg=name,
        )
    assert not np.asarray(g_vjp.light_color).any()


def test_chunked_backward_matches_one_chunk():
    """Row chunks (lax.map over 4 chunks, summed) give the gradients of a
    single chunk over the whole image, and a chunk must divide the rows."""
    scene, cam = _sphere_scene_and_camera()
    cfg = RenderConfig(width=32, height=16, no_history=True)
    out = fk.frame_forward_jnp(scene, cam, FRAME, cfg)
    g = {k: jnp.ones_like(v) for k, v in out.items() if k != "oid"}
    one = fg.frame_backward(scene, cam, FRAME, g, cfg, chunk=16)
    four = fg.frame_backward(scene, cam, FRAME, g, cfg, chunk=4)
    for a, b in zip(one, four):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a),
            atol=1e-5 * (np.abs(np.asarray(a)).max() + 1e-6),
        )
    assert fg.chunk_rows(1080, 1920) == 270
    with pytest.raises(ValueError, match="divide"):
        fg.frame_backward(scene, cam, FRAME, g, cfg, chunk=5)
