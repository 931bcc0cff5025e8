"""Silhouette/visibility gradients (SURVEY §7 hard part (a)).

The hard visibility test (march hit indicator, common.glsl:348-353) has zero
gradient w.r.t. an occluder that is not itself hit — autodiff cannot move a
shadow. diff/softvis.py replaces the sphere-occlusion NEE term with a smooth
transmittance; these tests (1) document the hard-mode zero gradient, (2)
check the soft gradient against finite differences, and (3) recover an
occluder's position through its shadow alone."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from kylespathtracer.diff import softvis
from kylespathtracer.scene.scene import sphere_scene


def _setup(x0=0.0):
    # Floor points in the shadow region; light above; occluder between.
    scene = sphere_scene([[x0, 2.0, 5.0]], [0.6], [[0.5, 0.5, 0.5]])
    # The default light sits at (6,5,-4) (common.glsl:229); an occluder near
    # (0,2,5) casts its shadow around (-3.5, 0, 11) on the floor.
    xs = jnp.linspace(-7.0, 0.0, 36)
    zs = jnp.linspace(8.0, 14.0, 24)
    gx, gz = jnp.meshgrid(xs, zs, indexing="ij")
    hl = jnp.stack([gx, jnp.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    hn = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), hl.shape)
    ho = jnp.full(hl.shape[:-1], 2, jnp.int32)  # floor id
    return scene, hl, hn, ho


def _soft_loss(scene, sx, hl, hn, ho, beta):
    scene = scene.replace(
        spheres=scene.spheres.at[1, 0].set(sx)  # row 0 is the light
    )
    img = softvis.soft_direct_light(scene, hl, hn, ho, beta)
    return jnp.mean(img)


def test_soft_gradient_matches_finite_difference():
    scene, hl, hn, ho = _setup()
    beta = 0.05
    f = lambda sx: _soft_loss(scene, sx, hl, hn, ho, beta)
    g = jax.grad(f)(0.3)
    eps = 1e-3
    fd = (f(0.3 + eps) - f(0.3 - eps)) / (2 * eps)
    assert np.isfinite(float(g))
    assert abs(float(g) - float(fd)) < 0.1 * max(abs(float(fd)), 1e-6), (
        f"grad {float(g)} vs fd {float(fd)}"
    )
    assert abs(float(g)) > 1e-4  # the silhouette gradient exists


def test_hard_visibility_gradient_is_zero():
    """The documented bias: the hard hit test gives no occluder gradient."""
    from kylespathtracer.core import gmath
    from kylespathtracer.scene import intersect as isect

    scene, hl, hn, ho = _setup()

    def hard_loss(sx):
        sc = scene.replace(spheres=scene.spheres.at[1, 0].set(sx))
        lv = sc.light[:3] - hl
        dist = gmath.length(lv)
        ndir = lv / dist[..., None]
        _, tid = isect.intersect(sc, hl, ndir, ho)
        vis = (tid == sc.light_id).astype(jnp.float32)
        return jnp.mean(vis * gmath.lambertian(hn, ndir))

    g = jax.grad(hard_loss)(0.3)
    eps = 5e-2
    fd = (hard_loss(0.3 + eps) - hard_loss(0.3 - eps)) / (2 * eps)
    # FD sees the shadow move; autodiff of the indicator does not.
    assert abs(float(fd)) > 1e-4
    assert abs(float(g)) < 0.05 * abs(float(fd))


def test_occluder_position_recovery_through_shadow():
    """Optimize ONLY the occluder x from its shadow: converges with soft
    visibility, impossible with the hard test."""
    scene, hl, hn, ho = _setup()
    beta = 0.08
    x_true = 0.25
    target = softvis.soft_direct_light(
        scene.replace(spheres=scene.spheres.at[1, 0].set(x_true)),
        hl, hn, ho, beta,
    )

    def loss(sx):
        img = softvis.soft_direct_light(
            scene.replace(spheres=scene.spheres.at[1, 0].set(sx)),
            hl, hn, ho, beta,
        )
        return jnp.mean((img - target) ** 2)

    opt = optax.adam(5e-2)
    x = jnp.asarray(-0.4)
    state = opt.init(x)
    vg = jax.jit(jax.value_and_grad(loss))
    for _ in range(150):
        _, g = vg(x)
        up, state = opt.update(g, state, x)
        x = optax.apply_updates(x, up)
    assert abs(float(x) - x_true) < 0.05, float(x)


def test_soft_shadows_config_runs_through_pipeline():
    """config.soft_shadows routes through dual_mis and stays finite/diffable."""
    from kylespathtracer.diff import inverse
    from kylespathtracer.render.camera import Camera
    from kylespathtracer.utils.config import RenderConfig

    cfg = RenderConfig(width=32, height=24, soft_shadows=0.05)
    scene = sphere_scene([[0.0, 1.0, 6.0]], [1.0], [[0.6, 0.3, 0.2]])
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))
    img = inverse.render_once(scene, cam, cfg, jnp.asarray(0, jnp.int32))
    assert np.isfinite(np.asarray(img)).all()
    params = inverse.extract_params(scene)
    loss, grads = jax.value_and_grad(inverse.loss_fn, allow_int=True)(
        params, scene, cam, jnp.zeros_like(img), jnp.asarray(0, jnp.int32), cfg
    )
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(grads["spheres"])).all()


def test_soft_shadows_keep_hard_occluders():
    """Soft-shadow mode must not leak light past plane/box occluders.

    In the default scene the only sphere is the light itself, so the sphere
    transmittance is 1 everywhere; with the hard-trace gate in place the
    soft render equals the hard render exactly. Without the gate, pixels
    whose shadow ray is blocked by the wall/box/ceiling get full direct
    light (the round-2 light-leak bug, ADVICE r2 #2)."""
    from kylespathtracer.diff import inverse
    from kylespathtracer.render.camera import Camera
    from kylespathtracer.scene.scene import default_scene
    from kylespathtracer.utils.config import RenderConfig

    scene = default_scene()
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    frame = jnp.asarray(0, jnp.int32)
    hard = inverse.render_once(
        scene, cam, RenderConfig(width=64, height=48), frame
    )
    soft = inverse.render_once(
        scene, cam, RenderConfig(width=64, height=48, soft_shadows=0.05), frame
    )
    np.testing.assert_allclose(np.asarray(soft), np.asarray(hard), atol=1e-5)
