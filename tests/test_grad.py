"""Gradient correctness: autodiff vs finite differences through the full
differentiable render, and a small inverse-rendering recovery."""

import numpy as np
import jax
import jax.numpy as jnp

from kylespathtracer.diff import inverse
from kylespathtracer.render.camera import Camera
from kylespathtracer.scene.scene import sphere_scene
from kylespathtracer.utils.config import RenderConfig

CFG = RenderConfig(width=48, height=32)
CAM = Camera.create(loc=(0.0, 2.0, -2.0), orient=(-0.15, 0.0))


BASE = sphere_scene(
    centers=[[0.0, 1.2, 4.0], [1.6, 0.8, 5.0]],
    radii=[1.0, 0.8],
    albedos=[[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]],
)


def make_scene(dx=0.0, dr=0.0, da=0.0):
    """Perturb the base scene with (possibly traced) offsets."""
    scene = BASE.replace(
        spheres=BASE.spheres.at[1, 0].add(dx).at[1, 3].add(dr)
    )
    return scene.replace(
        materials=scene.materials.replace(
            alb_const=scene.materials.alb_const.at[3, 0].add(da)
        )
    )


def render_mean(scene):
    img = inverse.render_once(scene, CAM, CFG, jnp.asarray(0, jnp.int32))
    return jnp.mean(img)


def test_grad_matches_finite_difference_position():
    g = jax.grad(lambda dx: render_mean(make_scene(dx=dx)))(0.0)
    h = 2e-3
    fd = (render_mean(make_scene(dx=h)) - render_mean(make_scene(dx=-h))) / (2 * h)
    g, fd = float(g), float(fd)
    assert np.isfinite(g) and np.isfinite(fd)
    # Visibility edges make FD noisy; demand sign agreement and rough scale.
    assert abs(g - fd) < max(0.35 * abs(fd), 5e-3), (g, fd)


def test_grad_matches_finite_difference_albedo():
    g = jax.grad(lambda da: render_mean(make_scene(da=da)))(0.0)
    h = 1e-2
    fd = (render_mean(make_scene(da=h)) - render_mean(make_scene(da=-h))) / (2 * h)
    g, fd = float(g), float(fd)
    assert np.isfinite(g) and np.isfinite(fd)
    assert abs(g - fd) < max(0.15 * abs(fd), 1e-3), (g, fd)


def test_grads_finite_everywhere():
    scene = make_scene()
    params = inverse.extract_params(scene)
    loss, grads = jax.value_and_grad(inverse.loss_fn)(
        params,
        scene,
        CAM,
        jnp.zeros((CFG.height, CFG.width, 3), jnp.float32),
        jnp.asarray(0, jnp.int32),
        CFG,
    )
    assert np.isfinite(float(loss))
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()


def test_inverse_rendering_recovers_albedo():
    """Start from a wrong albedo; Adam should move it toward the target."""
    cfg = RenderConfig(width=32, height=24)
    target_scene = make_scene()
    target = inverse.render_once(target_scene, CAM, cfg, jnp.asarray(0, jnp.int32))

    wrong = make_scene(da=-0.35)
    fitted, losses = inverse.fit(
        wrong, target, CAM, cfg, keys=("alb_const",), steps=40, lr=5e-2,
        vary_seed=False,
    )
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
    got = float(fitted.materials.alb_const[3, 0])
    want = float(target_scene.materials.alb_const[3, 0])
    start = want - 0.35
    assert abs(got - want) < abs(start - want) * 0.5, (start, got, want)
