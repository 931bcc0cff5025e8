"""Multi-chip sharding on the virtual 8-device CPU mesh: sharded render must
equal unsharded, the sharded train step must run, and the driver dryrun must
pass."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kylespathtracer.parallel import mesh as mesh_mod
from kylespathtracer.render.camera import Camera
from kylespathtracer.render.pipeline import init_history, render_frame
from kylespathtracer.scene import default_scene
from kylespathtracer.utils.config import RenderConfig


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_unsharded():
    cfg = RenderConfig(width=64, height=32)
    scene = default_scene()
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    hist = init_history(cfg, cam)
    frame = jnp.asarray(0, jnp.int32)

    img_ref, hist_ref = render_frame(scene, cam, hist, frame, cfg)

    mesh = mesh_mod.make_mesh(8)
    hist_sh = mesh_mod.shard_image_pytree(hist, mesh, cfg.height)
    fn = jax.jit(render_frame, static_argnames=("config",))
    img_sh, hist_sh2 = fn(scene, cam, hist_sh, frame, cfg)

    np.testing.assert_allclose(np.asarray(img_sh), np.asarray(img_ref), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(hist_sh2.diffuse.rgb), np.asarray(hist_ref.diffuse.rgb), atol=1e-4
    )


def test_sharded_multiframe_reprojection():
    """Reprojection gathers cross shard boundaries; GSPMD must handle them."""
    cfg = RenderConfig(width=64, height=32)
    scene = default_scene()
    mesh = mesh_mod.make_mesh(8)
    fn = jax.jit(render_frame, static_argnames=("config",))

    cam0 = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    cam1 = Camera.create(loc=(3.1, 2.05, -3.0), orient=(0.02, 0.72))

    hist = init_history(cfg, cam0)
    hist_sh = mesh_mod.shard_image_pytree(hist, mesh, cfg.height)
    img_r, hist_r = render_frame(scene, cam0, hist, jnp.asarray(0, jnp.int32), cfg)
    img_s, hist_s = fn(scene, cam0, hist_sh, jnp.asarray(0, jnp.int32), cfg)
    img_r2, _ = render_frame(scene, cam1, hist_r, jnp.asarray(1, jnp.int32), cfg)
    img_s2, _ = fn(scene, cam1, hist_s, jnp.asarray(1, jnp.int32), cfg)
    np.testing.assert_allclose(np.asarray(img_s2), np.asarray(img_r2), atol=1e-4)


def test_driver_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_driver_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


def test_shard_map_tiled_matches_reference():
    """Explicit shard_map tiles (all_gather history + per-device row blocks)
    must match the unsharded render over two frames."""
    from kylespathtracer.parallel import shard as shard_mod

    cfg = RenderConfig(width=64, height=32)
    scene = default_scene()
    mesh = mesh_mod.make_mesh(8)
    cam0 = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    cam1 = Camera.create(loc=(3.1, 2.05, -3.0), orient=(0.02, 0.72))
    hist = init_history(cfg, cam0)

    img_r, hist_r = render_frame(scene, cam0, hist, jnp.asarray(0, jnp.int32), cfg)
    img_t, hist_t = shard_mod.render_frame_tiled(
        scene, cam0, hist, jnp.asarray(0, jnp.int32), cfg, mesh
    )
    np.testing.assert_allclose(np.asarray(img_t), np.asarray(img_r), atol=1e-5)

    img_r2, _ = render_frame(scene, cam1, hist_r, jnp.asarray(1, jnp.int32), cfg)
    img_t2, _ = shard_mod.render_frame_tiled(
        scene, cam1, hist_t, jnp.asarray(1, jnp.int32), cfg, mesh
    )
    np.testing.assert_allclose(np.asarray(img_t2), np.asarray(img_r2), atol=1e-4)


def test_shard_map_train_step():
    import optax

    from kylespathtracer.diff import inverse
    from kylespathtracer.parallel import shard as shard_mod
    from kylespathtracer.scene.scene import sphere_scene

    cfg = RenderConfig(width=64, height=32)
    mesh = mesh_mod.make_mesh(8)
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))
    scene = sphere_scene([[0.0, 1.0, 6.0]], [1.0], [[0.6, 0.3, 0.2]])
    params = inverse.extract_params(scene)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    target = mesh_mod.shard_image_pytree(
        jnp.zeros((cfg.height, cfg.width, 3)), mesh, cfg.height
    )
    p2, os2, loss = shard_mod.train_step_tiled(
        params, opt_state, opt, scene, cam, target, jnp.asarray(0, jnp.int32),
        cfg, mesh,
    )
    assert np.isfinite(float(loss))
    # The update actually changed the parameters.
    assert not np.allclose(np.asarray(p2["spheres"]), np.asarray(params["spheres"]))


@pytest.mark.slow
def test_sharded_inverse_resume_trajectory():
    """Multi-step sharded inverse + elastic recovery UNDER SHARDING
    (round-4 verdict item 7; the other resume tests are single-device):
    a 16-step train_step_tiled fit on the 8-device mesh tracks the
    single-device trajectory step for step, and a checkpoint→kill→resume
    at step 8 (checkpoint roundtrip, fresh optimizer/step objects) reproduces
    the uninterrupted sharded trajectory exactly."""
    import tempfile

    import optax

    from kylespathtracer.diff import inverse
    from kylespathtracer.parallel import shard as shard_mod
    from kylespathtracer.scene.scene import sphere_scene
    from kylespathtracer.utils import checkpoint as ckpt_mod

    cfg = RenderConfig(width=64, height=32)
    mesh = mesh_mod.make_mesh(8)
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))
    gt = sphere_scene(
        [[0.0, 1.0, 6.0], [2.0, 1.0, 7.0]], [1.0, 0.8],
        [[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]],
    )
    target = inverse.render_once(gt, cam, cfg, jnp.asarray(0, jnp.int32))
    start = sphere_scene(
        [[0.3, 1.1, 6.2], [1.8, 0.9, 6.8]], [0.9, 0.85],
        [[0.5, 0.4, 0.3], [0.3, 0.4, 0.5]],
    )
    params0 = inverse.extract_params(start)
    opt = optax.adam(1e-2)
    STEPS, CKPT_AT = 16, 8

    def run_sharded(params, opt_state, lo, hi, snapshot_at=None):
        snap, losses = None, []
        for i in range(lo, hi):
            params, opt_state, loss = shard_mod.train_step_tiled(
                params, opt_state, opt, start, cam, target,
                jnp.asarray(i, jnp.int32), cfg, mesh,
            )
            losses.append(float(loss))
            if snapshot_at is not None and i + 1 == snapshot_at:
                snap = (jax.device_get(params), jax.device_get(opt_state))
        return params, losses, snap

    p_sh, losses_sh, snap = run_sharded(
        params0, opt.init(params0), 0, STEPS, snapshot_at=CKPT_AT
    )

    # Single-device trajectory: the sharded fit must track it step for step.
    step1 = jax.jit(
        lambda p, s, f: inverse.fit_step(
            p, s, start, cam, target, f, opt, cfg
        )[:3]
    )
    p1, os1, losses_1 = params0, opt.init(params0), []
    for i in range(STEPS):
        p1, os1, loss = step1(p1, os1, jnp.asarray(i, jnp.int32))
        losses_1.append(float(loss))
    np.testing.assert_allclose(losses_sh, losses_1, rtol=1e-4)
    for k in p1:
        a = np.asarray(p1[k])
        np.testing.assert_allclose(
            np.asarray(p_sh[k]), a, atol=1e-4 * (np.abs(a).max() + 1e-8),
            err_msg=k,
        )

    # Kill + resume: checkpoint save/restore of (params, opt_state), then the
    # remaining 8 sharded steps. Resumed state re-executes the identical
    # computation on bit-identical restored values → exact trajectory.
    with tempfile.TemporaryDirectory() as d:
        ckpt_mod.save(
            d, CKPT_AT, {"params": snap[0], "opt_state": snap[1]}
        )
        like = {"params": params0, "opt_state": opt.init(params0)}
        _, state = ckpt_mod.restore(d, step=CKPT_AT, like=like)
    p_r, losses_r, _ = run_sharded(
        state["params"], state["opt_state"], CKPT_AT, STEPS
    )
    np.testing.assert_allclose(losses_r, losses_sh[CKPT_AT:], rtol=0, atol=0)
    for k in p_sh:
        np.testing.assert_array_equal(
            np.asarray(p_r[k]), np.asarray(p_sh[k]), err_msg=k
        )


def test_tiled_fused_matches_unsharded():
    """The fused temporal frame on 4 devices' row tiles (per-tile fused
    forward + exact gather behind the ppermute history halo) reproduces the
    unsharded fused frame over a moving 2-frame sequence."""
    from kylespathtracer.parallel import shard as shard_mod

    cfg = RenderConfig(width=64, height=32, pipeline="fused")
    mesh = mesh_mod.make_mesh(4)
    cams = [
        Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7)),
        Camera.create(loc=(3.02, 2.0, -3.01), orient=(0.001, 0.7)),
    ]

    hist = init_history(cfg, cams[0])
    img_ref = None
    for i, cam in enumerate(cams):
        img_ref, hist = render_frame(
            default_scene(), cam, hist, jnp.asarray(i, jnp.int32), cfg
        )

    hist = init_history(cfg, cams[0])
    img_t = None
    for i, cam in enumerate(cams):
        img_t, hist = shard_mod.render_frame_tiled(
            default_scene(), cam, hist, jnp.asarray(i, jnp.int32), cfg, mesh,
        )
    np.testing.assert_allclose(
        np.asarray(img_t), np.asarray(img_ref), atol=1e-5
    )


def test_train_step_tiled_fused_matches_single_device():
    """One fused train_step_tiled on 4 devices (per-tile custom-VJP
    backward, psum/pmean of the tile gradients) gives the loss and updated
    parameters of the same step on one device."""
    import optax

    from kylespathtracer.diff import inverse
    from kylespathtracer.parallel import shard as shard_mod
    from kylespathtracer.scene.scene import sphere_scene

    cfg = RenderConfig(width=48, height=32, pipeline="fused",
                       soft_shadows=0.05)
    mesh = mesh_mod.make_mesh(4)
    cam = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))
    gt = sphere_scene([[0.0, 1.0, 6.0], [2.0, 1.0, 7.0]], [1.0, 0.8],
                      [[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]])
    start = sphere_scene([[0.3, 1.1, 6.2], [1.8, 0.9, 6.8]], [0.9, 0.85],
                         [[0.5, 0.4, 0.3], [0.3, 0.4, 0.5]])
    frame = jnp.asarray(0, jnp.int32)
    target = inverse.render_once(gt, cam, cfg, frame)
    params = inverse.extract_params(start)
    # SGD: the parameter change is linear in the gradient.
    opt = optax.sgd(1e-2)
    p1, _, l1, _ = inverse.fit_step(
        params, opt.init(params), start, cam, target, frame, opt, cfg)
    pt, _, lt = shard_mod.train_step_tiled(
        params, opt.init(params), opt, start, cam, target, frame, cfg, mesh
    )
    np.testing.assert_allclose(float(lt), float(l1), rtol=1e-5)
    for k in params:
        a = np.asarray(p1[k]) - np.asarray(params[k])
        np.testing.assert_allclose(
            np.asarray(pt[k]) - np.asarray(params[k]), a, rtol=1e-4,
            atol=1e-4 * (np.abs(a).max() + 1e-12), err_msg=k,
        )
