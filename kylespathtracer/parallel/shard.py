"""Sharded rendering and training.

Two complementary paths (SURVEY §2.3):

* GSPMD path — place the history pytree with `NamedSharding` row shardings
  (parallel.mesh) and jit the ordinary `render_frame`; XLA inserts the
  cross-shard gathers for the reprojection taps and all-reduces scene
  gradients. Zero code changes to the pipeline.

* shard_map path — explicit per-device tiles with hand-placed collectives:
  each device renders its row block; scene-parameter gradients are
  `psum`-reduced inside the mapped function. The only cross-device traffic
  is the tiny scene-grad psum and the reprojection halo.

The reprojection gather reads the *previous frame's* accumulation near the
current pixel (a 2×2 tap pattern around the reprojected point,
common.glsl:677-688), so each device only needs its own history rows plus a
halo of `halo_rows` from each neighbor: one `ppermute` each way per frame —
comm O(halo·W), not O(H·W). Taps that land beyond the halo (camera jumps of
more than halo_rows) are zero-weighted, restarting the temporal history at
those pixels exactly like an off-screen tap (common.glsl:673-674); the
velocity-adaptive clamp already resets history under fast motion
(diffuse.frag:49-51), so this costs nothing in practice.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kylespathtracer.parallel.mesh import DATA_AXIS, make_mesh, row_sharding, shard_image_pytree
from kylespathtracer.render.camera import Camera
from kylespathtracer.render.pipeline import History, init_history, render_frame
from kylespathtracer.scene.types import Scene
from kylespathtracer.utils.config import RenderConfig


def jit_render_sharded(config: RenderConfig, mesh: Mesh):
    """GSPMD path: jitted render_frame; sharding follows the input placement
    (use `mesh.shard_image_pytree` on the history), XLA inserts the
    reprojection cross-shard gathers."""
    if config.pipeline == "fused":
        raise ValueError(
            "GSPMD cannot partition the fused frame kernel; use "
            "render_frame_tiled (shard_map), which runs the fused frame "
            "per row tile, or pipeline='pass' for the GSPMD path"
        )
    fn = jax.jit(render_frame, static_argnames=("config",))

    def run(scene, camera, history, frame):
        return fn(scene, camera, history, frame, config)

    return run


def render_frame_tiled(scene, camera, history, frame, config, mesh,
                       halo_rows: int = 8):
    """shard_map: each device renders its block of image rows.

    History enters row-sharded; each device ppermutes `halo_rows` edge rows
    to its neighbors so the reprojection 2×2 taps are local reads within
    [row0-halo, row0+rows+halo). Returns row-sharded (image, new history).
    """
    assert config.height % mesh.devices.size == 0, (
        "height must divide the data axis"
    )
    mapped = _tiled_frame_fn(config, mesh, halo_rows)
    hist_sharded = shard_image_pytree(history, mesh, config.height)
    return mapped(scene, camera, hist_sharded, frame)


@lru_cache(maxsize=32)
def _tiled_frame_fn(config, mesh, halo_rows):
    """Build (once per (config, mesh, halo)) the jitted shard_map frame, so
    a frame loop reuses the compiled program instead of retracing."""
    n = mesh.devices.size
    rows_per = config.height // n
    halo = min(halo_rows, rows_per) if n > 1 else 0

    def tile_fn(scene, camera, hist_rows, frame):
        # hist_rows: this device's rows of the previous accumulation.
        idx = jax.lax.axis_index(DATA_AXIS)

        # Halo exchange: receive the last `halo` rows of the previous device
        # (below) and the first `halo` rows of the next (above); edge devices
        # receive zeros, which the gather's bounds mask already rejects.
        def with_halo(l):
            if not (l.ndim >= 2 and l.shape[0] == rows_per) or halo == 0:
                return l
            below = jax.lax.ppermute(
                l[-halo:], DATA_AXIS, [(i, i + 1) for i in range(n - 1)]
            )
            above = jax.lax.ppermute(
                l[:halo], DATA_AXIS, [(i, i - 1) for i in range(1, n)]
            )
            return jnp.concatenate([below, l, above], axis=0)

        prev_window = jax.tree_util.tree_map(with_halo, hist_rows)

        # Render only this device's rows: geometry + shading restricted to a
        # row window. The camera ray grid depends on absolute pixel rows, so
        # shift the NDC window by the device index.
        return _render_row_block(
            scene, camera, prev_window, frame, config, idx * rows_per,
            rows_per, buffer_row0=idx * rows_per - halo,
        )

    # Image-shaped history leaves are row-sharded; the camera is replicated.
    hist_spec = jax.tree_util.tree_map(
        lambda l: P(DATA_AXIS) if l.ndim >= 2 else P(),
        init_history(config),
    )
    in_specs = (P(), P(), hist_spec, P())
    out_specs = (P(DATA_AXIS), hist_spec)

    # check_vma=False: the varying-manual-axes checker rejects replicated->
    # P(DATA_AXIS) outputs that are only *made* device-varying by in-body
    # axis_index row offsets (tile_fn renders different rows per device from
    # replicated scene/camera inputs) - a false positive for this pattern.
    # Correctness is covered numerically instead: __graft_entry__'s dryrun
    # asserts the tiled frame equals the unsharded image.
    return jax.jit(
        jax.shard_map(
            tile_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    )


def _render_row_block(scene, camera, full_prev_hist, frame, config, row0, rows,
                      buffer_row0=0):
    """Render rows [row0, row0+rows) against a previous-history row window
    whose first buffer row is global image row `buffer_row0` (a full-height
    buffer when 0, a tile+halo window from the ppermute exchange otherwise).
    """
    from kylespathtracer.core import gmath, sampler
    from kylespathtracer.render import composite as comp_mod
    from kylespathtracer.render import gbuffer as gb_mod
    from kylespathtracer.render import mis as mis_mod
    from kylespathtracer.render import reproject as rep_mod
    from kylespathtracer.render.camera import ray_dirs_window
    from kylespathtracer.render.passes import (
        Channel,
        _temporal_clamp,
        count_floor as _count_floor,
        get_trace,
    )
    from kylespathtracer.scene import materials as mat_mod
    from kylespathtracer.scene import sdf as sdf_mod
    from kylespathtracer.scene import intersect as isect

    W, H = config.width, config.height
    rd = ray_dirs_window(camera, W, H, row0, rows, config.fov)

    fused = config.pipeline == "fused"
    if fused:
        # Per-tile fused frame (row_base offsets the pixel grid so NDC/seeds
        # match the full image bitwise); the reprojection gather below reads
        # the halo'd history window. The custom VJP makes this tile
        # differentiable — train_step_tiled's per-tile value_and_grad runs
        # the recompute backward, and the psum over the mesh axis sums the
        # tile-partial scene gradients.
        from kylespathtracer.ops import frame_grad as fg

        out = fg.frame_forward(scene, camera, frame, config, row_base=row0,
                               rows=rows)
        oid = out["oid"]
        depth = out["depth"]
        curv = out["curv"]
    else:
        ro = jnp.broadcast_to(camera.loc, rd.shape)
        if config.intersect_mode == "analytic":
            t, oid = isect.intersect(scene, ro, rd, -1, config.steps)
        else:
            t, oid = sdf_mod.march(scene, ro, rd, -1, config.steps)
        hit = oid > 0
        hl_full = ro + rd * t[..., None]
        if gb_mod.use_tetra_normals(config):
            n, curv = sdf_mod.norcurv(scene, hl_full)
        else:
            from kylespathtracer.scene import normals as nrm_mod
            n, curv = nrm_mod.normal_curv(scene, hl_full, oid)
        n = jnp.where(hit[..., None], n, 0.0)
        depth = t - gmath.EPS
        gb = gb_mod.GBuffer(
            normal=n, obj_id=oid, depth=depth, ray_dir=rd, curv=curv
        )

    prev_cam = full_prev_hist.camera
    hl = camera.loc + rd * depth[..., None]
    px = jnp.broadcast_to(
        jnp.arange(W, dtype=jnp.int32)[None, :], (rows, W)
    )
    py = row0 + jnp.broadcast_to(
        jnp.arange(rows, dtype=jnp.int32)[:, None], (rows, W)
    )
    seed = sampler.gen_seed(frame, px, py, W, H)
    vv = gmath.length(camera.loc - prev_cam.loc)

    light_dist = gmath.length(hl - scene.light[:3])
    fac = gmath.EPS / jnp.sqrt(jnp.maximum(gmath.EPS, curv))
    sl = hl + rd * (light_dist * fac)[..., None]

    if config.no_history:
        rep_rgb_d = rep_rgb_s = jnp.zeros(oid.shape + (3,), jnp.float32)
        rep_cnt_d = rep_cnt_s = jnp.zeros(oid.shape, jnp.float32)
    else:
        pd, ps = full_prev_hist.diffuse, full_prev_hist.specular
        rep_rgb_d, rep_cnt_d = rep_mod.reproject(
            prev_cam.loc, prev_cam.orient, hl, oid, pd.rgb, pd.cnt, pd.oid,
            config.fov, image_size=(H, W), buffer_row0=buffer_row0,
        )
        rep_rgb_s, rep_cnt_s = rep_mod.reproject(
            prev_cam.loc, prev_cam.orient, sl, oid, ps.rgb, ps.cnt, ps.oid,
            config.fov, image_size=(H, W), buffer_row0=buffer_row0,
        )
        rep_cnt_d = _count_floor(rep_cnt_d)
        rep_cnt_s = _count_floor(rep_cnt_s)
        rep_rgb_d, rep_cnt_d = _temporal_clamp(rep_rgb_d, rep_cnt_d, vv, config)
        rep_rgb_s, rep_cnt_s = _temporal_clamp(rep_rgb_s, rep_cnt_s, vv, config)

    if fused:
        d = Channel(rgb=rep_rgb_d + out["add_d"], cnt=rep_cnt_d + 1.0, oid=oid)
        s = Channel(rgb=rep_rgb_s + out["add_s"], cnt=rep_cnt_s + 1.0, oid=oid)
        image = comp_mod.composite_from(out["alb"], out["ene"], d, s, config)
        return image, History(diffuse=d, specular=s, camera=camera)

    trace = get_trace(config)
    _, emission, _ = mat_mod.surface(scene.materials, oid, hl)
    est_d, est_s = mis_mod.dual_mis(scene, trace, rd, hl, n, oid, seed, config)
    shade = ((oid != scene.light_id) & (oid > 0))[..., None]

    d = Channel(
        rgb=rep_rgb_d + emission + jnp.where(shade, est_d, 0.0),
        cnt=rep_cnt_d + 1.0, oid=oid,
    )
    s = Channel(
        rgb=rep_rgb_s + emission + jnp.where(shade, est_s, 0.0),
        cnt=rep_cnt_s + 1.0, oid=oid,
    )
    image = comp_mod.composite(scene, config, gb, camera, d, s)
    return image, History(diffuse=d, specular=s, camera=camera)


@lru_cache(maxsize=32)
def _tiled_step_fn(opt, config, mesh):
    """Build (once per (opt, config, mesh)) the jitted shard_map train step.

    Cached so a multi-step fit loop reuses the compiled step instead of
    retracing per call — `opt` (a NamedTuple of functions), the frozen
    config, and the Mesh are all hashable."""
    import dataclasses

    from kylespathtracer.diff import inverse

    n = mesh.devices.size
    rows_per = config.height // n
    # Single-frame differentiable render: skip the all-zero history gather.
    config = dataclasses.replace(config, no_history=True)

    def loss_tile(params, scene, camera, target_rows, frame):
        idx = jax.lax.axis_index(DATA_AXIS)
        scene_p = inverse.apply_params(scene, params)
        # Fresh (zero) full-height history: single-frame differentiable render
        # of this device's rows only.
        img, _ = _render_row_block(
            scene_p, camera, init_history(config, camera),
            frame, config, idx * rows_per, rows_per,
        )
        # Mean over *global* pixels: local sum, psum, divide by global count.
        se = jnp.sum((img - target_rows) ** 2)
        return jax.lax.psum(se, DATA_AXIS) / (config.height * config.width * 3)

    def step(params, opt_state, scene, camera, target, frame):
        loss, grads = jax.value_and_grad(loss_tile)(
            params, scene, camera, target, frame
        )
        grads = jax.lax.pmean(grads, DATA_AXIS)
        updates, opt_state = opt.update(grads, opt_state, params)
        import optax

        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    in_specs = (P(), P(), P(), P(), P(DATA_AXIS), P())
    out_specs = (P(), P(), P())
    # check_vma=False for the same reason as render_frame_tiled above (the
    # per-device row offset comes from axis_index, not a sharded operand);
    # the dryrun asserts sharded grads/updates match single-device.
    return jax.jit(
        jax.shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)
    )


def train_step_tiled(params, opt_state, opt, scene, camera, target, frame,
                     config, mesh):
    """shard_map inverse-rendering step: per-device loss on its rows, scene
    gradients psum-reduced over the mesh, replicated optimizer update.

    Inputs are placed as the step's outputs are (replicated; the target
    row-sharded), so a loop feeding the outputs back in reuses one
    compilation."""
    mapped = _tiled_step_fn(opt, config, mesh)
    params, opt_state, scene, camera, frame = jax.device_put(
        (params, opt_state, scene, camera, frame), NamedSharding(mesh, P())
    )
    target = jax.device_put(target, row_sharding(mesh))
    return mapped(params, opt_state, scene, camera, target, frame)
