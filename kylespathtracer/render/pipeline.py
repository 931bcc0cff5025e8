"""The frame pipeline: a pure function under jit.

The reference's four GL draw calls per frame (main.cpp:344-350) become

    render_frame(scene, camera, history, frame, config)
        → (image, new_history)

with all state (history buffers, previous camera) loop-carried in a pytree —
no texture feedback, no pixel-smuggled camera (common.glsl:643-647).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kylespathtracer.render import composite as comp_mod
from kylespathtracer.render import gbuffer as gb_mod
from kylespathtracer.render.camera import Camera
from kylespathtracer.render.passes import Channel, shade_passes
from kylespathtracer.scene.types import Scene
from kylespathtracer.utils.config import RenderConfig
from kylespathtracer.utils import struct


@struct.dataclass
class History:
    diffuse: Channel
    specular: Channel
    camera: Camera  # the camera the buffers were rendered with

    @classmethod
    def zeros(cls, config: RenderConfig, camera: Camera) -> "History":
        return cls(
            diffuse=Channel.zeros(config.height, config.width),
            specular=Channel.zeros(config.height, config.width),
            camera=camera,
        )


def init_history(config: RenderConfig, camera: Camera | None = None) -> History:
    return History.zeros(config, camera or Camera.create())


def render_frame(
    scene: Scene,
    camera: Camera,
    history: History,
    frame: jnp.ndarray,
    config: RenderConfig,
) -> tuple[jnp.ndarray, History]:
    """One full frame: geometry → diffuse → specular → composite.

    (reference frame loop: main.cpp:344-350)
    """
    if config.pipeline == "fused":
        # Honors the full quality config: smp_* loops and the unbiased
        # ground-truth estimators run in-kernel (biased=False switches
        # frame_block to shade_kernel._shade_core_unbiased); unequal smp_*
        # counts raise ValueError (frame_kernel.smp_of) — the fused path
        # never silently diverges from the config.
        return render_frame_fused(scene, camera, history, frame, config)
    gb = gb_mod.geometry_pass(scene, camera, config)
    d, s = shade_passes(
        scene, config, gb, camera, history.camera,
        history.diffuse, history.specular, frame,
    )
    image = comp_mod.composite(scene, config, gb, camera, d, s)
    return image, History(diffuse=d, specular=s, camera=camera)


def render_frame_fused(
    scene: Scene,
    camera: Camera,
    history: History,
    frame: jnp.ndarray,
    config: RenderConfig,
) -> tuple[jnp.ndarray, History]:
    """The fast-path frame: the fused frame forward (raygen + intersect +
    normals + dual-MIS shade + primary material in one kernel on the GPU,
    ops/platform.py) plus the exact XLA reprojection gather and composite.
    Numerically equivalent to the unfused frame with
    intersect_mode="analytic", normal_mode="analytic". Differentiable: the
    forward carries a custom VJP whose backward is XLA's vjp of the same
    math (ops/frame_grad.py)."""
    from kylespathtracer.core import gmath
    from kylespathtracer.ops import frame_grad as fg
    from kylespathtracer.render import camera as cam_mod
    from kylespathtracer.render import reproject as rep_mod
    from kylespathtracer.render.passes import _temporal_clamp, count_floor

    out = fg.frame_forward(scene, camera, frame, config)
    ho = out["oid"]

    if config.no_history:
        # Fresh-history single-frame render (the differentiable single-frame
        # forward): reprojecting an all-zero history is pure waste — skip the
        # gather and the temporal clamp (numerically identical; passes.py).
        ones = jnp.ones(ho.shape, jnp.float32)
        d = Channel(rgb=out["add_d"], cnt=ones, oid=ho)
        s = Channel(rgb=out["add_s"], cnt=ones, oid=ho)
        image = comp_mod.composite_from(out["alb"], out["ene"], d, s, config)
        return image, History(diffuse=d, specular=s, camera=camera)

    # Hit point + curvature-pushed specular anchor (specular.frag:45-49).
    rd = cam_mod.ray_dirs(camera, config.width, config.height, config.fov)
    hl = camera.loc + rd * out["depth"][..., None]
    light_dist = gmath.length(hl - scene.light[:3])
    fac = gmath.EPS / jnp.sqrt(jnp.maximum(gmath.EPS, out["curv"]))
    sl = hl + rd * (light_dist * fac)[..., None]

    # Exact arbitrary-motion 2x2 gather of the previous accumulation
    # (common.glsl:661-694); differentiable.
    vv = gmath.length(camera.loc - history.camera.loc)
    prev = history.camera
    with jax.named_scope("reproject"):
        rep_rgb_d, rep_cnt_d = rep_mod.reproject(
            prev.loc, prev.orient, hl, ho,
            history.diffuse.rgb, history.diffuse.cnt, history.diffuse.oid,
            config.fov,
        )
        rep_rgb_s, rep_cnt_s = rep_mod.reproject(
            prev.loc, prev.orient, sl, ho,
            history.specular.rgb, history.specular.cnt, history.specular.oid,
            config.fov,
        )
    rep_cnt_d = count_floor(rep_cnt_d)
    rep_cnt_s = count_floor(rep_cnt_s)
    rep_rgb_d, rep_cnt_d = _temporal_clamp(rep_rgb_d, rep_cnt_d, vv, config)
    rep_rgb_s, rep_cnt_s = _temporal_clamp(rep_rgb_s, rep_cnt_s, vv, config)

    d = Channel(rgb=rep_rgb_d + out["add_d"], cnt=rep_cnt_d + 1.0, oid=ho)
    s = Channel(rgb=rep_rgb_s + out["add_s"], cnt=rep_cnt_s + 1.0, oid=ho)
    image = comp_mod.composite_from(out["alb"], out["ene"], d, s, config)
    return image, History(diffuse=d, specular=s, camera=camera)


def render_image(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    frames: int = 1,
    history: History | None = None,
):
    """Convenience: render `frames` frames with a static camera, return the
    last image (temporal accumulation warms up over the sequence)."""
    if history is None:
        history = init_history(config, camera)

    fn = jax.jit(render_frame, static_argnames=("config",))

    image = None
    for i in range(frames):
        image, history = fn(scene, camera, history, jnp.asarray(i, jnp.int32), config)
    return image, history


def render_sequence(
    scene: Scene,
    cameras: Camera,  # stacked pytree: leaves have leading axis [T]
    history: History,
    config: RenderConfig,
    start_frame: int = 0,
):
    """Scan over an animated camera path; returns (images[T,H,W,3], history).

    The whole sequence compiles to a single XLA while-loop — the device
    analog of the reference's 60 Hz main loop (main.cpp:328-357)."""

    def step(hist, xs):
        cam, idx = xs
        img, hist = render_frame(scene, cam, hist, idx, config)
        return hist, img

    idxs = start_frame + jnp.arange(
        jax.tree_util.tree_leaves(cameras)[0].shape[0], dtype=jnp.int32
    )
    history, images = jax.lax.scan(step, history, (cameras, idxs))
    return images, history
