"""Frame-loop driver.

The reference's 60 Hz windowed main loop (main.cpp:328-357) becomes a
headless sequence renderer: the scripted spline camera (the benchmark path,
geometry.frag:26-34) or a played-back input script drives `render_frame`
under one jit, frames stream to PNG/PPM, metrics to JSONL, and the loop can
checkpoint/resume mid-sequence.
"""

from __future__ import annotations

import time
from pathlib import Path

import jax
import jax.numpy as jnp

from kylespathtracer.app.controller import (
    ControllerState,
    InputFrame,
    update_controller,
)
from kylespathtracer.render.camera import Camera, camera_pose_spline
from kylespathtracer.render.pipeline import History, init_history, render_frame
from kylespathtracer.scene.types import Scene
from kylespathtracer.utils import image_io
from kylespathtracer.utils.config import RenderConfig
from kylespathtracer.utils.metrics import MetricsLogger


def spline_cameras(num_frames: int, fps: float = 60.0) -> Camera:
    """Stacked Camera pytree along the reference's scripted spline
    (geometry.frag:26-34,45-55; t = iTime·0.5 with iTime in seconds)."""
    times = jnp.arange(num_frames, dtype=jnp.float32) / fps
    locs, orients = jax.vmap(camera_pose_spline)(times)
    return Camera(loc=locs, orient=orients)


def playback_cameras(state: ControllerState, inputs: InputFrame) -> Camera:
    """Run a recorded input script through the fly controller; returns the
    per-frame cameras (leaves have leading axis [T])."""

    def step(st, inp):
        st = update_controller(st, inp)
        return st, (st.loc, st.orient)

    _, (locs, orients) = jax.lax.scan(step, state, inputs)
    return Camera(loc=locs, orient=orients)


def render_animation(
    scene: Scene,
    config: RenderConfig,
    num_frames: int = 64,
    cameras: Camera | None = None,
    history: History | None = None,
    start_frame: int = 0,
    out_dir=None,
    save_every: int = 0,
    metrics: MetricsLogger | None = None,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    preview: bool = False,
    resume: bool = False,
):
    """Render `num_frames` frames; returns (last_image, history).

    Frames run one jitted `render_frame` per step (history donated to avoid
    the ping-pong copy the reference needed GL feedback hacks for; a
    `history` passed in is consumed).
    `resume=True` restores the newest checkpoint under `checkpoint_dir`
    (history + frame index) and continues the sequence from there — the
    elastic-recovery path: a preempted run relaunched with the same flags
    picks up where the last checkpoint left it, bitwise-deterministically.
    """
    if resume and checkpoint_dir:
        from kylespathtracer.utils import checkpoint as ckpt_mod

        like = {"history": init_history(config, Camera.create())}
        try:
            step, state = ckpt_mod.restore(checkpoint_dir, like=like)
            history = state["history"]
            num_frames = max(0, start_frame + num_frames - (step + 1))
            start_frame = step + 1
            print(f"resumed from checkpoint step {step}")
        except FileNotFoundError:
            pass  # fresh start
    if cameras is None:
        cameras = spline_cameras(start_frame + num_frames)
    if history is None:
        history = init_history(config, jax.tree.map(lambda l: l[0], cameras))
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)

    fn = jax.jit(
        render_frame, static_argnames=("config",), donate_argnames=("history",)
    )

    rays = config.width * config.height
    tty = None
    if preview:
        from kylespathtracer.utils.preview import TerminalPreview

        tty = TerminalPreview()
    image = None
    for i in range(start_frame, start_frame + num_frames):
        cam = jax.tree.map(lambda l: l[i], cameras)
        t0 = time.perf_counter()
        image, history = fn(scene, cam, history, jnp.asarray(i, jnp.int32), config)
        jax.block_until_ready(image)
        dt = time.perf_counter() - t0
        if metrics is not None:
            metrics.log(frame=i, wall_s=round(dt, 6), rays_per_s=round(rays / dt, 1))
        if tty is not None:
            import numpy as _np

            tty.show(
                _np.asarray(image),
                caption=f"frame {i}  {dt*1e3:.1f} ms  {rays/dt/1e6:.1f} Mrays/s",
            )
        if out_dir is not None and save_every and (i % save_every == 0):
            image_io.save_image(Path(out_dir) / f"frame_{i:05d}.png", image)
        if checkpoint_dir and checkpoint_every and i and (i % checkpoint_every == 0):
            from kylespathtracer.utils import checkpoint as ckpt_mod

            ckpt_mod.save(checkpoint_dir, step=i, state={"history": history})

    if out_dir is not None:
        image_io.save_image(Path(out_dir) / "final.png", image)
    return image, history
