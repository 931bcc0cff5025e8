"""Interactive fly-cam: the reference's live app loop, over a terminal.

The reference polls GLFW and blits to an OpenGL window at ~60 Hz
(main.cpp:328-357). This build is headless and usually remote, so the
loop becomes: raw-mode stdin → key parse → InputFrame →
`update_controller` (the exact handleInput semantics, app/controller.py) →
one jitted fused frame on the device → ANSI half-block preview.

Keys (mouse-look is remapped to the arrow keys):
    w/a/s/d   fly forward/left/back/right     (main.cpp:264-275)
    space/c   up / down                        (space/shift upstream, :276-279)
    arrows    look (injected as mouse drag deltas, main.cpp:241-262)
    q or ESC  quit

The controller state/physics (friction 0.9, accel 0.01, rot 0.002, max
speed 0.5) are bit-identical to playback mode — `parse_keys` is the only
new logic, and it is pure and unit-tested (tests/test_app.py).
"""

from __future__ import annotations

import select
import sys
import time

import jax
import jax.numpy as jnp

from kylespathtracer.app.controller import (
    ControllerState,
    InputFrame,
    update_controller,
)
from kylespathtracer.render.pipeline import init_history, render_frame
from kylespathtracer.scene import default_scene
from kylespathtracer.utils.config import RenderConfig
from kylespathtracer.utils.preview import TerminalPreview

# One arrow keypress = this many pixels of virtual mouse drag.
ARROW_PX = 24.0


def parse_keys(data: bytes):
    """Pending raw tty bytes → (move xyz, look dx dy, quit).

    move is the camera-space intent vector (x right, y up, z forward);
    look is a virtual mouse drag in pixels (arrow keys)."""
    move = [0.0, 0.0, 0.0]
    look = [0.0, 0.0]
    quit_ = False
    i = 0
    while i < len(data):
        c = data[i:i + 1]
        if c == b"\x1b":
            seq = data[i:i + 3]
            if seq == b"\x1b[A":
                look[1] -= ARROW_PX  # look up = negative dy (screen coords)
                i += 3
                continue
            if seq == b"\x1b[B":
                look[1] += ARROW_PX
                i += 3
                continue
            if seq == b"\x1b[C":
                look[0] += ARROW_PX
                i += 3
                continue
            if seq == b"\x1b[D":
                look[0] -= ARROW_PX
                i += 3
                continue
            quit_ = True  # bare ESC
            i += 1
            continue
        if c in (b"w", b"W"):
            move[2] += 1.0
        elif c in (b"s", b"S"):
            move[2] -= 1.0
        elif c in (b"a", b"A"):
            move[0] -= 1.0
        elif c in (b"d", b"D"):
            move[0] += 1.0
        elif c == b" ":
            move[1] += 1.0
        elif c in (b"c", b"C"):
            move[1] -= 1.0
        elif c in (b"q", b"Q"):
            quit_ = True
        i += 1
    clamp = lambda v: max(-1.0, min(1.0, v))
    return [clamp(v) for v in move], look, quit_


def _read_pending(fd) -> bytes:
    out = b""
    while select.select([fd], [], [], 0)[0]:
        chunk = sys.stdin.buffer.raw.read(64)
        if not chunk:
            break
        out += chunk
    return out


def fly_step(config: RenderConfig):
    """One jitted (controller tick + frame) step: (state, inp, hist, frame)
    → (state, image, hist). Shared by the live loop and tests."""

    def step(scene, state, inp, hist, frame):
        state = update_controller(state, inp)
        img, hist = render_frame(scene, state.camera, hist, frame, config)
        return state, img, hist

    return jax.jit(step, static_argnames=())


def fly(
    config: RenderConfig | None = None,
    scene=None,
    fps: float = 20.0,
    max_w: int = 100,
    max_h: int = 48,
    frames: int | None = None,
):
    """Run the interactive loop until q/ESC (or `frames` steps)."""
    import termios
    import tty

    if config is None:
        from kylespathtracer.ops import platform

        config = RenderConfig(
            width=480, height=270, pipeline=platform.default_pipeline()
        )
    if scene is None:
        scene = default_scene()

    state = ControllerState.create()
    hist = init_history(config, state.camera)
    step = fly_step(config)
    preview = TerminalPreview(max_w=max_w, max_h=max_h)

    if not sys.stdin.isatty():
        print("kpt fly: stdin is not a tty; run from an interactive terminal",
              file=sys.stderr)
        return

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    frame_s = 1.0 / fps
    try:
        i = 0
        t_last = time.perf_counter()
        while frames is None or i < frames:
            data = _read_pending(fd)
            move, look, quit_ = parse_keys(data)
            if quit_:
                break
            inp = InputFrame.create(
                move=move, mouse_delta=look, mouse_down=bool(look[0] or look[1]),
            )
            # Arrow-look needs down on consecutive frames (mouseP logic):
            # pre-arm was_down so a single arrow press takes effect.
            if look[0] or look[1]:
                state = state.replace(was_down=jnp.asarray(True))
            state, img, hist = step(
                scene, state, inp, hist, jnp.asarray(i, jnp.int32)
            )
            img.block_until_ready()
            now = time.perf_counter()
            dt, t_last = now - t_last, now
            loc = [round(float(v), 2) for v in state.loc]
            preview.show(
                img,
                caption=(
                    f"frame {i}  {1.0 / max(dt, 1e-6):5.1f} fps  loc {loc}  "
                    "wasd fly · space/c up/down · arrows look · q quit"
                ),
            )
            i += 1
            sleep = frame_s - (time.perf_counter() - now)
            if sleep > 0:
                time.sleep(sleep)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
