"""Fly-camera controller.

Pure-functional equivalent of the reference's `handleInput`
(reference: main.cpp:239-295): mouse-drag look with pitch clamp and yaw
wrap, WASD/arrow/space/shift fly with friction, dead-stop and speed limit.
GLFW polling becomes an explicit `InputFrame`; the mutated globals
(main.cpp:41-44) become a `ControllerState` pytree, so input playback is
deterministic, jittable, and scannable.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath
from kylespathtracer.render.camera import Camera
from kylespathtracer.utils import struct

# Reference constants (main.cpp:36).
ACCEL_SPEED = 0.01
ROT_SPEED = 0.002
MAX_SPEED = 0.5


@struct.dataclass
class InputFrame:
    """One frame of user intent (the poll results of main.cpp:241-279).

    move: f32[3] intent in camera space — x right, y up, z forward
          (each in {-1, 0, 1}; diagonals are normalized like the reference).
    mouse_delta: f32[2] cursor (dx, dy) in pixels since last frame.
    mouse_down: bool — left button held.
    """

    move: jnp.ndarray
    mouse_delta: jnp.ndarray
    mouse_down: jnp.ndarray

    @classmethod
    def create(cls, move=(0.0, 0.0, 0.0), mouse_delta=(0.0, 0.0), mouse_down=False):
        return cls(
            move=jnp.asarray(move, jnp.float32),
            mouse_delta=jnp.asarray(mouse_delta, jnp.float32),
            mouse_down=jnp.asarray(mouse_down, bool),
        )


@struct.dataclass
class ControllerState:
    """Camera state carried frame to frame (the globals of main.cpp:41-44)."""

    loc: jnp.ndarray      # f32[3]
    vel: jnp.ndarray      # f32[3]
    orient: jnp.ndarray   # f32[2] (pitch, yaw)
    was_down: jnp.ndarray  # bool: mouse held last frame (mouseP, main.cpp:44)

    @classmethod
    def create(cls, loc=(-2.0, 2.5, -5.0), orient=(0.1, 1.8)) -> "ControllerState":
        """Defaults are the reference's start pose (main.cpp:41-43)."""
        return cls(
            loc=jnp.asarray(loc, jnp.float32),
            vel=jnp.zeros(3, jnp.float32),
            orient=jnp.asarray(orient, jnp.float32),
            was_down=jnp.asarray(False),
        )

    @property
    def camera(self) -> Camera:
        return Camera(loc=self.loc, orient=self.orient)


def _rotate_y(p: jnp.ndarray, yaw: jnp.ndarray) -> jnp.ndarray:
    """Yaw-only rotation of the intent vector into the view frame
    (reference: main.cpp:48-54 — the pitch row is commented out upstream)."""
    c = jnp.cos(yaw)
    s = jnp.sin(yaw)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return jnp.stack([x * c + z * s, y, -x * s + z * c], axis=-1)


def update_controller(state: ControllerState, inp: InputFrame) -> ControllerState:
    """One tick of `handleInput` (main.cpp:239-295). Jittable and scannable."""
    # Mouse look: only while held on consecutive frames (main.cpp:248-258).
    rot = jnp.where(inp.mouse_down & state.was_down, ROT_SPEED, 0.0)
    pitch = state.orient[0] + -inp.mouse_delta[1] * rot
    yaw = state.orient[1] + inp.mouse_delta[0] * rot
    pitch = jnp.clip(pitch, -gmath.HPI, gmath.HPI)
    yaw = jnp.where(yaw < -gmath.PI, yaw + gmath.TWOPI, yaw)
    yaw = jnp.where(yaw > gmath.PI, yaw - gmath.TWOPI, yaw)
    orient = jnp.stack([pitch, yaw])

    # Normalize diagonal intent (main.cpp:280-281).
    mlen = gmath.length(inp.move)
    move = jnp.where(mlen > 1.0, inp.move / jnp.maximum(mlen, 1e-6), inp.move)

    # Friction, world-frame acceleration, dead stop, speed cap
    # (main.cpp:283-293).
    vel = state.vel * 0.9 + _rotate_y(move * ACCEL_SPEED, yaw)
    speed = gmath.length(vel)
    vel = jnp.where(speed < ACCEL_SPEED, 0.0, vel)
    vel = jnp.where(
        speed > MAX_SPEED, vel * (MAX_SPEED / jnp.maximum(speed, 1e-6)), vel
    )

    return ControllerState(
        loc=state.loc + vel, vel=vel, orient=orient, was_down=inp.mouse_down
    )
