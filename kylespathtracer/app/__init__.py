"""Application layer: frame-loop driver, camera controller, CLI.

The reference's Win32/GLFW host app (main.cpp:239-363) becomes a pure
functional frame loop: a fly-camera controller as a jittable state update, a
scripted benchmark camera, and a CLI driver that renders sequences, writes
images, and logs metrics.
"""

from kylespathtracer.app.controller import ControllerState, InputFrame, update_controller
from kylespathtracer.app.driver import render_animation

__all__ = [
    "ControllerState",
    "InputFrame",
    "update_controller",
    "render_animation",
]
