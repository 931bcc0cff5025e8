"""App-layer tests: controller semantics, driver loop, image IO, checkpoint."""

import numpy as np
import jax
import jax.numpy as jnp

from kylespathtracer.app.controller import (
    ControllerState,
    InputFrame,
    update_controller,
    ACCEL_SPEED,
    MAX_SPEED,
)
from kylespathtracer.app.driver import render_animation, spline_cameras, playback_cameras
from kylespathtracer.scene.scene import default_scene
from kylespathtracer.utils.config import RenderConfig
from kylespathtracer.core import gmath


def test_controller_forward_motion():
    """Holding W accelerates along the view direction; friction caps speed
    (main.cpp:283-293)."""
    st = ControllerState.create(loc=(0.0, 0.0, 0.0), orient=(0.0, 0.0))
    inp = InputFrame.create(move=(0.0, 0.0, 1.0))
    step = jax.jit(update_controller)
    for _ in range(200):
        st = step(st, inp)
    # Terminal speed = accel / (1 - friction) = 0.01 / 0.1 = 0.1 < MAX_SPEED.
    speed = float(jnp.linalg.norm(st.vel))
    assert abs(speed - ACCEL_SPEED / 0.1) < 1e-3
    assert float(st.loc[2]) > 10.0  # moved forward (+z at yaw 0)
    assert abs(float(st.loc[0])) < 1e-4 and abs(float(st.loc[1])) < 1e-4


def test_controller_dead_stop_and_speed_cap():
    st = ControllerState.create(loc=(0.0, 0.0, 0.0), orient=(0.0, 0.0))
    # One tap then release: velocity dies to exactly zero (dead stop).
    st = update_controller(st, InputFrame.create(move=(0.0, 0.0, 1.0)))
    idle = InputFrame.create()
    for _ in range(60):
        st = update_controller(st, idle)
    assert float(jnp.linalg.norm(st.vel)) == 0.0
    # Speed cap holds under extreme synthetic velocity.
    st = st.replace(vel=jnp.asarray([9.0, 0.0, 0.0], jnp.float32))
    st = update_controller(st, idle)
    assert float(jnp.linalg.norm(st.vel)) <= MAX_SPEED + 1e-5


def test_controller_mouse_look_clamp_wrap():
    """Pitch clamps at ±HPI; yaw wraps into (−π, π] (main.cpp:250-256)."""
    st = ControllerState.create(orient=(0.0, 0.0))
    down = InputFrame.create(mouse_delta=(4000.0, -4000.0), mouse_down=True)
    st = update_controller(st, down)  # first press: no look yet (mouseP gate)
    orient0 = np.asarray(st.orient)
    assert np.allclose(orient0, [0.0, 0.0])
    st = update_controller(st, down)
    assert abs(float(st.orient[0]) - gmath.HPI) < 1e-5  # pitch clamped
    assert -gmath.PI <= float(st.orient[1]) <= gmath.PI  # yaw wrapped


def test_playback_matches_stepwise():
    T = 16
    inputs = InputFrame(
        move=jnp.tile(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (T, 1)),
        mouse_delta=jnp.zeros((T, 2), jnp.float32),
        mouse_down=jnp.zeros((T,), bool),
    )
    st = ControllerState.create()
    cams = playback_cameras(st, inputs)
    st2 = ControllerState.create()
    for i in range(T):
        st2 = update_controller(st2, jax.tree.map(lambda l: l[i], inputs))
    np.testing.assert_allclose(np.asarray(cams.loc[-1]), np.asarray(st2.loc), rtol=1e-6)


def test_render_animation_writes_images(tmp_path):
    config = RenderConfig(width=32, height=24)
    img, hist = render_animation(
        default_scene(), config, num_frames=2, out_dir=tmp_path, save_every=1
    )
    assert img.shape == (24, 32, 3)
    assert (tmp_path / "final.png").exists()
    assert (tmp_path / "frame_00000.png").exists()


def test_spline_cameras_loop():
    cams = spline_cameras(8)
    assert cams.loc.shape == (8, 3)
    assert np.isfinite(np.asarray(cams.loc)).all()


def test_image_io_roundtrip(tmp_path):
    from kylespathtracer.utils import image_io

    img = np.random.default_rng(0).random((16, 20, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    image_io.save_png(p, img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    image_io.save_ppm(tmp_path / "x.ppm", img)
    assert (tmp_path / "x.ppm").read_bytes().startswith(b"P6\n20 16\n255\n")


def test_checkpoint_roundtrip(tmp_path):
    from kylespathtracer.utils import checkpoint as ck
    from kylespathtracer.render.pipeline import init_history
    from kylespathtracer.render.camera import Camera

    h = init_history(RenderConfig(width=8, height=8), Camera.create())
    ck.save(tmp_path, 7, {"history": h})
    step, state = ck.restore(tmp_path, like={"history": h})
    assert step == 7
    assert state["history"].diffuse.rgb.shape == (8, 8, 3)
    np.testing.assert_array_equal(
        np.asarray(state["history"].camera.loc), np.asarray(h.camera.loc)
    )


def test_terminal_preview_ansi():
    import io

    import numpy as np

    from kylespathtracer.utils.preview import TerminalPreview, frame_to_ansi

    img = np.random.default_rng(0).random((48, 64, 3)).astype(np.float32)
    s = frame_to_ansi(img, max_w=32, max_h=12)
    assert len(s.split("\n")) == 12 and "\x1b[38;2;" in s
    buf = io.StringIO()
    tp = TerminalPreview(max_w=16, max_h=8, stream=buf)
    tp.show(img, caption="f0")
    tp.show(img, caption="f1")
    assert "f1" in buf.getvalue()


def test_fly_parse_keys():
    from kylespathtracer.app.fly import ARROW_PX, parse_keys

    move, look, q = parse_keys(b"w")
    assert move == [0.0, 0.0, 1.0] and look == [0.0, 0.0] and not q
    move, look, q = parse_keys(b"wd \x1b[C\x1b[A")
    assert move == [1.0, 1.0, 1.0]
    assert look == [ARROW_PX, -ARROW_PX]
    move, look, q = parse_keys(b"ss")  # repeats clamp to unit intent
    assert move[2] == -1.0
    assert parse_keys(b"q")[2] and parse_keys(b"\x1b")[2]
    assert not parse_keys(b"\x1b[D")[2]  # arrow is not quit


def test_fly_step_moves_camera():
    """One fly step: key intent moves the camera and renders a frame."""
    import jax.numpy as jnp

    from kylespathtracer.app.controller import ControllerState, InputFrame
    from kylespathtracer.app.fly import fly_step, parse_keys
    from kylespathtracer.render.pipeline import init_history
    from kylespathtracer.scene import default_scene
    from kylespathtracer.utils.config import RenderConfig

    cfg = RenderConfig(width=32, height=24)
    scene = default_scene()
    state = ControllerState.create()
    hist = init_history(cfg, state.camera)
    step = fly_step(cfg)
    move, look, _ = parse_keys(b"w")
    inp = InputFrame.create(move=move, mouse_delta=look)
    state2, img, hist = step(scene, state, inp, hist, jnp.asarray(0, jnp.int32))
    assert img.shape == (24, 32, 3)
    assert bool(jnp.isfinite(img).all())
    # Forward intent at yaw 1.8 moved the camera in world space.
    assert float(jnp.linalg.norm(state2.loc - state.loc)) > 0.0


def test_render_animation_resume_matches_uninterrupted(tmp_path):
    """Elastic recovery: kill a run after its checkpoint, relaunch with
    resume=True, and the final frame must equal the uninterrupted run's."""
    import numpy as np
    import jax.numpy as jnp

    from kylespathtracer.app.driver import render_animation
    from kylespathtracer.scene import default_scene
    from kylespathtracer.utils.config import RenderConfig

    scene = default_scene()
    cfg = RenderConfig(width=32, height=24)
    ck = tmp_path / "ck"

    # Uninterrupted 6-frame reference.
    ref, _ = render_animation(scene, cfg, num_frames=6)

    # "Preempted" run: 4 frames with a checkpoint at frame 3, then resume.
    render_animation(
        scene, cfg, num_frames=4, checkpoint_dir=ck, checkpoint_every=3
    )
    img, _ = render_animation(
        scene, cfg, num_frames=6, checkpoint_dir=ck, checkpoint_every=0,
        resume=True,
    )
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(img))
