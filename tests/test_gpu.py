"""Tests that need the card. They skip elsewhere (conftest.py's fixture)
and run on the GPU through chip_smoke.py's last phase:

    python chip_smoke.py            # runs `pytest -m gpu` in its process

The Triton kernel has no CPU route but interpret mode, so these are the
tests of what the card's Triton compiler makes of it. A two-sphere scene
keeps the kernel (and its compile) small; chip_smoke.py's own phases
compare the compiled kernel with XLA on the default and 10-sphere scenes at
1920x1080.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kylespathtracer.ops import frame_grad as fg
from kylespathtracer.ops import frame_kernel as fk
from kylespathtracer.render.camera import Camera
from kylespathtracer.scene.scene import sphere_scene
from kylespathtracer.utils.config import RenderConfig

pytestmark = pytest.mark.gpu

SCENE = sphere_scene([[0.0, 1.0, 6.0], [2.0, 1.2, 7.0]], [1.0, 0.8],
                     [[0.7, 0.3, 0.2], [0.2, 0.5, 0.6]])
CAM = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0))
FRAME = jnp.asarray(2, jnp.int32)


def test_custom_vjp_grads_on_gpu():
    """Triton forward + XLA backward on the card == plain jax.grad of the
    XLA forward on the card."""
    cfg = RenderConfig(width=128, height=64, no_history=True)

    def loss(out):
        return jnp.mean(out["add_d"]) + jnp.mean(out["add_s"]) + jnp.mean(
            out["alb"]) + 0.01 * jnp.mean(out["depth"])

    with jax.default_matmul_precision("highest"):
        g_vjp = jax.jit(jax.grad(lambda s: loss(
            fg.frame_forward(s, CAM, FRAME, cfg)), allow_int=True))(SCENE)
        g_ref = jax.jit(jax.grad(lambda s: loss(
            fk.frame_forward_jnp(s, CAM, FRAME, cfg)), allow_int=True))(SCENE)
    for name in ("planes", "spheres", "light_color"):
        a = np.asarray(getattr(g_ref, name))
        np.testing.assert_allclose(
            np.asarray(getattr(g_vjp, name)), a,
            atol=1e-3 * (np.abs(a).max() + 1e-6), err_msg=name,
        )
