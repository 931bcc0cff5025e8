"""Image-level allclose: JAX pipeline vs the NumPy CPU re-execution of the
GLSL math (the BASELINE correctness metric)."""

import numpy as np
import jax.numpy as jnp

from kylespathtracer.cpu_reference import render_ref as rr
from kylespathtracer.render.camera import Camera
from kylespathtracer.render.pipeline import init_history, render_frame
from kylespathtracer.scene import default_scene
from kylespathtracer.utils.config import RenderConfig

W, H = 48, 32
LOC = (3.0, 2.0, -3.0)
ORI = (0.0, 0.7)


def _render_jax(frames, cfg):
    scene = default_scene()
    cam = Camera.create(loc=LOC, orient=ORI)
    hist = init_history(cfg, cam)
    img = None
    for i in range(frames):
        img, hist = render_frame(scene, cam, hist, jnp.asarray(i, jnp.int32), cfg)
    return np.asarray(img), hist


def _render_ref(frames):
    hist = rr.zero_history(W, H)
    img = None
    for i in range(frames):
        img, hist = rr.render_frame(LOC, ORI, LOC, ORI, hist, i, W, H)
    return img, hist


def test_single_frame_allclose_march():
    """March mode is the reference-faithful path: frame 0 must match the CPU
    oracle pixel for pixel (small float tolerance)."""
    cfg = RenderConfig(width=W, height=H, intersect_mode="march")
    img_j, _ = _render_jax(1, cfg)
    img_r, _ = _render_ref(1)
    # Same RNG streams, same march → differences are pure float accumulation.
    mismatch = np.abs(img_j - img_r)
    frac_bad = (mismatch > 2e-2).mean()
    assert frac_bad < 0.02, f"{frac_bad:.3%} pixels differ, max {mismatch.max():.4f}"
    assert np.median(mismatch) < 2e-3


def test_multi_frame_temporal_allclose_march():
    cfg = RenderConfig(width=W, height=H, intersect_mode="march")
    img_j, _ = _render_jax(4, cfg)
    img_r, _ = _render_ref(4)
    mismatch = np.abs(img_j - img_r)
    frac_bad = (mismatch > 3e-2).mean()
    assert frac_bad < 0.03, f"{frac_bad:.3%} pixels differ, max {mismatch.max():.4f}"


def test_analytic_close_to_ref():
    """The fast path may differ at object silhouettes but must match almost
    everywhere else."""
    cfg = RenderConfig(width=W, height=H, intersect_mode="analytic")
    img_j, _ = _render_jax(1, cfg)
    img_r, _ = _render_ref(1)
    mismatch = np.abs(img_j - img_r)
    assert (mismatch > 3e-2).mean() < 0.06
