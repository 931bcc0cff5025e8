"""Composite + tonemap pass (reference: passthrough.frag:29-47)."""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import color
from kylespathtracer.render.camera import Camera
from kylespathtracer.render.gbuffer import GBuffer
from kylespathtracer.render.passes import Channel
from kylespathtracer.scene import materials as mat_mod
from kylespathtracer.scene.types import Scene
from kylespathtracer.utils.config import RenderConfig


def composite(
    scene: Scene,
    config: RenderConfig,
    gb: GBuffer,
    camera: Camera,
    diffuse: Channel,
    specular: Channel,
) -> jnp.ndarray:
    """Modulate the accumulators by the primary surface, average by sample
    count, tonemap → sRGB image f32[H,W,3]."""
    hl = camera.loc + gb.ray_dir * gb.depth[..., None]
    albedo, _, energy = mat_mod.surface(scene.materials, gb.obj_id, hl)
    return composite_from(albedo, energy, diffuse, specular, config)


def composite_from(
    albedo: jnp.ndarray,
    energy: jnp.ndarray,
    diffuse: Channel,
    specular: Channel,
    config: RenderConfig,
) -> jnp.ndarray:
    """Composite from precomputed primary albedo/energy (the fused kernel
    outputs them; the reference re-fetches the surface, passthrough.frag:38)."""
    # diffuse × albedo·E_d; specular × sqrt(albedo)·E_s (passthrough.frag:39-41).
    # sqrt guarded with the safe-where pattern: d/dx sqrt at 0 is inf, and the
    # miss material row is exactly 0.
    pos = albedo > 0.0
    alb_sqrt = jnp.where(pos, jnp.sqrt(jnp.where(pos, albedo, 1.0)), 0.0)
    d = diffuse.rgb * albedo * energy[..., 0:1]
    s = specular.rgb * alb_sqrt * energy[..., 1:2]

    img = d / jnp.maximum(jnp.floor(diffuse.cnt), 1.0)[..., None] + s / jnp.maximum(
        jnp.floor(specular.cnt), 1.0
    )[..., None]
    return color.linear_srgb(color.aces_fitted(img * config.brightness))
