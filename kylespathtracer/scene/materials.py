"""Material evaluation.

Vectorized, differentiable equivalent of the reference's procedural
`getSurface(ho, hl)` switch (reference: common.glsl:237-262), driven by the
`Materials` table. Returns the same three quantities as the reference's mat3:
albedo ("reflection color"), emission, and (diffuse, specular) energy.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.scene.types import Materials


def checker(hl: jnp.ndarray, freq: jnp.ndarray) -> jnp.ndarray:
    """3D checkerboard: float((floor(x f)+floor(y f)+floor(z f)) & 1).

    (reference: common.glsl:244, 250)
    """
    s = jnp.floor(hl[..., 0] * freq) + jnp.floor(hl[..., 1] * freq) + jnp.floor(
        hl[..., 2] * freq
    )
    return jnp.abs(jnp.mod(s, 2.0))


def surface(materials: Materials, ho: jnp.ndarray, hl: jnp.ndarray
            ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Evaluate (albedo[...,3], emission[...,3], energy[...,2]) at hit points.

    ho: int32[...] object IDs (0 = miss → all-zero material row).
    hl: f32[...,3] hit locations (for the procedural checker).
    """
    k = jnp.clip(ho, 0, materials.num_ids - 1)
    s = materials.s0[k] + materials.s1[k] * checker(hl, materials.freq[k])
    s = s[..., None]
    albedo = materials.alb_const[k] + materials.alb_scale[k] * s
    energy = materials.en_const[k] + materials.en_scale[k] * s
    emission = materials.emission[k]
    return albedo, emission, energy
