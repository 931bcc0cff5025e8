"""Color pipeline: sRGB transfer, ACES tonemap, spectral ramp.

(reference: common.glsl:70-139)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# ACES input/output matrices (reference: common.glsl:120-139). GLSL mat3
# constructors are column-major and the reference multiplies row-vector *
# matrix, i.e. out_i = dot(color, column_i). Stored rows-as-written below,
# each written row IS one GLSL column, so the numpy op is color @ M.T.
_ACES_IN = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    jnp.float32,
)
_ACES_OUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    jnp.float32,
)


def linear_srgb(x: jnp.ndarray) -> jnp.ndarray:
    """Linear → sRGB transfer (reference: common.glsl:111-113)."""
    lo = 12.92 * x
    hi = 1.055 * jnp.power(jnp.maximum(x, 1e-10), 1.0 / 2.4) - 0.055
    return jnp.where(x <= 0.0031308, lo, hi)


def srgb_linear(x: jnp.ndarray) -> jnp.ndarray:
    """sRGB → linear transfer (reference: common.glsl:115-117)."""
    lo = x / 12.92
    hi = jnp.power(jnp.maximum((x + 0.055) / 1.055, 1e-10), 2.4)
    return jnp.where(x <= 0.04045, lo, hi)


def _mat3(v: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Row-vector × mat3 as explicit fma chains: exact float32 (a
    (…,3)×(3,3) matmul is a dot_general, whose default precision may round
    f32 operands — bf16 on some backends, TF32 on the GPU)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            x * m[0, 0] + y * m[0, 1] + z * m[0, 2],
            x * m[1, 0] + y * m[1, 1] + z * m[1, 2],
            x * m[2, 0] + y * m[2, 1] + z * m[2, 2],
        ],
        axis=-1,
    )


def aces_fitted(color: jnp.ndarray) -> jnp.ndarray:
    """Paniq/MJP fitted ACES RRT+ODT (reference: common.glsl:120-139)."""
    c = _mat3(color, _ACES_IN)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    c = a / b
    c = _mat3(c, _ACES_OUT)
    return jnp.clip(c, 0.0, 1.0)


# Spectral→RGB piecewise-quadratic fit (reference: common.glsl:86-108).
_FR1 = np.array([400., 410., 545., 595., 650., 415., 475., 585., 400., 475.])
_FR2 = np.array([410., 475., 595., 650., 700., 475., 585., 639., 475., 560.])
_DV1 = np.array([10., 65., 50., 55., 50., 60., 115., 54., 75., 85.])
_C = np.array(
    [
        [0.0, 0.33, -0.2], [0.14, 0.0, -0.13], [0.0, 1.98, -1.0],
        [0.98, 0.06, -0.4], [0.65, -0.84, 0.2], [0.0, 0.0, 0.8],
        [0.8, 0.76, -0.8], [0.84, -0.84, 0.0], [0.0, 2.2, -1.5],
        [0.7, -1.0, 0.3],
    ]
)


def texture_good(tex: jnp.ndarray, x: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Smoothstep-weighted bilinear texel fetch with power-of-two wraparound
    (reference: common.glsl:70-79; unused upstream, kept for parity).

    tex: f32[S,S,C] with S = bits+1 a power of two; x: f32[...,2] continuous
    texel coordinates.
    """
    p = jnp.floor(x).astype(jnp.int32)
    f = x - p
    f = f * f * (3.0 - 2.0 * f)

    def fetch(dx, dy):
        q = (p + jnp.asarray([dx, dy], jnp.int32)) & bits
        return tex[q[..., 1], q[..., 0]]

    fx = f[..., 0:1]
    fy = f[..., 1:2]
    top = fetch(0, 0) * (1 - fx) + fetch(1, 0) * fx
    bot = fetch(0, 1) * (1 - fx) + fetch(1, 1) * fx
    return top * (1 - fy) + bot * fy


def spectrum(x: jnp.ndarray) -> jnp.ndarray:
    """Normalized wavelength (0=400nm..1=700nm) → RGB (common.glsl:86-108)."""
    l = x * 300.0 + 400.0
    l = l[..., None]
    t = (l - _FR1) / _DV1
    in_range = (l >= _FR1) & (l <= _FR2)
    seg = jnp.where(in_range, _C[:, 0] + _C[:, 1] * t + _C[:, 2] * t * t, 0.0)
    r = jnp.sum(seg[..., 0:5], axis=-1)
    g = jnp.sum(seg[..., 5:8], axis=-1)
    b = jnp.sum(seg[..., 8:10], axis=-1)
    rgb = jnp.stack([r, g, b], axis=-1)
    return rgb * rgb
