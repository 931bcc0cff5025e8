"""Temporal reprojection.

Projects the current hit point into the previous frame's camera and gathers
a 2×2 neighborhood from the history buffers, zero-weighting taps whose stored
object ID differs from the current hit (reference: common.glsl:661-694).
History is SoA (rgb, count, id) instead of the reference's alpha-packed
count+ID (common.glsl:629-635).
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath


def reproject_query(
    prev_loc: jnp.ndarray,
    prev_orient: jnp.ndarray,
    hl: jnp.ndarray,
    fov: float,
    image_size: tuple[int, int],
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Project anchor points into the previous camera → (iuv, duv, inside).

    iuv i32[...,2]: integer corner pixel of the 2×2 tap window; duv f32[...,2]
    the bilinear fraction; inside the NDC on-screen mask
    (reference: common.glsl:663-677).
    """
    H, W = image_size
    asp = W / H

    # Previous camera basis (common.glsl:663-665).
    lf = gmath.rotate_xy(jnp.asarray([0.0, 0.0, 1.0], hl.dtype), prev_orient)
    r = gmath.normalize(jnp.cross(lf, jnp.asarray([0.0, 1.0, 0.0], hl.dtype)))
    u = gmath.normalize(jnp.cross(lf, r))

    # Direction from hit point to the previous camera (common.glsl:667).
    nhl = gmath.normalize(prev_loc - hl)
    denom = gmath.dot(nhl, lf)
    denom = jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
    luv = jnp.stack([gmath.dot(nhl, r), gmath.dot(nhl, u)], axis=-1)
    luv = luv / denom[..., None] * fov / jnp.asarray([asp, 1.0], hl.dtype)

    inside = jnp.all((luv <= 1.0) & (luv >= -1.0), axis=-1)  # common.glsl:673

    # NDC → pixel coords minus the half-pixel center offset (common.glsl:677).
    fuv = (luv * -0.5 + 0.5) * jnp.asarray([W, H], hl.dtype) - 0.5
    iuv = jnp.trunc(fuv).astype(jnp.int32)
    duv = fuv - iuv
    return iuv, duv, inside


def reproject(
    prev_loc: jnp.ndarray,     # f32[3] previous camera position (ll)
    prev_orient: jnp.ndarray,  # f32[2] previous camera orientation (lo)
    hl: jnp.ndarray,           # f32[H,W,3] reprojection anchor points
    ho: jnp.ndarray,           # i32[H,W] current object IDs
    prev_rgb: jnp.ndarray,     # f32[H,W,3]
    prev_cnt: jnp.ndarray,     # f32[H,W]
    prev_id: jnp.ndarray,      # i32[H,W]
    fov: float = gmath.FOV,
    image_size: tuple[int, int] | None = None,
    buffer_row0: jnp.ndarray | int = 0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """→ (rgb[...,3], cnt[...]) accumulated history carried to this frame.

    Query points (hl, ho) may cover only a row window of the image (sharded
    tiles); `image_size` (H, W) fixes the NDC→pixel mapping (defaults to the
    buffer shape). The history buffers themselves may also be only a row
    window (a tile plus halo rows, parallel/shard.py): `buffer_row0` is the
    global image row of buffer row 0, and taps falling outside the buffer
    window contribute zero weight — the history simply restarts there, the
    same way an off-screen tap does (common.glsl:673-674).
    """
    if image_size is not None:
        H, W = image_size
    else:
        H, W = prev_cnt.shape
    window = prev_cnt.shape[0]

    iuv, duv, inside = reproject_query(prev_loc, prev_orient, hl, fov, (H, W))

    def tap(dx, dy):
        x = jnp.clip(iuv[..., 0] + dx, 0, W - 1)
        yg = iuv[..., 1] + dy  # global image row
        inb = (
            (iuv[..., 0] + dx >= 0) & (iuv[..., 0] + dx < W)
            & (yg >= 0) & (yg < H)
        )
        # Buffer-local row; taps outside the buffer window are zero-weighted.
        yl = yg - buffer_row0
        inb = inb & (yl >= 0) & (yl < window)
        y = jnp.clip(yl, 0, window - 1)
        match = (prev_id[y, x] == ho) & inb & inside
        m = match.astype(hl.dtype)
        return prev_rgb[y, x] * m[..., None], prev_cnt[y, x] * m

    rgb00, c00 = tap(0, 0)
    rgb10, c10 = tap(1, 0)
    rgb01, c01 = tap(0, 1)
    rgb11, c11 = tap(1, 1)

    dx = duv[..., 0]
    dy = duv[..., 1]
    rgb = gmath.mix(
        gmath.mix(rgb00, rgb10, dx[..., None]),
        gmath.mix(rgb01, rgb11, dx[..., None]),
        dy[..., None],
    )
    cnt = gmath.mix(gmath.mix(c00, c10, dx), gmath.mix(c01, c11, dx), dy)
    return rgb, cnt
