"""Low-discrepancy per-pixel RNG.

Bit-faithful port of the reference's integer-overflow Weyl sequence sampler
(reference: common.glsl:39-51, 165-196). All integer math is int32 with
two's-complement wraparound, exactly as GLSL `highp int` behaves, so the
sample streams match the reference (and the NumPy CPU twin) bit for bit.

Seeds are plain int32 arrays carried per pixel — the batched analog of the
per-fragment `genSeed` call. A `jax.random`-based PCG/R2 upgrade path lives in
`fold_seed` for decorrelating multi-sample loops without the reference's
`seed + i` stream reuse.
"""

from __future__ import annotations

import jax.numpy as jnp

from kylespathtracer.core import gmath

WEYL = (13743434, 11258243, 9222443)  # common.glsl:44
_EXP2_24 = 16777216.0


def gen_seed(frame: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray,
             res_x, res_y) -> jnp.ndarray:
    """Unique int32 per pixel/frame (reference: common.glsl:39-41).

    ((frame<<12) + x + (y<<1)) ^ x*res.y ^ y*res.x, all int32 wraparound.
    """
    frame = jnp.asarray(frame, jnp.int32)
    px = px.astype(jnp.int32)
    py = py.astype(jnp.int32)
    rx = jnp.asarray(res_x, jnp.int32)
    ry = jnp.asarray(res_y, jnp.int32)
    return ((frame << 12) + px + (py << 1)) ^ (px * ry) ^ (py * rx)


def weyl3(v: jnp.ndarray) -> jnp.ndarray:
    """3D Weyl/additive sequence: fract(float(v*k)/2^24) (common.glsl:43-45).

    v*k wraps in int32; the int→float32 conversion and fract are done in
    float32 to match GLSL.
    """
    v = v.astype(jnp.int32)[..., None]
    k = jnp.asarray(WEYL, jnp.int32)
    prod = (v * k).astype(jnp.float32) / jnp.float32(_EXP2_24)
    return prod - jnp.floor(prod)


def logit3(v: jnp.ndarray) -> jnp.ndarray:
    """Logit warp of (0,1)³ → approximately gaussian (common.glsl:48-51)."""
    t = 0.988 * (v + 0.006)
    return jnp.log(t / (1.0 - t)) * 0.221 + 0.5


def uniform_sphere(seed: jnp.ndarray) -> jnp.ndarray:
    """Gaussian-ish point in [-1,1]³ (common.glsl:165-168)."""
    return logit3(weyl3(seed)) * 2.0 - 1.0


def uniform_dir(seed: jnp.ndarray) -> jnp.ndarray:
    """Unit direction from the gaussian-ish sphere sample (common.glsl:171-173)."""
    return gmath.normalize_fast(uniform_sphere(seed))


def uniform_hemi_dir(hn: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Uniform hemisphere direction around hn (common.glsl:176-179)."""
    rnd = uniform_dir(seed)
    return rnd * jnp.sign(gmath.dot_k(hn, rnd))


def cos_hemi_dir(hn: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere direction (common.glsl:182-185)."""
    rnd = uniform_dir(seed)
    return gmath.normalize_fast(hn + rnd * gmath.IEPS)


def cone_pre(seed: jnp.ndarray):
    """Hoisted per-seed cone-sampling draws (sqrt(u1), cos/sin(2π·u2), u3).

    Every cone sample taken with the same seed draws the same weyl3 values
    (the reference re-evaluates them in each strategy, common.glsl:437,459,
    492…), so the transcendentals can be computed once and shared.
    """
    rnd = weyl3(seed)
    tha = rnd[..., 1] * gmath.TWOPI
    return (jnp.sqrt(rnd[..., 0]), jnp.cos(tha), jnp.sin(tha), rnd[..., 2])


def uniform_cone_dir(lv: jnp.ndarray, lr: jnp.ndarray, seed: jnp.ndarray = None,
                     pre=None) -> jnp.ndarray:
    """Uniform direction in the cone subtending a sphere of radius lr at lv.

    rad = sqrt(u1)*tan(linearAngle(|lv|, lr)), theta = u2*2pi, built on the
    branchless ONB (reference: common.glsl:188-196). Pass `pre` (from
    `cone_pre`) to reuse the draws across samples with the same seed.
    """
    if pre is None:
        pre = cone_pre(seed)
    su1, ct, st, _ = pre
    rad = su1 * gmath.tan_linear_angle(gmath.length(lv), lr)
    # Safe normalize: lv=0 (a sample toward the plane the shaded point lies
    # on — pdf-masked upstream) must yield a finite direction, not NaN.
    nlv = gmath.normalize(lv)
    r, u = gmath.basis(nlv)
    return gmath.normalize(
        nlv + rad[..., None] * (r * ct[..., None] + u * st[..., None])
    )


def fold_seed(seed: jnp.ndarray, i, decorrelate: bool = False) -> jnp.ndarray:
    """Derive the i-th sample stream from a pixel seed.

    The reference uses plain `seed + i` (common.glsl:437 etc.), kept as the
    default for parity — and measured to be the BETTER estimator: adjacent
    seeds stride the Weyl lattice, so the i samples form a short
    low-discrepancy progression (QMC-style stratification). PCG-hashing
    the (seed, i) pair (`decorrelate=True`, config.decorrelate_samples)
    yields independent plain-MC streams instead: at SMP_*=4 the hashed
    streams' frame MSE vs a 32-frame reference is 2.4x HIGHER (5.3e-4 vs
    2.2e-4 at 48x32; tests/test_core.py). The option remains for variance
    analysis; sample 0 is the identity in both modes.
    """
    if not decorrelate or (isinstance(i, int) and i == 0):
        return seed + jnp.asarray(i, jnp.int32)
    mixed = seed.astype(jnp.uint32) ^ (
        jnp.asarray(i, jnp.uint32) * jnp.uint32(0x9E3779B9)
    )
    return pcg_hash(mixed).astype(jnp.int32)


# ---------------------------------------------------------------------------
# PCG-hashed R2 low-discrepancy sampler — the upgrade path beyond the
# reference's Weyl sequence, used by the multi-bounce wavefront integrator
# (BASELINE config #3). The 2D R2 sequence (generalized golden ratio) gives
# near-optimal stratification per dimension pair; a per-(pixel, dim-pair)
# Cranley–Patterson rotation derived from a PCG hash decorrelates pixels and
# dimensions. All arithmetic is exact uint32 fixed point, so the sequence
# never loses stratification to float rounding at high sample counts.
# ---------------------------------------------------------------------------

# round(2^32 / phi2^k) for the plastic constant phi2 ≈ 1.3247179572:
# alpha = (1/phi2, 1/phi2^2) ≈ (0.75487767, 0.56984029).
_R2_A1 = 3242174889  # round(0.7548776662466927 * 2^32)
_R2_A2 = 2447445413  # round(0.5698402909980532 * 2^32)
_INV_2_32 = 2.3283064365386963e-10  # 2^-32


def pcg_hash(x: jnp.ndarray) -> jnp.ndarray:
    """PCG-RXS-M-XS output permutation over a 32-bit LCG state — the standard
    one-word PCG hash. uint32 → uint32, bijective, well-distributed."""
    x = x.astype(jnp.uint32)
    state = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    shift = (state >> jnp.uint32(28)) + jnp.uint32(4)
    word = ((state >> shift) ^ state) * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def r2_pair(n: jnp.ndarray, stream: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The n-th point of the 2D R2 sequence, PCG-rotated per stream.

    n:      uint32/int32[...] sample index (frame*spp + s).
    stream: uint32/int32[...] stream id — hash of (pixel, dimension-pair).
    Returns two float32 uniforms in [0, 1), stratified jointly in 2D within
    each stream and decorrelated across streams.
    """
    n = n.astype(jnp.uint32)
    rot1 = pcg_hash(stream)
    rot2 = pcg_hash(rot1 ^ jnp.uint32(0x9E3779B9))
    # Drop the low 8 bits before converting: a straight uint32→float32 cast
    # rounds to a 24-bit mantissa, so lattice values within ~128 of 2^32
    # round up to exactly 2^32 and u would hit 1.0, violating [0, 1).
    u1 = ((n * jnp.uint32(_R2_A1) + rot1) >> jnp.uint32(8)).astype(
        jnp.float32
    ) * jnp.float32(2**-24)
    u2 = ((n * jnp.uint32(_R2_A2) + rot2) >> jnp.uint32(8)).astype(
        jnp.float32
    ) * jnp.float32(2**-24)
    return u1, u2


def pixel_stream(px: jnp.ndarray, py: jnp.ndarray, width, pair: jnp.ndarray
                 ) -> jnp.ndarray:
    """Stream id for (pixel, dimension-pair): hash-mix of the linear pixel
    index and the pair index. pair may be a traced scalar (bounce-dependent
    dims inside lax.scan are fine)."""
    pid = (py.astype(jnp.uint32) * jnp.uint32(width) + px.astype(jnp.uint32))
    return pid * jnp.uint32(0x85EBCA6B) + jnp.asarray(pair, jnp.uint32)
