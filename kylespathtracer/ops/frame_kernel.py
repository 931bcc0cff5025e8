"""Fused full-frame forward kernel.

One Pallas program computes, per pixel block, everything the reference's
three heavy fragment passes compute per pixel (geometry.frag +
diffuse.frag + specular.frag, minus the history gathers):

    raygen → primary intersect → analytic normal/curvature →
    dual-MIS shade (direct light + 4 plane roulettes, ~9 traces) →
    emission + primary material (albedo/energy)

Device-memory traffic is the tiny scene tables in and 14 image planes out —
no G-buffer round trip, no seed image, no ray-dir image; every
intermediate stays in registers, one pixel per thread like the reference's
fragment shader. Temporal reprojection (a 2×2 history gather,
common.glsl:661-694) and the composite stay in XLA, where a gather is a
native load.

The kernel goes through Pallas's Triton route (`backend="triton"`).
`frame_forward_jnp` is the same per-pixel math (`frame_block`) as plain
jnp under XLA: the CPU implementation, the test oracle, and the function
the backward differentiates (ops/frame_grad.py).

All math is the component-plane style of ops/shade_kernel.py (which
provides the shade core); normals/curvature are the closed forms of
scene/normals.py. The full quality config runs in-kernel: smp_* loops,
BIASED on (dual-MIS) or off (the unbiased ground-truth estimators,
common.glsl:394-415).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from kylespathtracer.core import gmath
from kylespathtracer.ops import shade_kernel as sk
from kylespathtracer.scene.types import Scene
from kylespathtracer.utils.config import RenderConfig

# Pixel block of one Triton program and its warp count.
BLOCK = (1, 256)
NUM_WARPS = 4


def _normal_curv(sc, counts, hl, ho):
    """Component-plane analytic normal + curvature (scene/normals.py)."""
    nP, nS, nB = counts
    zero = jnp.zeros_like(hl[0])
    n = [zero, zero, zero]
    c = zero

    for i in range(nP):
        sel = ho == sc["plane_ids"][i, 0]
        for k in range(3):
            n[k] = jnp.where(sel, sc["planes"][i, k], n[k])

    for i in range(nS):
        sel = ho == sc["sphere_ids"][i, 0]
        d = (
            hl[0] - sc["spheres"][i, 0],
            hl[1] - sc["spheres"][i, 1],
            hl[2] - sc["spheres"][i, 2],
        )
        inv = jax.lax.rsqrt(jnp.maximum(sk._dot(d, d), 1e-12))
        for k in range(3):
            n[k] = jnp.where(sel, d[k] * inv, n[k])
        c = jnp.where(sel, gmath.EPS * inv, c)

    for i in range(nB):
        sel = ho == sc["box_ids"][i, 0]
        q = (
            hl[0] - sc["boxes"][i, 0],
            hl[1] - sc["boxes"][i, 1],
            hl[2] - sc["boxes"][i, 2],
        )
        d = tuple(jnp.abs(q[k]) - sc["boxes"][i, 3 + k] for k in range(3))
        m = tuple(jnp.maximum(d[k], 0.0) for k in range(3))
        inv = jax.lax.rsqrt(jnp.maximum(sk._dot(m, m), 1e-12))
        kpos = sum((d[k] > 0.0).astype(hl[0].dtype) for k in range(3))
        for k in range(3):
            n[k] = jnp.where(sel, m[k] * jnp.sign(q[k]) * inv, n[k])
        c = jnp.where(sel, 0.5 * gmath.EPS * jnp.maximum(kpos - 1.0, 0.0) * inv, c)

    return tuple(n), c


# Ordered names of the kernel's 20 small operands; the first block builds
# the `sc` dict, the last three are camera loc / orient / frame index.
SC_KEYS = (
    "planes", "plane_ids", "spheres", "sphere_ids", "boxes", "box_ids",
    "light_color", "light", "light_id_arr", "mat_s0", "mat_s1", "mat_freq",
    "mat_alb_const", "mat_alb_scale", "mat_emission", "mat_en_const",
    "mat_en_scale",
)


def smp_of(config: RenderConfig) -> int:
    """The fused kernel's per-strategy sample count from the six SMP_*
    knobs (common.glsl:13-24). The kernel shares every cone draw across
    strategies (like mis.dual_mis), which requires the six counts equal;
    any other combination must use pipeline="pass"."""
    smp = config.smp_direct_lambert
    if not (
        smp == config.smp_lambert_surface_lambert
        == config.smp_lambert_surface_phong == config.smp_direct_phong
        == config.smp_phong_surface_lambert == config.smp_phong_surface_phong
    ) or smp < 1:
        raise ValueError(
            "the fused pipeline requires all six smp_* counts equal and >=1 "
            f"(got {smp}, {config.smp_lambert_surface_lambert}, "
            f"{config.smp_lambert_surface_phong}, {config.smp_direct_phong}, "
            f"{config.smp_phong_surface_lambert}, "
            f"{config.smp_phong_surface_phong}); use pipeline='pass' for "
            "per-strategy counts"
        )
    return int(smp)


def _fold_seed(seed, i: int, decorrelate: bool):
    """Per-sample stream in component form (core/sampler.fold_seed):
    `seed + i` Weyl-lattice stride by default, PCG-hashed (seed, i) when
    decorrelating."""
    if not decorrelate or i == 0:
        return seed + jnp.int32(i)
    mixed = seed.astype(jnp.uint32) ^ jnp.uint32((i * 0x9E3779B9) & 0xFFFFFFFF)
    state = mixed * jnp.uint32(747796405) + jnp.uint32(2891336453)
    shift = (state >> jnp.uint32(28)) + jnp.uint32(4)
    word = ((state >> shift) ^ state) * jnp.uint32(277803737)
    return ((word >> jnp.uint32(22)) ^ word).astype(jnp.int32)


def _raygen(shape, cam, orient, width, height, fov, row0, col0=0):
    """Pixel grid + primary rays for a block (geometry.frag:38-39,67):
    aspect-scaled NDC → normalize → pitch/yaw rotation. Returns
    (px, py, ro, rd) component planes."""
    px = jax.lax.broadcasted_iota(jnp.int32, shape, 1) + col0
    py = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + row0
    asp = float(width) / float(height)
    xf = (2.0 * (px.astype(jnp.float32) + 0.5) / float(width) - 1.0) * asp
    yf = 2.0 * (py.astype(jnp.float32) + 0.5) / float(height) - 1.0
    zf = jnp.full(shape, float(fov), jnp.float32)
    inv = jax.lax.rsqrt(xf * xf + yf * yf + zf * zf)
    dx, dy, dz = xf * inv, yf * inv, zf * inv
    cx = jnp.cos(orient[0, 0])
    sx = jnp.sin(orient[0, 0])
    cy = jnp.cos(orient[0, 1])
    sy = jnp.sin(orient[0, 1])
    y2 = dy * cx + dz * sx
    z1 = -dy * sx + dz * cx
    rd = (dx * cy + z1 * sy, y2, -dx * sy + z1 * cy)
    ro = (
        jnp.full(shape, 0.0, jnp.float32) + cam[0, 0],
        jnp.full(shape, 0.0, jnp.float32) + cam[0, 1],
        jnp.full(shape, 0.0, jnp.float32) + cam[0, 2],
    )
    return px, py, ro, rd


def frame_block(
    sc, cam, orient, frame, row0,
    *, counts, nK, gloss, width, height, fov, block_rows, soft_beta=0.0,
    block_cols=None, col0=0, smp=1, decorrelate=False, biased=True,
):
    """The fused frame's per-block math as a pure function of VALUES.

    sc: dict of SC_KEYS → arrays (kernel operand shapes); cam f32[1,3];
    orient f32[1,2]; frame i32 scalar; row0/col0 i32 scalars (first image
    row/col of the block). Returns the 14 planes, 13 f32 + oid i32, each
    (block_rows, block_cols or width).

    Shared three ways: the Triton kernel wraps it over refs (one pixel
    block per program); `frame_forward_jnp` runs it over the whole image
    under XLA; the backward (ops/frame_grad.py) `jax.vjp`s it per row
    chunk.
    """
    sc = dict(sc)
    sc["nK"] = nK
    shape = (block_rows, width if block_cols is None else block_cols)

    # Pixel grid of this block. Row 0 is the image bottom (GL fragCoord).
    px, py, ro, rd = _raygen(shape, cam, orient, width, height, fov, row0, col0)

    # Per-pixel Weyl seed (common.glsl:39-41), all int32 wraparound.
    seed = (
        ((frame << 12) + px + (py << 1))
        ^ (px * jnp.int32(height))
        ^ (py * jnp.int32(width))
    )

    # Primary intersect (geometry.frag:67-68) + analytic normal/curvature.
    no_excl = jnp.full(shape, -1, jnp.int32)
    t, oid = sk._trace(sc, ro, rd, no_excl, *counts)
    hit = oid > 0
    hl_n = (ro[0] + rd[0] * t, ro[1] + rd[1] * t, ro[2] + rd[2] * t)
    hn, curv = _normal_curv(sc, counts, hl_n, oid)
    hn = sk._where_v(hit, hn, (jnp.zeros_like(t),) * 3)

    # Shading point: one more eps back along the ray (geometry.frag:71
    # stores t-eps; the accumulation passes shade at that depth).
    depth = t - gmath.EPS
    hl = (ro[0] + rd[0] * depth, ro[1] + rd[1] * depth, ro[2] + rd[2] * depth)

    if biased:
        # Dual-MIS estimators (common.glsl:430-616), averaged over the smp
        # per-strategy samples exactly like mis.dual_mis: per-sample streams
        # via _fold_seed, statically unrolled so each iteration's
        # intermediates die before the next.
        est_d = [jnp.zeros(shape, jnp.float32) for _ in range(3)]
        est_s = [jnp.zeros(shape, jnp.float32) for _ in range(3)]
        for i in range(smp):
            ed, es = sk._shade_core(
                sc, counts, nK, gloss, hn, rd, oid, hl,
                _fold_seed(seed, i, decorrelate), soft_beta=soft_beta,
            )
            for c in range(3):
                est_d[c] = est_d[c] + ed[c]
                est_s[c] = est_s[c] + es[c]
        if smp > 1:
            inv_smp = 1.0 / float(smp)
            est_d = [e * inv_smp for e in est_d]
            est_s = [e * inv_smp for e in est_s]
    else:
        # Unbiased ground-truth mode (BIASED off, common.glsl:394-415).
        est_d, est_s = sk._shade_core_unbiased(
            sc, counts, gloss, hn, rd, oid, hl, seed, smp, decorrelate
        )

    # Emission + primary material for reprojection add / composite
    # (diffuse.frag:54-56; passthrough.frag:39-41).
    alb, emi, ene = sk._surface(sc, oid, hl, nK)
    shade = (oid != sc["light_id_arr"][0, 0]) & hit

    return (
        emi[0] + jnp.where(shade, est_d[0], 0.0),
        emi[1] + jnp.where(shade, est_d[1], 0.0),
        emi[2] + jnp.where(shade, est_d[2], 0.0),
        emi[0] + jnp.where(shade, est_s[0], 0.0),
        emi[1] + jnp.where(shade, est_s[1], 0.0),
        emi[2] + jnp.where(shade, est_s[2], 0.0),
        alb[0], alb[1], alb[2], ene[0], ene[1], depth, curv, oid,
    )


def _frame_kernel(
    *refs,
    counts, nK, gloss, width, height, fov, block_rows, block_cols, soft_beta,
    smp, decorrelate, biased,
):
    in_refs, out_refs = refs[:21], refs[21:]
    # The scene tables stay refs: frame_block reads each entry as a scalar
    # load (planes_ref[i, k]) with static indices, so no table is ever
    # materialized as a block tensor.
    sc = dict(zip(SC_KEYS, in_refs[:17]))
    cam_ref, orient_ref, frame_ref, row0_ref = in_refs[17:]
    outs = frame_block(
        sc, cam_ref, orient_ref, frame_ref[0, 0],
        row0_ref[0, 0] + pl.program_id(0) * block_rows,
        counts=counts, nK=nK, gloss=gloss, width=width, height=height,
        fov=fov, block_rows=block_rows, soft_beta=soft_beta, smp=smp,
        decorrelate=decorrelate, biased=biased,
        block_cols=block_cols, col0=pl.program_id(1) * block_cols,
    )
    for ref, val in zip(out_refs, outs):
        ref[:] = val


def small_operands(scene: Scene, camera, frame):
    """The 20 small kernel operands (SC_KEYS order + cam, orient, frame).

    Zero-row geometry tables (a scene with no boxes/planes) are padded to
    one dummy row — a kernel operand cannot be 0-sized, and the static
    counts mean the kernel never reads them. ops/frame_grad crops the
    matching gradients back."""
    mats = scene.materials

    def pad1(a):
        if a.shape[0]:
            return a
        return jnp.zeros((1,) + a.shape[1:], a.dtype)

    col = lambda a: pad1(a.reshape(-1, 1))
    row = lambda a: a.reshape(1, -1)
    light_id = scene.sphere_ids[scene.light_index].reshape(1, 1)
    return (
        pad1(scene.planes), col(scene.plane_ids), pad1(scene.spheres),
        col(scene.sphere_ids), pad1(scene.boxes), col(scene.box_ids),
        row(scene.light_color), row(scene.light), light_id,
        col(mats.s0), col(mats.s1), col(mats.freq), mats.alb_const,
        mats.alb_scale, mats.emission, mats.en_const, mats.en_scale,
        row(camera.loc), row(camera.orient),
        jnp.asarray(frame, jnp.int32).reshape(1, 1),
    )


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _counts(scene: Scene):
    return (
        int(scene.planes.shape[0]),
        int(scene.spheres.shape[0]),
        int(scene.boxes.shape[0]),
    )


def frame_forward_pallas(
    scene: Scene,
    camera,
    frame: jnp.ndarray,
    config: RenderConfig,
    block: tuple[int, int] = BLOCK,
    interpret: bool = False,
    row_base=0,
    rows: int | None = None,
):
    """Run the fused forward kernel (Pallas, Triton route) → dict of planes.

    Returns {"add_d","add_s","alb": f32[H,W,3]; "ene": f32[H,W,2];
    "depth","curv": f32[H,W]; "oid": i32[H,W]}.

    `block` is the (rows, cols) pixel block of one program; Triton wants
    both powers of two. The image is padded up to whole blocks and the
    planes are cropped back here, so any width and height work.

    `row_base`/`rows` restrict the render to image rows
    [row_base, row_base+rows) — the per-device tile of the sharded renderer
    (parallel/shard.py). The NDC mapping, seeds, and ray grid stay those of
    the FULL config.height image, so the tiles are bitwise the matching
    rows of the unsharded frame. `row_base` may be traced.
    """
    br, bc = block
    if not (_is_pow2(br) and _is_pow2(bc)):
        raise ValueError(f"block {block} must be powers of two")
    H, W = (rows if rows is not None else config.height), config.width
    Hp = -(-H // br) * br
    Wp = -(-W // bc) * bc

    kernel = functools.partial(
        _frame_kernel,
        counts=_counts(scene),
        nK=int(scene.materials.s0.shape[0]),
        gloss=config.gloss,
        width=W,
        height=config.height,  # full-image NDC/seed mapping, even for tiles
        fov=config.fov,
        block_rows=br,
        block_cols=bc,
        soft_beta=float(config.soft_shadows),
        smp=smp_of(config),
        decorrelate=bool(config.decorrelate_samples),
        biased=bool(config.biased),
    )
    operands = small_operands(scene, camera, frame) + (
        jnp.asarray(row_base, jnp.int32).reshape(1, 1),
    )
    whole = lambda a: pl.BlockSpec(a.shape, lambda i, j: (0,) * a.ndim)
    img = pl.BlockSpec((br, bc), lambda i, j: (i, j))
    f32 = jax.ShapeDtypeStruct((Hp, Wp), jnp.float32)
    i32 = jax.ShapeDtypeStruct((Hp, Wp), jnp.int32)

    outs = pl.pallas_call(
        kernel,
        grid=(Hp // br, Wp // bc),
        in_specs=[whole(a) for a in operands],
        out_specs=[img] * 14,
        out_shape=[f32] * 13 + [i32],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="frame_forward",
    )(*operands)
    return assemble_planes([o[:, :W] for o in outs], H)


def assemble_planes(outs, H):
    """14 (Hp, W) planes → the frame dict, rows cropped to H."""
    crop = lambda a: a[:H]
    return {
        "add_d": jnp.stack([crop(o) for o in outs[0:3]], axis=-1),
        "add_s": jnp.stack([crop(o) for o in outs[3:6]], axis=-1),
        "alb": jnp.stack([crop(o) for o in outs[6:9]], axis=-1),
        "ene": jnp.stack([crop(o) for o in outs[9:11]], axis=-1),
        "depth": crop(outs[11]),
        "curv": crop(outs[12]),
        "oid": crop(outs[13]),
    }


def frame_forward_jnp(scene: Scene, camera, frame, config: RenderConfig,
                      row_base=0, rows: int | None = None):
    """`frame_block` over the image (or the row tile [row_base,
    row_base+rows)) as plain jnp — the fused kernel's math without Pallas.
    The CPU implementation of the fused frame, the test oracle, and the
    baseline the kernel is timed against."""
    H = rows if rows is not None else config.height
    ops = small_operands(scene, camera, frame)
    outs = frame_block(
        dict(zip(SC_KEYS, ops[:17])), ops[17], ops[18], ops[19][0, 0],
        jnp.asarray(row_base, jnp.int32),
        counts=_counts(scene), nK=int(scene.materials.s0.shape[0]),
        gloss=config.gloss, width=config.width, height=config.height,
        fov=config.fov, block_rows=H, soft_beta=float(config.soft_shadows),
        smp=smp_of(config), decorrelate=bool(config.decorrelate_samples),
        biased=bool(config.biased),
    )
    return assemble_planes(outs, H)
