"""Differentiable fused frame: a custom VJP around the fused forward.

* forward: the platform's fused frame (ops/platform.py): the Triton kernel
  on the GPU, `frame_forward_jnp` under XLA on the CPU. Residuals saved =
  (scene, camera, frame, row_base) — a few KB of parameter tables, no
  per-pixel activations.
* backward: XLA's `jax.vjp` of the same per-pixel math
  (`frame_kernel.frame_block`), recomputed from the scene tables over row
  chunks of the image or tile and summed over the chunks. Chunking bounds
  the memory the transposed program holds live; the sum runs in a fixed
  order, so the gradients are deterministic.

Output planes the loss never touches arrive as symbolic zeros and are
dropped before the vjp, so their whole backward chain is pruned (e.g. the
primary-intersect and curvature backward in an image-only loss).

Gradient semantics match the XLA pass pipeline: analytic-intersection
derivatives (the closed forms differentiate to the same values
scene/sdf.ift_backward produces), hard-visibility masks contribute zero,
and `config.soft_shadows > 0` smooths direct-light sphere silhouettes
exactly like render/mis.dual_mis (reference visibility:
common.glsl:348-353).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from kylespathtracer.ops import frame_kernel as fk
from kylespathtracer.ops import platform
from kylespathtracer.scene.types import Scene
from kylespathtracer.utils.config import RenderConfig

# Indices into the 20 small operands (frame_kernel.small_operands order)
# that receive gradients: planes, spheres, boxes, light_color, light,
# mat_s0, mat_s1, alb_const, alb_scale, emission, en_const, en_scale,
# cam, orient. (ids/freq/frame are integer or piecewise-constant.)
DIFF_IDX = (0, 2, 4, 6, 7, 9, 10, 12, 13, 14, 15, 16, 17, 18)

# The 13 float output planes, in frame_block order: (dict key, channel).
PLANES = (
    ("add_d", 0), ("add_d", 1), ("add_d", 2),
    ("add_s", 0), ("add_s", 1), ("add_s", 2),
    ("alb", 0), ("alb", 1), ("alb", 2),
    ("ene", 0), ("ene", 1), ("depth", None), ("curv", None),
)

# Pixels per backward chunk: the transposed program keeps the forward's
# per-pixel residuals of one chunk live at a time.
CHUNK_PIXELS = 1 << 19


def _f0(x):
    """float0 cotangent for an integer-dtype primal (JAX convention)."""
    return np.zeros(np.shape(x), jax.dtypes.float0)


def chunk_rows(rows: int, width: int, budget: int | None = None) -> int:
    """The largest divisor of `rows` whose chunk holds at most `budget`
    (default CHUNK_PIXELS) pixels; at least one row."""
    budget = CHUNK_PIXELS if budget is None else budget
    fits = [d for d in range(1, rows + 1) if rows % d == 0 and d * width <= budget]
    return max(fits, default=1)


def frame_backward(
    scene: Scene,
    camera,
    frame,
    g: dict,
    config: RenderConfig,
    row_base=0,
    rows: int | None = None,
    chunk: int | None = None,
):
    """Gradients of the fused frame, in DIFF_IDX order, by XLA's `jax.vjp`
    of `frame_block` recomputed over row chunks.

    `g` maps plane names to cotangents; a missing or None entry is a plane
    the loss never touched and is pruned. `row_base`/`rows` select the
    per-device row tile of the sharded trainer (parallel/shard.py); tile
    gradients are partial sums over the tile's pixels."""
    H, W = (rows if rows is not None else config.height), config.width
    chunk = chunk_rows(H, W) if chunk is None else chunk
    if H % chunk:
        raise ValueError(f"chunk {chunk} must divide the {H} rows")
    n = H // chunk

    ops = fk.small_operands(scene, camera, frame)
    sc_vals = list(ops)
    present = tuple(g.get(k) is not None for k, _ in PLANES)
    g_planes = [
        (g[k] if c is None else g[k][..., c]).reshape(n, chunk, W)
        for (k, c), p in zip(PLANES, present) if p
    ]
    kw = dict(
        counts=fk._counts(scene), nK=int(scene.materials.s0.shape[0]),
        gloss=config.gloss, width=W, height=config.height, fov=config.fov,
        block_rows=chunk, soft_beta=float(config.soft_shadows),
        smp=fk.smp_of(config), decorrelate=bool(config.decorrelate_samples),
        biased=bool(config.biased),
    )
    base = jnp.asarray(row_base, jnp.int32)

    def chunk_grads(args):
        r0, cot = args

        def f(diff_vals):
            v = list(sc_vals)
            for k, dv in zip(DIFF_IDX, diff_vals):
                v[k] = dv
            outs = fk.frame_block(
                dict(zip(fk.SC_KEYS, v[:17])), v[17], v[18], v[19][0, 0],
                base + r0, **kw,
            )
            return tuple(o for o, p in zip(outs[:13], present) if p)

        _, vjp = jax.vjp(f, tuple(sc_vals[k] for k in DIFF_IDX))
        return vjp(tuple(cot))[0]

    if n == 1:
        return chunk_grads((jnp.int32(0), [c[0] for c in g_planes]))
    per_chunk = jax.lax.map(
        chunk_grads, (jnp.arange(n, dtype=jnp.int32) * chunk, g_planes)
    )
    return tuple(jnp.sum(x, axis=0) for x in per_chunk)


def assemble_grads(scene, camera, grads, light_index: int):
    """DIFF_IDX-ordered gradient tables → (d_scene, d_camera) pytrees."""
    (d_planes, d_spheres, d_boxes, d_lc, d_light, d_s0, d_s1,
     d_ac, d_as, d_em, d_ec, d_es, d_cam, d_or) = grads
    # Crop gradients of dummy-padded zero-row tables (small_operands).
    d_planes = d_planes[: scene.planes.shape[0]]
    d_spheres = d_spheres[: scene.spheres.shape[0]]
    d_boxes = d_boxes[: scene.boxes.shape[0]]
    # scene.light is spheres[light_index]: fold its cotangent back.
    d_spheres = d_spheres.at[light_index].add(d_light.reshape(4))
    mats = scene.materials
    d_mats = mats.replace(
        s0=d_s0.reshape(-1), s1=d_s1.reshape(-1),
        freq=jnp.zeros_like(mats.freq),
        alb_const=d_ac, alb_scale=d_as, emission=d_em,
        en_const=d_ec, en_scale=d_es,
        bsdf=None if mats.bsdf is None else _f0(mats.bsdf),
        ior=None if mats.ior is None else jnp.zeros_like(mats.ior),
    )
    d_scene = scene.replace(
        planes=d_planes, plane_ids=_f0(scene.plane_ids),
        spheres=d_spheres, sphere_ids=_f0(scene.sphere_ids),
        boxes=d_boxes, box_ids=_f0(scene.box_ids),
        light_color=d_lc.reshape(3), materials=d_mats,
    )
    d_camera = camera.replace(loc=d_cam.reshape(3), orient=d_or.reshape(2))
    return d_scene, d_camera


def _forward(scene, camera, frame, config, row_base, rows, interpret):
    if interpret or platform.frame_forward_impl() == "triton":
        return fk.frame_forward_pallas(
            scene, camera, frame, config, interpret=interpret,
            row_base=row_base, rows=rows,
        )
    return fk.frame_forward_jnp(
        scene, camera, frame, config, row_base=row_base, rows=rows
    )


@functools.lru_cache(maxsize=64)
def _make_diff_fn(config: RenderConfig, light_index: int, interpret: bool,
                  rows: int | None = None):
    @jax.custom_vjp
    def fwd(scene, camera, frame, row_base):
        return _forward(scene, camera, frame, config, row_base, rows, interpret)

    def fwd_fwd(scene, camera, frame, row_base):
        # symbolic_zeros=True wraps every input leaf in CustomVJPPrimal.
        unwrap = lambda t: jax.tree_util.tree_map(lambda p: p.value, t)
        scene, camera, frame, row_base = (
            unwrap(scene), unwrap(camera), unwrap(frame), unwrap(row_base)
        )
        return (
            fwd(scene, camera, frame, row_base),
            (scene, camera, frame, row_base),
        )

    def fwd_bwd(res, g):
        from jax.custom_derivatives import SymbolicZero

        scene, camera, frame, row_base = res
        g = {
            k: (None if isinstance(v, SymbolicZero) else v)
            for k, v in g.items()
        }
        grads = frame_backward(
            scene, camera, frame, g, config, row_base=row_base, rows=rows
        )
        d_scene, d_camera = assemble_grads(scene, camera, grads, light_index)
        return d_scene, d_camera, _f0(frame), _f0(row_base)

    fwd.defvjp(fwd_fwd, fwd_bwd, symbolic_zeros=True)
    return fwd


def frame_forward(
    scene: Scene,
    camera,
    frame,
    config: RenderConfig,
    interpret: bool = False,
    row_base=0,
    rows: int | None = None,
):
    """Differentiable fused forward: the platform's fused frame with the
    recompute backward above. `interpret=True` (tests only) runs the Triton
    kernel in Pallas's interpreter on any platform. `row_base`/`rows`
    select the per-device row tile of the sharded trainer
    (parallel/shard.py); row_base may be traced (axis_index·rows), rows is
    static. Tile gradients are partial sums over the tile's pixels.
    """
    fn = _make_diff_fn(
        config, int(scene.light_index), bool(interpret), rows
    )
    return fn(scene, camera, frame, jnp.asarray(row_base, jnp.int32))
