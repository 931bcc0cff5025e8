"""Render configuration.

Maps 1:1 onto the reference's compile-time quality knobs
(reference: common.glsl:1-29) plus execution options. Static (hashable) so
a config instance can be a `jax.jit` static argument.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image.
    width: int = 1280          # reference window size (main.cpp:302)
    height: int = 720
    # Quality knobs (reference: common.glsl:1-29).
    biased: bool = True        # BIASED: MIS estimators vs unbiased ground truth
    bounces: int = 1           # BOUNCES (unused by the reference's estimators)
    steps: int = 255           # STEPS: max sphere-trace iterations
    temporal: int = 16         # TEMPORALSMOOTHING: history frames
    smp_direct_lambert: int = 1
    smp_lambert_surface_lambert: int = 1
    smp_lambert_surface_phong: int = 1
    smp_direct_phong: int = 1
    smp_phong_surface_lambert: int = 1
    smp_phong_surface_phong: int = 1
    smp_unbias: int = 4        # SMP_UNBIAS (unused by the reference)
    # BIAS_WEIGHT — dead in the reference too: it is applied only inside
    # `#ifndef BIASED` blocks that are compiled out (BIASED is defined,
    # common.glsl:3-4) and diffuse.frag:27-31,69-72 never reaches it.
    # Declared for knob parity; no code path reads it.
    bias_weight: float = 1.0
    # Hash the per-sample streams (core/sampler.fold_seed) instead of the
    # reference's `seed + i` when SMP_* > 1. Off by default — and measured
    # WORSE when on: `seed + i` strides the Weyl lattice (QMC-style
    # stratification, ~2.4x lower multi-sample MSE than independent hashed
    # streams; see fold_seed). Kept for variance analysis.
    decorrelate_samples: bool = False
    # Wavefront multi-bounce integrator (BASELINE config #3; the reference
    # defines BOUNCES but never loops, common.glsl:6).
    max_depth: int = 6         # path length for render.wavefront
    spp: int = 1               # samples/pixel/frame for render.wavefront
    gloss: float = 5.0         # Phong exponent (common.glsl:536 et al.)
    brightness: float = 10.0   # exposure (passthrough.frag:27)
    # Intersection strategy:
    #   "march"    — sphere tracing, reference-faithful (common.glsl:283-295)
    #   "analytic" — closed-form ray/plane + ray/sphere, bounded march for
    #                rounded boxes; exact and far cheaper than 255 serial
    #                march steps.
    intersect_mode: str = "analytic"
    # Normal/curvature estimator:
    #   "auto"     — analytic with the analytic intersector, tetrahedron with
    #                the march (bit-parity with the reference oracle)
    #   "analytic" — closed-form per-primitive normal + curvature
    #   "tetra"    — 4+1-point tetrahedron norcurv (common.glsl:276-281)
    normal_mode: str = "auto"
    # Frame pipeline:
    #   "pass"  — geometry → shade → composite as separate (XLA-fused) passes;
    #             the reference path
    #   "fused" — one fused frame forward for raygen+intersect+normals+shade
    #             (ops/frame_kernel.py; the Triton kernel on the GPU, see
    #             ops/platform.py) + XLA reprojection/composite;
    #             differentiable through its custom VJP (ops/frame_grad.py)
    pipeline: str = "pass"
    # Single-frame fast path: treat the previous history as empty and skip
    # the reprojection gather + temporal clamp entirely. Numerically
    # identical to rendering against a fresh zero history (the gather of an
    # all-zero buffer returns zeros), but saves its full cost — dominant in
    # the differentiable single-frame render (diff/inverse.py).
    no_history: bool = False
    # Soft visibility (diff/softvis.py): beta > 0 replaces the hard NEE
    # sphere-occlusion test with a smooth transmittance so silhouette
    # gradients exist (biased estimator; inverse rendering only).
    soft_shadows: float = 0.0
    # Camera (reference: common.glsl:33 FOV; main.cpp:302 window).
    fov: float = 1.5
    # Execution.
    dtype: str = "float32"

    @property
    def resolution(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def aspect(self) -> float:
        return self.width / self.height
