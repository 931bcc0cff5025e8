"""Benchmark: forward primary-ray throughput on the GPU.

    python bench.py

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"device"}. Baseline: the reference's implied ~55 Mrays/s primary throughput
at 1280x720@60fps on a desktop GPU (BASELINE.md; main.cpp:302,355).

Every headline number is **device-resident**: K frames chained inside ONE
jitted `lax.scan` (the loop carry serializes the frames; outputs fold into
a scalar so nothing is fetched mid-loop), each run ended by
`block_until_ready`, timed at three K values; the per-frame time is the
least-squares SLOPE of time against K, so dispatch and sync overhead cancel.
`linear_ok` in the detail line means the two sub-slopes agree within 20%.
The single-dispatch blocked figure is recorded beside it as a sanity bound.

Supplementary metrics on stderr (JSON lines; all lines also go to
bench_out/bench.jsonl, which .gitignore lists):
  * fwd:       fused-pipeline temporal frame time / rays/s at 1080p
  * fwd+bwd:   value_and_grad of a pixel loss through the fused frame's
               custom VJP at 1spp 1080p (the BASELINE.json metric)
  * raycast:   the XLA geometry pass alone (primary visibility + normals)
  * wavefront: multi-bounce integrator path-segments/s

Every line names the device (platform, device_kind, count, and the card's
name and power limit from nvidia-smi). Without a GPU the script fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from kylespathtracer import (
    Camera,
    RenderConfig,
    default_scene,
    init_history,
    render_frame,
)
from kylespathtracer.utils.compile_cache import enable_compile_cache
from kylespathtracer.utils.device import nvidia_smi, require_gpu

BASELINE_RAYS_PER_S = 55.3e6  # 1280*720*60


_FULL_LOG = None  # opened in main(); bench_* helpers still work standalone
_DEVICE: dict = {}  # filled in main()
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_out")


def stderr_json(**kw):
    """One metric line, with the device, → stderr AND bench_out/bench.jsonl."""
    line = json.dumps({**kw, "device": _DEVICE})
    print(line, file=sys.stderr, flush=True)
    if _FULL_LOG is not None:
        _FULL_LOG.write(line + "\n")
        _FULL_LOG.flush()


def _timed_scan(make_scan, ks, tag: str, reps: int = 3,
                blocked_ms: float | None = None):
    """Device-resident per-frame time via the multi-K slope method.

    `make_scan(K)` returns a zero-argument callable that runs K chained
    frames on-device and returns a scalar. The per-frame time is the
    least-squares slope of total time vs K; per-dispatch overhead is the
    intercept and cancels out of the slope.
    `ks` must be ≥3 ascending ints; the detail line records the sub-slopes
    between consecutive K pairs and whether they agree within 20%.
    """
    fns = [make_scan(k) for k in ks]
    compile_s = 0.0
    times = []
    for fn in fns:
        t0 = time.perf_counter()
        jax.block_until_ready(fn())  # compile + warm
        compile_s += time.perf_counter() - t0
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            best = min(best, time.perf_counter() - t0)
        times.append(best)

    # Least-squares slope of best-time vs K.
    n = len(ks)
    mk = sum(ks) / n
    mt = sum(times) / n
    slope = sum((k - mk) * (t - mt) for k, t in zip(ks, times)) / sum(
        (k - mk) ** 2 for k in ks
    )
    sub = [
        (times[i + 1] - times[i]) / (ks[i + 1] - ks[i]) for i in range(n - 1)
    ]
    lo, hi = min(sub), max(sub)
    linear_ok = hi <= lo * 1.2 + 1e-4
    detail = dict(
        metric=f"{tag}_timing_detail",
        method="scan-slope",
        ks=list(ks),
        totals_ms=[round(t * 1e3, 2) for t in times],
        sub_slopes_ms=[round(s * 1e3, 3) for s in sub],
        slope_ms=round(slope * 1e3, 3),
        linear_ok=bool(linear_ok),
        compile_s=round(compile_s, 1),
        reps=reps,
    )
    if blocked_ms is not None:
        detail["blocked_single_dispatch_ms"] = round(blocked_ms, 2)
        detail["scan_within_blocked"] = bool(slope * 1e3 <= blocked_ms * 1.2)
    stderr_json(**detail)
    return max(slope, 1e-9)


def _blocked_once(step, iters: int) -> float:
    """Single-dispatch blocked timing in ms (sanity upper bound)."""
    t0 = time.perf_counter()
    for i in range(iters):
        jax.block_until_ready(step(i))
    return (time.perf_counter() - t0) / iters * 1e3


def bench_forward(scene, camera, width=1920, height=1080, iters=8):
    """Fused-pipeline forward frames (history carried through the scan, so
    every frame pays the real reprojection + temporal accumulation cost)."""
    config = RenderConfig(width=width, height=height, pipeline="fused")
    history = init_history(config, camera)

    def make_scan(K):
        def body(carry, i):
            hist, acc = carry
            # Slow pan (~0.3 px/frame at 1080p): keeps the temporal
            # reprojection honestly exercised.
            cam = camera.replace(
                orient=camera.orient
                + jnp.asarray([0.0, 1e-3], jnp.float32) * i.astype(jnp.float32)
            )
            img, hist = render_frame(scene, cam, hist, i, config)
            return (hist, acc + img[0, 0, 0]), None

        @jax.jit
        def run(history):
            (h, acc), _ = jax.lax.scan(
                body, (history, jnp.float32(0.0)),
                jnp.arange(K, dtype=jnp.int32),
            )
            return acc

        return lambda: run(history)

    fn = jax.jit(render_frame, static_argnames=("config",))
    jax.block_until_ready(
        fn(scene, camera, history, jnp.asarray(0, jnp.int32), config)
    )
    blocked = _blocked_once(
        lambda i: fn(scene, camera, history, jnp.asarray(i, jnp.int32), config),
        iters,
    )
    dt = _timed_scan(make_scan, (4, 20, 36), "fwd_fused", blocked_ms=blocked)
    stderr_json(metric="fwd_frame_ms_1080p", pipeline="fused",
                value=round(dt * 1e3, 3))
    # Each pixel traces ~9 rays per frame (primary + direct-light
    # visibility + 4 roulette plane marches + 4 light re-samples,
    # SURVEY §3.2): the headline counts primaries only; this derived stat
    # is the total traced-ray throughput.
    stderr_json(metric="traced_rays_per_s_1080p", pipeline="fused",
                value=round(9 * width * height / dt, 1))
    return width * height / dt


def bench_fwd_bwd(scene, camera, width=1920, height=1080, iters=10):
    """value_and_grad of a pixel loss through the fused frame's custom VJP
    + the single-frame no_history fast path (BASELINE.json: rays/s/chip
    fwd+bwd at 1spp 1080p)."""
    config = RenderConfig(
        width=width, height=height, no_history=True, pipeline="fused"
    )
    history = init_history(config, camera)

    def loss_fn(scene, camera, history, frame):
        img, _ = render_frame(scene, camera, history, frame, config)
        return jnp.mean(img)

    vg = jax.value_and_grad(loss_fn, allow_int=True)

    def make_scan(K):
        @jax.jit
        def run(history, scene):
            def body(acc, i):
                v, g = vg(scene, camera, history, i)
                # Fold one float grad leaf in so the backward stays live.
                return acc + v + jnp.sum(g.spheres), None

            acc, _ = jax.lax.scan(
                body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.int32)
            )
            return acc

        return lambda: run(history, scene)

    vg_jit = jax.jit(vg)
    jax.block_until_ready(
        vg_jit(scene, camera, history, jnp.asarray(0, jnp.int32))
    )
    blocked = _blocked_once(
        lambda i: vg_jit(scene, camera, history, jnp.asarray(i, jnp.int32)),
        iters,
    )
    dt = _timed_scan(make_scan, (2, 10, 18), "fwd_bwd", blocked_ms=blocked)
    stderr_json(
        metric="fwd_bwd_rays_per_s_1080p",
        value=round(width * height / dt, 1),
        frame_ms=round(dt * 1e3, 3),
        pipeline="fused",
    )


def bench_raycast(scene, camera, width=1920, height=1080, iters=30):
    """Primary-visibility raycast (the XLA geometry pass alone: raygen +
    nearest-hit + analytic normals/curvature + G-buffer write)."""
    from kylespathtracer.render import gbuffer as gb_mod

    config = RenderConfig(width=width, height=height)

    def raycast(s, c, f):
        # `f` shifts the camera by nothing but keeps each scan step live.
        c = c.replace(loc=c.loc + 0.0 * f.astype(jnp.float32))
        return gb_mod.geometry_pass(s, c, config)

    fn = jax.jit(raycast)
    jax.block_until_ready(fn(scene, camera, jnp.asarray(0, jnp.int32)))
    blocked = _blocked_once(
        lambda i: fn(scene, camera, jnp.asarray(i, jnp.int32)), iters
    )

    def make_scan(K):
        @jax.jit
        def run(scene, camera):
            def body(acc, i):
                gb = raycast(scene, camera, i)
                return acc + gb.depth[0, 0], None

            acc, _ = jax.lax.scan(
                body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.int32)
            )
            return acc

        return lambda: run(scene, camera)

    dt = _timed_scan(make_scan, (8, 40, 72), "raycast", blocked_ms=blocked)
    stderr_json(
        metric="raycast_rays_per_s_1080p",
        value=round(width * height / dt, 1),
        frame_ms=round(dt * 1e3, 3),
    )


def bench_wavefront(scene, camera, width=1920, height=1080, iters=5,
                    spp=4, depth=6):
    """Multi-bounce wavefront integrator: path-segments/s at 1080p."""
    from kylespathtracer.render import wavefront as wf

    config = RenderConfig(width=width, height=height, spp=spp, max_depth=depth)
    fn = jax.jit(wf.render_pathtraced, static_argnames=("config",))
    jax.block_until_ready(fn(scene, camera, config, jnp.asarray(0, jnp.int32)))
    blocked = _blocked_once(
        lambda i: fn(scene, camera, config, jnp.asarray(i, jnp.int32)), iters
    )

    def make_scan(K):
        @jax.jit
        def run(scene, camera):
            def body(acc, i):
                img = wf.render_pathtraced(scene, camera, config, i)
                return acc + img[0, 0, 0], None

            acc, _ = jax.lax.scan(
                body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.int32)
            )
            return acc

        return lambda: run(scene, camera)

    dt = _timed_scan(make_scan, (1, 4, 7), "wavefront", blocked_ms=blocked)
    stderr_json(
        metric="wavefront_segments_per_s_1080p",
        value=round(width * height * spp * depth / dt, 1),
        frame_ms=round(dt * 1e3, 3),
        spp=spp, depth=depth,
    )


def main():
    global _FULL_LOG, _DEVICE
    _DEVICE = {**require_gpu(), "nvidia_smi": nvidia_smi()}
    enable_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    _FULL_LOG = open(os.path.join(OUT_DIR, "bench.jsonl"), "a")
    scene = default_scene()
    camera = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))

    rays_per_s = bench_forward(scene, camera)
    bench_fwd_bwd(scene, camera)
    bench_raycast(scene, camera)
    bench_wavefront(scene, camera)

    headline = json.dumps(
        {
            "metric": "primary_rays_per_s_fwd_1080p",
            "value": round(rays_per_s, 1),
            "unit": "rays/s",
            "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 3),
            "device": _DEVICE,
        }
    )
    print(headline)
    _FULL_LOG.write(headline + "\n")
    _FULL_LOG.close()


if __name__ == "__main__":
    main()
