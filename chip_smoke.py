"""Run the renderer's main path once on one GPU and check every result.

    python chip_smoke.py              # phases 1-6 on one card, 1920x1080
    python chip_smoke.py --chips 4    # only the 4-card tiled frame and step

One process drives the card(s); the only child process it starts is
nvidia-smi. Phases, in order, one line each with wall time, compile time
and the card's name and power limit:

1. device      JAX's first device is a GPU (anything else fails).
2. kernel      The fused frame kernel (Pallas, Triton route) at full size
               against `frame_forward_jnp` under XLA on the card (both
               timed), and its rows of one 64-row tile against
               `frame_forward_jnp` in tile mode on the host CPU.
3. temporal    `app.driver.render_animation` for 8 frames along the
               reference pose spline with pipeline="fused", finite, and
               matching pipeline="pass" after the 8 frames.
4. inverse     3 steps of `diff.inverse.fit` on the 10-sphere recovery
               scene through the custom VJP; for two scene seeds, one
               step's gradients against pipeline="pass", over the whole
               image and with silhouette pixels masked.
5. wavefront   `render_pathtraced` at 4 spp, depth 6: finite, and the same
               on two runs.
6. gpu-tests   the tests marked `gpu`, run in this process.

The tolerances are those of kylespathtracer/utils/parity.py; gradients
agree to GRAD_REL_L2 (silhouettes masked) and WHOLE_GRAD_REL_L2 relative
L2 error per parameter group, and on 4 cards SGD parameter updates to
1e-4. Any failed
phase makes the script exit non-zero before it prints its last line, which
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Relative L2 error allowed between the fused and pass pipelines'
# gradients, per parameter group, with the cotangents of silhouette pixels
# (object-ID edges) zeroed.
GRAD_REL_L2 = 1e-3
# The same over the whole image. A ray that grazes a sphere has
# dt/dparam ~ 1/(n.d): on those pixels a last-bit difference in the hit
# moves the derivative by O(1), so the whole-image gap is bounded by
# 1e-2, or by twice the gap a 1e-6 relative nudge of the parameters opens
# in either pipeline's own gradient where that is larger. On the CPU at
# 320x180 (10 spheres, seeds 0 and 1) the whole-image gap read 1.7e-3 and
# 9.8e-3 for the spheres, the nudge gap 1.6e-4 and 9.4e-3, and masking
# the 3.6% silhouette pixels took the gap to 3.6e-4 and 3.8e-4.
WHOLE_GRAD_REL_L2 = 1e-2
ROOT = os.path.dirname(os.path.abspath(__file__))


class PhaseFailed(AssertionError):
    def __init__(self, what, details=None):
        super().__init__(what)
        self.details = details or {}


class _CompileClock:
    """Seconds JAX spent compiling (tracing, lowering, backend compile),
    from JAX's own monitoring events."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


class Smoke:
    """Runs phases, prints one line per phase, remembers failures."""

    def __init__(self, card: str):
        self.card = card
        self.clock = _CompileClock()
        self.failed: list[str] = []

    def run(self, name, fn, *args, **kwargs):
        t0, c0 = time.perf_counter(), self.clock.total
        try:
            details = fn(*args, **kwargs)
            status = "ok"
        except Exception as e:  # recorded; main() exits non-zero
            details = {"error": f"{type(e).__name__}: {e}"[:4000],
                       **getattr(e, "details", {})}
            status = "FAILED"
            self.failed.append(name)
        wall = time.perf_counter() - t0
        compile_s = self.clock.total - c0
        print(
            f"[{name}] {status} wall {wall:.1f} s, compile {compile_s:.1f} s"
            f" | card: {self.card} | {json.dumps(details, default=str)}",
            flush=True,
        )
        return details


def _check(cond, what, details=None):
    if not cond:
        raise PhaseFailed(what, details)


def _median_ms(fn, *args, n: int = 5) -> float:
    """Median wall time of `fn(*args)` ended by block_until_ready, in ms
    (after one untimed call)."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _hit_points(camera, depth, config):
    import numpy as np

    from kylespathtracer.render.camera import ray_dirs

    rd = np.asarray(ray_dirs(camera, config.width, config.height, config.fov))
    return np.asarray(camera.loc) + rd * np.asarray(depth)[..., None]


# ------------------------------------------------------------------ phases


def phase_device():
    from kylespathtracer.utils.device import device_info

    info = device_info()
    _check(info["platform"] == "gpu", f"first device is {info['platform']}")
    return info


def phase_kernel(width=1920, height=1080, tile_rows=64, interpret=False):
    """The Triton forward against frame_forward_jnp: full frame on the
    card under XLA, and one row tile on the host CPU."""
    import jax
    import jax.numpy as jnp

    from kylespathtracer.ops import frame_kernel as fk
    from kylespathtracer.render.camera import Camera
    from kylespathtracer.scene import default_scene
    from kylespathtracer.utils import parity
    from kylespathtracer.utils.config import RenderConfig

    scene = default_scene()
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    frame = jnp.asarray(0, jnp.int32)
    cfg = RenderConfig(width=width, height=height)
    out = {}
    with jax.default_matmul_precision("highest"):
        tri = jax.jit(lambda s, c, f: fk.frame_forward_pallas(
            s, c, f, cfg, interpret=interpret)).lower(scene, cam, frame).compile()
        xla = jax.jit(lambda s, c, f: fk.frame_forward_jnp(
            s, c, f, cfg)).lower(scene, cam, frame).compile()
        out["memory_triton"] = _memory(tri)
        out["memory_xla"] = _memory(xla)
        got = jax.device_get(tri(scene, cam, frame))
        ref = jax.device_get(xla(scene, cam, frame))
        mask = parity.boundary_mask(
            [ref["oid"]], [_hit_points(cam, ref["depth"], cfg)]
        )
        out["triton_vs_xla"] = parity.compare(got, ref, parity.SINGLE, mask)
        out["triton_ms"] = _median_ms(tri, scene, cam, frame)
        out["xla_ms"] = _median_ms(xla, scene, cam, frame)

        # One tile through the middle of the image, computed on the host
        # CPU (tile mode, row_base/rows), against the same rows of the
        # kernel's frame.
        row_base = (height // 2 - tile_rows // 2) if height > tile_rows else 0
        rows = min(tile_rows, height)
        on_cpu = jax.device_put((scene, cam, frame), jax.devices("cpu")[0])
        t0 = time.perf_counter()
        ref_tile = jax.device_get(jax.jit(lambda s, c, f: fk.frame_forward_jnp(
            s, c, f, cfg, row_base=row_base, rows=rows))(*on_cpu))
        out["host_cpu_tile_s"] = time.perf_counter() - t0
        crop = {k: v[row_base:row_base + rows] for k, v in got.items()}
        out["tile_rows"] = [row_base, row_base + rows]
        out["tile_vs_host_cpu"] = parity.compare(crop, ref_tile, parity.SINGLE)
    for k in ("triton_vs_xla", "tile_vs_host_cpu"):
        _check(out[k]["ok"], f"{k} outside tolerance", out)
    return out


class _FrameTimes:
    """A metrics sink for render_animation: keeps each frame's record."""

    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)


def phase_temporal(width=1920, height=1080, frames=8):
    """render_animation along the pose spline, fused against pass."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from kylespathtracer.app.driver import render_animation, spline_cameras
    from kylespathtracer.render import gbuffer as gb_mod
    from kylespathtracer.render.pipeline import init_history, render_frame
    from kylespathtracer.scene import default_scene
    from kylespathtracer.utils import parity
    from kylespathtracer.utils.config import RenderConfig

    scene = default_scene()
    cams = spline_cameras(frames)
    out = {}
    results = {}
    with jax.default_matmul_precision("highest"):
        for pipeline in ("fused", "pass"):
            cfg = RenderConfig(width=width, height=height, pipeline=pipeline)
            cam0 = jax.tree.map(lambda l: l[0], cams)
            step = jax.jit(render_frame, static_argnames=("config",),
                           donate_argnames=("history",))
            out[f"memory_{pipeline}"] = _memory(step.lower(
                scene, cam0, init_history(cfg, cam0), jnp.int32(0), cfg
            ).compile())
            times = _FrameTimes()
            img, hist = render_animation(
                scene, cfg, num_frames=frames, cameras=cams, metrics=times
            )
            img = np.asarray(img)
            _check(np.isfinite(img).all(), f"{pipeline}: non-finite pixels",
                   out)
            out[f"frame_ms_{pipeline}"] = [
                round(r["wall_s"] * 1e3, 3) for r in times.records
            ]
            results[pipeline] = (img, hist)

        geo_cfg = RenderConfig(width=width, height=height)
        oids, hls = [], []
        for i in range(frames):
            cam = jax.tree.map(lambda l: l[i], cams)
            gb = gb_mod.geometry_pass(scene, cam, geo_cfg)
            oids.append(np.asarray(gb.obj_id))
            hls.append(_hit_points(cam, gb.depth, geo_cfg))
    (img_f, hist_f), (img_p, hist_p) = results["fused"], results["pass"]
    counts = [hist_p.diffuse.cnt, hist_p.specular.cnt]
    mask = parity.boundary_mask(oids, hls, counts)
    out["fused_vs_pass"] = parity.compare(
        {"image": img_f, "oid": hist_f.diffuse.oid},
        {"image": img_p, "oid": hist_p.diffuse.oid}, parity.TEMPORAL, mask,
    )
    out["history_cnt_mean"] = float(jnp.mean(hist_f.diffuse.cnt))
    _check(out["fused_vs_pass"]["ok"], "fused vs pass outside tolerance", out)
    return out


def _rel_l2(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_inverse(width=1920, height=1080, steps=3, soft_shadows=0.05,
                  num_spheres=10, seeds=(0, 1), grad_limit=GRAD_REL_L2,
                  whole_limit=WHOLE_GRAD_REL_L2, memory=True):
    """`steps` fit steps through the custom VJP (the first seed), and for
    each seed one step's gradients against pipeline="pass": over the whole
    image, with the silhouette pixels' cotangents zeroed, and each
    pipeline against itself after a 1e-6 relative nudge of the
    parameters. `memory=False` skips the step's memory analysis (a second
    compile where no persistent compile cache is on)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from kylespathtracer.diff import inverse
    from kylespathtracer.render import gbuffer as gb_mod
    from kylespathtracer.utils import parity
    from kylespathtracer.utils.config import RenderConfig

    cfg = RenderConfig(width=width, height=height, pipeline="fused",
                       soft_shadows=soft_shadows)
    pass_cfg = dataclasses.replace(cfg, pipeline="pass")
    frame = jnp.asarray(0, jnp.int32)
    opt = optax.sgd(1e-2)
    render = jax.jit(inverse.render_once, static_argnames=("config",))
    geometry = jax.jit(gb_mod.geometry_pass, static_argnames=("config",))

    def weighted_grads(params, scene, cam, target, weight, config):
        """The MSE's gradient with per-pixel weights on the residual."""
        def loss(p):
            img = inverse.render_once(inverse.apply_params(scene, p), cam,
                                      config, frame)
            return jnp.mean(weight[..., None] * (img - target) ** 2)
        return jax.grad(loss)(params)

    grads = jax.jit(weighted_grads, static_argnames=("config",))
    out = {"grad_rel_l2_limit": grad_limit,
           "whole_grad_rel_l2_limit": whole_limit}
    with jax.default_matmul_precision("highest"):
        for seed in seeds:
            scene_gt, scene_i, cams = inverse.recovery_problem(
                num_spheres=num_spheres, seed=seed, views=1
            )
            cam = jax.tree.map(lambda l: l[0], cams)
            target = render(scene_gt, cam, pass_cfg, frame)
            params = inverse.extract_params(scene_i)
            if seed == seeds[0]:
                # The production step (fit's own jitted step; the fit
                # below reuses its compilation).
                args = (params, opt.init(params), scene_i, cam, target,
                        frame, opt, cfg)
                loss = inverse.fit_step(*args)[2]
                _check(np.isfinite(float(loss)), f"step loss {loss}", out)
                out["fit_step_ms"] = _median_ms(inverse.fit_step, *args, n=3)
                out["peak_bytes_in_use"] = _peak_bytes()
                if memory:
                    out["memory_fit_step"] = _memory(
                        inverse.fit_step.lower(*args).compile()
                    )
                _, losses = inverse.fit(scene_i, target, cam, cfg,
                                        steps=steps, opt=opt,
                                        vary_seed=False)
                out["fit_losses"] = losses
                _check(all(np.isfinite(losses)), "non-finite fit losses",
                       out)

            # Silhouettes: object-ID edges, dilated by width // 640 pixels
            # so that the band keeps about its angular width across
            # resolutions.
            gb = geometry(scene_i, cam, pass_cfg)
            edge = parity.id_edges(gb.obj_id, dilate=width // 640)
            whole = jnp.ones((height, width), jnp.float32)
            masked = jnp.asarray(~edge, jnp.float32)
            nudged = jax.tree.map(lambda x: x * (1.0 + 1e-6), params)
            g = {}
            for c in (cfg, pass_cfg):
                g[c.pipeline] = jax.device_get({
                    "whole": grads(params, scene_i, cam, target, whole, c),
                    "masked": grads(params, scene_i, cam, target, masked, c),
                    "nudged": grads(nudged, scene_i, cam, target, whole, c),
                })
                if seed == seeds[0]:
                    out[f"fwd_bwd_ms_{c.pipeline}"] = _median_ms(
                        grads, params, scene_i, cam, target, whole, c, n=3
                    )
            f, p = g["fused"], g["pass"]
            rec = {
                "silhouette_frac": float(edge.mean()),
                "whole": {k: _rel_l2(f["whole"][k], p["whole"][k])
                          for k in params},
                "masked": {k: _rel_l2(f["masked"][k], p["masked"][k])
                           for k in params},
                "nudge_fused": {k: _rel_l2(f["nudged"][k], f["whole"][k])
                                for k in params},
                "nudge_pass": {k: _rel_l2(p["nudged"][k], p["whole"][k])
                               for k in params},
                # How much of the gradient the silhouette pixels carry.
                "silhouette_share": {
                    k: _rel_l2(p["masked"][k], p["whole"][k]) for k in params
                },
            }
            out[f"seed_{seed}"] = rec
            for k in params:
                limit = max(whole_limit, 2 * rec["nudge_fused"][k],
                            2 * rec["nudge_pass"][k])
                _check(rec["masked"][k] <= grad_limit,
                       f"seed {seed}: {k} gradients differ off silhouettes",
                       out)
                _check(rec["whole"][k] <= limit,
                       f"seed {seed}: {k} gradients differ", out)
    return out


def phase_wavefront(width=1920, height=1080, spp=4, depth=6):
    """The XLA wavefront integrator: finite and reproducible."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from kylespathtracer.render import wavefront as wf
    from kylespathtracer.render.camera import Camera
    from kylespathtracer.scene import default_scene
    from kylespathtracer.utils.config import RenderConfig

    scene = default_scene()
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth)
    frame = jnp.asarray(0, jnp.int32)
    fn = jax.jit(lambda s, c, f: wf.render_pathtraced(s, c, cfg, f)).lower(
        scene, cam, frame).compile()
    a = np.asarray(fn(scene, cam, frame))
    b = np.asarray(fn(scene, cam, frame))
    _check(np.isfinite(a).all(), "non-finite pixels")
    _check(np.array_equal(a, b), "two runs differ",
           {"max_abs_diff": float(np.abs(a - b).max())})
    return {
        "memory": _memory(fn),
        "frame_ms": _median_ms(fn, scene, cam, frame, n=3),
        "path_segments": width * height * spp * depth,
    }


def phase_gpu_tests():
    """The tests marked `gpu`, in this process (one process per card)."""
    import pytest

    os.environ["KPT_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider",
        os.path.join(ROOT, "tests"),
    ])
    _check(rc == 0, f"pytest exit code {int(rc)}")
    return {"pytest_exit_code": int(rc)}


def phase_multichip(width=1920, height=1080, frames=3, steps=2,
                    num_spheres=2):
    """The tiled temporal frame and the tiled train step on every card
    (row tiles behind a ppermute halo; gradients psum/pmean-reduced),
    against the same work on one card. Both use a small recovery scene
    (`num_spheres` spheres): the kernel compiles in seconds, and the
    collectives and halo do not depend on the scene."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from kylespathtracer.diff import inverse
    from kylespathtracer.parallel import mesh as mesh_mod
    from kylespathtracer.parallel import shard
    from kylespathtracer.render.pipeline import init_history, render_frame
    from kylespathtracer.utils import parity
    from kylespathtracer.utils.config import RenderConfig

    n = len(jax.devices())
    mesh = mesh_mod.make_mesh(n)
    scene_gt, scene_i, cams = inverse.recovery_problem(
        num_spheres=num_spheres, seed=0, views=1
    )
    cam0 = jax.tree.map(lambda l: l[0], cams)
    cfg = RenderConfig(width=width, height=height, pipeline="fused")
    # Slow pan: ~0.3 px per frame at 1080p.
    pan = [
        cam0.replace(orient=cam0.orient + jnp.asarray([0.0, 1e-3 * i]))
        for i in range(frames)
    ]
    out = {"devices": n, "tile_rows": height // n}
    with jax.default_matmul_precision("highest"):
        one = jax.jit(render_frame, static_argnames=("config",))
        h1 = init_history(cfg, cam0)
        ht = init_history(cfg, cam0)
        tiled_ms, one_ms = [], []
        for i, cam in enumerate(pan):
            f = jnp.asarray(i, jnp.int32)
            t0 = time.perf_counter()
            img1, h1 = one(scene_gt, cam, h1, f, cfg)
            jax.block_until_ready(img1)
            one_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
            t0 = time.perf_counter()
            imgt, ht = shard.render_frame_tiled(scene_gt, cam, ht, f, cfg, mesh)
            jax.block_until_ready(imgt)
            tiled_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        out["frame_ms_one_card"] = one_ms
        out["frame_ms_tiled"] = tiled_ms
        out["tiled_vs_one_card"] = parity.compare(
            {"image": np.asarray(imgt), "oid": np.asarray(ht.diffuse.oid)},
            {"image": np.asarray(img1), "oid": np.asarray(h1.diffuse.oid)},
        )

        # As in the inverse phase: target from the pass pipeline, frame 0,
        # soft shadows 0.05, SGD.
        tcfg = RenderConfig(width=width, height=height, pipeline="fused",
                            soft_shadows=0.05)
        frame = jnp.asarray(0, jnp.int32)
        target = jax.jit(inverse.render_once, static_argnames=("config",))(
            scene_gt, cam0, dataclasses.replace(tcfg, pipeline="pass"), frame
        )
        # Plain SGD: the parameter change is linear in the gradient, so the
        # comparison below measures gradient agreement (Adam's first steps
        # would amplify the sign of near-zero gradient components).
        opt = optax.sgd(1e-2)
        p0 = p1 = pt = inverse.extract_params(scene_i)
        s1 = st = opt.init(p1)
        step_ms = []
        for _ in range(steps):
            p1, s1, l1, _ = inverse.fit_step(
                p1, s1, scene_i, cam0, target, frame, opt, tcfg
            )
            t0 = time.perf_counter()
            pt, st, lt = shard.train_step_tiled(
                pt, st, opt, scene_i, cam0, target, frame, tcfg, mesh
            )
            jax.block_until_ready(pt)
            step_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        out["step_ms_tiled"] = step_ms
        out["loss_one_card"] = float(l1)
        out["loss_tiled"] = float(lt)
        moved = {k: np.asarray(p1[k]) - np.asarray(p0[k]) for k in p1}
        moved_t = {k: np.asarray(pt[k]) - np.asarray(p0[k]) for k in p1}
        out["update_rel_l2"] = {k: _rel_l2(moved_t[k], moved[k]) for k in p1}
    _check(out["tiled_vs_one_card"]["ok"], "tiled frame outside tolerance",
           out)
    _check(
        bool(np.isclose(out["loss_tiled"], out["loss_one_card"], rtol=1e-4)),
        "tiled loss differs", out,
    )
    _check(all(v <= 1e-4 for v in out["update_rel_l2"].values()),
           "tiled parameter updates differ", out)
    return out


# --------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phase on 4 cards")
    args = ap.parse_args(argv)

    import jax

    from kylespathtracer.utils.compile_cache import enable_compile_cache
    from kylespathtracer.utils.device import device_info, nvidia_smi

    info = device_info()
    if info["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {info['platform']})",
              file=sys.stderr)
        return 1
    if info["count"] < args.chips:
        print(f"chip_smoke: {args.chips} cards asked, {info['count']} found",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    card = nvidia_smi().replace("\n", "; ")
    smoke = Smoke(card)
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}, devices {jax.devices()}", flush=True)

    if args.chips == 1:
        smoke.run("device", phase_device)
        smoke.run("kernel", phase_kernel)
        smoke.run("temporal", phase_temporal)
        smoke.run("inverse", phase_inverse)
        smoke.run("wavefront", phase_wavefront)
        smoke.run("gpu-tests", phase_gpu_tests)
    else:
        smoke.run("multichip", phase_multichip)
    if smoke.failed:
        print(f"chip_smoke: failed phases {smoke.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
