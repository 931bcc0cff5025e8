"""Command-line driver.

The reference app is `main()` + a window (main.cpp:298-363); the
equivalent here is a headless CLI:

    python -m kylespathtracer.app.cli render  --width 1280 --height 720 \
        --frames 64 --out out/
    python -m kylespathtracer.app.cli bench   --width 1920 --height 1080
    python -m kylespathtracer.app.cli invert  --spheres 10 --steps 200
    python -m kylespathtracer.app.cli info
"""

from __future__ import annotations

import argparse
import json


def _add_size(p, w=1280, h=720):
    p.add_argument("--width", type=int, default=w)
    p.add_argument("--height", type=int, default=h)


def _config_from(args):
    from kylespathtracer.utils.config import RenderConfig

    kw = dict(width=args.width, height=args.height)
    if getattr(args, "march", False):
        kw["intersect_mode"] = "march"
    if getattr(args, "unbiased", False):
        kw["biased"] = False
    # --pipeline auto takes the platform's pipeline (ops/platform.py: fused
    # on the GPU, pass on the CPU); --pipeline pass/fused overrides;
    # --fused is the legacy spelling of --pipeline fused.
    choice = getattr(args, "pipeline", "auto")
    if getattr(args, "fused", False):
        if choice == "pass":
            raise SystemExit(
                "error: --fused conflicts with --pipeline pass "
                "(--fused is an alias for --pipeline fused)"
            )
        choice = "fused"
    if choice == "auto":
        from kylespathtracer.ops import platform

        choice = platform.default_pipeline()
    kw["pipeline"] = choice
    return RenderConfig(**kw)


def cmd_render(args):
    from kylespathtracer.app.driver import render_animation
    from kylespathtracer.scene.scene import default_scene
    from kylespathtracer.utils.metrics import MetricsLogger

    config = _config_from(args)
    metrics = MetricsLogger(args.metrics)
    render_animation(
        default_scene(),
        config,
        num_frames=args.frames,
        out_dir=args.out,
        save_every=args.save_every,
        metrics=metrics,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        preview=args.preview,
        resume=args.resume,
    )
    metrics.close()


def cmd_pathtrace(args):
    """Multi-bounce wavefront render (BASELINE config #3)."""
    import time

    import jax

    from kylespathtracer.render.camera import Camera
    from kylespathtracer.render import wavefront
    from kylespathtracer.scene.scene import default_scene
    from kylespathtracer.utils.config import RenderConfig
    from kylespathtracer.utils import image_io

    config = RenderConfig(
        width=args.width, height=args.height,
        max_depth=args.depth, spp=args.spp,
    )
    camera = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    fn = jax.jit(wavefront.render_pathtraced, static_argnames=("config",))
    t0 = time.perf_counter()
    img = fn(default_scene(), camera, config, 0)
    img.block_until_ready()
    dt = time.perf_counter() - t0
    rays = args.width * args.height * args.spp * args.depth
    print(json.dumps({
        "wall_s": dt, "depth": args.depth, "spp": args.spp,
        "path_segments": rays,
    }))
    if args.out:
        image_io.save_png(args.out, img)


def cmd_fly(args):
    """Interactive fly-cam over the terminal (reference: main.cpp:328-357)."""
    from kylespathtracer.app import fly as fly_mod

    config = _config_from(args)
    fly_mod.fly(config=config, fps=args.fps, max_w=args.cols, max_h=args.rows)


def cmd_info(args):
    import jax

    import kylespathtracer as pkg
    from kylespathtracer.utils import native

    print(
        json.dumps(
            {
                "version": pkg.__version__,
                "backend": jax.default_backend(),
                "devices": [str(d) for d in jax.devices()],
                "native_lib": native.available(),
            },
            indent=2,
        )
    )


def cmd_invert(args):
    from kylespathtracer.diff import inverse

    result = inverse.run_recovery(
        num_spheres=args.spheres,
        steps=args.steps,
        width=args.width,
        height=args.height,
        lr=args.lr,
        seed=args.seed,
        log_every=args.log_every,
        views=args.views,
        betas=tuple(args.betas),
        ckpt_dir=args.ckpt_dir,
        resume=args.resume,
    )
    print(json.dumps(result))


def main(argv=None):
    from kylespathtracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="kylespathtracer")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render an animated sequence")
    _add_size(p)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--out", default="out")
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--march", action="store_true", help="sphere-trace intersector")
    p.add_argument("--unbiased", action="store_true", help="ground-truth estimators")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --checkpoint-dir")
    p.add_argument("--preview", action="store_true",
                   help="live ANSI preview in the terminal")
    p.add_argument("--pipeline", choices=("auto", "pass", "fused"),
                   default="auto",
                   help="frame pipeline (auto: fused on the GPU, pass on the CPU)")
    p.add_argument("--fused", action="store_true",
                   help="alias for --pipeline fused")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("pathtrace", help="multi-bounce wavefront render")
    _add_size(p)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--out", default=None, help="output PNG path")
    p.set_defaults(fn=cmd_pathtrace)

    p = sub.add_parser("invert", help="inverse rendering: recover a sphere scene")
    _add_size(p, w=192, h=128)
    p.add_argument("--spheres", type=int, default=10)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint (scene, optimizer) after every beta phase")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest phase checkpoint in --ckpt-dir")
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--views", type=int, default=5,
                   help="look-at cameras on an arc (removes depth ambiguity)")
    p.add_argument("--betas", type=float, nargs="+",
                   default=[0.05, 0.02, 0.008, 0.003],
                   help="soft-shadow continuation schedule")
    p.set_defaults(fn=cmd_invert)

    p = sub.add_parser("fly", help="interactive fly-cam (wasd/arrows, ANSI preview)")
    _add_size(p, w=480, h=270)
    p.add_argument("--fps", type=float, default=20.0)
    p.add_argument("--cols", type=int, default=100, help="preview width in cells")
    p.add_argument("--rows", type=int, default=48, help="preview height in cells")
    p.add_argument("--pipeline", choices=("auto", "pass", "fused"),
                   default="auto",
                   help="frame pipeline (auto: fused on the GPU, pass on the CPU)")
    p.add_argument("--fused", action="store_true",
                   help="alias for --pipeline fused")
    p.set_defaults(fn=cmd_fly)

    p = sub.add_parser("info", help="backend / device / native-lib status")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
