"""Which implementation of the fused frame runs on which platform.

The one place the code looks at the platform it runs on. Each platform maps
to the implementation of the fused frame forward and to the frame pipeline
that `--pipeline auto` (CLI, fly-cam) and the inverse fit choose:

    gpu  the Pallas/Triton kernel (ops/frame_kernel.frame_forward_pallas),
         pipeline "fused"
    cpu  the same per-pixel math as plain jnp under XLA
         (frame_kernel.frame_forward_jnp), pipeline "pass"

A platform missing from the table is an error, not a fallback. Pallas's
interpret mode is never chosen here: tests ask for it explicitly.
"""

from __future__ import annotations

import jax

FRAME_FORWARD = {"gpu": "triton", "cpu": "xla"}
DEFAULT_PIPELINE = {"gpu": "fused", "cpu": "pass"}


def _lookup(table: dict, what: str, platform: str | None) -> str:
    platform = jax.default_backend() if platform is None else platform
    try:
        return table[platform]
    except KeyError:
        raise ValueError(
            f"no {what} for platform {platform!r} (known: {sorted(table)})"
        ) from None


def frame_forward_impl(platform: str | None = None) -> str:
    """"triton" or "xla": the fused frame forward for `platform` (default:
    JAX's default backend)."""
    return _lookup(FRAME_FORWARD, "frame-forward implementation", platform)


def default_pipeline(platform: str | None = None) -> str:
    """"fused" or "pass": the frame pipeline chosen for `platform`."""
    return _lookup(DEFAULT_PIPELINE, "default pipeline", platform)
