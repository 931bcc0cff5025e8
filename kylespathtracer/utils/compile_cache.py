"""JAX's persistent compilation cache, for the entry points.

Entry points (the CLI, chip_smoke.py, bench.py, bench_configs.py) call
`enable_compile_cache()` once at start-up; library modules set no cache.
When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no other
directory is set here. Otherwise the cache goes to `.jax_cache/` at the
root of the checkout (listed in .gitignore), a fixed path.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    path = os.environ.get(ENV)
    if not path:
        path = str(CHECKOUT_CACHE)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
