"""Compile-cache placement (utils/compile_cache.py): JAX_COMPILATION_CACHE_DIR
when set, else a fixed directory inside the checkout."""

from pathlib import Path

import jax

from kylespathtracer.utils import compile_cache


def test_env_var_is_honoured(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set.
    assert [c for c in calls if c[0] == "jax_compilation_cache_dir"] == []


def test_unset_uses_checkout_directory(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = Path(__file__).resolve().parents[1]
    assert Path(path) == root / ".jax_cache"
    assert ("jax_compilation_cache_dir", path) in calls
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_sets_nothing_but_the_directory(monkeypatch):
    """The helper changes no other JAX option (error locations keep their
    full paths and tracebacks)."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir", path)]
