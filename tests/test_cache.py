"""Persistent-compilation-cache helper (utils/cache.py)."""

import os
import pathlib
import tempfile

import jax

from rustfhe.utils import cache
from rustfhe.utils.cache import enable_compilation_cache


def test_enable_and_disable(tmp_path, monkeypatch):
    """An explicit path is created and configured; with
    JAX_COMPILATION_CACHE_DIR set, that directory wins."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        p = str(tmp_path / "xla")
        assert enable_compilation_cache(p) == p
        assert os.path.isdir(p)
        assert jax.config.jax_compilation_cache_dir == p
        q = str(tmp_path / "from_env")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", q)
        assert enable_compilation_cache(p) == q
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_sets_nothing_else(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, no config is touched and no
    directory is created (JAX reads the variable itself)."""
    q = tmp_path / "env_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(q))
    before = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
        jax.config.jax_persistent_cache_min_entry_size_bytes,
    )
    assert enable_compilation_cache() == str(q)
    assert not q.exists()
    assert (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
        jax.config.jax_persistent_cache_min_entry_size_bytes,
    ) == before


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    """Without the variable the cache sits at <checkout>/.jax_cache: no
    pid, time or temp-dir component, so every process finds the same one."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = pathlib.Path(__file__).resolve().parents[1]
    assert pathlib.Path(cache.DEFAULT_DIR) == root / ".jax_cache"
    assert str(os.getpid()) not in cache.DEFAULT_DIR
    assert not cache.DEFAULT_DIR.startswith(tempfile.gettempdir())
    ignored = (root / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
    old = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compilation_cache() == cache.DEFAULT_DIR
        assert enable_compilation_cache() == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_round_trip_on_cpu(tmp_path, monkeypatch):
    """A jitted program lands an entry in the cache directory (the test
    lowers JAX's minimum compile time so a tiny program qualifies)."""
    import jax.numpy as jnp

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    old_t = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        p = enable_compilation_cache(str(tmp_path / "xla"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        out = jax.jit(lambda x: x * 2 + 1)(jnp.arange(8))
        assert int(out[3]) == 7
        assert os.listdir(p), "no cache entries written"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", old_t)
