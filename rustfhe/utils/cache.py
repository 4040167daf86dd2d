"""Persistent XLA compilation cache setup.

The n-step bootstrap programs take tens of seconds to compile; JAX's
persistent compilation cache lets a later process load them instead.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed path inside the
checkout, ``.jax_cache/`` (listed in ``.gitignore``): the path is part of
what a cache entry is found by, so a directory that moved would never hit.

The library never mutates global jax config on import; applications
(``chip_smoke.py``, ``bench.py``, the nander console) opt in via
``enable_compilation_cache``.
"""

from __future__ import annotations

import os

#: The cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache(path: str | None = None) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins (and is left to JAX); otherwise
    ``path`` or ``DEFAULT_DIR`` is created and configured.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = path or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
