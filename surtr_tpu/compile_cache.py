"""Where JAX keeps its persistent compile cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives in ``<checkout>/.jax_cache``
(``.gitignore`` lists it), found from this file's location, so every process
of one checkout shares it whatever its working directory.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_root() -> str:
    """The cache directory this checkout uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache(subdir: str | None = None) -> str:
    """Turn the persistent cache on (at ``cache_root()``, or a ``subdir`` of
    the checkout's default root) and return its path. Programs that compile
    in under a second are not cached."""
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return jax.config.jax_compilation_cache_dir
    path = cache_root()
    if subdir:
        path = os.path.join(path, subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
