"""Persistent XLA compilation cache.

The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise at one fixed path inside the checkout (``<checkout>/.jax_cache``,
git-ignored).  The path is part of what makes a later run hit, so it is
never derived from a temp dir, a pid or the time.
"""

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE


def enable_compilation_cache() -> str:
    """Point JAX's persistent cache at compilation_cache_dir(); returns
    the directory."""
    import jax
    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
