"""Persistent XLA compilation cache for the entry-point scripts."""

from __future__ import annotations

import os

# ``<checkout>/.jax_cache``: a fixed path, because the cache key includes it.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
    sets nothing. Otherwise the cache lives in ``<checkout>/.jax_cache``.
    Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
