"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
this module sets nothing.  Otherwise the cache lives in ``.jax_cache/``
at the checkout root: a fixed path, since the directory is part of
what a later process must find again.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "CHECKOUT_CACHE_DIR"]

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, not only those that took over a second
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
