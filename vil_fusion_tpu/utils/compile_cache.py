"""Persistent XLA compile cache, placed from outside the program.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this does
nothing. Otherwise the cache lives in `.jax_cache/` at the checkout root (a
fixed path: the path is part of the cache key, and a moving directory never
hits). The directory is git-ignored.
"""
from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def use_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
