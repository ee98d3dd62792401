"""The one place that chooses the persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache is ``<repo>/.jax_cache`` (a fixed path: the path
is part of the cache key, so a directory that moves never hits). A process
whose cache is already configured (the test suite's own) keeps it.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache(min_compile_time_secs: float = 10.0) -> str:
    """Turn the persistent compile cache on; returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time_secs)
    return DEFAULT_DIR
