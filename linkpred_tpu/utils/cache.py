"""Persistent XLA compile cache for the program's entry points."""
from __future__ import annotations

import os

__all__ = ["enable_compile_cache"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep compiled programs in ``JAX_COMPILATION_CACHE_DIR`` when it is
    set, else in ``<repo>/.jax_cache``.  The path must not move between runs:
    it is part of what the cache matches on.  Returns the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
