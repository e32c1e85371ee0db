"""Persistent XLA compilation cache setup.

A large stack compiles for tens of seconds; the persistent cache lets a
later process reuse the compiled programs.  The cache directory is
``JAX_COMPILATION_CACHE_DIR`` where that variable is set (JAX also reads
it at import), and otherwise the fixed in-repo ``.jax_cache/``: the path
is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

#: the fixed fallback directory, at the repository root
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Activate the persistent compile cache and return its directory.

    Call it after importing jax and before the first jit compile."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
