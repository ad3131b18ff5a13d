"""Persistent compilation cache placement for the measurement scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left
alone. Otherwise the cache goes to ``.jax_cache`` at the root of the
checkout that holds this package: a fixed path, because the cache key
includes it, so a directory that moves never hits.
"""
from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
