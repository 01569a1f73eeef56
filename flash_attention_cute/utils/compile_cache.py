"""JAX's persistent compilation cache, kept at one fixed path.

The cache key includes the directory, so a path that moves between runs
(a temporary or per-process directory) never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Return the directory JAX keeps compiled programs in.

    If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to `.jax_cache` at the root of
    the checkout.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
