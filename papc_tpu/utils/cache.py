"""Persistent XLA compilation cache.

First compilation of the full detection predict program is slow; without
a persistent cache every CLI invocation pays it again. Entry points call
:func:`enable_persistent_cache` so repeated runs reuse compiled
executables across processes.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and nothing is changed. Otherwise the cache lives at a fixed path
inside the checkout, ``<checkout>/.jax_cache``: the path is part of the
cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def enable_persistent_cache() -> str:
    """Turn on the persistent cache; returns the directory it uses."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
