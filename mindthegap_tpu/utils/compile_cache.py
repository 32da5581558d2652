"""JAX's persistent compilation cache, at a path that does not move.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives in `<checkout>/.jax_cache`: a fixed path,
since the cache directory is part of what a later process must find again.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
