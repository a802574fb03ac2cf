"""Persistent XLA compilation cache shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
itself) and no other directory is set. Otherwise the cache lives at
``<checkout>/.jax_cache`` (git-ignored), a fixed path, so repeated runs from
one checkout find their compiled programs again.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
