"""Persistent XLA compilation cache.

Compiling the integrators takes seconds to minutes; the persistent cache
turns every later process start into a load.  Called by the CLI / bench /
driver entry points.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX keeps
the cache there and this module sets no other directory; otherwise the
cache lives at the fixed path `<checkout>/.jax_cache` (a fixed path, since
the path is part of the cache key).
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
