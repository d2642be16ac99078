"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (``bench.py``, ``chip_smoke.py``, the
``apps``): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and nothing here overrides it; otherwise the cache lives in
:data:`REPO_CACHE_DIR`, one fixed directory inside the checkout (the path
is part of the cache key, so a moving directory would never hit).
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache():
    """Apply the rule above; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
