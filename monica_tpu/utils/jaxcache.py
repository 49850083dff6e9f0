"""Persistent XLA compilation cache.

The classify program is shape-stable across runs (length-bucketed
batches), so a persistent cache turns every rerun (benchmarks, the
streaming runtime, CI) into a cache hit.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and this module
sets no other directory.  Otherwise the cache lives at a fixed path in
the checkout, ``<checkout>/.jax_cache`` (git-ignored): the path is part
of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    """Where compiled programs are cached."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else CHECKOUT_CACHE


def enable_compilation_cache() -> Path:
    """Turn the persistent cache on; returns its directory."""
    import jax

    d = cache_dir()
    if ENV_VAR not in os.environ:
        d.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(d))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
