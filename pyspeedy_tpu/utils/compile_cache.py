"""Placement of JAX's persistent compilation cache.

The scripts of this repository (chip_smoke.py, bench.py, bench_scaling.py,
the tools) call `enable_compile_cache()` once at start-up, so reruns reuse
compiled executables.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

# <checkout>/.jax_cache: a fixed path, since the path is part of the cache
# key (a directory that moves never hits). Listed in .gitignore.
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here. Otherwise the cache lives in CHECKOUT_CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    CHECKOUT_CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(CHECKOUT_CACHE_DIR)
