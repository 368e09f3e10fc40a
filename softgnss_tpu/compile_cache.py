"""Persistent XLA compilation cache at one fixed place.

The reference-scale tracking scan is a large nested program, so a cold
run is dominated by compilation.  Entry points (the CLI, ``bench.py``,
``chip_smoke.py``) call :func:`enable_compile_cache` once at start-up; it
is not called at package import, and the tests never enable it.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: the cache directory used when JAX_COMPILATION_CACHE_DIR is unset:
#: ``.jax_cache`` at the root of the checkout (git-ignored).  A fixed path,
#: because the directory is part of what a later process looks up.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads the variable itself
    and nothing is changed here.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
