"""The persistent XLA compile cache's location — one rule for the tests,
``bench.py`` and ``chip_smoke.py``.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
code here sets another directory. Otherwise the cache goes to a fixed,
git-ignored ``.jax_cache/`` inside the checkout: the path is part of the
cache key, so a fixed path is what lets a later run hit it.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(checkout: str) -> str:
    """The cache directory for a checkout rooted at ``checkout``."""
    return os.environ.get(ENV_VAR) or os.path.join(
        os.path.abspath(checkout), ".jax_cache")


def enable_compile_cache(checkout: str) -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir`` and
    return that directory."""
    path = compile_cache_dir(checkout)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
