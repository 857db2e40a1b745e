"""Persistent XLA compilation cache placement for entry points.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py`` and the scripts) call
:func:`enable_compile_cache` once before compiling; importing the library
sets nothing. A cache directory that moves between runs never hits, so the
path is fixed: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it
(JAX reads that variable itself, so nothing is set in code), otherwise
``.jax_cache`` in the checkout that holds this package (git-ignored).
"""
from __future__ import annotations

import os
from pathlib import Path

#: <checkout>/.jax_cache, derived from this file's own location
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
