"""Persistent XLA compilation cache.

Long ``lax.scan`` chunks compile slowly (minutes for the large FEM
chunks, whose element tables XLA constant-folds into the loop body), and
a relaunch of the same configuration pays that again. JAX's persistent
compilation cache makes the relaunch near-instant. Its keys cover the
jaxpr including inlined constants, so a different mesh is a miss; the
directory is part of the key too, so it stays at one fixed path.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it itself and the
  program sets no other directory;
- otherwise ``<checkout>/.jax_cache`` (listed in ``.gitignore``).

The CLI, ``bench.py`` and ``chip_smoke.py`` call
:func:`enable_compilation_cache` at start-up, before the first
compilation.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> Path:
    """The directory the persistent compilation cache uses."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else CHECKOUT_CACHE


def enable_compilation_cache(min_compile_secs: float = 2.0) -> Path:
    """Turn on the persistent compilation cache (see the module docstring
    for where it lives) and return its directory. Call before any
    compilation."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs)
    )
    return path
