"""Where the persistent XLA compilation cache lives.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself and
this module sets nothing).  Otherwise the cache is the fixed, gitignored
``<checkout>/.jax_cache``: a fixed path, because the path is part of the
cache key and a directory that moves never hits.
"""
from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_dir() -> str:
    return str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")


def resolve_dir(environ=None) -> str:
    """The cache directory a process with ``environ`` uses."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or default_dir()


def enable() -> str:
    """Point JAX at the cache directory; returns the directory in use."""
    import jax

    path = resolve_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
