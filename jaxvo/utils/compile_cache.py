"""Persistent XLA compilation cache location.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX itself reads
it, and no other directory is set in code.  Otherwise the cache lives in
``<checkout>/.jax_cache`` (listed in ``.gitignore``): a fixed path, since
the path is part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir(environ=None) -> str | None:
    """The directory to set in code: None when the environment decides."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return None
    return os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns the directory."""
    import jax

    path = default_cache_dir()
    if path is None:
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
