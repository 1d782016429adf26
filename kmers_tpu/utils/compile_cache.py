"""Where the persistent XLA compile cache lives.

JAX keys a cached executable by, among other things, the cache path, so
the directory must not move between runs: ``JAX_COMPILATION_CACHE_DIR``
when it is set (JAX reads it itself), otherwise ``.jax_cache`` at the
root of the checkout, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os

__all__ = ["use_compile_cache"]

#: the checkout root (the directory that holds the ``kmers_tpu`` package)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed directory and
    return that directory.  Call before the first compilation."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
