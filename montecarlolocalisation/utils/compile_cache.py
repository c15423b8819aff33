"""Where the persistent XLA compile cache lives.

One rule for every entry point (bench.py, chip_smoke.py, the CLI, the
tests): if JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
nothing here touches the configuration; otherwise the cache goes to
`.jax_cache/` at the root of the checkout (listed in .gitignore).  The
path is fixed, never derived from a temporary name, a process id or the
time, because it is part of the cache's key: a directory that moves
never hits.
"""
from __future__ import annotations

import os
import os.path as osp

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def default_cache_dir(root: str = CHECKOUT) -> str:
    return osp.join(root, ".jax_cache")


def configure_compile_cache(root: str = CHECKOUT) -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = default_cache_dir(root)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
