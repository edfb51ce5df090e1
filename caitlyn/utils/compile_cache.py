"""Persistent XLA compilation cache for the entry points (`cli`,
`bench.py`, `chip_smoke.py`).

When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
is configured here.  Otherwise the cache lives at a fixed, git-ignored path
inside the checkout, so that every run from the same checkout finds what an
earlier one compiled (the path is part of the cache key, so it must not
move)."""

from __future__ import annotations

import os
from typing import Mapping, Optional

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory to configure, or None when the environment names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_DIR


def configure(environ: Mapping[str, str] = os.environ) -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring); returns the directory in use."""
    path = cache_dir(environ)
    if path is None:
        return environ["JAX_COMPILATION_CACHE_DIR"]
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    return path
