"""Persistent XLA compilation cache at a fixed place.

Compiling the flagship render takes long enough that every entry point
(the CLI, bench.py, chip_smoke.py) keeps compiled executables on disk.
JAX reads JAX_COMPILATION_CACHE_DIR by itself; when it is set, that is the
cache and nothing is changed here. Otherwise the cache lives at a fixed
path inside the checkout: the path is part of the cache key, so a
per-run temporary directory would never hit.
"""
from __future__ import annotations

import os

import jax

__all__ = ["cache_dir", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory compiled executables are kept in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at cache_dir() and return it. Sets
    nothing when JAX_COMPILATION_CACHE_DIR is set (JAX already uses it)."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
