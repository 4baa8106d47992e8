"""Runtime numeric sanitizers — the analogue of the reference's
sanitizer builds (cmake/Sanitizers.cmake:1-43, all OFF by default; the
Vulkan validation layers, VulkanInstance.cpp:137-139, are the runtime
contract checker).

JAX is functional, so data races cannot exist at the model level; the
failure class that remains is *numeric*: NaN/Inf from bad inputs, corrupt
checkpoint shards, or unstable fits. Two tools:

  * `checked(f)` — wrap any jittable function with `checkify` float
    checks: the wrapped function raises JaxRuntimeError on the first
    NaN/Inf produced anywhere inside (the "sanitizer build" — debug
    runs / tests, not the hot path).
  * `first_nonfinite(tree)` — post-hoc device-side scan of a pytree for
    non-finite values; returns a {path: count} dict (cheap enough to run
    on checkpoints before trusting them — fault detection for corrupted
    shards, SURVEY.md §5.3).

The fit loop's NaN-step skip lives in fit.fit_grid (`nan_guard=True`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import checkify

__all__ = ["checked", "first_nonfinite", "assert_all_finite"]


def checked(f):
    """Wrap a jittable function with NaN/Inf + div-by-zero checks.

    Returns a callable with the same signature; raises
    `checkify.JaxRuntimeError` naming the failing primitive if any float
    check trips. Compiles separately from the unchecked version (checks
    insert guards into the HLO), so use for debug runs and tests."""
    cf = checkify.checkify(f, errors=checkify.float_checks)

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        err, out = cf(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper


def first_nonfinite(tree) -> dict:
    """Count non-finite elements per leaf of a pytree; {} when clean.

    Used as the corruption detector for restored checkpoints / received
    shards (fault injection test: tests/test_sanitize.py)."""
    flat, _ = jax.tree.flatten_with_path(tree)
    bad = {}
    for path, leaf in flat:
        arr = jnp.asarray(leaf)
        if not jnp.issubdtype(arr.dtype, jnp.floating):
            continue
        n = int(jnp.sum(~jnp.isfinite(arr)))
        if n:
            bad[jax.tree_util.keystr(path) or "<root>"] = n
    return bad


def assert_all_finite(tree, name="array"):
    """Raise ValueError naming the first corrupt leaf (host-side check)."""
    bad = first_nonfinite(tree)
    if bad:
        raise ValueError(f"non-finite values in {name}: {bad}")
