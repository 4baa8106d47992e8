"""High-resolution timing — the `Clock` equivalent (Clock.h:3-15,
Clock.cpp:13-26: Elapsed reads, Stamp reads and restarts), plus a
block-until-ready render timer for honest device measurements (XLA dispatch is
async; wall-clock without a sync measures nothing).
"""
from __future__ import annotations

import time

import jax

__all__ = ["Clock", "device_timer", "compile_and_time"]


class Clock:
    """Elapsed()/Stamp() semantics matching the reference Clock."""

    def __init__(self):
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since construction or last stamp (Clock.cpp:13-17)."""
        return time.perf_counter() - self._start

    def stamp(self) -> float:
        """Read elapsed and restart (Clock.cpp:19-26)."""
        now = time.perf_counter()
        dt = now - self._start
        self._start = now
        return dt


def device_timer(fn, *args, warmup=1, iters=10, **kwargs):
    """Time fn(*args) with jax.block_until_ready bracketing.

    Returns (result, seconds_per_call). The warmup calls absorb compile."""
    result = None
    for _ in range(max(warmup, 1)):
        result = jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        result = jax.block_until_ready(fn(*args, **kwargs))
    dt = (time.perf_counter() - t0) / iters
    return result, dt


def compile_and_time(fn, *args, iters=5):
    """Compile jax.jit(fn) for args, then time `iters` calls on the host
    clock, each ended by block_until_ready. Returns (compiled, result,
    compile_s, steady_s_per_call)."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    result = jax.block_until_ready(compiled(*args))  # first run: warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        result = jax.block_until_ready(compiled(*args))
    return compiled, result, compile_s, (time.perf_counter() - t0) / iters
