"""Profiling / timing helpers (greenfield vs the reference, SURVEY.md S5).

Thin wrappers over ``jax.profiler`` plus a wall-clock timer whose
completion signal is ``jax.block_until_ready``: JAX dispatches
asynchronously, so a timer without it measures the enqueue, not the work.
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timeit(fn, *args, iters: int = 3):
    """Wall-clock of ``fn(*args)`` after one warm (compiling) call, each
    call ending in ``block_until_ready``. Returns ``(min_seconds,
    all_seconds)``."""
    jax.block_until_ready(args)
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times), times
