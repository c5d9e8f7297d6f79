"""Tracing/profiling helpers (SURVEY.md §5.1).

The reference prints wall-clock fps at most; here profiling is first-class:
``trace()`` wraps ``jax.profiler`` (view in TensorBoard/Perfetto) and
``time_runs`` is the one timing harness of the benchmarks and the smoke
test.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: `with trace(dir): run()` → TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def time_runs(fn: Callable, *args, runs: int = 20):
    """(first-call s, [run s], last outputs) of ``fn(*args)``.

    The first call compiles a jitted ``fn`` (or loads it from the compile
    cache) and is timed apart; each of the ``runs`` timed calls ends in
    ``block_until_ready``. Report the median of the run times."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first_s, times, out
