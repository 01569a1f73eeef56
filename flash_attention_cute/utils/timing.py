"""Wall-clock timing of device work.

The reference times kernels with CUDA events around a Python loop
(reference: scripts/benchmark_kernel.py:88-112, scripts/benchmark_llm.py:50-59).
Here the host clock brackets warmed calls that end in `block_until_ready`:
JAX dispatch is asynchronous, so a timing without it measures only the
enqueue.
"""

from __future__ import annotations

import statistics
import time

import jax


def time_fn(f, args, iters: int = 10, warmup: int = 2,
            repeats: int = 3) -> float:
    """Median over `repeats` of the seconds per call of `f(*args)`, each
    repeat timing `iters` back-to-back calls and one final
    `block_until_ready`. The first `warmup` calls (compilation included)
    are not timed."""
    for _ in range(warmup):
        jax.block_until_ready(f(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / iters)
    return statistics.median(times)
