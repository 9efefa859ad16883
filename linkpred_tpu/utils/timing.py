"""Wall-clock timing harness.

Parity with the reference's `measureDuration(fn, N)` repeat-averaged milliseconds
(`/root/reference/inc/_utility.hxx:113-119`), adapted to an async accelerator:
results are awaited with `jax.block_until_ready` before the clock stops, and an
optional warmup call excludes XLA compilation (the reference's g++ compiles ahead
of time, so timed regions never include compilation).
"""
from __future__ import annotations

import time
from typing import Callable, Tuple, TypeVar

import jax

T = TypeVar("T")

__all__ = ["measure_duration", "measure_duration_marked"]


def measure_duration(fn: Callable[[], T], repeat: int = 1, warmup: bool = True) -> Tuple[float, T]:
    """Run ``fn`` ``repeat`` times; return (average milliseconds, last result).

    The wait happens once after the loop: device programs run in dispatch
    order, so the last one completing bounds all ``repeat`` executions.
    """
    result = None
    if warmup:
        result = jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(max(repeat, 1)):
        result = fn()
    result = jax.block_until_ready(result)
    t1 = time.perf_counter()
    return (t1 - t0) * 1e3 / max(repeat, 1), result


def measure_duration_marked(fn: Callable[[Callable], T], repeat: int = 1) -> Tuple[float, T]:
    """Time only sub-sections that ``fn`` wraps in the provided ``mark`` callable
    (reference ``measureDurationMarked``, `_utility.hxx:155-164`)."""
    acc = 0.0
    result = None
    for _ in range(max(repeat, 1)):
        def mark(f):
            nonlocal acc
            t0 = time.perf_counter()
            r = jax.block_until_ready(f())
            acc += time.perf_counter() - t0
            return r
        result = fn(mark)
    return acc * 1e3 / max(repeat, 1), result
