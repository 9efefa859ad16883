"""Device profiling: trace capture + per-op summary.

The reference's observability is wall-clock only (`measureDuration`,
`/root/reference/inc/_utility.hxx:113-119`).  On an accelerator the interesting
question is *which op* dominates device time, so this wraps `jax.profiler` trace
capture and parses the chrome-trace output into an aggregated per-op table.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
from typing import Callable, Optional

__all__ = ["trace", "summarize_trace", "profile_fn"]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Context manager: capture a profiler trace; yields the trace directory."""
    import jax

    d = log_dir or tempfile.mkdtemp(prefix="linkpred_trace_")
    jax.profiler.start_trace(d)
    try:
        yield d
    finally:
        jax.profiler.stop_trace()


def summarize_trace(trace_dir: str, top: int = 25) -> list[tuple[str, float]]:
    """Aggregate op durations from a captured trace.

    Returns [(op_name, total_ms)] sorted descending — device ops and host spans
    mixed; device-op rows (e.g. ``sort.17``, ``fusion.2``) reveal kernel costs.
    """
    files = glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    agg: dict[str, float] = {}
    for f in files:
        with gzip.open(f, "rt") as fh:
            data = json.load(fh)
        for e in data.get("traceEvents", []):
            if e.get("ph") == "X":
                name = e.get("name", "?")
                agg[name] = agg.get(name, 0.0) + e.get("dur", 0) / 1e3
    return sorted(agg.items(), key=lambda kv: -kv[1])[:top]


def profile_fn(fn: Callable, *args, top: int = 25, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a trace; returns (result, summary)."""
    import jax

    with trace() as d:
        result = jax.block_until_ready(fn(*args, **kwargs))
    return result, summarize_trace(d, top=top)
