"""Parallel scans and reductions.

Reference parity (`/root/reference/inc/_vector.hxx`): ``inclusiveScan[Omp]W`` /
``exclusiveScan[Omp]W`` (:1374-1536, the two-pass chunked parallel scan), the
``sumValues``/``countValue`` reductions (:652-760), and the L1/L2/L∞ norm family
(:776-1357).  The reference hand-chunks across OpenMP threads; here these are
single XLA ops (`jnp.cumsum` / `jax.lax.associative_scan`) that the compiler
parallelizes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "inclusive_scan",
    "exclusive_scan",
    "sum_values",
    "count_value",
    "l1_norm",
    "l2_norm",
    "li_norm",
    "l1_norm_delta",
    "l2_norm_delta",
    "li_norm_delta",
]


def inclusive_scan(x, axis: int = -1):
    """Inclusive prefix sum (`_vector.hxx:1374-1444`)."""
    return jnp.cumsum(x, axis=axis)


def exclusive_scan(x, axis: int = -1):
    """Exclusive prefix sum (`_vector.hxx:1456-1536`)."""
    inc = jnp.cumsum(x, axis=axis)
    return inc - x


def sum_values(x):
    """Total (`sumValues[Omp]`, `_vector.hxx:652-697`)."""
    return jnp.sum(x)


def count_value(x, v):
    """Occurrences of ``v`` (`countValue[Omp]`, `_vector.hxx:713-760`)."""
    return jnp.sum(x == v)


def l1_norm(x):
    return jnp.sum(jnp.abs(x))


def l2_norm(x):
    return jnp.sqrt(jnp.sum(x * x))


def li_norm(x):
    return jnp.max(jnp.abs(x))


def l1_norm_delta(x, y):
    """``l1NormDelta`` (`_vector.hxx:871-918`)."""
    return jnp.sum(jnp.abs(x - y))


def l2_norm_delta(x, y):
    return jnp.sqrt(jnp.sum((x - y) ** 2))


def li_norm_delta(x, y):
    return jnp.max(jnp.abs(x - y))
